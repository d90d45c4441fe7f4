"""The device tier's adjacency width on the card: the plain ``[N, R]``
table the port holds against the JAX package's layout (two nodes a row,
R padded to 64 slots), which row-major is the plain table padded to 64
columns of -1.

    python experiments/torch_device_tier_width.py [--n 200000] [--turns 2]

The SQ4 path's corpus (``synthetic_dataset(n, 128, n_queries=8192,
n_clusters=n // 500, seed=0)``) is built with ``GraphConfig(max_degree=32,
ef_construction=100)``; both tiers come from ``DeviceTierIndex.from_arrays``
on the same SQ4 codes, bfloat16 rerank rows and hierarchy, one with the
base layer cut to 32 columns and one padded to 64.  Prints one JSON line:
each tier's ``hbm_bytes``, recall@10 at beams 20 and 100 over the first
1024 queries (the ids must be equal), and QPS at those beams over 65,536
queries in 4096-query waves, timed in turns (plain, padded, padded,
plain; ``--turns`` rounds), with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from jvector_tpu_torch.disk import DeviceTierIndex  # noqa: E402
from jvector_tpu_torch.graph import GraphConfig, build_graph  # noqa: E402
from jvector_tpu_torch.quantization import ScalarQuantization4  # noqa: E402
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

BEAMS = (20, 100)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.phase_env()
    cs.phase_build()
    ds = synthetic_dataset(n=args.n, dim=128, n_queries=cs.N_QUERIES, k=cs.TOP_K, n_clusters=args.n // 500,
                           seed=0, device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    graph, _ = build_graph(base, "euclidean", GraphConfig(max_degree=32, ef_construction=100))
    sq = ScalarQuantization4.compute(base)
    codes = sq.encode(base)
    w2, _ = sq.node_constants(codes)
    nbrs = graph.base.neighbors.cpu().numpy()
    if (nbrs[:, 32:] >= 0).any():
        raise SystemExit("the base layer holds more than 32 neighbors a row")
    padded = np.full((nbrs.shape[0], 64), -1, np.int32)
    padded[:, : nbrs.shape[1]] = nbrs
    upper = [(layer.neighbors.cpu().numpy(), layer.counts.cpu().numpy(), ids.cpu().numpy())
             for layer, ids in zip(graph.layers[1:], graph.level_node_ids)]
    kw = dict(codes_packed=codes.cpu().numpy(), node_const=w2.cpu().numpy(), vectors=ds.base,
              scale=sq.scale.cpu().numpy(), offset=sq.offset.cpu().numpy(), sim="euclidean",
              entry_node=int(graph.entry_node), num_nodes=int(graph.num_nodes), upper_layers=upper, device=dev)
    tiers = {"plain_32": DeviceTierIndex.from_arrays(neighbors=nbrs[:, :32], **kw),
             "padded_64": DeviceTierIndex.from_arrays(neighbors=padded, **kw)}
    queries = torch.as_tensor(ds.queries, device=dev)
    q_gt = queries[: cs.GT_QUERIES]

    def run(tier, qs, beam):
        return tier.search(qs, top_k=cs.TOP_K, beam_width=beam, rerank_k=beam, repack_after=max(8, int(1.6 * beam)))

    out = {"n": args.n, "card": card, "beams": BEAMS}
    ids = {}
    for name, tier in tiers.items():
        ids[name] = {b: run(tier, q_gt, b).ids.cpu().numpy() for b in BEAMS}
        out[name] = {"hbm_bytes": tier.hbm_bytes(), "row_cap": tier.row_cap,
                     "recall": {b: recall_at_k(ids[name][b], ds.ground_truth[: cs.GT_QUERIES], cs.TOP_K)
                                for b in BEAMS}, "qps": {b: [] for b in BEAMS}}
    out["ids_equal"] = all(np.array_equal(ids["plain_32"][b], ids["padded_64"][b]) for b in BEAMS)
    t0 = time.time()
    for _ in range(args.turns):
        for name in ("plain_32", "padded_64", "padded_64", "plain_32"):
            for b in BEAMS:
                out[name]["qps"][b].append(cs._qps(lambda qs, _t=tiers[name], _b=b: run(_t, qs, _b), queries))
    out["timing_seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)
    if not out["ids_equal"]:
        raise SystemExit("the two adjacency widths returned different ids")


if __name__ == "__main__":
    main()
