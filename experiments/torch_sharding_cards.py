"""The port's sharded build and serve with the shards on separate cards
against the same shards laid on one card, in turns, on one host.

    python experiments/torch_sharding_cards.py            # needs 4 visible cards
    python experiments/torch_sharding_cards.py --n 20000  # a short run

``chip_smoke.py`` uses one card, so its ``sharding`` phase lays four
shards on ``cuda:0``; this script measures what only separate cards show:
the peer copies of the merge and how far one Python thread issuing every
shard's launches lets the cards overlap.  The corpus is the phase's
(``synthetic_dataset(n, 128, n_queries=4096, k=10, n_clusters=max(64, n //
500), seed=0)``), ``sharded_build`` at ``GraphConfig(max_degree=32,
ef_construction=100)`` over ``make_mesh(4)`` (four cards) and over
``["cuda:0"] * 4``, in the order one, four, four, one; each build's
seconds, K1 / K2 launches, recall@10 at beam 100 over 1024 queries, QPS
at beam 100 over 65,536 queries in 4096-query waves, peak memory per
card.  Both layouts must give equal tables and equal ids (the same
arithmetic on the same card model), or the script fails; then
``entry.dryrun_multichip(4)`` on the four cards.  One JSON line a run,
then the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jvector_tpu_torch import entry  # noqa: E402
from jvector_tpu_torch.bench.diagnostics import device_memory_stats  # noqa: E402
from jvector_tpu_torch.graph import GraphConfig  # noqa: E402
from jvector_tpu_torch.ops.kernels import fused_update_inplace, packed_adj_update_inplace  # noqa: E402
from jvector_tpu_torch.parallel import make_mesh, sharded_build, sharded_graph_search  # noqa: E402
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

SHARDS, WAVE, GT_QUERIES, MIN_TIMED = 4, 4096, 1024, 65_536


def _run(layout: str, ds, queries: torch.Tensor) -> tuple[dict, list]:
    mesh = make_mesh(SHARDS, "shard") if layout == "cards" else make_mesh(devices=["cuda:0"] * SHARDS)
    for d in set(mesh.devices):
        torch.cuda.reset_peak_memory_stats(d)
    before = packed_adj_update_inplace.launches, fused_update_inplace.launches
    t0 = time.time()
    idx = sharded_build(ds.base, mesh, GraphConfig(max_degree=32, ef_construction=100))
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    build_s = time.time() - t0
    kw = dict(top_k=10, beam_width=100, rerank_k=100)
    ids, _ = sharded_graph_search(idx, queries[:GT_QUERIES], mesh, **kw)
    waves = [queries[i : i + WAVE] for i in range(0, queries.shape[0], WAVE)]
    timed = waves * max(1, -(-MIN_TIMED // queries.shape[0]))
    sharded_graph_search(idx, waves[0], mesh, **kw)  # warm-up
    t0 = time.time()
    for wv in timed:
        out, _ = sharded_graph_search(idx, wv, mesh, **kw)
    out.cpu()
    qps = len(timed) * WAVE / (time.time() - t0)
    tables = [g.base.neighbors.cpu() for g in idx.graphs]
    row = {"layout": layout, "mesh": [str(d) for d in mesh.devices], "build_seconds": build_s,
           "k1_launches": packed_adj_update_inplace.launches - before[0],
           "k2_launches": fused_update_inplace.launches - before[1],
           "recall_beam_100": recall_at_k(ids.cpu().numpy(), ds.ground_truth[:GT_QUERIES], 10), "qps_beam_100": qps,
           "timed_queries": len(timed) * WAVE,
           "peak_memory": {str(d): device_memory_stats(d)["peak_bytes_in_use"]
                           for d in sorted(set(mesh.devices), key=str)}}
    return row, [tables, ids.cpu()]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=100_000)
    args = p.parse_args()
    if torch.cuda.device_count() < SHARDS:
        raise SystemExit(f"needs {SHARDS} visible cards, {torch.cuda.device_count()} visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    ds = synthetic_dataset(n=args.n, dim=128, n_queries=WAVE, k=10, n_clusters=max(64, args.n // 500), seed=0)
    queries = torch.as_tensor(ds.queries, device="cuda:0")
    results = {}
    for layout in ("one_card", "cards", "cards", "one_card"):
        row, res = _run(layout, ds, queries)
        print(json.dumps(row), flush=True)
        results.setdefault(layout, res)
    (t1, i1), (t4, i4) = results["one_card"], results["cards"]
    same = all(torch.equal(a, b) for a, b in zip(t1, t4)) and torch.equal(i1, i4)
    print(json.dumps({"tables_and_ids_equal": same}), flush=True)
    entry.dryrun_multichip(SHARDS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if not same:
        raise SystemExit("the four-card layout's tables or ids differ from the one-card layout's")


if __name__ == "__main__":
    main()
