"""How far recall can tell the FreshDiskANN splice from a splice that only
drops edges into deleted nodes (the port, on the CPU, at a small size).

    python experiments/torch_splice_drop_only_cpu.py [--n 4000]

``synthetic_dataset(n, 64, n_queries=512, n_clusters=max(8, n // 500),
seed=0)`` is built with ``GraphConfig(max_degree=32, ef_construction=100)``
(exact scores); a tenth of the nodes (``default_rng(11)``) is marked
deleted; then (a) ``remove_deleted`` and (b) the same graph with every edge
into a deleted node removed, each row's live edges kept in order, deleted
rows emptied, and the splice's entry and upper levels.  Prints recall@10
against the exact top-10 of the live nodes at several beams for the
tombstoned graph and both splices, and their average degrees.
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

from jvector_tpu_torch.graph import GraphConfig, build_graph, search  # noqa: E402
from jvector_tpu_torch.graph.index import NEG_INF  # noqa: E402
from jvector_tpu_torch.graph.mutation import mark_deleted, remove_deleted  # noqa: E402
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

BEAMS = (10, 16, 20, 40, 100)


def drop_only(tomb, spliced, live: np.ndarray):
    """``tomb``'s base layer with the edges into deleted nodes removed (no
    2-hop repair), on ``spliced``'s entry and upper levels."""
    nb, sc = tomb.base.neighbors, tomb.base.scores
    dead = torch.zeros(nb.shape[0], dtype=torch.bool)
    dead[: len(live)] = torch.as_tensor(~live)
    bad = (nb >= 0) & dead[nb.clamp(min=0).long()]
    nb, sc = torch.where(bad, -1, nb), torch.where(bad, NEG_INF, sc)
    order = torch.argsort((nb < 0).to(torch.int8), dim=1, stable=True)
    nb, sc = torch.gather(nb, 1, order), torch.gather(sc, 1, order)
    nb[dead] = -1
    sc[dead] = NEG_INF
    layer = spliced.base._replace(neighbors=nb, scores=sc, counts=(nb >= 0).sum(1).to(torch.int32))
    return spliced._replace(layers=(layer,) + tuple(spliced.layers[1:]))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=4000)
    args = p.parse_args()
    n = args.n
    ds = synthetic_dataset(n=n, dim=64, n_queries=512, k=10, n_clusters=max(8, n // 500), seed=0, device="cpu")
    cfg = GraphConfig(max_degree=32, ef_construction=100)
    t0 = time.time()
    graph, exact = build_graph(torch.as_tensor(ds.base), "euclidean", cfg, device="cpu")
    deleted = np.sort(np.random.default_rng(11).choice(n, n // 10, replace=False))
    live = np.ones(n, bool)
    live[deleted] = False
    d2 = ((ds.queries[:, None, :] - ds.base[None]) ** 2).sum(-1)
    d2[:, ~live] = np.inf
    gt_live = np.argsort(d2, axis=1)[:, :10]
    tomb = mark_deleted(graph, deleted)
    spliced = remove_deleted(tomb, exact, cfg)
    graphs = {"tombstoned": tomb, "splice": spliced, "drop_only": drop_only(tomb, spliced, live)}
    q = torch.as_tensor(ds.queries)
    recall = {b: {name: recall_at_k(search(g, exact, q, top_k=10, beam_width=b).ids.numpy(), gt_live, 10)
                  for name, g in graphs.items()} for b in BEAMS}
    degree = {name: float(g.base.counts[: n][torch.as_tensor(live)].float().mean()) for name, g in graphs.items()}
    print(json.dumps({"n": n, "deleted": len(deleted), "recall": recall, "live_average_degree": degree,
                      "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()
