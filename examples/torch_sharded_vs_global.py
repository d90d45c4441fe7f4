"""Sharded-vs-global quality on the PyTorch/CUDA port (the counterpart of
``examples/sharded_vs_global.py``).

Disjoint per-shard subgraphs against one global graph, compared at an equal
expansion budget per query: a sharded search with per-shard beam ``b`` over
S = 8 shards expands about as many candidates as a global search with beam
``S*b``, so those are the fair pairs.  The 8 shards lie on a mesh of the
visible cards taken in turn (``["cuda:0"] * 8`` on one card), or of
``["cpu"] * 8`` on the CPU.  Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_sharded_vs_global.py [--device cpu]
"""

import argparse
import time

import torch

from jvector_tpu_torch.graph import GraphConfig, build_graph, search
from jvector_tpu_torch.parallel import make_mesh, sharded_build, sharded_graph_search
from jvector_tpu_torch.util.datasets import exact_ground_truth, recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device

SHARDS = 8


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(n=32_768, dim=64, nq=256, k=10, device=None):
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [f"cuda:{i % torch.cuda.device_count()}" for i in range(SHARDS)]
    else:
        devices = ["cpu"] * SHARDS
    ds = synthetic_dataset(n=n, dim=dim, n_queries=nq, k=k, n_clusters=max(64, n // 500), seed=0, device=dev)
    gt = exact_ground_truth(ds.base, ds.queries, k, device=dev)
    cfg = GraphConfig(max_degree=16, ef_construction=60, wave_size=256)
    q = torch.as_tensor(ds.queries, device=dev)

    t0 = time.time()
    graph, prov = build_graph(ds.base, "euclidean", cfg, device=dev)
    _sync(dev)
    t_global = time.time() - t0

    mesh = make_mesh(SHARDS, "shard", devices=devices)
    t0 = time.time()
    idx = sharded_build(ds.base, mesh, cfg, "euclidean")
    _sync(dev)
    t_shard = time.time() - t0

    print(f"devices={SHARDS} n={n} d={dim}")
    print(f"build: global {t_global:.1f}s  sharded {t_shard:.1f}s")
    print(f"{'budget':>8} {'global beam':>12} {'r_global':>9} {'shard beam':>11} {'r_sharded':>10}")
    rows = []
    for b in (2, 4, 8, 16):
        gbeam = b * SHARDS
        r_g = recall_at_k(search(graph, prov, q, top_k=k, beam_width=gbeam).ids.cpu().numpy(), gt, k)
        gids, _ = sharded_graph_search(idx, q, mesh, top_k=k, beam_width=max(b, k))
        r_s = recall_at_k(gids.cpu().numpy(), gt, k)
        print(f"{gbeam:>8} {gbeam:>12} {r_g:>9.4f} {max(b, k):>11} {r_s:>10.4f}")
        rows.append({"budget": gbeam, "global_beam": gbeam, "r_global": r_g, "shard_beam": max(b, k),
                     "r_sharded": r_s})
    return {"build_global_s": t_global, "build_sharded_s": t_shard, "rows": rows}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
