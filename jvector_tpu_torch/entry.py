"""Entry points: a one-device search step and a multi-device dry run of the
sharded paths (counterpart of the repository's ``__graft_entry__.py``).

``entry(device)`` returns a search step on the flagship path (a query-wave
beam search over a Vamana graph) with example arguments on ``device``.

``dryrun_multichip(n_devices, devices=None)`` runs the sharded sequence on
a mesh: the sharded build (each shard's wave inserts on its device), the
sharded serve held to the node-sharded brute force, a save -> load ->
re-serve round trip, and the packed-regime sharded build (K1 and K2 once
per shard per wave on a card).  ``devices`` names the mesh's devices
(``["cpu"] * 2``, ``["cuda:0"] * 4``); by default the first ``n_devices``
cards.

    python -m jvector_tpu_torch.entry [--devices cuda:0,cuda:0]
"""

from __future__ import annotations

import argparse
import functools
import tempfile
from typing import Sequence

import numpy as np
import torch

from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, search
from jvector_tpu_torch.graph.index import GraphIndex, GraphLayer
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.parallel import (
    load_sharded,
    make_mesh,
    save_sharded,
    sharded_brute_force,
    sharded_build,
    sharded_graph_search,
)
from jvector_tpu_torch.util.device import resolve_device


def _random_graph(n: int, deg: int, dim: int, device: torch.device, seed: int = 0) -> tuple[GraphIndex, np.ndarray]:
    rng = np.random.default_rng(seed)
    # unique neighbor ids per row via a per-row permutation
    perm = np.argsort(rng.random((n, n)), axis=1)[:, :deg].astype(np.int32)
    vectors = rng.normal(size=(n, dim)).astype(np.float32)
    layer = GraphLayer(
        neighbors=torch.as_tensor(perm, device=device),
        scores=torch.zeros((n, deg), device=device),
        counts=torch.full((n,), deg, dtype=torch.int32, device=device),
    )
    graph = GraphIndex(
        layers=(layer,), level_node_ids=(),
        entry_node=torch.tensor(0, dtype=torch.int32, device=device),
        num_nodes=torch.tensor(n, dtype=torch.int32, device=device),
        deleted=torch.zeros((n,), dtype=torch.bool, device=device),
    )
    return graph, vectors


def entry(device: torch.device | str | None = None):
    """``(fn, example_args)``: a search step and its arguments on ``device``
    (default: the card)."""
    device = resolve_device(device)
    graph, vectors = _random_graph(n=512, deg=16, dim=64, device=device)
    provider = ExactScoreProvider(vectors=torch.as_tensor(vectors, device=device), sim=SimilarityFunction.EUCLIDEAN)
    queries = torch.as_tensor(np.random.default_rng(1).normal(size=(32, 64)).astype(np.float32), device=device)
    fn = functools.partial(search, top_k=10, beam_width=32, max_iters=64)
    return fn, (graph, provider, queries)


def _same_sets(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    for q, (x, y) in enumerate(zip(a.cpu().numpy(), b.cpu().numpy())):
        if set(x.tolist()) != set(y.tolist()):
            raise AssertionError(f"{what} != brute force for query {q}: {sorted(x)} vs {sorted(y)}")


def dryrun_multichip(n_devices: int, devices: Sequence[torch.device | str] | None = None) -> None:
    """Run the sharded sequence on an ``n_devices`` mesh; raises on any
    mismatch."""
    rng = np.random.default_rng(0)
    dim = 16
    n = 48 * n_devices
    vectors = rng.normal(size=(n, dim)).astype(np.float32)
    euclid = SimilarityFunction.EUCLIDEAN

    # --- sharded build (wave inserts shard-local) -------------------------
    mesh = make_mesh(n_devices, "shard", devices=devices)
    cfg = GraphConfig(max_degree=8, ef_construction=16, wave_size=32, max_build_iters=16)
    idx = sharded_build(vectors, mesh, cfg, euclid)
    if idx.n_shards != n_devices:
        raise AssertionError(f"{idx.n_shards} shards on a mesh of {n_devices}")

    # --- sharded serve: shard-local beam + merge --------------------------
    # beam 32 over 48-node shards is near-exhaustive, so the merged result
    # must equal brute force (the full top-k as a set)
    queries = rng.normal(size=(8, dim)).astype(np.float32)
    gids, _ = sharded_graph_search(idx, queries, mesh, top_k=4, beam_width=32)
    if tuple(gids.shape) != (8, 4) or int(gids.max()) >= n:
        raise AssertionError(f"sharded serve gave ids {tuple(gids.shape)}, max {int(gids.max())} of {n}")

    # --- node-sharded brute force (per-shard top-k + merge) ---------------
    mesh_n = make_mesh(n_devices, "nodes", devices=devices)
    _, bids = sharded_brute_force(queries, vectors, mesh_n, k=4, sim=euclid)
    _same_sets(gids, bids, "sharded search")

    # --- sharded persistence round trip: save -> load -> re-serve ---------
    with tempfile.TemporaryDirectory() as td:
        save_sharded(idx, td)
        gids2, _ = sharded_graph_search(load_sharded(td, mesh), queries, mesh, top_k=4, beam_width=32)
    _same_sets(gids2, bids, "reloaded sharded serve")

    # --- packed-adjacency sharded build (the per-shard regime at scale) ---
    # dim 32 / M=8 / wave 256 aligns the fused rows, so sharded_build runs
    # the packed wave loop (search / compute / in-place apply) per shard
    cfg_p = GraphConfig(max_degree=8, ef_construction=32, wave_size=256)
    n_p = 512 * n_devices
    vec_p = rng.normal(size=(n_p, 32)).astype(np.float32)
    idx_p = sharded_build(vec_p, mesh, cfg_p, euclid)
    if idx_p.search_providers is None or idx_p.search_providers[0].fused_w2.dtype != torch.int32:
        raise AssertionError("the packed sharded build left no packed w2 table")
    qp = rng.normal(size=(8, 32)).astype(np.float32)
    gp, _ = sharded_graph_search(idx_p, qp, mesh, top_k=4, beam_width=32, rerank_k=32)
    if tuple(gp.shape) != (8, 4) or int(gp.max()) >= n_p:
        raise AssertionError(f"packed sharded serve gave ids {tuple(gp.shape)}, max {int(gp.max())} of {n_p}")
    # 512-node shards at beam 32 are not exhaustive: high overlap, not equality
    _, bi_p = sharded_brute_force(qp, vec_p, mesh_n, k=4, sim=euclid)
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(gp.cpu().numpy(), bi_p.cpu().numpy()))
    if hits < 0.8 * 8 * 4:
        raise AssertionError(f"packed sharded recall too low: {hits}/32")
    print(f"dryrun_multichip({n_devices}): OK")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", default=None, help="comma-separated mesh devices (default: every visible card)")
    args = p.parse_args()
    devices = args.devices.split(",") if args.devices else None
    fn, fargs = entry(devices[0] if devices else None)
    print("entry OK:", tuple(fn(*fargs).ids.shape))
    dryrun_multichip(len(devices) if devices else torch.cuda.device_count(), devices)


if __name__ == "__main__":
    main()
