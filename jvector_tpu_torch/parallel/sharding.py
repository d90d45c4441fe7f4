"""A mesh of torch devices, query-parallel search and node-sharded scoring
(counterpart of ``jvector_tpu/parallel/sharding.py``).

The JAX package is single-controller: one process drives a
``jax.sharding.Mesh``, ``shard_map`` runs each shard's program on its
device and ``all_gather`` + ``top_k`` merges.  Here one process drives a
:class:`Mesh`, a tuple of ``torch.device``:

- shard-local work is the port's ordinary functions run on each shard's
  tensors on that shard's device;
- the merge is the all-gather: each shard's top-k moves to
  ``mesh.devices[0]`` (a peer copy between cards), the shards' lists are
  concatenated in shard order and a stable top-k picks, so among equal
  scores the lowest index in shard-major order wins, as ``lax.top_k``.

Several shards may share one device when the caller names it more than
once (``make_mesh(devices=["cuda:0"] * 4)``), the counterpart of XLA's
virtual CPU devices; it is never done silently.  One Python thread issues
every shard's launches, so on a multi-card host the cards overlap only
where no shard's loop waits on a read.  The ``axis`` / ``axis_name``
arguments keep the JAX package's signatures; a mesh has one axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from jvector_tpu_torch.graph.searcher import SearchResult, _top_k_stable, search
from jvector_tpu_torch.ops.similarity import SimilarityFunction, pairwise_scores
from jvector_tpu_torch.util.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a one-axis mesh, shard ``s`` on ``devices[s]``."""

    devices: tuple[torch.device, ...]
    axis_name: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d: torch.device | str) -> torch.device:
    """``d`` resolved, with a bare ``cuda`` pinned to the current card so
    that device comparisons hold."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: int | None = None,
    axis_name: str = "dp",
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` visible cards (all of them when
    None), or over ``devices`` as named (``["cpu"] * 8``, ``["cuda:0"] *
    4``: several shards on one device).  Raises when fewer cards are visible
    than asked for, or when no card is present and no devices are named."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if n_devices is not None:
            if len(devs) < n_devices:
                raise ValueError(f"a mesh of {n_devices} devices needs as many, got {len(devs)}")
            devs = devs[:n_devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        return Mesh(devs, axis_name)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for a mesh; name the devices (devices=['cpu'] * n) to run on the CPU")
    visible = torch.cuda.device_count()
    n = n_devices or visible
    if n > visible:
        raise ValueError(f"a mesh of {n} devices needs {n} visible cards, {visible} visible")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis_name)


def _to(obj, dev: torch.device):
    """``obj`` with every tensor in it on ``dev`` (tensors already there are
    shared, not copied): tensors, tuples and named tuples, lists, frozen
    dataclasses; anything else as is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(x, dev) for x in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(x, dev) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _to(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def replicate(tree, mesh: Mesh) -> list:
    """One copy of ``tree`` per shard, on that shard's device (shards on one
    device share one copy)."""
    by_dev = {}
    return [by_dev.setdefault(d, _to(tree, d)) for d in mesh.devices]


def shard_queries(queries: torch.Tensor | np.ndarray, mesh: Mesh, axis_name: str = "dp") -> list[torch.Tensor]:
    """The query wave split into ``mesh.size`` equal blocks, block ``s`` on
    ``mesh.devices[s]``; the query count must divide by the mesh size."""
    q = queries.shape[0]
    if q % mesh.size:
        raise ValueError(f"{q} queries do not split over a mesh of {mesh.size} devices")
    b = q // mesh.size
    return [torch.as_tensor(queries[s * b : (s + 1) * b], dtype=torch.float32, device=d)
            for s, d in enumerate(mesh.devices)]


def _gather(parts: Sequence[torch.Tensor], dev: torch.device, dim: int) -> torch.Tensor:
    """The all-gather: every shard's block on ``dev``, in shard order."""
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def sharded_search(
    graph,
    provider,
    queries: torch.Tensor | np.ndarray,
    mesh: Mesh,
    top_k: int,
    beam_width: int | None = None,
    rerank_k: int | None = None,
    reranker=None,
    axis_name: str = "dp",
) -> SearchResult:
    """Data-parallel wave search: the queries split over the mesh, the
    graph and providers replicated; the result on ``mesh.devices[0]``.

    The query count must be divisible by the mesh size.
    """
    blocks = shard_queries(queries, mesh, axis_name)
    graphs, providers, rerankers = (replicate(x, mesh) for x in (graph, provider, reranker))
    parts = [
        search(g, p, q, top_k=top_k, beam_width=beam_width, rerank_k=rerank_k, reranker=r)
        for g, p, r, q in zip(graphs, providers, rerankers, blocks)
    ]
    return SearchResult(*(_gather(fields, mesh.devices[0], 0) for fields in zip(*parts)))


def sharded_brute_force(
    queries: torch.Tensor | np.ndarray,
    base: torch.Tensor | np.ndarray,
    mesh: Mesh,
    k: int,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    axis_name: str = "nodes",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Node-sharded exact top-k: ``base`` split by ordinal over the mesh,
    each shard scores and keeps its top-k, and the merge picks the global
    top-k.  Returns ``(scores, ids)`` ``[Q, k]`` on ``mesh.devices[0]``.

    Pad rows are masked to -inf by global id before each shard's top-k
    (a zero row's score is arbitrary: under dot product it can beat every
    real row); slots beyond ``n`` (``k > n``) report id -1.
    """
    sim = SimilarityFunction.parse(sim)
    n = base.shape[0]
    n_local = -(-n // mesh.size)
    scores, ids = [], []
    qs = replicate(torch.as_tensor(queries, dtype=torch.float32), mesh)
    for s, (dev, q) in enumerate(zip(mesh.devices, qs)):
        rows = torch.as_tensor(base[s * n_local : min((s + 1) * n_local, n)], dtype=torch.float32, device=dev)
        sc = pairwise_scores(q, rows, sim)  # [Q, rows]
        # the pad rows of the last shards: -inf, as the masked zero rows
        sc = torch.nn.functional.pad(sc, (0, n_local - rows.shape[0]), value=float("-inf"))
        kk = min(k, n_local)
        top, idx = _top_k_stable(sc, kk)
        gid = (idx + s * n_local).to(torch.int32)
        if kk < k:
            top = torch.nn.functional.pad(top, (0, k - kk), value=float("-inf"))
            gid = torch.nn.functional.pad(gid, (0, k - kk), value=n)
        scores.append(top)
        ids.append(gid)
    dev0 = mesh.devices[0]
    top, pick = _top_k_stable(_gather(scores, dev0, 1), k)
    gid = torch.gather(_gather(ids, dev0, 1), 1, pick)
    return top, torch.where(gid < n, gid, -1)
