"""Device-resident serving tier (counterpart of
``jvector_tpu/disk/device_tier.py``).

The host tier (:mod:`jvector_tpu_torch.disk.host_graph`) bounds device
memory by streaming rows from host memory every step.  This tier is the
other end of the trade: the index's compact arrays stay resident on the
card and a search never touches the host:

- the base layer's adjacency, plain ``int32 [N, R]`` (the JAX package
  pairs two nodes a row and pads R to 64 slots, a TPU lane layout; on the
  card that would double the bytes and the slots every expansion gathers,
  so any L0 layout of the file, the v3 paired one too, is read into the
  plain table once at load);
- SQ4 code rows with the per-node constant, ``uint8 [N, MP+4]`` (one
  gather per scored candidate, no fused tables);
- the rerank vectors, ``bfloat16 [N, D]`` (float32 on request);
- the hierarchy's upper levels.

Reference parity: the memory / disk split of ``OnDiskGraphIndex``
(``OnDiskGraphIndex.java:132-162``: upper layers and hot state in memory).
The fused SQ4 table (``R * MP`` bytes a node) is not loaded: scoring
gathers one code row per candidate instead of one fused row per expansion.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.disk.format import IndexFileReader, _read_l0_neighbors
from jvector_tpu_torch.graph.index import NEG_INF, GraphIndex, GraphLayer
from jvector_tpu_torch.graph.score import ExactScoreProvider, SQ4ScoreProvider
from jvector_tpu_torch.graph.searcher import SearchResult, _descend_hierarchy, _repack_tail, search_layer
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.util.device import resolve_device


def sq4_aug_rows_host(codes_packed: np.ndarray, const: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`jvector_tpu_torch.graph.score.sq4_aug_rows`."""
    cb = np.ascontiguousarray(const, np.float32).view(np.uint8).reshape(-1, 4)
    return np.concatenate([np.ascontiguousarray(codes_packed, np.uint8), cb], axis=1)


@dataclasses.dataclass(frozen=True)
class DeviceTierIndex:
    """A serving index held whole on the card (see the module docstring)."""

    neighbors: torch.Tensor  # int32 [N_cap, R], -1 padded
    provider: SQ4ScoreProvider  # code rows with constants, no fused tables
    reranker: ExactScoreProvider  # bfloat16 / float32 vectors
    upper: GraphIndex | None  # the hierarchy's levels (dummy base layer) or None
    entry_node: torch.Tensor  # int32 scalar
    num_nodes: torch.Tensor  # int32 scalar
    deleted: torch.Tensor  # bool [N_cap]
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    @property
    def capacity(self) -> int:
        return self.neighbors.shape[0]

    @property
    def row_cap(self) -> int:
        return self.neighbors.shape[1]

    def hbm_bytes(self) -> int:
        """Resident device bytes (reference ``Accountable.ramBytesUsed``)."""
        tensors = [self.neighbors, self.entry_node, self.num_nodes, self.deleted, self.reranker.vectors]
        fields = (getattr(self.provider, f.name) for f in dataclasses.fields(self.provider))
        tensors += [t for t in fields if isinstance(t, torch.Tensor)]
        if self.upper is not None:
            tensors += [t for layer in self.upper.layers for t in layer] + list(self.upper.level_node_ids)
            tensors += [self.upper.entry_node, self.upper.num_nodes, self.upper.deleted]
        seen, total = set(), 0
        for t in tensors:
            if id(t) not in seen:  # the provider shares one constant table twice
                seen.add(id(t))
                total += t.numel() * t.element_size()
        return total

    @classmethod
    def from_arrays(
        cls,
        neighbors: np.ndarray,  # [N_cap, R] int32, -1 padded (host)
        codes_packed: np.ndarray,  # [N_cap, MP] uint8 (host)
        node_const: np.ndarray,  # [N_cap] float32: w2 (euclidean / dot) or norm2 (cosine)
        vectors: np.ndarray,  # [N, D] rerank rows (host)
        scale: np.ndarray,
        offset: np.ndarray,
        sim,
        entry_node: int,
        num_nodes: int,
        upper_layers: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = (),
        # [(neighbors, counts, node_ids)] for levels 1..L-1, in slot space
        deleted: np.ndarray | None = None,
        rerank_dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
    ) -> "DeviceTierIndex":
        dev = resolve_device(device)
        sim = SimilarityFunction.parse(sim)
        n_cap = neighbors.shape[0]

        def padded(arr: np.ndarray, dtype) -> np.ndarray:
            out = np.zeros((n_cap,) + arr.shape[1:], dtype)
            k = min(arr.shape[0], n_cap)
            out[:k] = arr[:k]
            return out

        const = padded(np.asarray(node_const, np.float32), np.float32)
        codes = padded(np.asarray(codes_packed, np.uint8), np.uint8)
        const_dev = torch.as_tensor(const, device=dev)
        provider = SQ4ScoreProvider(
            codes_packed=None,
            node_w2=const_dev,
            node_norm2=const_dev,
            fused_packed=torch.zeros((1, 0), dtype=torch.uint8, device=dev),
            fused_w2=torch.zeros((1, 0), dtype=torch.float32, device=dev),
            scale=torch.as_tensor(np.array(scale, np.float32), device=dev),
            offset=torch.as_tensor(np.array(offset, np.float32), device=dev),
            codes_aug=torch.as_tensor(sq4_aug_rows_host(codes, const), device=dev),
            sim=sim,
        )
        vec = torch.as_tensor(padded(np.asarray(vectors, np.float32), np.float32), device=dev)
        reranker = ExactScoreProvider(vectors=vec.to(rerank_dtype), sim=sim)
        dead = np.zeros(n_cap, bool) if deleted is None else padded(np.asarray(deleted, bool), bool)
        del_dev = torch.as_tensor(dead, device=dev)
        entry = torch.tensor(int(entry_node), dtype=torch.int32, device=dev)
        num = torch.tensor(int(num_nodes), dtype=torch.int32, device=dev)

        upper = None
        if upper_layers:
            # the real upper levels over an 8-row dummy base: the descent
            # seeds from the top level and walks down to level 1, never
            # reading layer 0, but a GraphIndex counts levels by its layers
            layers = [GraphLayer(
                neighbors=torch.full((8, 8), -1, dtype=torch.int32, device=dev),
                scores=torch.full((8, 8), NEG_INF, device=dev),
                counts=torch.zeros((8,), dtype=torch.int32, device=dev),
            )]
            level_ids = []
            for nbrs_l, counts_l, ids_l in upper_layers:
                ids_np = np.asarray(ids_l)
                if not np.all(np.diff(ids_np) > 0):
                    raise ValueError("level node ids must be sorted ascending")
                nbrs_d = torch.as_tensor(np.array(nbrs_l, np.int32), device=dev)
                layers.append(GraphLayer(
                    neighbors=nbrs_d,
                    scores=torch.where(nbrs_d >= 0, 0.0, NEG_INF),
                    counts=torch.as_tensor(np.array(counts_l, np.int32), device=dev),
                ))
                level_ids.append(torch.as_tensor(ids_np.astype(np.int32), device=dev))
            upper = GraphIndex(layers=tuple(layers), level_node_ids=tuple(level_ids), entry_node=entry,
                               num_nodes=num, deleted=del_dev)

        return cls(
            neighbors=torch.as_tensor(np.array(neighbors, np.int32), device=dev),
            provider=provider,
            reranker=reranker,
            upper=upper,
            entry_node=entry,
            num_nodes=num,
            deleted=del_dev,
            sim=sim,
        )

    @classmethod
    def load(
        cls,
        path: str,
        use_hierarchy: bool = True,
        rerank_dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
    ) -> "DeviceTierIndex":
        """Load a saved container's compact arrays onto ``device`` (default:
        the card): the L0 adjacency in any layout (plain, renumbered or v3
        paired, each read as the plain ``[N, R]`` table), the SQ4 codes and
        constants, the inline vectors for the rerank, the hierarchy.  A
        fused table in the file is not read.  Containers without ``fused_sq4`` codes are refused."""
        r = IndexFileReader(path)
        meta = r.meta
        f = "feature/fused_sq4"
        if not r.has_array(f"{f}/codes_packed"):
            raise ValueError(
                f"{path}: no fused_sq4 codes; the device tier serves SQ4-compressed containers "
                f"(features present: {meta.get('features')})"
            )
        upper = []
        if use_hierarchy:
            for lv in range(1, meta.get("num_levels", 1)):
                upper.append(tuple(r.read(f"graph/L{lv}/{a}") for a in ("neighbors", "counts", "node_ids")))
        return cls.from_arrays(
            neighbors=_read_l0_neighbors(r),
            codes_packed=r.read(f"{f}/codes_packed"),
            node_const=r.read(f"{f}/node_const"),
            vectors=r.read("feature/inline_vectors/vectors"),
            scale=r.read(f"{f}/scale"),
            offset=r.read(f"{f}/offset"),
            sim=meta.get("similarity", "euclidean"),
            entry_node=meta["entry_node"],
            num_nodes=meta["num_nodes"],
            upper_layers=upper,
            deleted=r.read("graph/deleted") if r.has_array("graph/deleted") else None,
            rerank_dtype=rerank_dtype,
            device=device,
        )

    def search(
        self,
        queries,  # [Q, D]
        top_k: int,
        beam_width: int | None = None,
        rerank_k: int | None = None,
        expand_per_iter: int = 1,
        entry_seeds: int = 1,
        hierarchy_beam: int = 1,
        max_iters: int = 1000,
        repack_after: int = 0,
    ) -> SearchResult:
        """Two-pass wave search on the card (the contract of
        :func:`jvector_tpu_torch.graph.search` without its filtered and
        threshold modes, which serve through the other tiers).
        ``repack_after`` finishes the wave's convergence tail at quarter
        width (see :func:`jvector_tpu_torch.graph.searcher._repack_tail`)."""
        if beam_width is None:
            beam_width = max(top_k, 100)
        if rerank_k is None:
            rerank_k = beam_width
        queries = torch.as_tensor(queries, device=self.neighbors.device)
        return _device_search(self, queries, top_k, beam_width, rerank_k, expand_per_iter, entry_seeds,
                              hierarchy_beam, max_iters, repack_after)


def _device_search(
    idx: DeviceTierIndex,
    queries: torch.Tensor,
    top_k: int,
    beam_width: int,
    rerank_k: int,
    expand_per_iter: int,
    entry_seeds: int,
    hierarchy_beam: int,
    max_iters: int,
    repack_after: int = 0,
) -> SearchResult:
    provider = idx.provider
    qstate = provider.prepare(queries)
    q = queries.shape[0]
    if idx.upper is not None:
        entries = _descend_hierarchy(idx.upper, provider, qstate, q, hierarchy_beam)[:, None]
    else:
        entries = idx.entry_node.to(torch.int32).expand(q)[:, None]
    if entry_seeds > 1:
        # ordinal-strided extra seeds
        entry_seeds = min(entry_seeds, beam_width)
        s = torch.arange(1, entry_seeds, dtype=torch.int32, device=queries.device)
        strided = (s * torch.div(idx.num_nodes, entry_seeds, rounding_mode="floor")).to(torch.int32)
        entries = torch.cat([entries, strided[None].expand(q, -1)], dim=1)

    repack = 0 < repack_after < max_iters and q >= 64
    kw = dict(beam_width=beam_width, expand_per_iter=expand_per_iter)
    final = search_layer(idx.neighbors, provider, qstate, entries,
                         max_iters=repack_after if repack else max_iters, **kw)
    if repack:
        final = _repack_tail(idx.neighbors, provider, qstate, final, max_iters=max_iters, **kw)

    cand_ids = final.ids[:, :rerank_k]
    cand_scores = final.scores[:, :rerank_k]
    safe = torch.clamp(cand_ids, min=0)
    ok = (cand_ids >= 0) & ~idx.deleted[safe.long()]
    exact = torch.where(ok, idx.reranker.score(idx.reranker.prepare(queries), safe), NEG_INF)
    order = torch.argsort(-exact, dim=1, stable=True)
    return SearchResult(
        ids=torch.gather(torch.where(ok, cand_ids, -1), 1, order)[:, :top_k],
        scores=torch.gather(exact, 1, order)[:, :top_k],
        visited_count=final.visited_count,
        expanded_count=final.expanded_count,
        reranked_count=ok.sum(dim=1, dtype=torch.int32),
        approx_scores=torch.gather(cand_scores, 1, order)[:, :top_k],
    )
