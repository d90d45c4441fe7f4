"""Bounded-memory graph serving: adjacency and codes stay on the host
(counterpart of ``jvector_tpu/disk/host_graph.py``).

Reference: ``OnDiskGraphIndex.View`` reads each expanded node's record
(adjacency + fused codes) from storage with O(beam) memory.  Here the big
arrays (``neighbors [N, R]``, ``fused_packed [N, R*MP]``, ``fused_w2 [N, R]``)
are memmaps of the index file; the device holds only the wave's beam state
and one streamed expansion.  Each iteration:

1. a device step merges the previously streamed rows into the beam (the
   in-memory searcher's exact dedup and merge) and pops the next ``E``
   candidates per query;
2. the host gathers the popped rows out of the memmaps (one contiguous row
   per expansion) and ships them to the device.

``pipeline`` splits the wave into lanes: while one lane's step runs on the
card, the host gathers the other lane's rows (pinned buffers, an event per
lane).  The full-precision rerank (:mod:`jvector_tpu_torch.disk.host_tier`)
composes on top.  Hierarchical indexes keep their small upper levels and
those levels' codes on the device and descend there; only the base layer
streams.

``accept`` runs the in-loop filtered search of the in-memory searcher: the
beam traverses accepted and other nodes alike, accepted discoveries gather
in a top-K channel, popped slots leave the beam, and a per-query bitset of
popped nodes on the host keeps a purged node from coming back.  A small
accepted set is scored exactly instead (``accept_brute_cutoff``).
``threshold`` drops results below the similarity.

:class:`ShardedHostIndex` serves a sharded directory: each shard a
``HostGraphIndex``, the per-shard top-k merged by score.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from jvector_tpu_torch.disk.format import FeatureId, _read_l0_neighbors, load_index, write_index
from jvector_tpu_torch.disk.host_tier import HostVectorStore
from jvector_tpu_torch.graph.hierarchy import slots_for
from jvector_tpu_torch.graph.index import NEG_INF
from jvector_tpu_torch.graph.diversity import dedup_sorted_desc
from jvector_tpu_torch.graph.searcher import (
    BeamState,
    SearchResult,
    _history_len,
    _merge_beam,
    _top_e,
    _top_k_stable,
    search_layer,
)
from jvector_tpu_torch.ops.kernels.frontier import frontier_filter
from jvector_tpu_torch.ops.similarity import SimilarityFunction, normalize_score
from jvector_tpu_torch.quantization.sq import group_dims, unpack_nibble_rows_grouped
from jvector_tpu_torch.util.device import resolve_device
from jvector_tpu_torch.util.native import gather_rows


@dataclasses.dataclass(frozen=True)
class SQ4StreamScorer:
    """Query-side SQ4 arithmetic for streamed rows (no device codes)."""

    scale: torch.Tensor  # [D_pad]
    offset: torch.Tensor  # [D_pad]
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN

    def prepare(self, queries: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        q = queries.float()
        dp = self.scale.shape[0]
        if q.shape[-1] < dp:
            q = torch.nn.functional.pad(q, (0, dp - q.shape[-1]))
        if self.sim == SimilarityFunction.EUCLIDEAN:
            qb = q - self.offset
            return group_dims(-2.0 * self.scale * qb), torch.sum(qb * qb, dim=-1)
        if self.sim == SimilarityFunction.COSINE:
            qn = q / torch.clamp(torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True)), min=1e-30)
            return group_dims(qn * self.scale), torch.sum(qn * self.offset, dim=-1)
        return group_dims(q * self.scale), torch.sum(q * self.offset, dim=-1)

    def score_rows(self, qstate, k_packed: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
        """k_packed ``[Q, C, MP]`` uint8, w2 ``[Q, C]`` -> scores ``[Q, C]``."""
        u, c0 = qstate
        k = unpack_nibble_rows_grouped(k_packed).float()
        acc = torch.bmm(k, u.unsqueeze(-1)).squeeze(-1)
        if self.sim == SimilarityFunction.EUCLIDEAN:
            raw = torch.clamp(acc + c0[:, None] + w2, min=0.0)
        elif self.sim == SimilarityFunction.COSINE:
            raw = (acc + c0[:, None]) / torch.clamp(torch.sqrt(w2), min=1e-30)
        else:
            raw = acc + c0[:, None]
        return normalize_score(raw, self.sim)


@dataclasses.dataclass(frozen=True)
class _SlotSQ4Provider:
    """SQ4 scoring over a device-resident slot-indexed code block: the
    upper-level descent's provider (levels address nodes by slot)."""

    codes: torch.Tensor  # [nl, MP] uint8
    w2: torch.Tensor  # [nl] float32
    scorer: SQ4StreamScorer

    def prepare(self, queries: torch.Tensor):
        return self.scorer.prepare(queries)

    def score(self, qstate, slot_ids: torch.Tensor) -> torch.Tensor:
        s = slot_ids.long()
        return self.scorer.score_rows(qstate, self.codes[s], self.w2[s])


def _host_step(
    state: BeamState,  # updated in place where it owns the tensors
    scorer: SQ4StreamScorer,
    qstate,
    sel_prev: torch.Tensor,  # int32 [Q, E] (-1 = inactive)
    nbrs: torch.Tensor,  # int32 [Q, E, R] rows of sel_prev
    k_rows: torch.Tensor,  # uint8 [Q, E, R, MP]
    w2_rows: torch.Tensor,  # float32 [Q, E, R]
    expand: int,
    acc_bits: torch.Tensor | None = None,  # bool [Q, E, R]: filtered search
) -> tuple[BeamState, torch.Tensor]:
    """Merge the streamed expansion, then pop the next E candidates.

    Filtered (``acc_bits``, the accept bits of the streamed neighbors, and
    the state's result channel): accepted discoveries join the channel,
    deduplicated by id (purged nodes may come back past the history ring);
    only candidates that can beat the worst accepted result are popped; and
    popped slots leave the beam."""
    Q, E, R = nbrs.shape
    flat_nbrs = nbrs.reshape(Q, E * R)
    fresh, new_ids, _ = frontier_filter(flat_nbrs, sel_prev >= 0, R, state.ids, state.history)
    scores = scorer.score_rows(qstate, k_rows.reshape(Q, E * R, -1), w2_rows.reshape(Q, E * R))
    res_ids, res_scores = state.res_ids, state.res_scores
    if acc_bits is not None:
        acc = fresh & acc_bits.reshape(Q, E * R)
        k = res_ids.shape[1]
        d_ids, d_sc = dedup_sorted_desc(
            torch.cat([res_ids, torch.where(acc, flat_nbrs, -1)], dim=1),
            torch.cat([res_scores, torch.where(acc, scores, NEG_INF)], dim=1),
        )
        res_ids, res_scores = d_ids[:, :k], d_sc[:, :k]
    ids2, scores2, expanded2 = _merge_beam(
        state.ids, state.scores, state.expanded, new_ids, torch.where(fresh, scores, NEG_INF)
    )
    # pop phase
    poppable = ~expanded2
    if acc_bits is not None:
        poppable &= scores2 > res_scores[:, -1:]
    top_scores, sel_idx = _top_e(torch.where(poppable, scores2, NEG_INF), expand)
    active = top_scores > NEG_INF
    sel_ids = torch.where(active, torch.gather(ids2, 1, sel_idx), -1)
    pos_l = torch.arange(ids2.shape[1], device=ids2.device)
    hit = ((pos_l[None, :, None] == sel_idx[:, None, :]) & active[:, None, :]).any(dim=2)
    history = state.history
    pos = (state.iters * expand) % history.shape[1]
    history[:, pos : pos + expand] = sel_ids
    if acc_bits is not None:  # popped slots leave the frontier
        ids2, scores2, expanded2 = torch.where(hit, -1, ids2), torch.where(hit, NEG_INF, scores2), expanded2 & ~hit
    else:
        expanded2 = expanded2 | hit
    new_state = BeamState(
        ids=ids2,
        scores=scores2,
        expanded=expanded2,
        history=history,
        visited_count=state.visited_count + fresh.sum(dim=1, dtype=torch.int32),
        expanded_count=state.expanded_count + active.sum(dim=1, dtype=torch.int32),
        iters=state.iters + 1,
        res_ids=res_ids,
        res_scores=res_scores,
    )
    return new_state, sel_ids


def _screen_popped(popped: np.ndarray, sel_np: np.ndarray, nbrs_np: np.ndarray, accept: np.ndarray) -> np.ndarray:
    """Filtered host search: mark this round's pops in the per-query popped
    bitset ``[q, N/8]``, drop streamed neighbors already popped (purged from
    the frontier, they must never return), in place, and return the accept
    bits of the rest ``[q, E, R]``."""
    qn = sel_np.shape[0]
    qi = np.repeat(np.arange(qn), sel_np.shape[1])
    pops = sel_np.reshape(-1)
    ok = pops >= 0
    np.bitwise_or.at(popped, (qi[ok], pops[ok] >> 3), np.uint8(1) << (pops[ok] & 7).astype(np.uint8))
    safe = np.maximum(nbrs_np, 0)
    seen = (popped[np.arange(qn)[:, None, None], safe >> 3] >> (safe & 7)) & 1
    nbrs_np[(seen != 0)] = -1
    return accept[np.maximum(nbrs_np, 0)] & (nbrs_np >= 0)


class _Lane:
    """One phase-shifted sub-wave of a host-served search.  On the card its
    popped ids come back through a pinned buffer and an event, and its rows
    go up from pinned buffers, so the host gathers one lane's rows while the
    card runs the other lane's step."""

    def __init__(self, index: "HostGraphIndex", a: int, b: int, expand: int):
        self.a, self.b, self.done = a, b, False
        qn, r = b - a, index.neighbors.shape[1]
        self.shape = (qn, expand, r)
        self.cuda = index.device.type == "cuda"
        if self.cuda:
            pin = dict(pin_memory=True)
            self.sel_host = torch.empty((qn, expand), dtype=torch.int32, **pin)
            self.bufs = (
                torch.empty((qn * expand, r), dtype=torch.int32, **pin),
                torch.empty((qn * expand,) + index.fused_packed.shape[1:], dtype=torch.uint8, **pin),
                torch.empty((qn * expand, r), dtype=torch.float32, **pin),
            )
            self.event = torch.cuda.Event()

    def post(self, sel: torch.Tensor) -> None:
        """Keep the step's popped ids; on the card, start their copy home."""
        self.sel = sel
        if self.cuda:
            self.sel_host.copy_(sel, non_blocking=True)
            self.event.record()

    def fetch(self) -> np.ndarray:
        """The popped ids on the host (waits for this lane's step only)."""
        if self.cuda:
            self.event.synchronize()
            return self.sel_host.numpy()
        return self.sel.numpy()

    def gather(self, index: "HostGraphIndex", safe: np.ndarray, device, screen=None) -> tuple[torch.Tensor, ...]:
        """The expanded nodes' adjacency, fused code and w2 rows, on
        ``device``; ``screen(nbrs [q, E, R])`` may edit the adjacency rows on
        the host before they go up, and its result (the accept bits) goes
        up as a fourth tensor."""
        qn, e, r = self.shape
        srcs = (index.neighbors, index.fused_packed, index.fused_w2)
        outs, extra = [], None
        for i, src in enumerate(srcs):
            rows = gather_rows(src, safe, out=self.bufs[i].numpy() if self.cuda else None)
            if i == 0 and screen is not None:
                extra = torch.as_tensor(screen(rows.reshape(qn, e, r)), device=device)
            outs.append(self.bufs[i].to(device, non_blocking=True) if self.cuda else torch.from_numpy(rows))
        return outs[0].reshape(qn, e, r), outs[1].reshape(qn, e, r, -1), outs[2].reshape(qn, e, r), extra


@dataclasses.dataclass
class HostGraphIndex:
    """SQ4-fused graph whose big arrays live on the host (memmaps); searches
    run on ``device`` (default: the card)."""

    neighbors: np.ndarray  # [N, R] int32
    fused_packed: np.ndarray  # [N, R*MP] uint8
    fused_w2: np.ndarray  # [N, R] float32
    codes_packed: np.ndarray  # [N, MP] uint8 (entry scoring)
    node_const: np.ndarray  # [N] float32 (w2 or norm2 per similarity)
    scale: np.ndarray  # [D_pad]
    offset: np.ndarray  # [D_pad]
    entry_node: int
    sim: SimilarityFunction = SimilarityFunction.EUCLIDEAN
    deleted: np.ndarray | None = None  # [N] bool
    rerank_store: HostVectorStore | None = None  # from the file's inline vectors
    # hierarchy (empty = flat): per level l >= 1 the level's slot-space
    # adjacency and its sorted base ordinals; small, device-resident at the
    # first search (the reference's loadInMemoryLayers split)
    upper_neighbors: tuple = ()
    upper_node_ids: tuple = ()
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._upper_dev = None

    @staticmethod
    def load(path, device: torch.device | str | None = None) -> "HostGraphIndex":
        """Memmap the graph and the fused-SQ4 feature straight off an index file."""
        idx = load_index(path)
        r = idx.reader
        f = f"feature/{FeatureId.FUSED_SQ4}"
        sim = SimilarityFunction.parse(idx.meta.get("similarity", "euclidean"))
        num_levels = int(idx.meta.get("num_levels", 1))
        inline = f"feature/{FeatureId.INLINE_VECTORS}/vectors"
        return HostGraphIndex(
            # version-dispatching read: paired files unpack, plain files stay memmaps
            neighbors=_read_l0_neighbors(r, mmap=True),
            fused_packed=r.read(f"{f}/fused_packed", mmap=True),
            fused_w2=r.read(f"{f}/fused_w2", mmap=True),
            codes_packed=r.read(f"{f}/codes_packed", mmap=True),
            node_const=r.read(f"{f}/node_const", mmap=True),
            scale=np.array(r.read(f"{f}/scale")),
            offset=np.array(r.read(f"{f}/offset")),
            entry_node=int(idx.meta["entry_node"]),
            sim=sim,
            deleted=r.read("graph/deleted", mmap=True) if r.has_array("graph/deleted") else None,
            # inline vectors present -> two-pass serving by default; only
            # [Q, rerank_k] rows of them ever reach the device
            rerank_store=HostVectorStore.from_index_file(r, inline, sim) if r.has_array(inline) else None,
            upper_neighbors=tuple(np.array(r.read(f"graph/L{lv}/neighbors")) for lv in range(1, num_levels)),
            upper_node_ids=tuple(np.array(r.read(f"graph/L{lv}/node_ids")) for lv in range(1, num_levels)),
            device=device,
        )

    def _scorer(self) -> SQ4StreamScorer:
        return SQ4StreamScorer(
            scale=torch.as_tensor(self.scale, device=self.device),
            offset=torch.as_tensor(self.offset, device=self.device),
            sim=self.sim,
        )

    def _upper_device(self) -> list[dict]:
        """The upper levels on the device (adjacency, ids, codes, constants),
        uploaded once."""
        if self._upper_dev is None:
            dev = self.device
            self._upper_dev = []
            for nbrs, ids in zip(self.upper_neighbors, self.upper_node_ids):
                safe = np.minimum(ids, self.codes_packed.shape[0] - 1)
                self._upper_dev.append({
                    "nbrs": torch.as_tensor(nbrs, device=dev),
                    "ids": torch.as_tensor(ids, device=dev),
                    "codes": torch.as_tensor(gather_rows(self.codes_packed, safe), device=dev),
                    "w2": torch.as_tensor(np.ascontiguousarray(self.node_const[safe]), device=dev),
                })
        return self._upper_dev

    def _descend(self, scorer: SQ4StreamScorer, queries: torch.Tensor, hierarchy_beam: int = 1) -> np.ndarray:
        """Descent through the device-resident upper levels -> per-query base
        entries: score every top-level node, then a narrow beam per level."""
        levels = self._upper_device()
        qstate = scorer.prepare(queries)
        q = queries.shape[0]
        top = levels[-1]
        n_top = top["ids"].shape[0]
        sc = scorer.score_rows(qstate, top["codes"][None].expand(q, -1, -1), top["w2"][None].expand(q, n_top))
        if self.deleted is not None:
            dead = torch.as_tensor(np.asarray(self.deleted)[self.upper_node_ids[-1]], device=self.device)
            sc = torch.where(dead[None, :], NEG_INF, sc)
        best = top["ids"][torch.argmax(sc, dim=1)]
        best = torch.where(sc.max(dim=1).values > NEG_INF, best, self.entry_node).to(torch.int32)
        for lv in levels[-2::-1]:
            beam = search_layer(
                lv["nbrs"], _SlotSQ4Provider(codes=lv["codes"], w2=lv["w2"], scorer=scorer), qstate,
                slots_for(lv["ids"], best), beam_width=max(1, hierarchy_beam), max_iters=64,
            )
            best = lv["ids"][torch.clamp(beam.ids[:, 0], 0, lv["ids"].shape[0] - 1).long()]
        return best.cpu().numpy().astype(np.int32)

    def hbm_bytes(self, n_queries: int, beam_width: int, expand: int, pipeline: int = 2) -> int:
        """Device working-set estimate: beam state, one streamed expansion,
        and that expansion's scoring transient, which the JAX package's
        formula leaves out: one lane's candidates unpacked to int32 levels
        and their float32 copy (``SQ4StreamScorer.score_rows``), 8 bytes a
        dimension, 16x the packed rows (the largest allocations at the
        serve's device peak, ``chip_smoke.py``'s ``peak_split``)."""
        q, lw = n_queries, beam_width
        r = self.neighbors.shape[1]
        mp = self.fused_packed.shape[1] // r
        t = 256  # history ring order of magnitude
        lane = -(-q // max(1, min(pipeline, q)))
        return q * lw * (4 + 4 + 1) + q * t * 4 + q * expand * r * (4 + mp + 4) + lane * expand * r * 2 * mp * 8

    def _filtered_brute(self, queries: torch.Tensor, top_k: int, acc_ids: np.ndarray, beam_width: int, rerank,
                        threshold: float) -> SearchResult:
        """Exact evaluation of a small accepted set: one host gather of the
        A accepted code rows, one scoring pass on the device, the optional
        rerank."""
        dev = self.device
        scorer = self._scorer()
        Q = queries.shape[0]
        A = 1 << max(4, int(max(acc_ids.size, top_k) - 1).bit_length())
        ids = np.full(A, -1, np.int32)
        ids[: acc_ids.size] = acc_ids
        safe = np.maximum(ids, 0)
        k_rows = torch.as_tensor(gather_rows(self.codes_packed, safe), device=dev)
        w2 = torch.as_tensor(np.ascontiguousarray(self.node_const[safe]), device=dev)
        sc = scorer.score_rows(scorer.prepare(queries), k_rows[None].expand(Q, -1, -1), w2[None].expand(Q, -1))
        ids_t = torch.as_tensor(ids, device=dev)
        sc = torch.where((ids_t >= 0)[None], sc, NEG_INF)
        k1 = min(max(top_k, beam_width if rerank is not None else top_k), A)
        approx, idx = _top_k_stable(sc, k1)
        pick = torch.where(approx > NEG_INF, torch.gather(ids_t[None].expand(Q, A), 1, idx), -1)
        res = SearchResult(
            ids=pick, scores=approx, visited_count=torch.full((Q,), acc_ids.size, dtype=torch.int32, device=dev),
            expanded_count=torch.zeros((Q,), dtype=torch.int32, device=dev),
            reranked_count=torch.zeros((Q,), dtype=torch.int32, device=dev), approx_scores=approx,
        )
        if rerank is not None:
            return rerank.rerank(queries, res, top_k)
        return res._replace(ids=pick[:, :top_k], scores=approx[:, :top_k], approx_scores=approx[:, :top_k])

    def search(
        self,
        queries,
        top_k: int,
        beam_width: int = 64,
        expand: int = 4,
        max_iters: int = 200,
        rerank=None,  # HostVectorStore | None (default: the file's inline vectors) | False for one pass
        pipeline: int = 2,
        accept: np.ndarray | None = None,  # bool [N] acceptOrds mask
        threshold: float = 0.0,  # drop results scoring below this similarity
        accept_brute_cutoff: int | None = None,
        hierarchy_beam: int = 1,
    ) -> SearchResult:
        """Wave beam search streaming graph rows from the host each step.

        ``pipeline`` splits the wave into that many phase-shifted lanes so
        the host's row gathers overlap the card's steps; ``pipeline=1`` is
        the serial loop.  Results do not depend on it.  With ``accept``,
        at most ``accept_brute_cutoff`` accepted nodes (default ``max(4 *
        beam, 512)``) are scored exactly; more run the in-loop filtered
        search, whose accepted channel holds ``max(top_k, beam)`` results.
        """
        if rerank is None:
            rerank = self.rerank_store
        elif rerank is False:
            rerank = None
        dev = self.device
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        n_rows, R = self.neighbors.shape
        acc_full = None
        if accept is not None:
            acc_full = np.zeros(n_rows, bool)
            a = np.asarray(accept, bool)
            acc_full[: a.shape[0]] = a
            if self.deleted is not None:
                acc_full &= ~np.asarray(self.deleted)
            acc_ids = np.flatnonzero(acc_full)
            cutoff = max(4 * beam_width, 512) if accept_brute_cutoff is None else accept_brute_cutoff
            if acc_ids.size <= cutoff:
                return _apply_threshold(self._filtered_brute(queries, top_k, acc_ids, beam_width, rerank, threshold),
                                        threshold)
        filtered = acc_full is not None
        scorer = self._scorer()
        Q, L = queries.shape[0], beam_width
        T = _history_len(expand, max_iters, 2 * L if filtered else L)
        K = max(top_k, beam_width)  # the filtered result channel's width
        mp = self.fused_packed.shape[1] // R
        n_lanes = max(1, min(pipeline, Q))
        cuts = [Q * i // n_lanes for i in range(n_lanes + 1)]  # balanced contiguous lanes
        if self.upper_node_ids:
            entries_np = self._descend(scorer, queries, hierarchy_beam)
        else:
            entries_np = np.full(Q, self.entry_node, np.int32)

        lanes = []
        for a, b in zip(cuts[:-1], cuts[1:]):
            ln = _Lane(self, a, b, expand)
            qn = b - a
            ln.qstate = scorer.prepare(queries[a:b])
            e_np = entries_np[a:b]
            e_ids = torch.as_tensor(e_np, device=dev)
            e_k = torch.as_tensor(gather_rows(self.codes_packed, e_np), device=dev)
            e_w2 = torch.as_tensor(np.ascontiguousarray(self.node_const[e_np]), device=dev)
            e_score = scorer.score_rows(ln.qstate, e_k[:, None, :], e_w2[:, None])
            ids = torch.full((qn, L), -1, dtype=torch.int32, device=dev)
            ids[:, 0] = e_ids
            scores = torch.full((qn, L), NEG_INF, device=dev)
            scores[:, 0] = e_score[:, 0]
            ln.state = BeamState(
                ids=ids, scores=scores, expanded=torch.zeros((qn, L), dtype=torch.bool, device=dev),
                history=torch.full((qn, T), -1, dtype=torch.int32, device=dev),
                visited_count=torch.ones((qn,), dtype=torch.int32, device=dev),
                expanded_count=torch.zeros((qn,), dtype=torch.int32, device=dev), iters=0,
            )
            acc0 = None
            if filtered:
                # the accepted channel, seeded with each query's entry when it
                # passes; the popped set is exact (N/8 bytes a query): a
                # filtered search runs far past the history ring, and a
                # forgotten pop that re-enters the purged frontier would be
                # popped again and again
                entry_ok = torch.as_tensor(acc_full[e_np], device=dev)
                res_ids = torch.full((qn, K), -1, dtype=torch.int32, device=dev)
                res_ids[:, 0] = torch.where(entry_ok, e_ids, -1)
                res_scores = torch.full((qn, K), NEG_INF, device=dev)
                res_scores[:, 0] = torch.where(entry_ok, e_score[:, 0], NEG_INF)
                ln.state = ln.state._replace(res_ids=res_ids, res_scores=res_scores)
                ln.popped = np.zeros((qn, (n_rows + 7) // 8), np.uint8)
                ln.popped[np.arange(qn), e_np >> 3] |= np.uint8(1) << (e_np & 7).astype(np.uint8)
                acc0 = torch.zeros((qn, expand, R), dtype=torch.bool, device=dev)
            # prologue: merge nothing, pop the entry
            ln.state, sel = _host_step(
                ln.state, scorer, ln.qstate, torch.full((qn, expand), -1, dtype=torch.int32, device=dev),
                torch.full((qn, expand, R), -1, dtype=torch.int32, device=dev),
                torch.zeros((qn, expand, R, mp), dtype=torch.uint8, device=dev),
                torch.zeros((qn, expand, R), device=dev), expand, acc0,
            )
            ln.post(sel)
            lanes.append(ln)

        for _ in range(max_iters):
            if all(ln.done for ln in lanes):
                break
            for ln in lanes:
                if ln.done:
                    continue
                sel_np = ln.fetch()  # waits for this lane's step only
                if (sel_np < 0).all():
                    ln.done = True
                    continue
                # the host's "disk read": one contiguous row per expansion;
                # the other lane's step runs on the card meanwhile
                safe = np.minimum(np.maximum(sel_np, 0), n_rows - 1).reshape(-1)
                screen = None
                if filtered:
                    def screen(nbrs_np, ln=ln, sel_np=sel_np):
                        return _screen_popped(ln.popped, sel_np, nbrs_np, acc_full)
                nbrs, rows, w2, acc = ln.gather(self, safe, dev, screen)
                ln.state, sel = _host_step(ln.state, scorer, ln.qstate, ln.sel, nbrs, rows, w2, expand, acc)
                ln.post(sel)

        def cat(field):
            return torch.cat([getattr(ln.state, field) for ln in lanes])

        if filtered:
            # results come from the accepted channel (sorted, deleted nodes
            # already folded into the mask)
            ids, scores = cat("res_ids"), cat("res_scores")
            k_out = K if rerank is not None else top_k
        else:
            ids, scores = cat("ids"), cat("scores")
            if self.deleted is not None and self.deleted.any():
                dead = torch.as_tensor(np.array(self.deleted), device=dev)[torch.clamp(ids, min=0).long()] & (ids >= 0)
                ids = torch.where(dead, -1, ids)
                scores = torch.where(dead, NEG_INF, scores)
            order = torch.argsort(-scores, dim=1, stable=True)
            ids, scores = torch.gather(ids, 1, order), torch.gather(scores, 1, order)
            k_out = beam_width if rerank is not None else top_k
        approx = SearchResult(
            ids=ids[:, :k_out], scores=scores[:, :k_out], visited_count=cat("visited_count"),
            expanded_count=cat("expanded_count"),
            reranked_count=torch.zeros((Q,), dtype=torch.int32, device=dev), approx_scores=scores[:, :k_out],
        )
        if rerank is not None:
            return _apply_threshold(rerank.rerank(queries, approx, top_k), threshold)
        return _apply_threshold(approx._replace(ids=ids[:, :top_k], scores=scores[:, :top_k],
                                                approx_scores=scores[:, :top_k]), threshold)


def _apply_threshold(res: SearchResult, threshold: float) -> SearchResult:
    """The threshold search's result contract: results below the similarity
    are dropped (the host loop ends on an exhausted frontier either way)."""
    if threshold <= 0.0:
        return res
    ok = res.scores >= threshold
    return res._replace(ids=torch.where(ok, res.ids, -1), scores=torch.where(ok, res.scores, NEG_INF))


@dataclasses.dataclass
class ShardedHostIndex:
    """Bounded-memory serving over a sharded directory (BASELINE config 5's
    serve tier): every shard is a self-contained :class:`HostGraphIndex`
    built by :func:`jvector_tpu_torch.parallel.sharded_build_on_disk`; a
    query wave searches each shard and the per-shard top-k merge by score
    (the reference's multi-segment search, ``GraphSearcher.java:386-404``).

    Shards are searched one after another here; a deployment runs one
    shard a host and merges the same per-shard results.  The merge is pure:
    ids are globalised by each shard's offset, and scores are exact after
    the default per-shard rerank, so they compare without a shared
    quantizer.
    """

    shards: list[HostGraphIndex]
    offsets: list[int]  # global ordinal of each shard's local node 0
    n_total: int

    @staticmethod
    def load(directory, device: torch.device | str | None = None) -> "ShardedHostIndex":
        """Open every shard of a manifest, searches on ``device`` (default:
        the card)."""
        directory = os.fspath(directory)
        with open(os.path.join(directory, "manifest.json")) as f:
            man = json.load(f)
        shards = [HostGraphIndex.load(os.path.join(directory, fname), device=device) for fname in man["shards"]]
        return ShardedHostIndex(
            shards=shards, offsets=[s * man["n_local"] for s in range(man["n_shards"])], n_total=man["n_total"]
        )

    def search(
        self,
        queries,
        top_k: int,
        beam_width: int = 64,
        expand: int = 4,
        max_iters: int = 200,
        rerank=None,  # forwarded to every shard (None: each shard's inline vectors)
        pipeline: int = 2,
        accept: np.ndarray | None = None,  # bool [n_total] global mask
        threshold: float = 0.0,
        accept_brute_cutoff: int | None = None,
    ) -> SearchResult:
        """Search every shard, globalise the ids, merge the top-k by score
        (a stable sort, so equal scores keep shard order).

        ``accept`` is a global-ordinal mask; each shard runs the filtered
        search on its slice, ``[offset, next offset)`` (offsets need not be
        uniform; the last shard ends at ``n_total``), and a shard with no
        accepted node is skipped.
        """
        acc = None if accept is None else np.asarray(accept, bool)
        per, offs = [], []
        for i, (hg, off) in enumerate(zip(self.shards, self.offsets)):
            # slice by the shard's node range, not its array capacity: the
            # containers are padded to one capacity, and a capacity-wide
            # slice would lay the next shard's bits on this one's padding
            end = self.offsets[i + 1] if i + 1 < len(self.offsets) else self.n_total
            acc_s = None
            if acc is not None:
                acc_s = acc[off:end]
                if not acc_s.any():
                    continue  # nothing in this shard can be returned
            per.append(hg.search(
                queries, top_k=top_k, beam_width=beam_width, expand=expand, max_iters=max_iters, rerank=rerank,
                pipeline=pipeline, accept=acc_s, threshold=threshold, accept_brute_cutoff=accept_brute_cutoff,
            ))
            offs.append(off)
        dev = self.shards[0].device
        if not per:  # an empty filter: nothing anywhere can be returned
            q = queries.shape[0]
            z = torch.zeros((q,), dtype=torch.int32, device=dev)
            empty = torch.full((q, top_k), NEG_INF, device=dev)
            return SearchResult(ids=torch.full((q, top_k), -1, dtype=torch.int32, device=dev), scores=empty,
                                visited_count=z, expanded_count=z, reranked_count=z, approx_scores=empty.clone())

        def cat(xs):
            return torch.cat([x.to(dev) for x in xs], dim=1)

        ids = cat([torch.where(r.ids >= 0, r.ids + off, -1) for r, off in zip(per, offs)])
        scores = cat([r.scores for r in per])
        approx = cat([r.scores if r.approx_scores is None else r.approx_scores for r in per])
        order = torch.argsort(-scores, dim=1, stable=True)[:, :top_k]
        return SearchResult(
            ids=torch.gather(ids, 1, order),
            scores=torch.gather(scores, 1, order),
            visited_count=sum(r.visited_count.to(dev) for r in per),
            expanded_count=sum(r.expanded_count.to(dev) for r in per),
            reranked_count=sum(r.reranked_count.to(dev) for r in per),
            approx_scores=torch.gather(approx, 1, order),
        )


def write_sq4_index(path, graph, sq, codes_packed, provider, sim, **extra_features) -> None:
    """Persist a graph + the fused-SQ4 feature for host-tier serving.

    ``provider`` is the SQ4 provider whose fused tables were built against
    ``graph.base.neighbors``.  ``sq`` is accepted for the JAX package's
    signature; the quantizer's scale and offset come from the provider.
    """
    sim = SimilarityFunction.parse(sim)
    const = provider.node_norm2 if sim == SimilarityFunction.COSINE else provider.node_w2
    feats = {
        FeatureId.FUSED_SQ4: {
            "codes_packed": codes_packed,
            "node_const": const,
            "fused_packed": provider.fused_packed,
            "fused_w2": provider.fused_w2,
            "scale": provider.scale,
            "offset": provider.offset,
        }
    }
    feats.update(extra_features)
    write_index(path, graph, features=feats, renumber=False, similarity=sim.value)
