"""Batched Vamana graph construction (counterpart of
``jvector_tpu/graph/builder.py``).

The unit of concurrency is a *wave* of W nodes:

1. beam-search all W nodes over the current graph in lock-step
   (:func:`_wave_search`);
2. wave members score each other directly (replaces the reference's
   insertions-in-progress snapshot), the pooled candidates are
   robust-pruned, backlinks are ranked into free slots, and rows that
   overflow are re-pruned;
3. the writes land in place.

Three wave loops, chosen as in the JAX package:

- **packed** (the default SQ4 build on aligned shapes): beam search on SQ4
  codes, exact rescore + prune (:func:`_wave_update_compute`), and the
  write streams applied by two hand-written kernels, K1 on the packed
  ``[N/8, 8, 128]`` adjacency + w2 tables and K2 on the fused SQ4 code
  table (:func:`_wave_apply_packed`);
- **fused** (the SQ4 build on other shapes, e.g. the small upper levels of
  a hierarchy): an unpacked ``[N, R]`` graph beside fused SQ4 tables kept
  slot-exact by K2's slot patches (:func:`_wave_update_fused`);
- **plain** (an exact build, or an explicit provider such as PQ): search
  and prune on the provider as given (:func:`_insert_wave`,
  :func:`_wave_update_plain`).

The fused and plain loops update an unpacked graph whose tables carry one
extra *sink* row at index N_cap: writes the JAX package drops
(``mode="drop"``) land there, and the loop slices it off at the end.
Every table is updated in place, where the JAX package donated it.
``cleanup`` enforces the max degree and picks the entry point nearest the
centroid; ``add_hierarchy`` adds HNSW-style upper levels.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from jvector_tpu_torch.graph.diversity import (
    dedup_sorted_desc,
    robust_prune,
    tie_break_pairs,
    tie_break_scores,
)
from jvector_tpu_torch.graph.hierarchy import assign_levels
from jvector_tpu_torch.graph.index import (
    NEG_INF,
    GraphConfig,
    GraphIndex,
    GraphLayer,
    bucket_capacity,
    empty_graph,
    empty_layer,
)
from jvector_tpu_torch.graph.score import (
    ExactScoreProvider,
    SQ4ScoreProvider,
    exact_pairwise_rows,
    exact_score_rows,
    sq4_aug_rows,
)
from jvector_tpu_torch.graph.searcher import _repack_tail, search_layer
from jvector_tpu_torch.ops.kernels.packed_adj import packed_adj_only_update_inplace, packed_adj_update_inplace
from jvector_tpu_torch.ops.kernels.scatter_rows import fused_update_inplace, scatter_rows3_inplace
from jvector_tpu_torch.ops.similarity import SimilarityFunction, normalize_score, pairwise_raw
from jvector_tpu_torch.quantization.sq import ScalarQuantization4
from jvector_tpu_torch.util.device import resolve_device

_BIG = 2**30
# patch-stream alignment the JAX package's packed layout requires (its
# Pallas chunk); kept so both packages take the packed path on the same
# configurations
_PATCH_ALIGN = 256


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, lowest index first among ties (``lax.top_k``)."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, order), order


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none), like ``jnp.argmax``."""
    return torch.argmax(mask.to(torch.int32), dim=1)


def _pairwise_from_provider(provider, ids: torch.Tensor) -> torch.Tensor:
    """Candidate-pair similarity matrix ``[B, C, C]`` for the prune."""
    safe = torch.clamp(ids, min=0)
    return provider.pairwise(safe, safe)


def _prune_simmat(provider, ids: torch.Tensor) -> torch.Tensor:
    """Jittered pairwise matrix for the diversity prune.  Exact providers
    take one row gather and the bf16-rounded products of
    :func:`exact_pairwise_rows`; others their own ``pairwise``."""
    if isinstance(provider, ExactScoreProvider):
        sim = exact_pairwise_rows(provider.vectors[torch.clamp(ids, min=0).long()], provider.sim)
        return tie_break_pairs(ids, sim)
    return tie_break_pairs(ids, _pairwise_from_provider(provider, ids))


class _EntrySeedSampler:
    """Host-side multi-seed bookkeeping: the RNG and the inserted-id prefix
    (numpy, so both packages draw the same seeds)."""

    def __init__(self, n: int, w: int, n_seeds: int):
        self.rng = np.random.default_rng(0xBEE5)
        self.inserted = np.empty(n, np.int32)
        self.n_ins = 0
        self.w = w
        self.n_seeds = max(1, n_seeds)

    def sample(self, device) -> torch.Tensor | None:
        sd = _sample_entry_seeds(self.rng, self.inserted, self.n_ins, self.w, self.n_seeds)
        return None if sd is None else torch.as_tensor(sd, device=device)

    def record(self, ids: np.ndarray) -> None:
        valid = ids[ids >= 0]
        self.inserted[self.n_ins : self.n_ins + valid.size] = valid
        self.n_ins += valid.size

    def state_dict(self) -> dict:
        """Checkpointable state (larger-than-memory build resume): the RNG
        and the inserted prefix."""
        return {"rng_state": self.rng.bit_generator.state, "inserted": self.inserted[: self.n_ins].copy()}

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng_state"]
        ins = np.asarray(state["inserted"], np.int32)
        self.inserted[: ins.size] = ins
        self.n_ins = int(ins.size)


def _sample_entry_seeds(
    rng: np.random.Generator, inserted: np.ndarray, n_ins: int, w: int, n_seeds: int
) -> np.ndarray | None:
    """Sample extra beam-entry seeds from the already-inserted nodes
    (``None`` when the knob is off; all ``-1`` on the first wave)."""
    if n_seeds <= 1:
        return None
    if n_ins > 0:
        return inserted[rng.integers(0, n_ins, (w, n_seeds - 1))]
    return np.full((w, n_seeds - 1), -1, np.int32)


def _wave_search(
    graph_neighbors: torch.Tensor,  # [N, R] or packed [N/8, 8, 128] int32 adjacency
    provider,
    entry_node: torch.Tensor,  # int32 scalar
    wave_ids: torch.Tensor,  # int32 [W], -1 padded
    wave_vectors: torch.Tensor,  # float32 [W, D]
    config: GraphConfig,
    seed_ids: torch.Tensor | None = None,  # int32 [W, S-1] extra entry seeds
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam-search a wave against the current graph (read-only)."""
    ef = config.ef_construction
    wave_valid = wave_ids >= 0
    qstate = provider.prepare(wave_vectors)
    entries = torch.where(wave_valid & (entry_node >= 0), entry_node, -1).to(torch.int32)
    if seed_ids is not None and seed_ids.shape[1] > 0:
        extra = seed_ids[:, : max(0, ef - 1)]
        extra = torch.where(wave_valid[:, None], extra, -1).to(torch.int32)
        entries = torch.cat([entries[:, None], extra], dim=1)
    packed_rows = config.row_cap if graph_neighbors.dim() == 3 else None
    cut = config.build_repack_after
    repack = 0 < cut < config.max_build_iters and wave_ids.shape[0] >= 64
    beam = search_layer(
        graph_neighbors,
        provider,
        qstate,
        entries,
        beam_width=ef,
        max_iters=cut if repack else config.max_build_iters,
        expand_per_iter=config.build_expand,
        packed_rows=packed_rows,
    )
    if repack:
        beam = _repack_tail(
            graph_neighbors,
            provider,
            qstate,
            beam,
            beam_width=ef,
            max_iters=config.max_build_iters,
            expand_per_iter=config.build_expand,
            packed_rows=packed_rows,
        )
    return beam.ids[:, :ef], beam.scores[:, :ef]


# ---------------------------------------------------------------------------
# Unpacked wave loops (plain and fused): an [N_cap + 1, R] graph whose last
# row is the sink for dropped writes, updated in place.
# ---------------------------------------------------------------------------


def _sink_graph(n_cap: int, config: GraphConfig, device) -> GraphIndex:
    """An empty build graph whose layer tables have the extra sink row."""
    g = empty_graph(n_cap, config, device)
    return g._replace(layers=(empty_layer(n_cap + 1, config.row_cap, device),))


def _drop_sink(graph: GraphIndex) -> GraphIndex:
    """The build graph without its sink row (views, no copy)."""
    n_cap = graph.base.neighbors.shape[0] - 1
    return graph._replace(layers=(GraphLayer(*(t[:n_cap] for t in graph.base)),) + graph.layers[1:])


def _pad_rows(ids: torch.Tensor, scores: torch.Tensor, r_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, M]`` selections -> ``[B, r_cap]`` rows padded with ``(-1, -inf)``."""
    b, m = ids.shape
    pad_ids = torch.full((b, r_cap - m), -1, dtype=torch.int32, device=ids.device)
    pad_sc = torch.full((b, r_cap - m), NEG_INF, device=ids.device)
    return torch.cat([ids, pad_ids], dim=1), torch.cat([scores, pad_sc], dim=1)


def _intra_candidates(prune_provider, prune_qstate, wave_ids: torch.Tensor, ef: int):
    """Intra-wave candidates (replaces insertionsInProgress): each member's
    top-``ef`` wave-mates by ``prune_provider``, tie-break jittered BEFORE
    the quota so quantized ties do not funnel every owner to the same
    lowest-index mates.  Returns ``(ids, scores)`` ``[W, min(W, ef)]``."""
    W = wave_ids.shape[0]
    wave_valid = wave_ids >= 0
    safe_wave = torch.where(wave_valid, wave_ids, 0)
    pair = prune_provider.score(prune_qstate, safe_wave[None, :].expand(W, W))
    self_mask = torch.eye(W, dtype=torch.bool, device=wave_ids.device)
    intra_valid = wave_valid[None, :] & wave_valid[:, None] & ~self_mask
    scores = torch.where(intra_valid, pair, NEG_INF)
    ids = torch.where(intra_valid, wave_ids[None, :], -1)
    scores = tie_break_scores(safe_wave, ids, scores)
    if W > ef:
        scores, idx = _top_k_stable(scores, ef)
        ids = torch.gather(ids, 1, idx)
    return ids, scores


def _write_wave_rows(layer: GraphLayer, wave_ids, sel_ids, sel_scores, sel_count) -> tuple:
    """Step 4a: the wave's new rows, in place.  Returns ``(row_ids,
    row_scores, scatter_rows)`` (invalid members scatter to the sink)."""
    n_cap = layer.neighbors.shape[0] - 1
    row_ids, row_scores = _pad_rows(sel_ids, sel_scores, layer.neighbors.shape[1])
    scatter_rows = torch.where(wave_ids >= 0, wave_ids, n_cap)
    idx = scatter_rows.long()
    layer.neighbors[idx] = row_ids
    layer.scores[idx] = row_scores
    layer.counts[idx] = sel_count.to(torch.int32)
    return row_ids, row_scores, scatter_rows


class _Backlinks(NamedTuple):
    flat_t: torch.Tensor  # [W*M] targets
    bl_valid: torch.Tensor  # [W*M] the backlink is new
    key_sorted: torch.Tensor  # [W*M] targets sorted (invalid = _BIG)
    s_sorted: torch.Tensor  # [W*M] sources in that order
    valid_sorted: torch.Tensor
    is_start: torch.Tensor  # first entry of a run of equal targets
    t_ok: torch.Tensor  # valid target or 0
    ok: torch.Tensor  # the backlink took a slot
    scatter_slot: torch.Tensor  # its slot (0 when not ok)


def _append_backlinks(layer: GraphLayer, wave_ids, sel_ids, sel_scores) -> _Backlinks:
    """Step 4b: append each selection's reverse edge to its target's row,
    in place.  Backlinks already present are skipped; collisions on one
    target take consecutive free slots (sort by target + run rank); those
    past the row capacity are dropped."""
    n_cap, r_cap = layer.neighbors.shape[0] - 1, layer.neighbors.shape[1]
    W, M = sel_ids.shape
    flat_t = sel_ids.reshape(-1)
    flat_s = wave_ids[:, None].expand(W, M).reshape(-1)
    flat_sc = sel_scores.reshape(-1)
    bl_valid = (flat_t >= 0) & (flat_s >= 0)
    t_rows = layer.neighbors[torch.clamp(flat_t, min=0).long()]
    bl_valid = bl_valid & ~(t_rows == flat_s[:, None]).any(dim=1)

    key = torch.where(bl_valid, flat_t, _BIG)
    order = torch.argsort(key, stable=True)
    key_sorted, s_sorted, sc_sorted, valid_sorted = key[order], flat_s[order], flat_sc[order], bl_valid[order]
    pos_idx = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    is_start = torch.ones_like(valid_sorted)
    is_start[1:] = key_sorted[1:] != key_sorted[:-1]
    rank = pos_idx - torch.cummax(torch.where(is_start, pos_idx, 0), dim=0).values

    t_ok = torch.where(valid_sorted, key_sorted, 0)
    slot = layer.counts[t_ok.long()] + rank
    ok = valid_sorted & (slot < r_cap)
    scatter_t = torch.where(ok, t_ok, n_cap).long()
    scatter_slot = torch.where(ok, slot, 0)
    layer.neighbors[scatter_t, scatter_slot.long()] = s_sorted
    layer.scores[scatter_t, scatter_slot.long()] = sc_sorted
    layer.counts.index_add_(0, scatter_t, torch.ones_like(t_ok))
    return _Backlinks(flat_t, bl_valid, key_sorted, s_sorted, valid_sorted, is_start, t_ok, ok, scatter_slot)


def _enforce_overflow(layer: GraphLayer, prune_provider, bl: _Backlinks, W: int, config: GraphConfig):
    """Step 5: re-prune the (at most W) most-overflowed touched rows, in
    place.  Returns ``(er, p_row_ids)``: the rewritten rows (sink where not
    over the cap; duplicates carry identical images) and their ids."""
    n_cap, r_cap = layer.neighbors.shape[0] - 1, layer.neighbors.shape[1]
    touched = torch.where(bl.bl_valid, bl.flat_t, 0)
    touched_counts = torch.where(bl.bl_valid, layer.counts[touched.long()], -1)
    _, worst_idx = _top_k_stable(touched_counts, W)
    enforce_rows = touched[worst_idx]
    er_idx = enforce_rows.long()
    enforce_mask = layer.counts[er_idx] > config.overflow_degree
    e_ids = layer.neighbors[er_idx]
    e_ids = torch.where(torch.arange(r_cap, device=e_ids.device)[None, :] < layer.counts[er_idx][:, None], e_ids, -1)
    e_scores = torch.where(e_ids >= 0, layer.scores[er_idx], NEG_INF)
    e_scores = tie_break_scores(enforce_rows, e_ids, e_scores)
    e_ids_s, e_scores_s = dedup_sorted_desc(e_ids, e_scores)
    p_ids, p_scores, p_count = robust_prune(
        e_ids_s, e_scores_s, _prune_simmat(prune_provider, e_ids_s), config.max_degree,
        config.alphas, algo=config.prune_algo,
    )
    p_row_ids, p_row_scores = _pad_rows(p_ids, p_scores, r_cap)
    er = torch.where(enforce_mask, enforce_rows, n_cap)
    layer.neighbors[er.long()] = p_row_ids
    layer.scores[er.long()] = p_row_scores
    layer.counts[er.long()] = p_count.to(torch.int32)
    return er, p_row_ids


def _advance(graph: GraphIndex, layer: GraphLayer, wave_ids: torch.Tensor) -> GraphIndex:
    """Bookkeeping after a wave: the first wave's first node becomes the
    entry point; the node count grows by the valid members."""
    n_new = (wave_ids >= 0).sum(dtype=torch.int32)
    first = torch.where(wave_ids[0] >= 0, wave_ids[0], 0)
    entry = torch.where(graph.entry_node >= 0, graph.entry_node, torch.where(n_new > 0, first, -1))
    return graph._replace(
        layers=(layer,) + graph.layers[1:],
        entry_node=entry.to(torch.int32),
        num_nodes=(graph.num_nodes + n_new).to(torch.int32),
    )


def _insert_wave(
    graph: GraphIndex,  # build graph with the sink row, updated in place
    provider,
    wave_ids: torch.Tensor,  # int32 [W], -1 padded on the ragged final wave
    wave_vectors: torch.Tensor,  # float32 [W, D]
    config: GraphConfig,
    prune_provider=None,
    seed_ids: torch.Tensor | None = None,  # int32 [W, S-1] extra entry seeds
) -> GraphIndex:
    """One wave insert: search on ``provider``, then update with
    ``prune_provider`` (default: ``provider``), which then also rescores
    the candidates."""
    beam_ids, beam_scores = _wave_search(
        graph.base.neighbors, provider, graph.entry_node, wave_ids, wave_vectors, config, seed_ids
    )
    rescore = prune_provider is not None and prune_provider is not provider
    return _wave_update_plain(
        graph, prune_provider if rescore else provider, wave_ids, wave_vectors,
        beam_ids, beam_scores, config, rescore,
    )


def _wave_update_plain(
    graph: GraphIndex,  # build graph with the sink row, updated in place
    prune_provider,  # scores intra-wave pairs, the prune (+ rescore)
    wave_ids: torch.Tensor,  # int32 [W]
    wave_vectors: torch.Tensor,  # float32 [W, D]
    beam_ids: torch.Tensor,  # int32 [W, ef]
    beam_scores: torch.Tensor,  # float32 [W, ef]
    config: GraphConfig,
    rescore: bool = False,  # beam scores are compressed: re-rank with prune_provider
) -> GraphIndex:
    """Update half of :func:`_insert_wave` (steps 2-5)."""
    W = wave_ids.shape[0]
    ef = config.ef_construction
    layer = graph.base
    safe_wave = torch.where(wave_ids >= 0, wave_ids, 0)
    prune_qstate = prune_provider.prepare(wave_vectors)
    intra_ids, intra_scores = _intra_candidates(prune_provider, prune_qstate, wave_ids, ef)

    # beam and intra-wave candidates keep separate top-ef quotas and are
    # pruned as a union without re-truncation by score, so a burst of
    # near-duplicates in one wave cannot flood out the long-range edges
    cand_ids = torch.cat([beam_ids[:, :ef], intra_ids], dim=1)
    cand_scores = torch.cat([beam_scores[:, :ef], intra_scores], dim=1)
    cand_scores = tie_break_scores(safe_wave, cand_ids, cand_scores)
    cand_ids, cand_scores = dedup_sorted_desc(cand_ids, cand_scores)
    if rescore:
        rescored = prune_provider.score(prune_qstate, torch.clamp(cand_ids, min=0))
        cand_scores = torch.where(cand_ids >= 0, rescored, NEG_INF)
        cand_scores = tie_break_scores(safe_wave, cand_ids, cand_scores)
        order = torch.argsort(-cand_scores, dim=1, stable=True)
        cand_ids, cand_scores = torch.gather(cand_ids, 1, order), torch.gather(cand_scores, 1, order)
    sel_ids, sel_scores, sel_count = robust_prune(
        cand_ids, cand_scores, _prune_simmat(prune_provider, cand_ids), config.max_degree,
        config.alphas, algo=config.prune_algo,
    )
    _write_wave_rows(layer, wave_ids, sel_ids, sel_scores, sel_count)
    bl = _append_backlinks(layer, wave_ids, sel_ids, sel_scores)
    _enforce_overflow(layer, prune_provider, bl, W, config)
    return _advance(graph, layer, wave_ids)


def _slot_patch_supported(table_ndim: int, mp: int) -> bool:
    """Whether K2's slot patches apply to this fused table / code width."""
    return table_ndim == 3 and (mp % 128 == 0 or 128 % mp == 0)


def _wave_update_fused(
    graph: GraphIndex,  # build graph with the sink row, updated in place
    fused_packed: torch.Tensor,  # uint8 [N_cap+1, T, 128] or [N_cap+1, R*MP], in place
    fused_w2: torch.Tensor,  # float32 [N_cap+1, R], in place
    prune_provider,  # full-precision provider (rescore + prune)
    codes_packed: torch.Tensor,  # uint8 [N_cap, MP] the build SQ4 codes
    node_const: torch.Tensor,  # float32 [N_cap] sim-appropriate per-node constant
    wave_ids: torch.Tensor,  # int32 [W]
    wave_vectors: torch.Tensor,  # float32 [W, D]
    beam_ids: torch.Tensor,  # int32 [W, ef]
    beam_scores: torch.Tensor,  # float32 [W, ef] (approximate; rescored here)
    config: GraphConfig,
) -> GraphIndex:
    """Insert a searched wave AND keep the fused SQ4 tables slot-exact: every
    adjacency write (wave rows, backlink slots, enforce rewrites) is
    mirrored into ``fused_packed`` / ``fused_w2``, so the next wave's search
    gathers one fused row per expansion.  Rank-3 tables whose slots tile
    128 lanes take K2's slot patches; other tables rewrite whole rows (K4a
    on rank-3 tables, an indexed assignment on 2-D ones).  Rescore and
    prune stay exact."""
    W = wave_ids.shape[0]
    layer = graph.base
    n_cap = layer.neighbors.shape[0] - 1
    r_cap = layer.neighbors.shape[1]
    mp = codes_packed.shape[1]
    safe_wave = torch.where(wave_ids >= 0, wave_ids, 0)
    prune_qstate = prune_provider.prepare(wave_vectors)
    intra_ids, intra_scores = _intra_candidates(prune_provider, prune_qstate, wave_ids, config.ef_construction)

    cand_ids = torch.cat([beam_ids, intra_ids], dim=1)
    cand_scores = torch.cat([beam_scores, intra_scores], dim=1)
    cand_ids, cand_scores = dedup_sorted_desc(cand_ids, cand_scores)
    rescored = prune_provider.score(prune_qstate, torch.clamp(cand_ids, min=0))
    cand_scores = torch.where(cand_ids >= 0, rescored, NEG_INF)
    cand_scores = tie_break_scores(safe_wave, cand_ids, cand_scores)
    order = torch.argsort(-cand_scores, dim=1, stable=True)
    cand_ids, cand_scores = torch.gather(cand_ids, 1, order), torch.gather(cand_scores, 1, order)
    sel_ids, sel_scores, sel_count = robust_prune(
        cand_ids, cand_scores, _prune_simmat(prune_provider, cand_ids), config.max_degree,
        config.alphas, algo=config.prune_algo,
    )

    def fused_rows_for(ids_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Full fused row images for adjacency rows ``[B, R]``."""
        ok = ids_rows >= 0
        safe = torch.clamp(ids_rows, min=0).long()
        f_codes = torch.where(ok[..., None], codes_packed[safe], 0)
        return f_codes.reshape(ids_rows.shape[0], -1), torch.where(ok, node_const[safe], 0.0)

    row_ids, _, scatter_rows = _write_wave_rows(layer, wave_ids, sel_ids, sel_scores, sel_count)
    f_codes, f_w2 = fused_rows_for(row_ids)
    bl = _append_backlinks(layer, wave_ids, sel_ids, sel_scores)
    slot_patch = _slot_patch_supported(fused_packed.dim(), mp)
    if not slot_patch:
        # whole-row rewrite of every touched target, read before the enforce
        bl_rows = torch.where(bl.valid_sorted & bl.is_start, bl.key_sorted, n_cap)
        safe_bl = torch.clamp(bl_rows, max=n_cap - 1).long()
        r_ids = layer.neighbors[safe_bl]
        r_ids = torch.where(torch.arange(r_cap, device=r_ids.device)[None, :] < layer.counts[safe_bl][:, None], r_ids, -1)
        bf_codes, bf_w2 = fused_rows_for(r_ids)
    er, p_row_ids = _enforce_overflow(layer, prune_provider, bl, W, config)
    pf_codes, pf_w2 = fused_rows_for(p_row_ids)

    # fused-table writes: priority enforce > patch > wave
    wave_in_er = (scatter_rows[:, None] == er[None, :]).any(dim=1)
    rows_a = torch.where(wave_in_er, n_cap, scatter_rows)
    if slot_patch:
        # patches into enforce rows are masked out (their images already
        # hold the surviving backlinks); masking removes whole runs or run
        # tails, so the patch stream stays row-sorted and run-contiguous
        p_ok = bl.ok & ~(bl.key_sorted[:, None] == er[None, :]).any(dim=1)
        src = torch.clamp(bl.s_sorted, min=0).long()
        t3 = fused_packed.shape[1]
        fused_update_inplace(
            fused_packed[:n_cap], rows_a, f_codes.reshape(W, t3, 128),
            torch.where(p_ok, bl.t_ok, -1), bl.scatter_slot, codes_packed[src],
            er, pf_codes.reshape(W, t3, 128),
        )
        fused_w2[rows_a.long()] = f_w2
        p_rows = torch.where(p_ok, bl.t_ok, n_cap).long()
        fused_w2[p_rows, bl.scatter_slot.long()] = torch.where(p_ok, node_const[src], 0.0)
        fused_w2[er.long()] = pf_w2
    else:
        # whole-row images: mask lower-priority rows covered by a
        # higher-priority image, so each surviving row is written once
        # (duplicate enforce rows carry identical images)
        rows_a = torch.where((scatter_rows[:, None] == bl_rows[None, :]).any(dim=1), n_cap, rows_a)
        rows_b = torch.where((bl_rows[:, None] == er[None, :]).any(dim=1), n_cap, bl_rows)
        all_rows = torch.cat([rows_a, rows_b, er]).to(torch.int32)
        images = torch.cat([f_codes, bf_codes, pf_codes])
        if fused_packed.dim() == 3:
            # whole-tile rows: K4a's in-place row scatter; the sink row n_cap drops
            scatter_rows3_inplace(fused_packed[:n_cap], all_rows, images.reshape((-1,) + fused_packed.shape[1:]))
        else:
            fused_packed[all_rows.long()] = images
        fused_w2[all_rows.long()] = torch.cat([f_w2, bf_w2, pf_w2])
    return _advance(graph, layer, wave_ids)


def _enforce_chunk(graph: GraphIndex, provider, start: int, config: GraphConfig, chunk: int) -> GraphIndex:
    """Prune the rows ``[start, start + chunk)`` down to max_degree, in
    place (cleanup pass); rows past the capacity are skipped."""
    layer = graph.base
    n_cap, r_cap = layer.neighbors.shape
    dev = layer.neighbors.device
    rows = start + torch.arange(chunk, dtype=torch.int32, device=dev)
    safe_rows = torch.clamp(rows, max=n_cap - 1)
    idx = safe_rows.long()
    cnt = layer.counts[idx]
    valid_row = (rows < graph.num_nodes) & (cnt > 0)
    e_ids = torch.where(torch.arange(r_cap, device=dev)[None, :] < cnt[:, None], layer.neighbors[idx], -1)
    e_scores = torch.where(e_ids >= 0, layer.scores[idx], NEG_INF)
    e_scores = tie_break_scores(safe_rows, e_ids, e_scores)
    e_ids_s, e_scores_s = dedup_sorted_desc(e_ids, e_scores)
    p_ids, p_scores, p_count = robust_prune(
        e_ids_s, e_scores_s, _prune_simmat(provider, e_ids_s), config.max_degree,
        config.alphas, algo=config.prune_algo,
    )
    row_ids, row_scores = _pad_rows(p_ids, p_scores, r_cap)
    k = min(start + chunk, n_cap) - start
    keep = valid_row[:k]
    sl = slice(start, start + k)
    layer.neighbors[sl] = torch.where(keep[:, None], row_ids[:k], layer.neighbors[sl])
    layer.scores[sl] = torch.where(keep[:, None], row_scores[:k], layer.scores[sl])
    layer.counts[sl] = torch.where(keep, p_count[:k].to(torch.int32), layer.counts[sl])
    return graph


def _adj_rows(adj: torch.Tensor, ids: torch.Tensor, r: int):
    """Gather packed adjacency rows: ids ``[B...]`` (>= 0) ->
    ``(neighbor ids [B..., r] int32, scores [B..., r] float32)``."""
    i = ids.long()
    rows = adj[i >> 3, i & 7]  # [B..., 128]
    return rows[..., :r], rows[..., 64 : 64 + r].contiguous().view(torch.float32)


def _intra_wave_scores(prune_provider, prune_qstate, wave_vectors, safe_wave):
    """Intra-wave all-pairs scores ``[W, W]``.  The exact provider takes a
    direct product of the wave vectors already at hand (no row gathers);
    others score the wave's ids."""
    if isinstance(prune_provider, ExactScoreProvider):
        raw = pairwise_raw(prune_qstate, wave_vectors.float(), prune_provider.sim)
        return normalize_score(raw, prune_provider.sim)
    w = safe_wave.shape[0]
    return prune_provider.score(prune_qstate, safe_wave[None, :].expand(w, w))


def _wave_update_compute(
    adj: torch.Tensor,  # [N/8, 8, 128] int32 packed adjacency (read only)
    counts: torch.Tensor,  # [N] int32 (read only)
    entry_node: torch.Tensor,  # int32 scalar
    num_nodes: torch.Tensor,  # int32 scalar
    prune_provider,  # rescore + prune (full precision, or the search's own)
    codes_packed: torch.Tensor | None,  # uint8 [N_cap, MP] the build SQ4 codes (with_fused only)
    node_const: torch.Tensor | None,  # float32 [N_cap] per-node constant (with_fused only)
    wave_ids: torch.Tensor,  # int32 [W], contiguous ascending, -1 padded
    wave_vectors: torch.Tensor,  # float32 [W, D]
    beam_ids: torch.Tensor,  # int32 [W, ef]
    beam_scores: torch.Tensor,  # float32 [W, ef]
    config: GraphConfig,
    rescore: bool = True,  # re-rank the candidates with prune_provider (False:
    #   prune on the beam's own scores, the larger-than-memory build)
    with_fused: bool = True,  # also emit the w2 and fused-table write streams
):
    """Read + compute half of the packed wave update.

    Returns ``(counts, entry_node, num_nodes, adj_stream, fused_stream)``:
    the new counts (a fresh tensor), the bookkeeping scalars, and the write
    streams for :func:`_wave_apply_packed`, in the JAX package's layout.
    With ``with_fused=False`` the adj stream omits the w2 parts,
    ``(a_rows, a_adj, m_key, m_slot, m_id, m_sc, m_img, e_adj_img)`` for
    :func:`_wave_apply_adj_only`, and ``fused_stream`` is None.
    """
    W = wave_ids.shape[0]
    dev = wave_ids.device
    N_cap = adj.shape[0] * 8
    R_cap = config.row_cap
    M = config.max_degree
    ef = config.ef_construction
    i32 = dict(dtype=torch.int32, device=dev)
    wave_valid = wave_ids >= 0
    safe_wave = torch.where(wave_valid, wave_ids, 0)
    # counts with one extra sink entry: out-of-range writes land at N_cap
    # (the JAX scatters' mode="drop") and are cut off at the end
    cnt = torch.cat([counts, torch.zeros(1, **i32)])

    # -- 2. intra-wave candidates ----------------------------------------
    prune_qstate = prune_provider.prepare(wave_vectors)
    wave_pair_scores = _intra_wave_scores(prune_provider, prune_qstate, wave_vectors, safe_wave)
    self_mask = torch.eye(W, dtype=torch.bool, device=dev)
    intra_valid = wave_valid[None, :] & wave_valid[:, None] & ~self_mask
    intra_scores = torch.where(intra_valid, wave_pair_scores, NEG_INF)
    intra_ids = torch.where(intra_valid, wave_ids[None, :], -1)
    intra_scores = tie_break_scores(safe_wave, intra_ids, intra_scores)

    # -- 3. merge + rescore exact + prune --------------------------------
    if W > ef:
        intra_top_scores, intra_idx = _top_k_stable(intra_scores, ef)
        intra_top_ids = torch.gather(intra_ids, 1, intra_idx)
    else:
        intra_top_scores, intra_top_ids = intra_scores, intra_ids
    cand_ids = torch.cat([beam_ids, intra_top_ids], dim=1)
    cand_scores = torch.cat([beam_scores, intra_top_scores], dim=1)
    cand_ids, cand_scores = dedup_sorted_desc(cand_ids, cand_scores)
    valid = cand_ids >= 0
    exact_rows = rescore and isinstance(prune_provider, ExactScoreProvider)
    if exact_rows:
        # the SQ4 beam scores only drove discovery: rescore exact.  One
        # [W, C, D] row gather feeds the rescore AND the prune matrix
        cand_va = prune_provider.vectors[torch.clamp(cand_ids, min=0).long()]
        rescored = exact_score_rows(prune_qstate, cand_va, prune_provider.sim)
        cand_scores = torch.where(valid, rescored, NEG_INF)
    elif rescore:
        rescored = prune_provider.score(prune_qstate, torch.clamp(cand_ids, min=0))
        cand_scores = torch.where(valid, rescored, NEG_INF)
    else:
        cand_scores = torch.where(valid, cand_scores, NEG_INF)
    cand_scores = tie_break_scores(safe_wave, cand_ids, cand_scores)
    order = torch.argsort(-cand_scores, dim=1, stable=True)
    cand_ids = torch.gather(cand_ids, 1, order)
    cand_scores = torch.gather(cand_scores, 1, order)
    if exact_rows:
        cand_va = torch.gather(cand_va, 1, order[..., None].expand_as(cand_va))
        simmat = tie_break_pairs(cand_ids, exact_pairwise_rows(cand_va, prune_provider.sim))
    else:
        simmat = tie_break_pairs(cand_ids, _pairwise_from_provider(prune_provider, cand_ids))
    sel_ids, sel_scores, sel_count = robust_prune(
        cand_ids, cand_scores, simmat, M, config.alphas, algo=config.prune_algo
    )

    # -- 4a. wave row images (invalid members get explicit EMPTY images) --
    row_ids = torch.cat([sel_ids, torch.full((W, R_cap - M), -1, **i32)], dim=1)
    row_scores = torch.cat([sel_scores, torch.full((W, R_cap - M), NEG_INF, device=dev)], dim=1)
    row_ids = torch.where(wave_valid[:, None], row_ids, -1)
    row_scores = torch.where(wave_valid[:, None], row_scores, NEG_INF)
    scatter_rows = torch.where(wave_valid, wave_ids, N_cap)
    cnt.index_put_((scatter_rows.long(),), sel_count)  # counts1

    def fused_rows_for(ids_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        ok = ids_rows >= 0
        safe = torch.clamp(ids_rows, min=0).long()
        f_codes = torch.where(ok[..., None], codes_packed[safe], 0)
        f_w2 = torch.where(ok, node_const[safe], 0.0)
        return f_codes.reshape(ids_rows.shape[0], -1), f_w2

    if with_fused:
        f_codes, f_w2 = fused_rows_for(row_ids)

    # -- 4b. backlinks: dedup against PRE-state + intra-wave overlay ------
    flat_t = sel_ids.reshape(-1)
    flat_s = wave_ids[:, None].expand(W, M).reshape(-1)
    flat_sc = sel_scores.reshape(-1)
    bl_valid = (flat_t >= 0) & (flat_s >= 0)
    t_pre_ids, _ = _adj_rows(adj, torch.clamp(flat_t, min=0), R_cap)
    exists_pre = (t_pre_ids == flat_s[:, None]).any(dim=1)
    # wave-member targets: their row is replaced this wave; mutual
    # selection comes from sel_ids
    eq_w = flat_t[:, None] == scatter_rows[None, :]  # [W*M, W]
    is_wave_t = eq_w.any(dim=1)
    widx = _first_true(eq_w)
    mutual = (sel_ids[widx] == flat_s[:, None]).any(dim=1)
    exists = torch.where(is_wave_t, mutual, exists_pre)
    bl_valid = bl_valid & ~exists

    key = torch.where(bl_valid, flat_t, _BIG)
    order = torch.argsort(key, stable=True)
    key_sorted = key[order]
    s_sorted = flat_s[order]
    sc_sorted = flat_sc[order]
    valid_sorted = bl_valid[order]
    pos_idx = torch.arange(key.shape[0], **i32)
    is_start = torch.ones_like(valid_sorted)
    is_start[1:] = key_sorted[1:] != key_sorted[:-1]
    run_start = torch.cummax(torch.where(is_start, pos_idx, 0), dim=0).values
    rank = pos_idx - run_start

    t_ok = torch.where(valid_sorted, key_sorted, 0)
    slot = cnt[t_ok.long()] + rank
    ok = valid_sorted & (slot < R_cap)
    scatter_slot = torch.where(ok, slot, 0)
    ones = torch.ones_like(t_ok)
    cnt.index_add_(0, torch.where(ok, t_ok, N_cap).long(), ones)  # counts2

    # -- 5. enforce overflow: reconstruct post-append rows from pre-state
    over_cap = config.overflow_degree
    touched = torch.where(bl_valid, flat_t, 0)
    touched_counts = torch.where(bl_valid, cnt[touched.long()], -1)
    _, worst_idx = _top_k_stable(touched_counts, W)
    enforce_rows = touched[worst_idx]
    # drop duplicate rows (the image stream wants unique rows)
    first_occ = _first_true(enforce_rows[:, None] == enforce_rows[None, :]) == torch.arange(W, device=dev)
    safe_er = torch.clamp(enforce_rows, min=0)
    enforce_mask = (cnt[safe_er.long()] > over_cap) & first_occ

    base_ids, base_scores = _adj_rows(adj, safe_er, R_cap)
    eq_ew = enforce_rows[:, None] == scatter_rows[None, :]
    er_is_wave = eq_ew.any(dim=1)
    ewidx = _first_true(eq_ew)
    base_ids = torch.where(er_is_wave[:, None], row_ids[ewidx], base_ids)
    base_scores = torch.where(er_is_wave[:, None], row_scores[ewidx], base_scores)
    # overlay this wave's appends into the (unique) enforce rows; row W is
    # the sink for appends that hit no enforce row
    eq_e = (key_sorted[:, None] == enforce_rows[None, :]) & ok[:, None]
    e_r = torch.where(eq_e.any(dim=1), _first_true(eq_e), W).long()
    e_ids = torch.cat([base_ids, torch.full((1, R_cap), -1, **i32)])
    e_scores = torch.cat([base_scores, torch.full((1, R_cap), NEG_INF, device=dev)])
    e_ids.index_put_((e_r, scatter_slot.long()), s_sorted)
    e_scores.index_put_((e_r, scatter_slot.long()), sc_sorted)
    e_ids, e_scores = e_ids[:W], e_scores[:W]

    e_ids_m = torch.where(
        torch.arange(R_cap, device=dev)[None, :] < cnt[safe_er.long()][:, None], e_ids, -1
    )
    e_scores_m = torch.where(e_ids_m >= 0, e_scores, NEG_INF)
    e_scores_m = tie_break_scores(enforce_rows, e_ids_m, e_scores_m)
    e_ids_s, e_scores_s = dedup_sorted_desc(e_ids_m, e_scores_m)
    e_sim = _prune_simmat(prune_provider, e_ids_s)
    p_ids, p_scores, p_count = robust_prune(
        e_ids_s, e_scores_s, e_sim, M, config.alphas, algo=config.prune_algo
    )
    p_row_ids = torch.cat([p_ids, torch.full((W, R_cap - M), -1, **i32)], dim=1)
    p_row_scores = torch.cat([p_scores, torch.full((W, R_cap - M), NEG_INF, device=dev)], dim=1)
    er = torch.where(enforce_mask, enforce_rows, N_cap)
    cnt.index_put_((er.long(),), p_count)  # counts3

    # -- assemble the write streams ---------------------------------------
    def adj_img(ids_img, scores_img):
        # lane layout: [ids R_cap | -1 pad to 64 | score bits R_cap | 0 pad]
        return torch.cat(
            [
                ids_img,
                torch.full((W, 64 - R_cap), -1, **i32),
                scores_img.contiguous().view(torch.int32),
                torch.zeros((W, 64 - R_cap), **i32),
            ],
            dim=1,
        )

    def w2_img(w2_vals):
        bits = w2_vals.float().contiguous().view(torch.int32)
        return torch.cat([bits, torch.zeros((W, 128 - R_cap), **i32)], dim=1)

    a_rows = (safe_wave[0] >> 3) + torch.arange(W // 8, **i32)
    a_adj = adj_img(row_ids, row_scores).reshape(W // 8, 8, 128)

    # merged patch stream: appends (scalar patches) + enforce images,
    # sorted by logical row; appends into enforce rows are excluded (the
    # enforce image is the complete row)
    in_er = (key_sorted[:, None] == er[None, :]).any(dim=1)
    p_ok = ok & ~in_er
    zero_w = torch.zeros((W,), **i32)
    m_key = torch.cat([torch.where(p_ok, t_ok, _BIG), torch.where(enforce_mask, enforce_rows, _BIG)])
    m_slot = torch.cat([scatter_slot, zero_w])
    m_id = torch.cat([s_sorted, zero_w])
    m_sc = torch.cat([sc_sorted.view(torch.int32), zero_w])
    m_img = torch.cat([torch.full((W * M,), -1, **i32), torch.arange(W, **i32)])
    m_order = torch.argsort(m_key, stable=True)
    e_adj_img = adj_img(p_row_ids, p_row_scores)

    # -- bookkeeping ----------------------------------------------------
    n_new = wave_valid.sum(dtype=torch.int32)
    entry2 = torch.where(
        entry_node >= 0, entry_node, torch.where(n_new > 0, safe_wave[0], -1)
    ).to(torch.int32)
    num2 = (num_nodes + n_new).to(torch.int32)
    if not with_fused:
        m_key, m_slot, m_id, m_sc, m_img = (x[m_order] for x in (m_key, m_slot, m_id, m_sc, m_img))
        return cnt[:N_cap], entry2, num2, (a_rows, a_adj, m_key, m_slot, m_id, m_sc, m_img, e_adj_img), None

    a_w2 = w2_img(f_w2).reshape(W // 8, 8, 128)
    app_w2 = node_const[torch.clamp(s_sorted, min=0).long()].float().view(torch.int32)
    m_w2 = torch.cat([app_w2, zero_w])
    m_key, m_slot, m_id, m_sc, m_w2, m_img = (
        x[m_order] for x in (m_key, m_slot, m_id, m_sc, m_w2, m_img)
    )
    pf_codes, pf_w2 = fused_rows_for(p_row_ids)
    e_w2_img = w2_img(pf_w2)

    # fused-table streams
    wave_in_er = (scatter_rows[:, None] == er[None, :]).any(dim=1)
    f_rows_a = torch.where(wave_in_er, N_cap, scatter_rows)
    f_p_rows = torch.where(p_ok, t_ok, -1)
    f_src_codes = codes_packed[torch.clamp(s_sorted, min=0).long()]
    return (
        cnt[:N_cap],
        entry2,
        num2,
        (a_rows, a_adj, a_w2, m_key, m_slot, m_id, m_sc, m_w2, m_img, e_adj_img, e_w2_img),
        (f_rows_a, f_codes, f_p_rows, scatter_slot, f_src_codes, er, pf_codes),
    )


def _wave_apply_packed(
    adj: torch.Tensor,  # [N/8, 8, 128] int32, updated in place
    w2t: torch.Tensor,  # [N/8, 8, 128] int32, updated in place
    fused_packed: torch.Tensor,  # [N, T, 128] uint8, updated in place
    adj_stream: tuple,
    fused_stream: tuple,
) -> None:
    """Write-only apply: K1 on the packed adjacency + w2 tables, then K2 on
    the fused code table, both in place."""
    (a_rows, a_adj, a_w2, m_key, m_slot, m_id, m_sc, m_w2, m_img, e_adj_img, e_w2_img) = adj_stream
    n_pr = adj.shape[0]
    prow = torch.where(m_key < n_pr * 8, m_key >> 3, _BIG)
    sub = m_key & 7
    packed_adj_update_inplace(
        adj, w2t, a_rows, a_adj, a_w2, prow, sub, m_slot, m_id, m_sc, m_w2, m_img, e_adj_img, e_w2_img
    )
    (f_rows_a, f_codes, f_p_rows, f_slots, f_src_codes, er, pf_codes) = fused_stream
    t3 = fused_packed.shape[1]
    w = f_codes.shape[0]
    fused_update_inplace(
        fused_packed,
        f_rows_a,
        f_codes.reshape(w, t3, 128),
        f_p_rows,
        f_slots,
        f_src_codes,
        er,
        pf_codes.reshape(w, t3, 128),
    )


def _wave_apply_adj_only(adj: torch.Tensor, adj_stream: tuple) -> None:
    """Write-only apply of the build without fused tables (the
    larger-than-memory regime): K3 on the packed adjacency, in place."""
    (a_rows, a_adj, m_key, m_slot, m_id, m_sc, m_img, e_adj_img) = adj_stream
    prow = torch.where(m_key < adj.shape[0] * 8, m_key >> 3, _BIG)
    packed_adj_only_update_inplace(adj, a_rows, a_adj, prow, m_key & 7, m_slot, m_id, m_sc, m_img, e_adj_img)


def _packed_adj_eligible(cfg: GraphConfig, n_cap: int) -> bool:
    """Whether the packed ``[N/8, 8, 128]`` adjacency layout applies."""
    w = cfg.wave_size
    return (
        cfg.row_cap <= 64
        and w % 8 == 0
        and (w * (cfg.max_degree + 1)) % _PATCH_ALIGN == 0
        and n_cap % 8 == 0
    )


def _packed_build_eligible(cfg: GraphConfig, mp: int, n_cap: int) -> bool:
    """Whether the packed-adjacency wave loop applies: the same rule as the
    JAX package (whole-kilobyte fused rows, lane-positionable slots)."""
    return (
        _packed_adj_eligible(cfg, n_cap)
        and (cfg.row_cap * mp) % 1024 == 0
        and (mp % 128 == 0 or 128 % mp == 0)
    )


def _empty_packed_adjacency(n_cap: int, r_cap: int, device) -> torch.Tensor:
    """Packed adjacency of an empty graph: id lanes -1, score lanes
    ``64..64+r_cap`` = bits of -inf, the rest 0."""
    row = torch.cat(
        [
            torch.full((64,), -1, dtype=torch.int32),
            torch.full((r_cap,), NEG_INF).view(torch.int32),
            torch.zeros((64 - r_cap,), dtype=torch.int32),
        ]
    ).to(device)
    return row.expand(n_cap // 8, 8, 128).contiguous()


def _unpack_adjacency(adj: torch.Tensor, counts: torch.Tensor, r_cap: int) -> GraphLayer:
    """Packed adjacency -> GraphLayer tensors (build-loop exit)."""
    flat = adj.reshape(adj.shape[0] * 8, 128)
    return GraphLayer(
        neighbors=flat[:, :r_cap].contiguous(),
        scores=flat[:, 64 : 64 + r_cap].contiguous().view(torch.float32),
        counts=counts,
    )


def _enforce_packed_chunk(
    adj: torch.Tensor,  # [N/8, 8, 128] int32, updated in place
    counts: torch.Tensor,  # [N] int32, updated in place
    provider,
    start: int,  # % 8 == 0
    num_nodes: torch.Tensor,
    config: GraphConfig,
    chunk: int,  # % 8 == 0
) -> None:
    """Enforce max degree on a contiguous chunk of packed rows, in place."""
    r_cap = config.row_cap
    M = config.max_degree
    dev = adj.device
    g0 = start // 8
    flat = adj[g0 : g0 + chunk // 8].reshape(chunk, 128)
    e_ids = flat[:, :r_cap]
    e_scores = flat[:, 64 : 64 + r_cap].contiguous().view(torch.float32)
    rows = start + torch.arange(chunk, dtype=torch.int32, device=dev)
    cnt = counts[start : start + chunk]
    valid_row = (rows < num_nodes) & (cnt > 0)
    e_ids = torch.where(torch.arange(r_cap, device=dev)[None, :] < cnt[:, None], e_ids, -1)
    e_scores = torch.where(e_ids >= 0, e_scores, NEG_INF)
    e_scores = tie_break_scores(rows, e_ids, e_scores)
    e_ids_s, e_scores_s = dedup_sorted_desc(e_ids, e_scores)
    simmat = _prune_simmat(provider, e_ids_s)
    p_ids, p_scores, p_count = robust_prune(
        e_ids_s, e_scores_s, simmat, M, config.alphas, algo=config.prune_algo
    )
    new_flat = torch.cat(
        [
            p_ids,
            torch.full((chunk, 64 - M), -1, dtype=torch.int32, device=dev),
            torch.cat(
                [p_scores, torch.full((chunk, r_cap - M), NEG_INF, device=dev)], dim=1
            ).view(torch.int32),
            torch.zeros((chunk, 64 - r_cap), dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    new_flat = torch.where(valid_row[:, None], new_flat, flat)
    new_cnt = torch.where(valid_row, p_count, cnt)
    adj[g0 : g0 + chunk // 8] = new_flat.reshape(chunk // 8, 8, 128)
    counts[start : start + chunk] = new_cnt


def packed_cleanup(
    adj: torch.Tensor,
    counts: torch.Tensor,
    provider,
    config: GraphConfig,
    num_nodes: torch.Tensor,
    chunk: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Enforce max_degree over the whole packed adjacency, in place.

    The tail chunk clamps its start back to ``n_cap - chunk``; re-enforcing
    the overlap rows is idempotent.
    """
    n_cap = adj.shape[0] * 8
    chunk = min(chunk, n_cap)
    starts = list(range(0, n_cap - chunk + 1, chunk))
    if n_cap % chunk:
        starts.append(n_cap - chunk)
    for s in starts:
        _enforce_packed_chunk(adj, counts, provider, s, num_nodes, config, chunk)
    return adj, counts


def _phase_timer(device: torch.device, on_phase: Callable[[str, float], None] | None):
    """Opt-in build phase timing: with ``on_phase`` set, each ``mark(name)``
    syncs the device and calls ``on_phase(name, seconds)`` with the seconds
    since the previous mark."""
    if on_phase is None:
        return lambda name: None
    last = [time.time()]

    def mark(name: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.time()
        on_phase(name, now - last[0])
        last[0] = now

    return mark


def _shuffled_wave_starts(n: int, wave: int, seed: int = 0x5EED) -> list[int]:
    """Deterministically shuffled wave insertion order (numpy, as in the
    JAX package): waves stay contiguous id chunks, clusters interleave."""
    starts = list(range(0, n, wave))
    np.random.default_rng(seed).shuffle(starts)
    return starts


def _fused_aligned_config(cfg: GraphConfig, mp: int) -> GraphConfig:
    """Bump row capacity so fused rows are whole kilobytes (row_cap * MP %
    1024 == 0), e.g. d=128 (MP=64) aligns row_cap 56 -> 64."""
    r = cfg.row_cap
    r2 = r
    while (r2 * mp) % 1024 and r2 < r + 64:
        r2 += 8
    if (r2 * mp) % 1024 or r2 == r:
        return cfg
    return dataclasses.replace(cfg, row_slack=cfg.row_slack + (r2 - r))


@dataclasses.dataclass
class GraphIndexBuilder:
    """Host-side loop around the wave steps::

        graph, provider = GraphIndexBuilder(config).build(vectors, sim)
        graph, pq_prov = GraphIndexBuilder(config).build(vectors, sim, provider=pq.provider(codes, sim))
    """

    config: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    # called by this builder's builds (not by the hierarchy's sub-builds) as
    # on_phase(name, seconds) after each phase, the device synced
    on_phase: Callable[[str, float], None] | None = dataclasses.field(default=None, repr=False, compare=False)

    def build(
        self,
        vectors: torch.Tensor | np.ndarray,
        sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
        provider=None,
        cleanup: bool = True,
        device: torch.device | str | None = None,
    ) -> tuple[GraphIndex, object]:
        """Build the graph on ``device`` (default: the tensor's device, or
        the card for numpy input).

        Without ``provider``, waves search on SQ4 codes (or exactly, with
        ``build_compression=None``) and rescore + prune exactly; the exact
        provider is returned.  An explicit provider (e.g. PQ, padded to the
        capacity) drives the search and the prune as given, and is
        returned.
        """
        sim = SimilarityFunction.parse(sim)
        if device is None and isinstance(vectors, torch.Tensor):
            device = vectors.device
        device = resolve_device(device)
        mark = _phase_timer(device, self.on_phase)
        vectors = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        n, d = vectors.shape
        cfg = self.config
        if provider is None and cfg.build_compression == "sq4":
            cfg = _fused_aligned_config(cfg, (d + 1) // 2)
        w = cfg.wave_size
        n_cap = bucket_capacity(n)
        if provider is None:
            # pad to capacity; padded rows are unreachable (no edge points there)
            pv = torch.nn.functional.pad(vectors, (0, 0, 0, n_cap - n))
            provider = ExactScoreProvider(vectors=pv, sim=sim)
            build_provider = self._sq4_build_provider(vectors, n_cap, sim) if cfg.build_compression == "sq4" else provider
        else:
            build_provider = provider
        # waves are contiguous id ranges: slice the capacity-padded vectors
        # where they exist, else gather with clamped ids
        wave_src = (
            provider.vectors
            if isinstance(provider, ExactScoreProvider) and provider.vectors.shape[0] == n_cap and n_cap % w == 0
            else None
        )

        def wave(start: int) -> tuple[np.ndarray, torch.Tensor, torch.Tensor]:
            ids = np.arange(start, start + w, dtype=np.int32)
            ids = np.where(ids < n, ids, -1)
            ids_dev = torch.as_tensor(ids, device=device)
            if wave_src is not None:
                return ids, ids_dev, wave_src[start : start + w]
            return ids, ids_dev, vectors[torch.clamp(ids_dev, max=n - 1).long()]

        mark("provider prep")
        enforced = False
        if build_provider is not provider and _packed_build_eligible(cfg, build_provider.codes_packed.shape[1], n_cap):
            graph = self._packed_loop(build_provider, provider, wave, n, n_cap, cfg, sim, cleanup, mark)
            enforced = cleanup
        elif build_provider is not provider:
            graph = self._fused_loop(build_provider, provider, wave, n, n_cap, cfg, sim)
        else:
            seeds = _EntrySeedSampler(n, w, cfg.build_entry_seeds)
            graph = _sink_graph(n_cap, cfg, device)
            for start in _shuffled_wave_starts(n, w):
                ids, ids_dev, wv = wave(start)
                graph = _insert_wave(graph, build_provider, ids_dev, wv, cfg, seed_ids=seeds.sample(device))
                seeds.record(ids)
            graph = _drop_sink(graph)
        if not enforced:
            mark("wave loop")
        if cleanup:
            graph = self.cleanup(graph, provider, vectors, enforce=not enforced)
            mark("cleanup")
        if cfg.add_hierarchy:
            graph = self.build_hierarchy(graph, vectors, sim)
            mark("hierarchy")
        return graph, provider

    def _packed_loop(self, build_provider, provider, wave, n, n_cap, cfg, sim, cleanup, mark) -> GraphIndex:
        """The packed-adjacency SQ4 wave loop (K1 + K2), then the packed
        degree enforcement when ``cleanup``."""
        device = provider.vectors.device
        mp = build_provider.codes_packed.shape[1]
        fused_packed = torch.zeros((n_cap, cfg.row_cap * mp // 128, 128), dtype=torch.uint8, device=device)
        adj = _empty_packed_adjacency(n_cap, cfg.row_cap, device)
        w2t = torch.zeros((n_cap // 8, 8, 128), dtype=torch.int32, device=device)
        counts = torch.zeros((n_cap,), dtype=torch.int32, device=device)
        entry = torch.tensor(-1, dtype=torch.int32, device=device)
        num_nodes = torch.tensor(0, dtype=torch.int32, device=device)
        const = build_provider.node_norm2 if sim == SimilarityFunction.COSINE else build_provider.node_w2
        codes_packed = build_provider.codes_packed
        # the search provider reads the tables that the kernels update in place
        bp = dataclasses.replace(build_provider, fused_packed=fused_packed, fused_w2=w2t)
        seeds = _EntrySeedSampler(n, cfg.wave_size, cfg.build_entry_seeds)
        for start in _shuffled_wave_starts(n, cfg.wave_size):
            ids, ids_dev, wv = wave(start)
            beam_ids, beam_scores = _wave_search(adj, bp, entry, ids_dev, wv, cfg, seeds.sample(device))
            seeds.record(ids)
            counts, entry, num_nodes, adj_stream, fused_stream = _wave_update_compute(
                adj, counts, entry, num_nodes, provider, codes_packed, const, ids_dev, wv,
                beam_ids, beam_scores, cfg,
            )
            _wave_apply_packed(adj, w2t, fused_packed, adj_stream, fused_stream)
        del bp, fused_packed, w2t
        if cleanup:
            mark("wave loop")
            packed_cleanup(adj, counts, provider, cfg, num_nodes)
        return GraphIndex(
            layers=(_unpack_adjacency(adj, counts, cfg.row_cap),),
            level_node_ids=(),
            entry_node=entry,
            num_nodes=num_nodes,
            deleted=torch.zeros((n_cap,), dtype=torch.bool, device=device),
        )

    def _fused_loop(self, build_provider, provider, wave, n, n_cap, cfg, sim) -> GraphIndex:
        """The unpacked SQ4 wave loop with incremental fused code tables:
        each wave search gathers one fused row per expansion."""
        device = provider.vectors.device
        mp = build_provider.codes_packed.shape[1]
        k_row = cfg.row_cap * mp
        if k_row % 1024 == 0:
            fused_packed = torch.zeros((n_cap + 1, k_row // 128, 128), dtype=torch.uint8, device=device)
        else:
            fused_packed = torch.zeros((n_cap + 1, k_row), dtype=torch.uint8, device=device)
        fused_w2 = torch.zeros((n_cap + 1, cfg.row_cap), dtype=torch.float32, device=device)
        const = build_provider.node_norm2 if sim == SimilarityFunction.COSINE else build_provider.node_w2
        codes_packed = build_provider.codes_packed
        bp = dataclasses.replace(build_provider, fused_packed=fused_packed, fused_w2=fused_w2)
        seeds = _EntrySeedSampler(n, cfg.wave_size, cfg.build_entry_seeds)
        graph = _sink_graph(n_cap, cfg, device)
        for start in _shuffled_wave_starts(n, cfg.wave_size):
            ids, ids_dev, wv = wave(start)
            beam_ids, beam_scores = _wave_search(
                graph.base.neighbors, bp, graph.entry_node, ids_dev, wv, cfg, seeds.sample(device)
            )
            seeds.record(ids)
            graph = _wave_update_fused(
                graph, fused_packed, fused_w2, provider, codes_packed, const, ids_dev, wv,
                beam_ids, beam_scores, cfg,
            )
        return _drop_sink(graph)

    def _sq4_build_provider(self, vectors: torch.Tensor, n_cap: int, sim) -> SQ4ScoreProvider:
        """SQ4 working set for construction (augmented rows; the fused
        tables are attached by the build loop)."""
        n = vectors.shape[0]
        sq = ScalarQuantization4.compute(vectors)  # random-samples the corpus
        codes = torch.nn.functional.pad(sq.encode(vectors), (0, 0, 0, n_cap - n))
        w2, norm2 = sq.node_constants(codes)
        const = norm2 if sim == SimilarityFunction.COSINE else w2
        empty = torch.zeros((n_cap, 0), device=vectors.device)
        return SQ4ScoreProvider(
            codes_packed=codes,
            node_w2=w2,
            node_norm2=norm2,
            fused_packed=empty.to(torch.uint8),
            fused_w2=empty,
            scale=sq.scale,
            offset=sq.offset,
            codes_aug=sq4_aug_rows(codes, const),
            sim=sim,
        )

    def build_hierarchy(
        self, graph: GraphIndex, vectors: torch.Tensor, sim: SimilarityFunction, seed: int = 0
    ) -> GraphIndex:
        """HNSW-style upper levels as batched Vamana subgraphs: levels are
        drawn up front (reference ``getRandomGraphLevel``) and each level is
        an ordinary wave build over its subset, stored in slot space."""
        levels = assign_levels(int(graph.num_nodes), self.config.max_degree, seed)
        sub_ids = np.where(levels >= 1)[0].astype(np.int32)
        sub_vectors = vectors[torch.as_tensor(sub_ids, device=vectors.device).long()]
        return self.build_hierarchy_from_subset(graph, sub_ids, sub_vectors, levels[sub_ids], sim)

    def build_hierarchy_from_subset(
        self,
        graph: GraphIndex,
        sub_ids: np.ndarray,  # int32 [S] base ordinals with level >= 1
        sub_vectors: torch.Tensor,  # [S, D] those nodes' vectors
        sub_levels: np.ndarray,  # int32 [S] each sub node's level
        sim: SimilarityFunction,
    ) -> GraphIndex:
        """Attach upper levels given only the level >= 1 nodes' vectors.
        Each level with more than one node is an SQ4 (or exact) sub-build
        with ``wave_size`` cut to the level's size (at least 32)."""
        cfg = self.config
        device = sub_vectors.device
        layers, node_ids = [graph.base], []
        max_level = int(sub_levels.max()) if len(sub_levels) else 0
        for level in range(1, max_level + 1):
            local = np.where(sub_levels >= level)[0].astype(np.int32)
            if len(local) == 0:
                break
            ids = torch.as_tensor(sub_ids[local], device=device)
            if len(local) == 1:
                layers.append(empty_layer(1, cfg.row_cap, device))
                node_ids.append(ids)
                continue
            sub_cfg = dataclasses.replace(cfg, wave_size=min(cfg.wave_size, max(32, len(local))), add_hierarchy=False)
            sub_graph, _ = GraphIndexBuilder(sub_cfg).build(
                sub_vectors[torch.as_tensor(local, device=device).long()], sim, cleanup=True
            )
            layers.append(sub_graph.base)
            node_ids.append(ids)
        return graph._replace(layers=tuple(layers), level_node_ids=tuple(node_ids))

    def cleanup(self, graph: GraphIndex, provider, vectors: torch.Tensor | None = None, enforce: bool = True) -> GraphIndex:
        """Enforce the max degree (in place) and recompute the entry point
        as the node nearest the centroid (reference ``cleanup():472-508``).
        ``enforce=False`` skips the degree pass (the packed build has run
        :func:`packed_cleanup` already)."""
        cfg = self.config
        chunk = min(4096, max(cfg.wave_size, 64))
        for start in range(0, graph.capacity, chunk) if enforce else ():
            graph = _enforce_chunk(graph, provider, start, cfg, chunk)
        if vectors is None:
            return graph
        centroid = torch.mean(vectors, dim=0, keepdim=True)
        qstate = provider.prepare(centroid)
        n = vectors.shape[0]
        chunk = 1 << 20  # bounds the [1, chunk, ...] scoring transient
        best_score, best_id = -float("inf"), 0
        for a in range(0, n, chunk):
            ids = torch.arange(a, min(a + chunk, n), dtype=torch.int32, device=vectors.device)
            sc = provider.score(qstate, ids[None, :])[0]
            i = int(torch.argmax(sc))
            s = float(sc[i])
            if s > best_score:
                best_score, best_id = s, a + i
        return graph._replace(entry_node=torch.tensor(best_id, dtype=torch.int32, device=vectors.device))


def build_graph(
    vectors,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    config: GraphConfig | None = None,
    provider=None,
    device: torch.device | str | None = None,
) -> tuple[GraphIndex, object]:
    """One-call bulk build (reference ``GraphIndexBuilder.build(ravv)``)."""
    return GraphIndexBuilder(config or GraphConfig()).build(vectors, sim, provider=provider, device=device)
