"""Query-wave batched beam search (counterpart of ``jvector_tpu/graph/searcher.py``).

A whole wave of Q queries advances in lock-step over a fixed-width beam of
``beam_width`` score-sorted slots with an ``expanded`` flag each; the visited
set is an exact compare-based dedup against the beam, a ring of expanded ids
(``history``) and earlier candidates of the same step.  ``expand_per_iter``
(E) pops the E best unexpanded slots per step.

The JAX package runs the loop as a device ``lax.while_loop``.  Here it is a
Python loop whose stop test ("no query has an unexpanded slot left") reads
the device every ``CHECK_EVERY`` steps.  A query with nothing left to expand
is a fixed point of a step (no pops, no new candidates, and the stable
re-sort of an already sorted beam is the identity), so the extra steps after
the last query finishes change no id, score or count: the results do not
depend on ``CHECK_EVERY``, and the step count is capped at ``max_iters``
exactly as in the JAX loop.

Every sort is stable and every top-E pick takes the lowest index among
equal scores, as ``lax.sort``, ``jnp.argsort`` and ``lax.top_k`` do, so ties
resolve as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from jvector_tpu_torch.graph.hierarchy import LevelProvider, slots_for
from jvector_tpu_torch.graph.index import NEG_INF, GraphIndex

CHECK_EVERY = 8  # steps between the host's reads of the stop test


class SearchResult(NamedTuple):
    """Per-wave result: ``[Q, k]`` ids/scores + counters (reference ``SearchResult``)."""

    ids: torch.Tensor  # int32 [Q, k]
    scores: torch.Tensor  # float32 [Q, k]
    visited_count: torch.Tensor  # int32 [Q]
    expanded_count: torch.Tensor  # int32 [Q]
    reranked_count: torch.Tensor  # int32 [Q]
    approx_scores: torch.Tensor  # float32 [Q, k] first-pass scores of the results


class BeamState(NamedTuple):
    """Beam-loop state (the continuation a repacked tail resumes from)."""

    ids: torch.Tensor  # int32 [Q, L]
    scores: torch.Tensor  # float32 [Q, L]
    expanded: torch.Tensor  # bool [Q, L]
    history: torch.Tensor  # int32 [Q, T] ring of expanded ids (-1 padded)
    visited_count: torch.Tensor  # int32 [Q]
    expanded_count: torch.Tensor  # int32 [Q]
    iters: int  # steps taken (host-side)


def _history_len(expand_per_iter: int, max_iters: int, beam_width: int) -> int:
    """Ring size: 2x the beam, a multiple of 128 and of E."""
    t = min(expand_per_iter * max_iters, max(128, 2 * beam_width))
    step = 128
    while step % expand_per_iter:  # keep T a multiple of E so ring writes
        step += 128  # never straddle the wrap point
    return max(((t + step - 1) // step) * step, step)


def _strictly_lower(c: int, device) -> torch.Tensor:
    """``[c, c]`` mask, True where column < row (an earlier entry)."""
    return torch.ones((c, c), dtype=torch.bool, device=device).tril(diagonal=-1)


def _dedup_new(new_ids: torch.Tensor, beam_ids: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """Fresh mask for ``new_ids [Q, C]`` vs beam ``[Q, L]``, history ``[Q, T]``
    and earlier same-step candidates.  Pure dense equality reductions."""
    n = new_ids[:, :, None]
    dup = (n == beam_ids[:, None, :]).any(dim=2)
    dup |= (n == history[:, None, :]).any(dim=2)
    eq = n == new_ids[:, None, :]
    dup |= (eq & _strictly_lower(new_ids.shape[1], new_ids.device)[None]).any(dim=2)
    return ~dup


def _merge_beam(beam_ids, beam_scores, beam_expanded, new_ids, new_scores):
    """Merge new scored candidates into the beam, keep the top L by score
    (stable, so equal scores keep beam-first, then candidate order)."""
    L = beam_ids.shape[1]
    ids = torch.cat([beam_ids, new_ids], dim=1)
    scores = torch.cat([beam_scores, new_scores], dim=1)
    expanded = torch.cat([beam_expanded, torch.zeros_like(new_ids, dtype=torch.bool)], dim=1)
    order = torch.argsort(-scores, dim=1, stable=True)[:, :L]
    return (
        torch.gather(ids, 1, order),
        torch.gather(scores, 1, order),
        torch.gather(expanded, 1, order),
    )


def _top_e(scores: torch.Tensor, e: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``e`` best entries per row, the lowest index first among equal
    scores (``lax.top_k``'s order).  Indices picked after the finite
    entries run out are arbitrary; callers mask them by score."""
    vals, idxs = [], []
    s = scores
    for k in range(e):
        v, i = s.max(dim=1)  # max returns the first maximal index
        vals.append(v)
        idxs.append(i)
        if k + 1 < e:
            s = s.scatter(1, i[:, None], NEG_INF)
    return torch.stack(vals, dim=1), torch.stack(idxs, dim=1)


def _has_unexpanded(s: BeamState) -> torch.Tensor:
    return (~s.expanded & (s.scores > NEG_INF)).any(dim=1)


def _step(s: BeamState, graph_neighbors, provider, qstate, E, R, packed_rows, use_fused) -> BeamState:
    """One lock-step iteration: pop E slots per query, expand, score, merge."""
    Q, Lc = s.ids.shape
    sel_scores = torch.where(s.expanded, NEG_INF, s.scores)
    top_scores, sel_idx = _top_e(sel_scores, E)  # [Q, E]
    active = top_scores > NEG_INF
    sel_ids = torch.gather(s.ids, 1, sel_idx)
    safe_sel = torch.where(active, sel_ids, 0)
    pos_l = torch.arange(Lc, device=s.ids.device)
    hit = ((pos_l[None, :, None] == sel_idx[:, None, :]) & active[:, None, :]).any(dim=2)
    expanded = s.expanded | hit

    history = s.history  # updated in place: the loop owns its state
    pos = (s.iters * E) % history.shape[1]
    history[:, pos : pos + E] = torch.where(active, sel_ids, -1)

    if packed_rows is not None:
        ss = safe_sel.long()
        nbrs = graph_neighbors[ss >> 3, ss & 7][..., :R].reshape(Q, -1)
    else:
        nbrs = graph_neighbors[safe_sel.long()].reshape(Q, -1)
    valid = (nbrs >= 0) & active.repeat_interleave(R, dim=1)
    nbrs = torch.where(valid, nbrs, -1)
    fresh = valid & _dedup_new(nbrs, s.ids, history)
    if use_fused:
        edge_scores = provider.score_edges(qstate, safe_sel)
    else:
        edge_scores = provider.score(qstate, torch.where(fresh, nbrs, 0))
    new_scores = torch.where(fresh, edge_scores, NEG_INF)
    new_ids = torch.where(fresh, nbrs, -1)
    ids3, scores3, expanded3 = _merge_beam(s.ids, s.scores, expanded, new_ids, new_scores)
    return BeamState(
        ids=ids3,
        scores=scores3,
        expanded=expanded3,
        history=history,
        visited_count=s.visited_count + fresh.sum(dim=1, dtype=torch.int32),
        expanded_count=s.expanded_count + active.sum(dim=1, dtype=torch.int32),
        iters=s.iters + 1,
    )


def _init_state(provider, qstate, entry_ids: torch.Tensor, L: int, T: int) -> BeamState:
    """Dedup and score the entry points, seed a sorted beam."""
    if entry_ids.dim() == 1:
        entry_ids = entry_ids[:, None]
    Q, E0 = entry_ids.shape
    dev = entry_ids.device
    if E0 > 1:
        eq = entry_ids[:, :, None] == entry_ids[:, None, :]
        dup = (eq & _strictly_lower(E0, dev)[None]).any(dim=2)
        entry_ids = torch.where(dup, -1, entry_ids)
    entry_scores = torch.where(
        entry_ids >= 0, provider.score(qstate, torch.clamp(entry_ids, min=0)), NEG_INF
    )
    beam_ids = torch.cat([entry_ids, torch.full((Q, L - E0), -1, dtype=torch.int32, device=dev)], dim=1)
    beam_scores = torch.cat([entry_scores, torch.full((Q, L - E0), NEG_INF, device=dev)], dim=1)
    order = torch.argsort(-beam_scores, dim=1, stable=True)
    return BeamState(
        ids=torch.gather(beam_ids, 1, order),
        scores=torch.gather(beam_scores, 1, order),
        expanded=torch.zeros((Q, L), dtype=torch.bool, device=dev),
        history=torch.full((Q, T), -1, dtype=torch.int32, device=dev),
        visited_count=(entry_ids >= 0).sum(dim=1, dtype=torch.int32),
        expanded_count=torch.zeros((Q,), dtype=torch.int32, device=dev),
        iters=0,
    )


def search_layer(
    graph_neighbors: torch.Tensor,  # int32 [N, R] (or packed [N/8, 8, 128])
    provider,
    qstate,
    entry_ids: torch.Tensor | None,  # int32 [Q] or [Q, E0] initial candidates
    beam_width: int,
    max_iters: int = 1000,
    expand_per_iter: int = 1,
    init_state: BeamState | None = None,  # pure continuation (repacked tail)
    packed_rows: int | None = None,  # packed build adjacency: ids in lanes
    # [0:packed_rows] of the [N/8, 8, 128] int32 table, one 512-byte
    # physical-row gather per expansion
) -> BeamState:
    """Run beam search to quiescence (or ``max_iters``) on one layer and
    return the final beam, sorted by score descending."""
    R = packed_rows if packed_rows is not None else graph_neighbors.shape[1]
    E = expand_per_iter
    if init_state is None:
        T = _history_len(E, max_iters, beam_width)
        state = _init_state(provider, qstate, entry_ids, beam_width, T)
    else:
        state = init_state
    use_fused = getattr(provider, "supports_fused", False)
    while state.iters < max_iters and bool(_has_unexpanded(state).any()):
        for _ in range(min(CHECK_EVERY, max_iters - state.iters)):
            state = _step(state, graph_neighbors, provider, qstate, E, R, packed_rows, use_fused)
    return state


def _descend_hierarchy(graph: GraphIndex, provider, qstate, n_queries: int) -> torch.Tensor:
    """Upper-layer descent: per-query layer-0 entry ids ``[Q]``.

    Seeds by scoring all top-level nodes in one batched call, then runs a
    beam of width 1 on each middle level, as the reference descends
    (``GraphSearcher.internalSearch:263-282``).
    """
    top_ids = graph.level_node_ids[-1]
    scores = provider.score(qstate, top_ids[None, :].expand(n_queries, -1))
    scores = torch.where(graph.deleted[top_ids.long()][None, :], NEG_INF, scores)
    best = top_ids[torch.argmax(scores, dim=1)]
    # every top node a hole: fall back to the (live) entry point
    best = torch.where(scores.max(dim=1).values > NEG_INF, best, graph.entry_node.to(torch.int32))
    for level in range(graph.num_levels - 2, 0, -1):
        ids_l = graph.level_node_ids[level - 1]
        beam = search_layer(
            graph.layers[level].neighbors,
            LevelProvider(inner=provider, node_ids=ids_l),
            qstate,
            slots_for(ids_l, best),
            beam_width=1,
            max_iters=64,
        )
        best = ids_l[torch.clamp(beam.ids[:, 0], 0, ids_l.shape[0] - 1).long()]
    return best


def _take_qstate(qstate, lanes: torch.Tensor):
    if isinstance(qstate, tuple):
        return tuple(a[lanes] for a in qstate)
    return qstate[lanes]


def _repack_tail(
    graph_neighbors: torch.Tensor,
    provider,
    qstate,
    final: BeamState,
    beam_width: int,
    max_iters: int,
    expand_per_iter: int,
    packed_rows: int | None = None,
) -> BeamState:
    """Finish a cut-short wave's convergence tail at quarter width.

    Gathers the still-active lanes of ``final`` (lowest lane first, then
    converged filler), continues them to quiescence, and writes the
    finished lanes back.  Active lanes beyond the sub-wave width stay
    frozen — the ``max_iters``-cutoff semantics.
    """
    Q = final.ids.shape[0]
    active = _has_unexpanded(final)
    w2 = max(32, (Q // 4) // 8 * 8)
    lanes = torch.argsort(active.to(torch.int32), descending=True, stable=True)[:w2]
    sub = BeamState(
        ids=final.ids[lanes],
        scores=final.scores[lanes],
        expanded=final.expanded[lanes],
        history=final.history[lanes],
        visited_count=final.visited_count[lanes],
        expanded_count=final.expanded_count[lanes],
        iters=final.iters,
    )
    sub_fin = search_layer(
        graph_neighbors,
        provider,
        _take_qstate(qstate, lanes),
        None,
        beam_width=beam_width,
        max_iters=max_iters,
        expand_per_iter=expand_per_iter,
        init_state=sub,
        packed_rows=packed_rows,
    )

    def put(full: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
        out = full.clone()
        out[lanes] = part
        return out

    return BeamState(
        ids=put(final.ids, sub_fin.ids),
        scores=put(final.scores, sub_fin.scores),
        expanded=put(final.expanded, sub_fin.expanded),
        history=put(final.history, sub_fin.history),
        visited_count=put(final.visited_count, sub_fin.visited_count),
        expanded_count=put(final.expanded_count, sub_fin.expanded_count),
        iters=sub_fin.iters,
    )


def search(
    graph: GraphIndex,
    provider,
    queries: torch.Tensor,  # [Q, D] on the graph's device
    top_k: int,
    beam_width: int | None = None,
    rerank_k: int | None = None,
    reranker=None,
    max_iters: int = 1000,
    expand_per_iter: int = 1,
    entry_seeds: int = 1,
    repack_after: int = 0,
) -> SearchResult:
    """Two-pass wave search (reference ``GraphSearcher.search:222-243``).

    The first pass descends the hierarchy, if the graph has one, then runs
    the layer-0 beam with ``provider`` (exact, SQ4 or PQ); with a
    ``reranker``, the top ``rerank_k`` beam entries get exact scores and
    the final top-k comes from those.  On a flat graph, ``entry_seeds > 1``
    adds k-1 ordinal-strided entries; ``repack_after > 0`` cuts the
    lock-step wave after that many steps and finishes the still-active
    lanes in a quarter-width sub-wave (identical results whenever the
    active tail fits).

    Filtered search, thresholds and resume are not in this port yet.
    """
    if beam_width is None:
        beam_width = max(top_k, 100)
    if rerank_k is None:
        rerank_k = beam_width if reranker is not None else top_k
    qstate = provider.prepare(queries)
    Q = queries.shape[0]
    if graph.num_levels > 1:
        entries = _descend_hierarchy(graph, provider, qstate, Q)
    else:
        entries = graph.entry_node.to(torch.int32).expand(Q)
    if graph.num_levels == 1 and entry_seeds > 1:
        entry_seeds = min(entry_seeds, beam_width)
        s = torch.arange(1, entry_seeds, dtype=torch.int32, device=queries.device)
        strided = s * torch.div(graph.num_nodes, entry_seeds, rounding_mode="floor").to(torch.int32)
        entries = torch.cat([entries[:, None], strided[None].expand(Q, -1)], dim=1)

    repack = 0 < repack_after < max_iters and Q >= 64
    neighbors = graph.base.neighbors
    final = search_layer(
        neighbors,
        provider,
        qstate,
        entries,
        beam_width=beam_width,
        max_iters=repack_after if repack else max_iters,
        expand_per_iter=expand_per_iter,
    )
    if repack:
        final = _repack_tail(
            neighbors, provider, qstate, final, beam_width, max_iters, expand_per_iter
        )

    def filter_allowed(ids, scores):
        """Drop tombstoned nodes (deleted nodes stay traversable)."""
        ok = (ids >= 0) & ~graph.deleted[torch.clamp(ids, min=0).long()]
        return torch.where(ok, ids, -1), torch.where(ok, scores, NEG_INF)

    if reranker is None:
        ids, scores = filter_allowed(final.ids, final.scores)
        order = torch.argsort(-scores, dim=1, stable=True)[:, :top_k]
        ids, scores = torch.gather(ids, 1, order), torch.gather(scores, 1, order)
        return SearchResult(
            ids=ids,
            scores=scores,
            visited_count=final.visited_count,
            expanded_count=final.expanded_count,
            reranked_count=torch.zeros((Q,), dtype=torch.int32, device=ids.device),
            approx_scores=scores,
        )

    cand_ids, cand_scores = filter_allowed(final.ids[:, :rerank_k], final.scores[:, :rerank_k])
    cand_valid = cand_ids >= 0
    exact = reranker.score(reranker.prepare(queries), torch.clamp(cand_ids, min=0))
    exact = torch.where(cand_valid, exact, NEG_INF)
    order = torch.argsort(-exact, dim=1, stable=True)[:, :top_k]
    return SearchResult(
        ids=torch.gather(cand_ids, 1, order),
        scores=torch.gather(exact, 1, order),
        visited_count=final.visited_count,
        expanded_count=final.expanded_count,
        reranked_count=cand_valid.sum(dim=1, dtype=torch.int32),
        approx_scores=torch.gather(cand_scores, 1, order),
    )
