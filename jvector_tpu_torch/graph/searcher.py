"""Query-wave batched beam search (counterpart of ``jvector_tpu/graph/searcher.py``).

A whole wave of Q queries advances in lock-step over a fixed-width beam of
``beam_width`` score-sorted slots with an ``expanded`` flag each; the visited
set is an exact compare-based dedup against the beam, a ring of expanded ids
(``history``) and earlier candidates of the same step (the frontier filter,
one K8 launch a step on the card: ``ops/kernels/frontier.py``).
``expand_per_iter`` (E) pops the E best unexpanded slots per step.

The JAX package runs the loop as a device ``lax.while_loop``.  Here it is a
Python loop whose stop test ("no query has a slot left to pop") reads the
device every ``CHECK_EVERY`` steps.  Every stop rule is a per-query mask
inside the step (a filtered query pops nothing that cannot beat its worst
accepted result; a threshold search retires a query by marking its beam
expanded), so a query with nothing left to pop is a fixed point of a step:
no pops, no new candidates, and the stable re-sort of an already sorted beam
is the identity.  The extra steps after the last query finishes change no
id, score or count, so the results do not depend on ``CHECK_EVERY``, and
the step count is capped at ``max_iters`` exactly as in the JAX loop.  Only
the state's bookkeeping (the history ring, the step count, the stale
counters) would differ, so a search that returns its state for a later
``resume`` reads the stop test every step.

Every sort is stable and every top-E pick takes the lowest index among
equal scores, as ``lax.sort``, ``jnp.argsort`` and ``lax.top_k`` do, so ties
resolve as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from jvector_tpu_torch import tracing
from jvector_tpu_torch.graph.diversity import dedup_sorted_desc
from jvector_tpu_torch.graph.hierarchy import LevelProvider, slots_for
from jvector_tpu_torch.graph.index import NEG_INF, GraphIndex
from jvector_tpu_torch.ops.kernels.frontier import _strictly_lower, frontier_filter

CHECK_EVERY = 8  # steps between the host's reads of the stop test
# threshold search: consecutive steps below the threshold that retire a
# query (the JAX package's default, characterised there: 100% retention)
STOP_PATIENCE = 32


class SearchResult(NamedTuple):
    """Per-wave result: ``[Q, k]`` ids/scores + counters (reference ``SearchResult``)."""

    ids: torch.Tensor  # int32 [Q, k]
    scores: torch.Tensor  # float32 [Q, k]
    visited_count: torch.Tensor  # int32 [Q]
    expanded_count: torch.Tensor  # int32 [Q]
    reranked_count: torch.Tensor  # int32 [Q]
    approx_scores: torch.Tensor  # float32 [Q, k] first-pass scores of the results


class BeamState(NamedTuple):
    """Beam-loop state; also the resumable continuation (reference evicted state)."""

    ids: torch.Tensor  # int32 [Q, L]
    scores: torch.Tensor  # float32 [Q, L]
    expanded: torch.Tensor  # bool [Q, L]
    history: torch.Tensor  # int32 [Q, T] ring of expanded ids (-1 padded)
    visited_count: torch.Tensor  # int32 [Q]
    expanded_count: torch.Tensor  # int32 [Q]
    iters: int  # steps taken (host-side)
    # consecutive steps whose best new candidate stayed below the threshold
    # (ScoreTracker early termination)
    stale: torch.Tensor | None = None  # int32 [Q]
    # filtered search (acceptOrds): the top-K accepted nodes found so far
    res_ids: torch.Tensor | None = None  # int32 [Q, K]
    res_scores: torch.Tensor | None = None  # float32 [Q, K]


def _history_len(expand_per_iter: int, max_iters: int, beam_width: int) -> int:
    """Ring size: 2x the beam, a multiple of 128 and of E."""
    t = min(expand_per_iter * max_iters, max(128, 2 * beam_width))
    step = 128
    while step % expand_per_iter:  # keep T a multiple of E so ring writes
        step += 128  # never straddle the wrap point
    return max(((t + step - 1) // step) * step, step)


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


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim, lowest index first among ties (``lax.top_k``)."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, order), order


def _top_sorted(ids: torch.Tensor, scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best ``(ids, scores)`` per row, stable (``lax.sort`` on -score)."""
    scores, order = _top_k_stable(scores, k)
    return torch.gather(ids, 1, order), scores


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


def _live(s: BeamState) -> torch.Tensor:
    """Per query: an unexpanded slot that may still be popped (filtered: one
    that can beat the worst accepted result)."""
    floor = s.res_scores[:, -1:] if s.res_scores is not None else NEG_INF
    return (~s.expanded & (s.scores > floor)).any(dim=1)


def _step(
    s: BeamState, graph_neighbors, provider, qstate, E, R, packed_rows, use_fused,
    accept: torch.Tensor | None = None, stop_threshold: float = 0.0,
) -> BeamState:
    """One lock-step iteration: pop E slots per query, expand, score, merge."""
    Q, Lc = s.ids.shape
    sel_scores = torch.where(s.expanded, NEG_INF, s.scores)
    top_scores, sel_idx = _top_e(sel_scores, E)  # [Q, E]
    active = top_scores > NEG_INF
    if accept is not None:
        # pop nothing that can no longer improve the accepted top-K
        active &= top_scores > s.res_scores[:, -1:]
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
    fresh, new_ids, safe_nbrs = frontier_filter(nbrs, active, R, s.ids, history)
    if use_fused:
        edge_scores = provider.score_edges(qstate, safe_sel)
    else:
        edge_scores = provider.score(qstate, safe_nbrs)
    new_scores = torch.where(fresh, edge_scores, NEG_INF)

    res_ids, res_scores = s.res_ids, s.res_scores
    beam_ids, beam_scores = s.ids, s.scores
    if accept is not None:
        # accepted discoveries join the result channel; popped slots leave
        # the beam, which is a pure frontier in filtered mode (history
        # dedup covers revisits of purged nodes)
        acc_new = fresh & accept[safe_nbrs.long()]
        res_ids, res_scores = _top_sorted(
            torch.cat([s.res_ids, torch.where(acc_new, nbrs, -1)], dim=1),
            torch.cat([s.res_scores, torch.where(acc_new, new_scores, NEG_INF)], dim=1),
            s.res_ids.shape[1],
        )
        beam_ids = torch.where(hit, -1, s.ids)
        beam_scores = torch.where(hit, NEG_INF, s.scores)
    ids3, scores3, expanded3 = _merge_beam(beam_ids, beam_scores, expanded, new_ids, new_scores)
    stale = s.stale
    if stop_threshold > 0:
        best_new = new_scores.max(dim=1).values
        stale = torch.where(best_new >= stop_threshold, 0, s.stale + 1)
        # retire queries stuck below the threshold: freeze their beams
        expanded3 = expanded3 | (stale >= STOP_PATIENCE)[:, None]
    return BeamState(
        ids=ids3,
        scores=scores3,
        expanded=expanded3,
        history=history,
        visited_count=s.visited_count + fresh.sum(dim=1, dtype=torch.int32),
        expanded_count=s.expanded_count + active.sum(dim=1, dtype=torch.int32),
        iters=s.iters + 1,
        stale=stale,
        res_ids=res_ids,
        res_scores=res_scores,
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


def _continue_state(state: BeamState, L: int, E: int, R: int, reopen_quiescent: bool) -> BeamState:
    """A continuation's starting state: the beam widened to ``L``, and (with
    ``reopen_quiescent``) the bottom valid slots of finished queries
    re-opened, so that paging past the old beam finds new candidates near
    its floor (the evicted pool the reference's ``resume()`` mines).  The
    history is copied: the loop writes its ring in place."""
    Q, L_old = state.ids.shape
    dev = state.ids.device
    if L_old < L:
        pad = L - L_old
        state = state._replace(
            ids=torch.cat([state.ids, torch.full((Q, pad), -1, dtype=torch.int32, device=dev)], dim=1),
            scores=torch.cat([state.scores, torch.full((Q, pad), NEG_INF, device=dev)], dim=1),
            expanded=torch.cat([state.expanded, torch.zeros((Q, pad), dtype=torch.bool, device=dev)], dim=1),
        )
    state = state._replace(history=state.history.clone())
    if reopen_quiescent:
        k_reopen = max(E, -(-(L - L_old) // R))
        valid = state.scores > NEG_INF
        quiescent = ~(~state.expanded & valid).any(dim=1, keepdim=True)
        pos = torch.arange(state.ids.shape[1], device=dev)[None, :]
        vc = valid.sum(dim=1, keepdim=True)
        reopen = quiescent & (pos >= vc - k_reopen) & (pos < vc)
        state = state._replace(expanded=state.expanded & ~reopen)
    return state


def search_layer(
    graph_neighbors: torch.Tensor,  # int32 [N, R] (or packed [N/8, 8, 128])
    provider,
    qstate,
    entry_ids: torch.Tensor | None,  # int32 [Q] or [Q, E0] initial candidates
    beam_width: int,
    max_iters: int = 1000,
    expand_per_iter: int = 1,
    init_state: BeamState | None = None,  # continue from this state
    packed_rows: int | None = None,  # packed build adjacency: ids in lanes
    # [0:packed_rows] of the [N/8, 8, 128] int32 table, one 512-byte
    # physical-row gather per expansion
    stop_threshold: float = 0.0,
    reopen_quiescent: bool = True,  # False: a pure continuation (repacked tail)
    accept: torch.Tensor | None = None,  # bool [N]: filtered search when given
    result_k: int | None = None,  # result-channel width in filtered mode
    check_every: int = CHECK_EVERY,
) -> BeamState:
    """Run beam search to quiescence (or ``max_iters``) on one layer and
    return the final beam, sorted by score descending.

    ``stop_threshold > 0`` retires a query whose best new candidate stayed
    below the threshold for ``STOP_PATIENCE`` consecutive steps (reference
    ``ScoreTracker``).  With ``accept``, accepted discoveries accumulate in
    the state's ``res_ids`` / ``res_scores`` channel (width ``result_k``,
    default the beam) and the search expands until no candidate can beat the
    worst accepted result; the dedup ring is twice as deep.
    """
    R = packed_rows if packed_rows is not None else graph_neighbors.shape[1]
    E = expand_per_iter
    L = beam_width
    filtered = accept is not None
    if init_state is None:
        T = _history_len(E, max_iters, 2 * L if filtered else L)
        state = _init_state(provider, qstate, entry_ids, L, T)
    else:
        state = _continue_state(init_state, L, E, R, reopen_quiescent)
    Q = state.ids.shape[0]
    dev = state.ids.device
    if stop_threshold > 0 and state.stale is None:
        state = state._replace(stale=torch.zeros((Q,), dtype=torch.int32, device=dev))
    if filtered and state.res_ids is None:
        # seed the result channel with the accepted entry points
        K = result_k or L
        acc_e = (state.ids >= 0) & accept[torch.clamp(state.ids, min=0).long()]
        res_ids, res_scores = _top_sorted(
            torch.cat([torch.where(acc_e, state.ids, -1), torch.full((Q, K), -1, dtype=torch.int32, device=dev)], 1),
            torch.cat([torch.where(acc_e, state.scores, NEG_INF), torch.full((Q, K), NEG_INF, device=dev)], 1),
            K,
        )
        state = state._replace(res_ids=res_ids, res_scores=res_scores)
    use_fused = getattr(provider, "supports_fused", False)
    iters0, pops0, k8_0 = state.iters, state.expanded_count, frontier_filter.launches
    while state.iters < max_iters:
        with tracing.span("beam.stop_test"):
            live = bool(_live(state).any())
        if not live:
            break
        for _ in range(min(check_every, max_iters - state.iters)):
            with tracing.span("beam.step"):
                state = _step(
                    state, graph_neighbors, provider, qstate, E, R, packed_rows, use_fused,
                    accept, stop_threshold,
                )
    tracing.add("beam.lane_slots", (state.iters - iters0) * Q * E)
    tracing.add("beam.pops", lambda: (state.expanded_count - pops0).sum())
    tracing.add("beam.frontier_kernel", frontier_filter.launches - k8_0)
    return state


def _descend_hierarchy(
    graph: GraphIndex, provider, qstate, n_queries: int, hierarchy_beam: int = 1
) -> torch.Tensor:
    """Upper-layer descent: per-query layer-0 entry ids ``[Q]``.

    Seeds by scoring all top-level nodes in one batched call, then runs a
    beam of width ``hierarchy_beam`` on each middle level (the reference
    descends with beam 1, ``GraphSearcher.internalSearch:263-282``).
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
            beam_width=hierarchy_beam,
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
    active = _live(final)
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
        reopen_quiescent=False,
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


def _entries(graph: GraphIndex, provider, qstate, Q: int, beam_width: int, hierarchy_beam: int,
             entry_seeds: int) -> torch.Tensor:
    """Layer-0 entry ids: the hierarchy's descent, or the entry node plus
    ``entry_seeds - 1`` ordinal-strided seeds on a flat graph."""
    if graph.num_levels > 1:
        return _descend_hierarchy(graph, provider, qstate, Q, hierarchy_beam)
    entries = graph.entry_node.to(torch.int32).expand(Q)
    if entry_seeds > 1:
        entry_seeds = min(entry_seeds, beam_width)
        s = torch.arange(1, entry_seeds, dtype=torch.int32, device=entries.device)
        strided = s * torch.div(graph.num_nodes, entry_seeds, rounding_mode="floor").to(torch.int32)
        entries = torch.cat([entries[:, None], strided[None].expand(Q, -1)], dim=1)
    return entries


def _as_mask(graph: GraphIndex, accept) -> torch.Tensor:
    """An accept mask (numpy or tensor) as a bool tensor on the graph's
    device, padded False over the capacity slack."""
    acc = torch.as_tensor(accept, device=graph.deleted.device).to(torch.bool)
    if acc.shape[0] < graph.capacity:
        acc = torch.cat([acc, torch.zeros(graph.capacity - acc.shape[0], dtype=torch.bool, device=acc.device)])
    return acc


def _wave(
    graph: GraphIndex,
    provider,
    qstate,
    entries: torch.Tensor | None,  # None with init_state
    Q: int,
    top_k: int,
    beam_width: int,
    rerank_k: int,
    reranker,
    rerank_qstate,  # the reranker's query state (a thunk: prepared only when needed)
    max_iters: int = 1000,
    accept: torch.Tensor | None = None,
    rerank_floor: torch.Tensor | None = None,
    expand_per_iter: int = 1,
    threshold: float = 0.0,
    exclude_ids: torch.Tensor | None = None,
    return_state: bool = False,
    init_state: BeamState | None = None,
    repack_after: int = 0,
):
    """One two-pass wave from prepared query state (``_search_jit``)."""
    in_loop_accept = accept is not None and init_state is None
    accept_mask = accept & ~graph.deleted if in_loop_accept else None
    repack = (
        0 < repack_after < max_iters and init_state is None and accept_mask is None and threshold == 0.0 and Q >= 64
    )
    neighbors = graph.base.neighbors
    final = search_layer(
        neighbors,
        provider,
        qstate,
        entries,
        beam_width=beam_width,
        max_iters=repack_after if repack else max_iters,
        expand_per_iter=expand_per_iter,
        init_state=init_state,
        stop_threshold=threshold,
        accept=accept_mask,
        result_k=max(rerank_k, top_k) if in_loop_accept else None,
        check_every=1 if return_state else CHECK_EVERY,
    )
    if repack:
        final = _repack_tail(neighbors, provider, qstate, final, beam_width, max_iters, expand_per_iter)
    if in_loop_accept:
        # results come from the accepted channel; the dedup guards the rare
        # history-ring overflow that re-admits a node
        d_ids, d_scores = dedup_sorted_desc(final.res_ids, final.res_scores)
        final = final._replace(ids=d_ids, scores=d_scores)

    def filter_allowed(ids, scores):
        """Drop tombstoned, not accepted and excluded nodes (deleted nodes
        stay traversable)."""
        safe = torch.clamp(ids, min=0).long()
        ok = (ids >= 0) & ~graph.deleted[safe]
        if accept is not None:
            ok &= accept[safe]
        if exclude_ids is not None:
            ok &= ~(ids[:, :, None] == exclude_ids[:, None, :]).any(dim=2)
        return torch.where(ok, ids, -1), torch.where(ok, scores, NEG_INF)

    if threshold > 0.0:
        # threshold search: results below the similarity threshold are dropped
        keep = final.scores >= threshold
        final = final._replace(ids=torch.where(keep, final.ids, -1), scores=torch.where(keep, final.scores, NEG_INF))

    if reranker is None:
        ids, scores = filter_allowed(final.ids, final.scores)
        ids, scores = _top_sorted(ids, scores, top_k)
        result = SearchResult(
            ids=ids,
            scores=scores,
            visited_count=final.visited_count,
            expanded_count=final.expanded_count,
            reranked_count=torch.zeros((Q,), dtype=torch.int32, device=ids.device),
            approx_scores=scores,
        )
        return (result, final) if return_state else result

    cand_ids, cand_scores = filter_allowed(final.ids[:, :rerank_k], final.scores[:, :rerank_k])
    cand_valid = cand_ids >= 0
    if rerank_floor is not None:
        # multi-index contract: skip exact scoring of candidates whose
        # approximate score cannot reach the caller's current top-k floor
        cand_valid &= cand_scores >= rerank_floor[:, None]
        cand_ids = torch.where(cand_valid, cand_ids, -1)
    exact = reranker.score(rerank_qstate(), torch.clamp(cand_ids, min=0))
    exact = torch.where(cand_valid, exact, NEG_INF)
    order = torch.argsort(-exact, dim=1, stable=True)[:, :top_k]
    result = SearchResult(
        ids=torch.gather(cand_ids, 1, order),
        scores=torch.gather(exact, 1, order),
        visited_count=final.visited_count,
        expanded_count=final.expanded_count,
        reranked_count=cand_valid.sum(dim=1, dtype=torch.int32),
        approx_scores=torch.gather(cand_scores, 1, order),
    )
    return (result, final) if return_state else result


def _search_wave(
    graph: GraphIndex,
    provider,
    queries: torch.Tensor,
    top_k: int,
    beam_width: int | None = None,
    rerank_k: int | None = None,
    reranker=None,
    max_iters: int = 1000,
    hierarchy_beam: int = 1,
    accept=None,
    rerank_floor=None,
    expand_per_iter: int = 1,
    threshold: float = 0.0,
    exclude_ids=None,
    return_state: bool = False,
    init_state: BeamState | None = None,
    entry_seeds: int = 1,
    repack_after: int = 0,
):
    """One wave of :func:`search` at one beam width (``_search_jit``)."""
    if beam_width is None:
        beam_width = max(top_k, 100)
    if rerank_k is None:
        rerank_k = beam_width if reranker is not None else top_k
    dev = queries.device
    qstate = provider.prepare(queries)
    Q = queries.shape[0]
    entries = None
    if init_state is None:
        entries = _entries(graph, provider, qstate, Q, beam_width, hierarchy_beam, entry_seeds)
    return _wave(
        graph, provider, qstate, entries, Q, top_k, beam_width, rerank_k, reranker,
        lambda: reranker.prepare(queries),
        max_iters=max_iters,
        accept=None if accept is None else _as_mask(graph, accept),
        rerank_floor=None if rerank_floor is None else torch.as_tensor(rerank_floor, device=dev),
        expand_per_iter=expand_per_iter,
        threshold=threshold,
        exclude_ids=None if exclude_ids is None else torch.as_tensor(exclude_ids, device=dev),
        return_state=return_state,
        init_state=init_state,
        repack_after=repack_after,
    )


def _filtered_brute(
    graph: GraphIndex,
    provider,
    queries: torch.Tensor,
    cand_ids: torch.Tensor,  # int32 [A], -1 padded accepted ordinals
    top_k: int,
    rerank_k: int,
    reranker,
    threshold: float,
    exclude_ids: torch.Tensor | None,
) -> SearchResult:
    """Exact evaluation over a small accepted set, no graph traversal
    (``_filtered_brute_jit``)."""
    qstate = provider.prepare(queries)
    Q, A = queries.shape[0], cand_ids.shape[0]
    safe = torch.clamp(cand_ids, min=0)
    ok = (cand_ids >= 0) & ~graph.deleted[safe.long()]
    ids_b = cand_ids[None].expand(Q, A)
    sc = torch.where(ok[None], provider.score(qstate, safe[None].expand(Q, A)), NEG_INF)
    if exclude_ids is not None:
        sc = torch.where((ids_b[:, :, None] == exclude_ids[:, None, :]).any(dim=2), NEG_INF, sc)
    k1 = min(rerank_k, A)
    approx, idx = _top_k_stable(sc, k1)
    pick = torch.gather(ids_b, 1, idx)
    if reranker is not None:
        ex = reranker.score(reranker.prepare(queries), torch.clamp(pick, min=0))
        ex = torch.where(approx > NEG_INF, ex, NEG_INF)
        order = torch.argsort(-ex, dim=1, stable=True)[:, :top_k]
        out_ids, out_sc = torch.gather(pick, 1, order), torch.gather(ex, 1, order)
        out_approx = torch.gather(approx, 1, order)
        reranked = torch.full((Q,), k1, dtype=torch.int32, device=queries.device)
    else:
        out_ids, out_sc = pick[:, :top_k], approx[:, :top_k]
        out_approx = out_sc
        reranked = torch.zeros((Q,), dtype=torch.int32, device=queries.device)
    out_ids = torch.where(out_sc > NEG_INF, out_ids, -1)
    if threshold > 0.0:
        keep = out_sc >= threshold
        out_ids = torch.where(keep, out_ids, -1)
        out_sc = torch.where(keep, out_sc, NEG_INF)
    return SearchResult(
        ids=out_ids,
        scores=out_sc,
        visited_count=ok.sum(dtype=torch.int32).expand(Q).clone(),
        expanded_count=torch.zeros((Q,), dtype=torch.int32, device=queries.device),
        reranked_count=reranked,
        approx_scores=out_approx,
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
    hierarchy_beam: int = 1,
    accept=None,
    accept_brute_cutoff: int | None = None,
    threshold: float = 0.0,
    exclude_ids=None,
    rerank_floor=None,
    return_state: bool = False,
    init_state: BeamState | None = None,
):
    """Two-pass wave search (reference ``GraphSearcher.search:222-243``).

    The first pass descends the hierarchy (``hierarchy_beam`` wide), if the
    graph has one, then runs the layer-0 beam with ``provider`` (exact, SQ4
    or PQ); with a ``reranker``, the top ``rerank_k`` beam entries get exact
    scores and the final top-k comes from those.  On a flat graph,
    ``entry_seeds > 1`` adds k-1 ordinal-strided entries; ``repack_after >
    0`` cuts a plain wave after that many steps and finishes the
    still-active lanes in a quarter-width sub-wave (identical results
    whenever the active tail fits).

    - ``threshold``: drop results below this similarity, and retire queries
      whose new candidates stay below it (``STOP_PATIENCE`` steps).
    - ``exclude_ids [Q, P]``: drop these ids from the results.
    - ``rerank_floor [Q]``: skip the exact rerank of candidates whose first-
      pass score is below it (the multi-index contract).
    - ``return_state=True`` returns ``(SearchResult, BeamState)``; the state
      goes back in as ``init_state`` (see :func:`resume`).
    - ``accept`` (the acceptOrds mask, bool ``[N]``): results come from the
      in-loop accepted channel and the search expands until the accepted
      top-k can no longer improve.  At most ``accept_brute_cutoff`` accepted
      nodes (default ``max(4 * beam, 512)``) are scored exactly instead of
      traversed.  Otherwise, if the bounded frontier starves before the
      accepted top-k fills, the search retries at double the beam width, up
      to ``min(capacity, max(16 * beam, 1024))``, stopping after two
      widenings that find nothing more.  A filtered search therefore reads
      the device between widenings.
    """
    kw = dict(rerank_k=rerank_k, reranker=reranker, max_iters=max_iters, expand_per_iter=expand_per_iter,
              entry_seeds=entry_seeds, repack_after=repack_after, hierarchy_beam=hierarchy_beam,
              threshold=threshold, exclude_ids=exclude_ids, rerank_floor=rerank_floor,
              return_state=return_state, init_state=init_state)
    with tracing.span("search"):
        if accept is None or init_state is not None:
            return _search_wave(graph, provider, queries, top_k, beam_width=beam_width, accept=accept, **kw)
        L = beam_width or max(top_k, 100)
        # low-cardinality cutoff: exact evaluation of a small accepted set beats
        # traversal and avoids the one geometry the bounded frontier explores
        # poorly (a small accepted island far from the entry); Cassandra SAI
        # makes the same call for low-cardinality predicates
        if accept_brute_cutoff is None:
            accept_brute_cutoff = max(4 * L, 512)
        if not return_state and rerank_floor is None:
            acc_ids = torch.nonzero(torch.as_tensor(accept).to(torch.bool)).flatten().cpu().numpy()
            if acc_ids.size <= accept_brute_cutoff:
                A = 1 << max(4, int(max(acc_ids.size, top_k) - 1).bit_length())
                ids = np.full(A, -1, np.int32)
                ids[: acc_ids.size] = acc_ids
                rk = rerank_k or (L if reranker is not None else top_k)
                dev = queries.device
                return _filtered_brute(
                    graph, provider, queries, torch.as_tensor(ids, device=dev), top_k, min(max(rk, top_k), A),
                    reranker, threshold, None if exclude_ids is None else torch.as_tensor(exclude_ids, device=dev),
                )
        cap = min(graph.capacity, max(16 * L, 1024))
        # widen only while widening finds more results: results can be missing
        # legitimately (threshold-dropped, or fewer reachable accepted nodes
        # than top_k); two rounds without gain stop short of the cap, so a
        # plateau-then-jump geometry gets its second widening
        prev_found, stalled = -1, 0
        while True:
            out = _search_wave(graph, provider, queries, top_k, beam_width=L, accept=accept, **kw)
            res = out[0] if return_state else out
            found = int((res.ids >= 0).sum())
            if L >= cap or found == res.ids.numel():
                return out
            stalled = stalled + 1 if found <= prev_found else 0
            if stalled >= 2:
                return out
            prev_found = found
            L = min(2 * L, cap)


def resume(
    graph: GraphIndex,
    provider,
    queries: torch.Tensor,
    previous: SearchResult,
    top_k: int,
    beam_width: int | None = None,
    reranker=None,
    state: BeamState | None = None,
    **kwargs,
):
    """Pull the next ``top_k`` results after ``previous`` (reference
    ``GraphSearcher.resume():509-547``).

    With ``state`` (from ``search(..., return_state=True)``) the beam and
    the expansion history carry over, so the continuation costs only the
    marginal expansions.  Without it, the search runs again at a wider
    beam.  Either way the results exclude ``previous.ids``.  A filtered
    search's state holds a frontier, not a result set, so it resumes
    without its state.
    """
    if state is not None and state.res_ids is not None:
        state = None
    prev_k = previous.ids.shape[1]
    if beam_width is None:
        if state is not None:
            # a converged beam: widen only enough to page top_k past prev_k
            beam_width = (3 * (top_k + prev_k) + 1) // 2
        else:
            beam_width = max(2 * (top_k + prev_k), 100)
    if state is not None:
        beam_width = max(beam_width, state.ids.shape[1])
    return search(graph, provider, queries, top_k=top_k, beam_width=beam_width, reranker=reranker,
                  exclude_ids=previous.ids, init_state=state, **kwargs)
