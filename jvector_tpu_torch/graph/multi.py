"""Multi-index search: the scatter-gather contract (counterpart of
``jvector_tpu/graph/multi.py``).

Reference: ``GraphSearcher.java:386-404``: Astra/Cassandra searches one
index per sstable and merges, skipping the exact rerank of candidates worse
than the current global top-k (``rerankFloor``, from
``SearchResult.worstApproximateScoreInTopK``).

Two paths, as in the JAX package:

- **stacked** (segments of one shape): every segment is searched at once
  and one global top-k merges them, with no floor gating.  The JAX package
  vmaps its search over a stacked segment axis.  Here the segments' tables
  are laid end to end (ids offset by ``s * capacity``) and one wave of
  ``S * Q`` lanes runs over them, lane ``s * Q + q`` holding query ``q``
  against segment ``s`` with that segment's query state, so the beam loop
  pays its per-step launches once for all segments.  A lane only ever
  reaches its own segment's rows, so each lane's search is the segment's
  own search.  Providers whose scoring reads per-segment tables other than
  the per-node rows (PQ codebooks under cosine) run the segments one after
  another instead, with the same result contract;
- **sequential**: segment by segment, carrying the global top-k, each later
  segment's rerank gated by ``rerank_floor = min(best approximate score) -
  floor_slack``.
"""

from __future__ import annotations

import dataclasses

import torch

from jvector_tpu_torch.graph.index import NEG_INF, GraphIndex, GraphLayer
from jvector_tpu_torch.graph.score import (
    ADCScoreProvider,
    ExactScoreProvider,
    FusedADCScoreProvider,
    LUT16ScoreProvider,
    SQ4ScoreProvider,
)
from jvector_tpu_torch.graph.searcher import SearchResult, _entries, _search_wave, _wave, search
from jvector_tpu_torch.ops.similarity import SimilarityFunction


@dataclasses.dataclass
class IndexShard:
    """One searchable segment: graph + first-pass provider (+ reranker)."""

    graph: GraphIndex
    provider: object
    reranker: object = None
    id_offset: int = 0  # added to local ids in the merged result


def _sig(x):
    """Structure, tensor shapes and dtypes, and static fields of ``x``."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, tuple):
        return (type(x).__name__, tuple(_sig(v) for v in x))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, tuple((f.name, _sig(getattr(x, f.name))) for f in dataclasses.fields(x)))
    return x


def _can_stack(shards: list[IndexShard]) -> bool:
    """Stackable iff every shard's graph, provider and reranker share their
    structure and tensor shapes (``bucket_capacity`` aligns same-size
    segments)."""
    if len(shards) < 2:
        return False
    first = [_sig(t) for t in (shards[0].graph, shards[0].provider, shards[0].reranker)]
    return all([_sig(t) for t in (s.graph, s.provider, s.reranker)] == first for s in shards[1:])


# fields each provider reads only in ``prepare`` (per-segment query state);
# its other tensor fields are per-node rows, laid end to end
_QUERY_SIDE = {
    ExactScoreProvider: (),
    SQ4ScoreProvider: ("scale", "offset"),
    ADCScoreProvider: ("codebooks", "center"),
    FusedADCScoreProvider: ("codebooks", "center"),
    LUT16ScoreProvider: ("codebooks", "center"),
}


def _stack_provider(provs: list):
    """One provider over the segments' per-node tables laid end to end, or
    None where scoring reads a per-segment table (PQ under cosine)."""
    kind = type(provs[0])
    if kind not in _QUERY_SIDE or (
        _QUERY_SIDE[kind] and provs[0].sim == SimilarityFunction.COSINE and kind is not SQ4ScoreProvider
    ):
        return None
    rows = {}
    for f in dataclasses.fields(provs[0]):
        v = getattr(provs[0], f.name)
        if isinstance(v, torch.Tensor) and f.name not in _QUERY_SIDE[kind]:
            rows[f.name] = torch.cat([getattr(p, f.name) for p in provs])
    return dataclasses.replace(provs[0], **rows)


def _cat_state(states: list):
    if isinstance(states[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*states))
    return torch.cat(states)


def _stack_graphs(graphs: list[GraphIndex]) -> GraphIndex:
    """The base layers end to end, ids offset by ``s * capacity`` (flat: the
    entries come from each segment's own descent)."""
    n_cap = graphs[0].capacity
    nbrs = [torch.where(g.base.neighbors >= 0, g.base.neighbors + s * n_cap, -1) for s, g in enumerate(graphs)]
    base = GraphLayer(
        neighbors=torch.cat(nbrs),
        scores=torch.cat([g.base.scores for g in graphs]),
        counts=torch.cat([g.base.counts for g in graphs]),
    )
    return GraphIndex(
        layers=(base,), level_node_ids=(), entry_node=graphs[0].entry_node,
        num_nodes=sum(g.num_nodes for g in graphs), deleted=torch.cat([g.deleted for g in graphs]),
    )


def _merge(parts: list[SearchResult], top_k: int) -> SearchResult:
    """Global top-k over per-segment results (ids already global), the
    lowest segment first among equal scores (``lax.top_k``)."""
    scores_all = torch.cat([r.scores for r in parts], dim=1)
    order = torch.argsort(-scores_all, dim=1, stable=True)[:, :top_k]

    def take(field):
        return torch.gather(torch.cat([getattr(r, field) for r in parts], dim=1), 1, order)

    return SearchResult(
        ids=take("ids"),
        scores=torch.gather(scores_all, 1, order),
        visited_count=sum(r.visited_count for r in parts),
        expanded_count=sum(r.expanded_count for r in parts),
        reranked_count=sum(r.reranked_count for r in parts),
        approx_scores=take("approx_scores"),
    )


def _offset(res: SearchResult, offset: int) -> SearchResult:
    return res._replace(ids=torch.where(res.ids >= 0, res.ids + offset, -1))


def _multi_search_stacked(
    shards: list[IndexShard],
    queries: torch.Tensor,
    top_k: int,
    beam_width: int | None,
    rerank_k: int | None,
    repack_after: int = 0,
) -> SearchResult:
    """All segments at once, no floor gating, one global top-k (see the
    module docstring)."""
    beam_width = beam_width or max(top_k, 100)
    has_rr = shards[0].reranker is not None
    rerank_k = rerank_k or (beam_width if has_rr else top_k)
    prov = _stack_provider([s.provider for s in shards])
    rer = _stack_provider([s.reranker for s in shards]) if has_rr else None
    if prov is None or (has_rr and rer is None):
        parts = [
            _offset(_search_wave(s.graph, s.provider, queries, top_k, beam_width=beam_width, rerank_k=rerank_k,
                                 reranker=s.reranker, repack_after=repack_after), s.id_offset)
            for s in shards
        ]
        return _merge(parts, top_k)
    Q, S = queries.shape[0], len(shards)
    n_cap = shards[0].graph.capacity
    qstates, entries = [], []
    for s, shard in enumerate(shards):
        qs = shard.provider.prepare(queries)
        qstates.append(qs)
        entries.append(_entries(shard.graph, shard.provider, qs, Q, beam_width, 1, 1) + s * n_cap)
    res = _wave(
        _stack_graphs([s.graph for s in shards]), prov, _cat_state(qstates), torch.cat(entries), S * Q, top_k,
        beam_width, rerank_k, rer, lambda: _cat_state([s.reranker.prepare(queries) for s in shards]),
        repack_after=repack_after,
    )
    parts = []
    for s, shard in enumerate(shards):
        lane = slice(s * Q, (s + 1) * Q)
        part = SearchResult(*(x[lane] for x in res))
        parts.append(_offset(part, shard.id_offset - s * n_cap))
    return _merge(parts, top_k)


def multi_search(
    shards: list[IndexShard],
    queries: torch.Tensor,
    top_k: int,
    beam_width: int | None = None,
    rerank_k: int | None = None,
    use_rerank_floor: bool = True,
    floor_slack: float = 0.02,
    stacked: bool | None = None,
    repack_after: int = 0,
) -> SearchResult:
    """Search every shard and merge the global top-k.

    Segments of one shape (``bucket_capacity`` aligns equal-size segments)
    take the stacked path unless ``stacked=False``; others run the
    sequential loop, where each later shard's exact rerank skips candidates
    that cannot enter the current global top-k (``rerankFloor``).
    """
    if stacked is None:
        stacked = _can_stack(shards)
    if stacked:
        return _multi_search_stacked(shards, queries, top_k, beam_width, rerank_k, repack_after)
    q, dev = queries.shape[0], queries.device
    best = SearchResult(
        ids=torch.full((q, top_k), -1, dtype=torch.int32, device=dev),
        scores=torch.full((q, top_k), NEG_INF, device=dev),
        visited_count=torch.zeros((q,), dtype=torch.int32, device=dev),
        expanded_count=torch.zeros((q,), dtype=torch.int32, device=dev),
        reranked_count=torch.zeros((q,), dtype=torch.int32, device=dev),
        approx_scores=torch.full((q, top_k), NEG_INF, device=dev),
    )
    for shard in shards:
        # the floor lives in approximate-score space: skip a candidate only
        # if even its first-pass score is below the worst approximate score
        # of the current global top-k; floor_slack absorbs the bias between
        # shards' first passes (each has its own codebooks)
        if use_rerank_floor:
            floor = best.approx_scores.min(dim=1).values - floor_slack
        else:
            floor = torch.full((q,), NEG_INF, device=dev)
        res = search(shard.graph, shard.provider, queries, top_k=top_k, beam_width=beam_width, rerank_k=rerank_k,
                     reranker=shard.reranker, rerank_floor=floor, repack_after=repack_after)
        best = _merge([best, _offset(res, shard.id_offset)], top_k)
    return best
