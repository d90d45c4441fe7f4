"""Index mutation: tombstone deletes, the FreshDiskANN splice, inserts
(counterpart of ``jvector_tpu/graph/mutation.py``).

Reference: ``GraphIndexBuilder.markNodeDeleted`` (tombstone bitset),
``removeDeletedNodes:689-799`` (FreshDiskANN section 4.2 edge splice: a
live node whose neighbor is deleted inherits that neighbor's live
neighbors, then re-prunes), and incremental ``addGraphNode`` on an
existing index.

The splice runs as a batched pass over row chunks: gather the 2-hop
frontier through deleted neighbors, dedup, rescore against the owner,
robust-prune.  Inserts pad the capacity and run the ordinary wave insert.
Every function leaves the caller's graph as it was (the JAX package's
updates are functional): each one copies the tables it then updates in
place.
"""

from __future__ import annotations

import numpy as np
import torch

from jvector_tpu_torch.graph.builder import (
    GraphIndexBuilder,
    _drop_sink,
    _insert_wave,
    _pad_rows,
    _write_rows,
)
from jvector_tpu_torch.graph.diversity import dedup_sorted_desc, robust_prune
from jvector_tpu_torch.graph.index import NEG_INF, GraphConfig, GraphIndex, GraphLayer, bucket_capacity
from jvector_tpu_torch.graph.score import ExactScoreProvider


def mark_deleted(graph: GraphIndex, ids) -> GraphIndex:
    """Tombstone nodes (kept traversable until :func:`remove_deleted`).
    The returned graph has a new ``deleted`` tensor; the caller's graph is
    unchanged and shares every other table."""
    idx = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1), device=graph.deleted.device)
    return graph._replace(deleted=graph.deleted.clone().index_fill_(0, idx, True))


def _splice_chunk(graph: GraphIndex, provider, start: int, config: GraphConfig, chunk: int) -> None:
    """Splice one chunk of live rows around their deleted neighbors, in
    place (the base layer is the caller's copy)."""
    layer = graph.base
    n_cap, r = layer.neighbors.shape
    dev = layer.neighbors.device
    m = config.max_degree
    rows = start + torch.arange(chunk, dtype=torch.int32, device=dev)
    safe_rows = torch.clamp(rows, max=n_cap - 1)
    idx = safe_rows.long()
    row_live = (rows < n_cap) & ~graph.deleted[idx] & (layer.counts[idx] > 0)

    nbrs = layer.neighbors[idx]  # [B, R]
    scores = layer.scores[idx]
    nbr_valid = nbrs >= 0
    nbr_deleted = nbr_valid & graph.deleted[torch.clamp(nbrs, min=0).long()]
    needs = row_live & nbr_deleted.any(dim=1)

    # candidates: live 1-hop neighbors + 2-hop through deleted neighbors
    live_ids = torch.where(nbr_valid & ~nbr_deleted, nbrs, -1)
    live_scores = torch.where(live_ids >= 0, scores, NEG_INF)
    hop_src = torch.where(nbr_deleted, nbrs, 0)
    two_hop = layer.neighbors[hop_src.long()]  # [B, R, R]
    two_hop = torch.where(nbr_deleted[:, :, None], two_hop, -1).reshape(chunk, r * r)
    # drop deleted 2-hop nodes and self references; score against the owner
    th_valid = (two_hop >= 0) & ~graph.deleted[torch.clamp(two_hop, min=0).long()]
    th_valid &= two_hop != safe_rows[:, None]
    two_hop = torch.where(th_valid, two_hop, -1)
    th_scores = torch.where(th_valid, provider.score_nodes(safe_rows, torch.clamp(two_hop, min=0)), NEG_INF)

    # only the 2-hop flood is cut to ef_construction by score; the node's
    # existing live edges always ride into the prune pool (low-scoring
    # long-range edges would otherwise be evicted and the graph disconnect)
    th_ids, th_sorted = dedup_sorted_desc(two_hop, th_scores)
    ef = config.ef_construction
    cand_ids, cand_scores = dedup_sorted_desc(
        torch.cat([live_ids, th_ids[:, :ef]], dim=1), torch.cat([live_scores, th_sorted[:, :ef]], dim=1)
    )
    safe_cand = torch.clamp(cand_ids, min=0)
    p_ids, p_scores, p_count = robust_prune(
        cand_ids, cand_scores, provider.pairwise(safe_cand, safe_cand), m, config.alphas
    )
    new_ids, new_scores = _pad_rows(p_ids, p_scores, r)
    # deleted rows are wiped only after every chunk has run: later chunks
    # still read them for their own 2-hop splices
    _write_rows(layer, start, needs, new_ids, new_scores, p_count)


def remove_deleted(graph: GraphIndex, provider, config: GraphConfig, chunk: int = 1024) -> GraphIndex:
    """The FreshDiskANN splice over the whole base layer, then the entry
    repair; returns a new graph.

    Upper levels drop their edges into deleted nodes (they are rebuilt
    cheaply on the next full cleanup; the descent only needs *an* entry).
    Tombstones are kept: the mask now marks holes, which hierarchy seeding
    and result filtering still read (the ordinal remap happens at save).
    """
    base = graph.base
    work = GraphLayer(base.neighbors.clone(), base.scores.clone(), base.counts.clone())
    graph = graph._replace(layers=(work,) + graph.layers[1:])
    for start in range(0, graph.capacity, chunk):
        _splice_chunk(graph, provider, start, config, chunk)

    # wipe the deleted rows (safe now: every splice is done)
    dead = graph.deleted
    layers = [GraphLayer(
        neighbors=work.neighbors.masked_fill_(dead[:, None], -1),
        scores=work.scores.masked_fill_(dead[:, None], NEG_INF),
        counts=work.counts.masked_fill_(dead, 0),
    )]
    # upper levels: mask out edges to deleted nodes
    for lv in range(1, graph.num_levels):
        layer = graph.layers[lv]
        slot_deleted = dead[graph.level_node_ids[lv - 1].long()]  # [n_l]
        nbr_del = (layer.neighbors >= 0) & slot_deleted[torch.clamp(layer.neighbors, min=0).long()]
        neighbors = torch.where(nbr_del, -1, layer.neighbors)
        layers.append(GraphLayer(
            neighbors, torch.where(nbr_del, NEG_INF, layer.scores), (neighbors >= 0).sum(dim=1, dtype=torch.int32)
        ))
    graph = graph._replace(layers=tuple(layers))

    # entry repair: a deleted entry gives way to the live node of most degree
    entry = graph.entry_node
    entry_dead = dead[torch.clamp(entry, min=0).long()] | (entry < 0)
    new_entry = torch.argmax(torch.where(dead, -1, layers[0].counts)).to(torch.int32)
    return graph._replace(entry_node=torch.where(entry_dead, new_entry, entry).to(torch.int32))


def add_nodes(
    graph: GraphIndex,
    provider: ExactScoreProvider,
    new_vectors,
    config: GraphConfig,
) -> tuple[GraphIndex, ExactScoreProvider]:
    """Insert new nodes into an existing index (incremental ``addGraphNode``):
    the capacity grows to the bucket that holds them, the vectors join the
    provider, and the ordinary wave insert runs once per wave.  Returns the
    new graph and provider; the caller's are left as they were."""
    dev = graph.base.neighbors.device
    new_vectors = torch.as_tensor(new_vectors, dtype=torch.float32, device=dev)
    k = new_vectors.shape[0]
    n0 = int(graph.num_nodes)
    need = n0 + k
    n_cap = bucket_capacity(need) if need > graph.capacity else graph.capacity
    base = graph.base
    r = base.neighbors.shape[1]
    # the build graph: the caller's tables copied, the capacity padding and
    # the wave loop's sink row (index n_cap) appended
    pad = n_cap + 1 - graph.capacity
    work = GraphLayer(
        neighbors=torch.cat([base.neighbors, torch.full((pad, r), -1, dtype=torch.int32, device=dev)]),
        scores=torch.cat([base.scores, torch.full((pad, r), NEG_INF, device=dev)]),
        counts=torch.cat([base.counts, torch.zeros((pad,), dtype=torch.int32, device=dev)]),
    )
    graph = graph._replace(
        layers=(work,) + graph.layers[1:],
        deleted=torch.cat([graph.deleted, torch.zeros((n_cap - graph.capacity,), dtype=torch.bool, device=dev)]),
    )

    # the provider's rows track the graph's capacity
    vectors = torch.cat([provider.vectors[:n0], new_vectors])
    vectors = torch.nn.functional.pad(vectors, (0, 0, 0, n_cap - need))
    provider = ExactScoreProvider(vectors=vectors, sim=provider.sim)

    w = config.wave_size
    for start in range(0, k, w):
        ids = torch.arange(n0 + start, n0 + start + w, dtype=torch.int32, device=dev)
        ids = torch.where(ids < need, ids, -1)
        wv = vectors[torch.clamp(ids, min=0, max=need - 1).long()]
        graph = _insert_wave(graph, provider, ids, wv, config)
    graph = _drop_sink(graph)

    if graph.num_levels > 1 and config.add_hierarchy:
        # refresh the (small) upper levels so new nodes join the descent;
        # rebuilding them costs ~n / max_degree inserts
        graph = graph._replace(layers=graph.layers[:1], level_node_ids=())
        graph = GraphIndexBuilder(config).build_hierarchy(graph, vectors[:need], provider.sim)
    return graph, provider
