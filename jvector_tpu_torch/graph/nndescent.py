"""NN-descent bulk construction (counterpart of
``jvector_tpu/graph/nndescent.py``).

The wave builder (``builder.py``) mirrors the reference's insert
semantics; this module builds the graph the way GPU ANN systems do (CAGRA,
GGNN, see PAPERS.md): NN-descent rounds in which every node refines its
neighbor list at once from neighbors-of-neighbors and reverse edges, then
one Vamana robust prune and a backlink pass.  Every step is a batched
gather / score / sort over node chunks.  The random draws (the initial
lists, the reverse-edge samples) are the JAX package's, from the same
``np.random.default_rng(seed)`` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from jvector_tpu_torch.graph.builder import GraphIndexBuilder, _pad_rows, _pairwise_from_provider, _write_rows
from jvector_tpu_torch.graph.diversity import dedup_sorted_desc, robust_prune
from jvector_tpu_torch.graph.index import GraphConfig, GraphIndex, GraphLayer, bucket_capacity, empty_graph
from jvector_tpu_torch.graph.score import ExactScoreProvider
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.util.device import resolve_device


def _descent_chunk(
    provider,
    fwd_ids: torch.Tensor,  # [N_cap, K] current best lists (score-sorted desc)
    fwd_scores: torch.Tensor,
    rev_ids: torch.Tensor,  # [N_cap, R] sampled reverse edges
    chunk_ids: torch.Tensor,  # [C] nodes to refine this call
    s1: int,
    s2: int,
    n_valid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One NN-descent refinement for a chunk of nodes: the candidates of u
    are fwd(fwd(u)) over the top ``s1`` neighbors' top ``s2`` entries, plus
    u's sampled reverse edges and their top ``s2`` entries."""
    c = chunk_ids.shape[0]
    k = fwd_ids.shape[1]
    idx = chunk_ids.long()
    fu = fwd_ids[idx]  # [C, K]
    ru = rev_ids[idx]  # [C, R]
    hop_src = torch.cat([fu[:, :s1], ru], dim=1)  # [C, s1+R]
    two_hop = fwd_ids[torch.clamp(hop_src, min=0).long()][:, :, :s2]
    two_hop = torch.where((hop_src >= 0)[:, :, None], two_hop, -1).reshape(c, -1)
    cand = torch.cat([ru, two_hop], dim=1)  # [C, R + (s1+R)*s2]
    cand = torch.where((cand == chunk_ids[:, None]) | (cand >= n_valid), -1, cand)
    qstate = provider.prepare(provider.vectors[idx])
    cand_scores = torch.where(cand >= 0, provider.score(qstate, torch.clamp(cand, min=0)), float("-inf"))
    all_ids, all_scores = dedup_sorted_desc(
        torch.cat([fu, cand], dim=1), torch.cat([fwd_scores[idx], cand_scores], dim=1)
    )
    return all_ids[:, :k], all_scores[:, :k]


def _reverse_sample(fwd_ids: np.ndarray, n_valid: int, r: int, rng: np.random.Generator) -> np.ndarray:
    """Sample up to ``r`` reverse edges per node (host, numpy): the JAX
    package's draws and fill, the ragged fill vectorized."""
    n_cap, k = fwd_ids.shape
    src = np.repeat(np.arange(n_cap, dtype=np.int32), k)
    dst = fwd_ids.reshape(-1)
    keep = (dst >= 0) & (src < n_valid)
    src, dst = src[keep], dst[keep]
    # shuffle, then take the first r per destination
    perm = rng.permutation(len(dst))
    src, dst = src[perm], dst[perm]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    rev = np.full((n_cap, r), -1, np.int32)
    starts = np.searchsorted(dst, np.arange(n_cap))
    ends = np.searchsorted(dst, np.arange(n_cap) + 1)
    take = np.minimum(ends - starts, r)
    rows = np.repeat(np.arange(n_cap), take)
    cols = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
    rev[rows, cols] = src[np.repeat(starts, take) + cols]
    return rev


def nn_descent_build(
    vectors,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    config: GraphConfig | None = None,
    rounds: int = 8,
    k_build: int | None = None,
    s1: int = 12,
    s2: int = 8,
    rev_edges: int = 16,
    chunk: int = 16_384,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> tuple[GraphIndex, ExactScoreProvider]:
    """Bulk-build a Vamana graph by NN-descent + robust prune + backlinks,
    then ``cleanup`` (degree and entry) and, with ``add_hierarchy``, the
    upper levels.  Runs on ``device`` (default: the tensor's device, or the
    card for numpy input)."""
    sim = SimilarityFunction.parse(sim)
    config = config or GraphConfig()
    if device is None and isinstance(vectors, torch.Tensor):
        device = vectors.device
    dev = resolve_device(device)
    vectors = torch.as_tensor(vectors, dtype=torch.float32, device=dev)
    n, _ = vectors.shape
    n_cap = bucket_capacity(n)
    provider = ExactScoreProvider(vectors=torch.nn.functional.pad(vectors, (0, 0, 0, n_cap - n)), sim=sim)
    rng = np.random.default_rng(seed)
    k = k_build or max(int(1.5 * config.max_degree), 48)
    m = config.max_degree

    def chunk_ids(start: int) -> torch.Tensor:
        return torch.arange(start, min(start + chunk, n_cap), dtype=torch.int32, device=dev)

    # --- init: random neighbor lists (no self ids), scored and sorted -------
    init = rng.integers(0, n, size=(n_cap, k), dtype=np.int32)
    init[np.arange(n_cap)[:, None] == init] = (init[0, 0] + 1) % n
    fwd_ids = torch.as_tensor(init, device=dev)
    fwd_scores = torch.empty((n_cap, k), device=dev)
    for start in range(0, n_cap, chunk):
        ids = chunk_ids(start)
        qstate = provider.prepare(provider.vectors[ids.long()])
        fwd_scores[start : start + ids.shape[0]] = provider.score(qstate, fwd_ids[ids.long()])
    fwd_ids, fwd_scores = dedup_sorted_desc(fwd_ids, fwd_scores)
    fwd_ids, fwd_scores = fwd_ids[:, :k], fwd_scores[:, :k]

    # a slice of the initial random lists stays as long-range prune
    # candidates: descent converges to near neighbors only, and without far
    # candidates the pruned graph fragments into cluster islands
    n_long = max(8, m // 2)
    long_ids, long_scores = fwd_ids[:, :n_long], fwd_scores[:, :n_long]

    # --- descent rounds -------------------------------------------------------
    for _ in range(rounds):
        rev = torch.as_tensor(_reverse_sample(fwd_ids.cpu().numpy(), n, rev_edges, rng), device=dev)
        new_ids, new_scores = fwd_ids.clone(), fwd_scores.clone()
        for start in range(0, n_cap, chunk):
            ids = chunk_ids(start)
            ci, cs = _descent_chunk(provider, fwd_ids, fwd_scores, rev, ids, s1, s2, n)
            new_ids[start : start + ids.shape[0]] = ci
            new_scores[start : start + ids.shape[0]] = cs
        fwd_ids, fwd_scores = new_ids, new_scores

    # --- robust prune to M, rows written ------------------------------------
    layer = empty_graph(n_cap, config, dev).base
    r_cap = layer.neighbors.shape[1]
    for start in range(0, n_cap, chunk):
        ids = chunk_ids(start)
        idx = ids.long()
        ci = torch.cat([fwd_ids[idx], long_ids[idx]], dim=1)
        cs = torch.cat([fwd_scores[idx], long_scores[idx]], dim=1)
        ci = torch.where(ids[:, None] < n, ci, -1)
        cs = torch.where(ci >= 0, cs, float("-inf"))
        ci, cs = dedup_sorted_desc(ci, cs)
        p_ids, p_scores, p_count = robust_prune(ci, cs, _pairwise_from_provider(provider, ci), m, config.alphas)
        row_ids, row_scores = _pad_rows(p_ids, p_scores, r_cap)
        _write_rows(layer, start, ids < n, row_ids, row_scores, p_count)

    # --- backlinks: vectorized group-append on the host -----------------------
    # (cleanup re-prunes and dedups; a mutual edge may append a duplicate,
    # which the searcher's dedup and cleanup's dedup_sorted_desc remove)
    nbrs_full = layer.neighbors.cpu().numpy()
    scores_full = layer.scores.cpu().numpy()
    counts_np = layer.counts.cpu().numpy()
    src = np.repeat(np.arange(n_cap, dtype=np.int32), m)
    dst = nbrs_full[:, :m].reshape(-1)
    sc = scores_full[:, :m].reshape(-1)
    keep = dst >= 0
    src, dst, sc = src[keep], dst[keep], sc[keep]
    order = np.argsort(dst, kind="stable")
    src, dst, sc = src[order], dst[order], sc[order]
    starts = np.searchsorted(dst, np.arange(n_cap))
    rank = np.arange(len(dst), dtype=np.int64) - starts[dst]
    pos = counts_np[dst] + rank
    ok = pos < r_cap
    nbrs_full[dst[ok], pos[ok]] = src[ok]
    scores_full[dst[ok], pos[ok]] = sc[ok]
    group = np.searchsorted(dst, np.arange(n_cap) + 1) - starts
    counts_np = np.minimum(counts_np + group, r_cap).astype(np.int32)

    graph = GraphIndex(
        layers=(GraphLayer(
            neighbors=torch.as_tensor(nbrs_full, device=dev),
            scores=torch.as_tensor(scores_full, device=dev),
            counts=torch.as_tensor(counts_np, device=dev),
        ),),
        level_node_ids=(),
        entry_node=torch.tensor(0, dtype=torch.int32, device=dev),
        num_nodes=torch.tensor(n, dtype=torch.int32, device=dev),
        deleted=torch.zeros((n_cap,), dtype=torch.bool, device=dev),
    )
    builder = GraphIndexBuilder(config)
    graph = builder.cleanup(graph, provider, vectors)  # degree + entry
    if config.add_hierarchy:
        graph = builder.build_hierarchy(graph, vectors, sim)
    return graph, provider
