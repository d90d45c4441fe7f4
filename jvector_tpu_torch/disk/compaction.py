"""N:1 index compaction: a streaming merge of segment indexes (counterpart
of ``jvector_tpu/disk/compaction.py``).

Reference: ``jv/graph/disk/OnDiskGraphIndexCompactor.java`` and
``docs/compaction.md``.  Per node the reference gathers candidates from
the same source (its existing neighbors, filtered and rescored) and from
the other sources (a beam search into each), then applies the Vamana
diversity prune with alpha in {1.0, 1.2}; PQ sidecars are retrained on
proportionally sampled merged data (``PQRetrainer``).

Here nodes are processed in waves: the per-node search into every other
source is one query-wave ``search_layer`` per (wave, other source), and the
merged rows are written by scatter.  No backlinks are needed: every output
row is computed on its own from both edge directions' candidates.

Two entry points:

- :func:`compact_indexes` merges in-memory sources into a graph on the
  device, exactly (full-precision vectors) or through a PQ sidecar
  (``pq=``: every score on codes, so the ADC kernel K5 runs on this path);
- :func:`compact_on_disk` merges saved segment files with bounded device
  memory: merged SQ4 codes, one resident source at a time, candidate ids on
  the host, rows streamed into reserved file extents.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jvector_tpu_torch.disk.format import (
    FeatureId,
    IndexFileReader,
    IndexFileWriter,
    _read_l0_neighbors,
    load_index,
)
from jvector_tpu_torch.graph.builder import GraphIndexBuilder, refine_graph
from jvector_tpu_torch.graph.diversity import dedup_sorted_desc, robust_prune, tie_break_pairs, tie_break_scores
from jvector_tpu_torch.graph.hierarchy import assign_levels
from jvector_tpu_torch.graph.index import NEG_INF, GraphConfig, GraphIndex, GraphLayer, bucket_capacity, empty_layer
from jvector_tpu_torch.graph.score import ExactScoreProvider, SQ4ScoreProvider, build_fused_sq4_host, sq4_aug_rows
from jvector_tpu_torch.graph.searcher import search_layer
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization.pq import MAX_TRAINING_SET_SIZE as PQ_MAX_TRAINING_SET_SIZE
from jvector_tpu_torch.quantization.pq import ProductQuantization
from jvector_tpu_torch.quantization.sq import MAX_TRAINING_SET_SIZE as SQ_MAX_TRAINING_SET_SIZE
from jvector_tpu_torch.quantization.sq import ScalarQuantization4
from jvector_tpu_torch.util.device import resolve_device


def _rows(vectors, ids: np.ndarray) -> np.ndarray:
    """``vectors[ids]`` as a float32 host array, from a tensor or a numpy
    array / memmap."""
    if isinstance(vectors, torch.Tensor):
        return vectors[torch.as_tensor(ids, device=vectors.device).long()].float().cpu().numpy()
    return np.asarray(vectors[ids], np.float32)


@dataclasses.dataclass
class CompactionSource:
    """One input segment: its graph, vectors and an optional live mask.

    ``vectors`` may be a host numpy array (memmap welcome): the PQ-sidecar
    mode of :func:`compact_indexes` uploads one wave of them at a time and
    never a whole source.
    """

    graph: GraphIndex
    vectors: torch.Tensor | np.ndarray  # [N_i, D]
    live: np.ndarray | None = None  # bool [N_i]; None = all live

    def live_ids(self) -> np.ndarray:
        n = int(self.graph.num_nodes)
        live = np.ones(n, bool) if self.live is None else np.array(self.live[:n], bool)
        live &= ~self.graph.deleted[:n].cpu().numpy()
        return np.where(live)[0].astype(np.int32)

    @classmethod
    def from_index_file(cls, path, live=None, device: torch.device | str | None = None) -> "CompactionSource":
        """Open a saved segment as a compaction input: the graph arrays on
        ``device`` (default: the card), the full-resolution vectors left as a
        host memmap (reference: the compactor's segment-file lifecycle,
        ``OnDiskGraphIndexCompactor.java:54+``)."""
        idx = load_index(path)
        vectors = idx.reader.read(f"feature/{FeatureId.INLINE_VECTORS}/vectors", mmap=True)
        return cls(graph=idx.graph_to_device(device), vectors=vectors, live=live)


def retrain_pq(
    sources: list[CompactionSource],
    live_ids: list[np.ndarray],
    base_pq: ProductQuantization,
    sim: SimilarityFunction,
    min_per_source: int = 1000,
    seed: int = 0,
) -> ProductQuantization:
    """Balanced proportional PQ retraining over the merged corpus
    (reference ``PQRetrainer.retrain`` + ``sampleBalanced``): each source
    sampled in proportion to its live count (at least ``min_per_source``
    each, at most the PQ training-set size in all), rows read in sorted
    order, a fresh PQ trained with the base PQ's M, K and threshold on the
    base PQ's device."""
    total = sum(len(x) for x in live_ids)
    rng = np.random.default_rng(seed)
    if total <= PQ_MAX_TRAINING_SET_SIZE:
        picks = live_ids
    else:
        picks = []
        for ids in live_ids:
            want = max(min(min_per_source, len(ids)), int(round(PQ_MAX_TRAINING_SET_SIZE * len(ids) / total)))
            picks.append(np.sort(rng.choice(ids, size=min(want, len(ids)), replace=False)))
    sample = np.concatenate([_rows(s.vectors, ids) for s, ids in zip(sources, picks)], axis=0)
    return ProductQuantization.compute(
        sample,
        m=base_pq.m,
        clusters=base_pq.clusters,
        globally_center=sim == SimilarityFunction.EUCLIDEAN,
        anisotropic_threshold=base_pq.anisotropic_threshold,
        device=base_pq.codebooks.device,
    )


def _pad_rows_to(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, n - x.shape[0])) if n > x.shape[0] else x


def _scores(provider, qstate, ids: torch.Tensor) -> torch.Tensor:
    """``provider`` scores of ``ids``, ``-inf`` where an id is -1."""
    return torch.where(ids >= 0, provider.score(qstate, torch.clamp(ids, min=0)), NEG_INF)


def compact_indexes(
    sources: list[CompactionSource],
    config: GraphConfig | None = None,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
    per_source_candidates: int = 32,
    wave: int = 256,
    pq: ProductQuantization | None = None,
    retrain: bool = True,
    refine_merged: bool = False,
) -> tuple[GraphIndex, object, list[np.ndarray]]:
    """Merge N segment indexes into one on the sources' device.

    Returns ``(merged_graph, merged_provider, mappers)``: ``mappers[i]``
    maps source i's old ordinal to the new one (-1 for dropped ordinals),
    the reference's ``OrdinalMapper`` contract.

    - ``pq=None`` (exact): the live vectors are uploaded and every score is
      full precision.
    - ``pq=ProductQuantization`` (the sidecar strategy): the codebooks are
      retrained on a balanced proportional sample (``retrain=False`` keeps
      them), every source is re-encoded, and every graph score (the
      in-source searches, the merged-space candidate scores, the prune) runs
      on codes through the ADC provider.  Sources may hold host arrays; one
      wave of query vectors is uploaded at a time.  The returned provider is
      the merged ``ADCScoreProvider``.

    ``refine_merged=True`` runs the ``refineCompactedGraph`` post-pass
    (``OnDiskGraphIndexCompactor.java:460-571``) over the output.
    """
    sim = SimilarityFunction.parse(sim)
    config = config or GraphConfig()
    dev = sources[0].graph.base.neighbors.device
    n_src = len(sources)

    # ordinal remap (OffsetMapper over the live ids)
    live_ids = [s.live_ids() for s in sources]
    offsets = np.cumsum([0] + [len(x) for x in live_ids])
    total = int(offsets[-1])
    mappers = []
    for i, s in enumerate(sources):
        m = np.full(int(s.graph.num_nodes), -1, np.int32)
        m[live_ids[i]] = np.arange(len(live_ids[i]), dtype=np.int32) + offsets[i]
        mappers.append(m)
    n_cap_out = bucket_capacity(total)

    if pq is not None:
        if retrain:
            pq = retrain_pq(sources, live_ids, pq, sim)
        # every source encoded in its full ordinal space (tombstones stay
        # traversable in the in-source searches)
        src_codes = [
            _pad_rows_to(pq.encode(_rows(s.vectors, np.arange(int(s.graph.num_nodes)))), s.graph.capacity)
            for s in sources
        ]
        merged_codes = torch.cat([c[torch.as_tensor(ids, device=c.device).long()] for c, ids in zip(src_codes, live_ids)])
        merged_provider = pq.provider(_pad_rows_to(merged_codes, n_cap_out), sim)
        src_providers = [pq.provider(c, sim) for c in src_codes]
        merged_vectors = None
    else:
        merged_vectors = torch.as_tensor(
            np.concatenate([_rows(s.vectors, ids) for s, ids in zip(sources, live_ids)]), device=dev
        )
        merged_provider = ExactScoreProvider(vectors=_pad_rows_to(merged_vectors, n_cap_out), sim=sim)
        src_providers = [
            ExactScoreProvider(vectors=torch.as_tensor(s.vectors, dtype=torch.float32, device=dev), sim=sim)
            for s in sources
        ]

    # the output layer, with a sink row at n_cap_out for the padded wave rows
    out = empty_layer(n_cap_out + 1, config.row_cap, dev)
    m_deg = config.max_degree
    mapper_dev = [torch.as_tensor(m, device=dev) for m in mappers]

    for si, s in enumerate(sources):
        ids_i = live_ids[si]
        for w0 in range(0, len(ids_i), wave):
            batch = ids_i[w0 : w0 + wave]
            batch_pad = np.concatenate([batch, np.full(wave - len(batch), -1, np.int32)])
            bdev = torch.as_tensor(np.maximum(batch_pad, 0), device=dev).long()
            valid = torch.as_tensor(batch_pad >= 0, device=dev)
            qvecs = torch.as_tensor(_rows(s.vectors, np.maximum(batch_pad, 0)), device=dev)  # [W, D]

            # same source: the existing neighbors, live-filtered and remapped
            nbrs = s.graph.base.neighbors[bdev]  # [W, R_src]
            nbr_new = torch.where(nbrs >= 0, mapper_dev[si][torch.clamp(nbrs, min=0).long()], -1)
            qstate_merged = merged_provider.prepare(qvecs)
            cand_ids, cand_scores = [nbr_new], [_scores(merged_provider, qstate_merged, nbr_new)]
            # other sources: a query-wave beam search into each, remapped
            for sj, other in enumerate(sources):
                if sj == si:
                    continue
                prov_j = src_providers[sj]
                entries = torch.where(valid, other.graph.entry_node, -1).to(torch.int32)
                beam = search_layer(
                    other.graph.base.neighbors, prov_j, prov_j.prepare(qvecs), entries,
                    beam_width=max(per_source_candidates, m_deg), max_iters=config.max_build_iters,
                )
                got = beam.ids[:, :per_source_candidates]
                got_new = torch.where(got >= 0, mapper_dev[sj][torch.clamp(got, min=0).long()], -1)
                cand_ids.append(got_new)
                cand_scores.append(_scores(merged_provider, qstate_merged, got_new))

            cids = torch.cat(cand_ids, dim=1)
            cscores = torch.cat(cand_scores, dim=1)
            self_new = mapper_dev[si][bdev]
            cids = torch.where((cids == self_new[:, None]) | ~valid[:, None], -1, cids)
            cscores = torch.where(cids >= 0, cscores, NEG_INF)
            # no top-ef cut here: the same-source neighbors include the
            # source graph's long-range edges, which score low, and dropping
            # them before the prune disconnects the merged graph.  The
            # tie-break jitter keeps quantized ties from pruning duplicate
            # bursts to identical neighbor sets
            cscores = tie_break_scores(torch.clamp(self_new, min=0), cids, cscores)
            cids, cscores = dedup_sorted_desc(cids, cscores)
            safe = torch.clamp(cids, min=0)
            simmat = tie_break_pairs(cids, merged_provider.pairwise(safe, safe))
            p_ids, p_scores, p_count = robust_prune(cids, cscores, simmat, m_deg, config.alphas)

            rows = torch.where(valid, self_new, n_cap_out).long()
            pad = torch.full((wave, config.row_cap - m_deg), -1, dtype=torch.int32, device=dev)
            out.neighbors[rows] = torch.cat([p_ids, pad], dim=1)
            out.scores[rows] = torch.cat([p_scores, torch.full(pad.shape, NEG_INF, device=dev)], dim=1)
            out.counts[rows] = p_count.to(torch.int32)

    # entry: the node nearest the centroid
    if merged_vectors is not None:
        centroid = torch.mean(merged_vectors, dim=0, keepdim=True)
    else:
        # streamed centroid: per-source sums on the host
        acc = None
        for s, ids in zip(sources, live_ids):
            v = _rows(s.vectors, ids)
            acc = v.sum(axis=0) if acc is None else acc + v.sum(axis=0)
        centroid = torch.as_tensor((acc / max(total, 1))[None, :], dtype=torch.float32, device=dev)
    all_ids = torch.arange(total, dtype=torch.int32, device=dev)[None, :]
    entry = torch.argmax(merged_provider.score(merged_provider.prepare(centroid), all_ids)[0]).to(torch.int32)

    merged = GraphIndex(
        layers=(GraphLayer(*(t[:n_cap_out] for t in out)),),
        level_node_ids=(),
        entry_node=entry,
        num_nodes=torch.tensor(total, dtype=torch.int32, device=dev),
        deleted=torch.zeros((n_cap_out,), dtype=torch.bool, device=dev),
    )
    if refine_merged or config.add_hierarchy:
        if merged_vectors is None:
            merged_host = np.concatenate([_rows(s.vectors, ids) for s, ids in zip(sources, live_ids)])
        if refine_merged:
            refine_vecs = merged_vectors if merged_vectors is not None else merged_host
            merged = refine_graph(merged, merged_provider, refine_vecs, config, chunk=min(1024, n_cap_out))
        if config.add_hierarchy:
            if merged_vectors is None:
                merged_vectors = torch.as_tensor(merged_host, device=dev)
            merged = GraphIndexBuilder(config).build_hierarchy(merged, merged_vectors, sim)
    return merged, merged_provider, mappers


def _prune_wave_streamed(provider, rows_dev: torch.Tensor, cids: torch.Tensor, max_degree: int, alphas):
    """One output wave of the streamed compactor: mask self and invalid
    entries, rescore the candidates against their owner on codes, dedup,
    diversity-prune (with the tie-break jitter: quantized scores tie
    exactly on tight clusters, and without it duplicate bursts pick the
    same neighbors and shatter into islands)."""
    owner_valid = rows_dev >= 0
    safe_rows = torch.clamp(rows_dev, min=0)
    cids = torch.where(owner_valid[:, None] & (cids != rows_dev[:, None]), cids, -1)
    cscores = torch.where(cids >= 0, provider.score_nodes(safe_rows, torch.clamp(cids, min=0)), NEG_INF)
    cscores = tie_break_scores(safe_rows, cids, cscores)
    cids, cscores = dedup_sorted_desc(cids, cscores)
    safe = torch.clamp(cids, min=0)
    return robust_prune(cids, cscores, tie_break_pairs(cids, provider.pairwise(safe, safe)), max_degree, alphas)


def _nbytes(t) -> int:
    if t is None:
        return 0
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else int(t.nbytes)


class _DeviceLedger:
    """The streamed compactor's own large device allocations, in logical
    bytes.

    The contract is that device memory stays bounded by one source's
    working set + the merged codes + wave transients, never the merged
    graph.  Every large tensor the compactor allocates is registered under
    a phase tag (the hierarchy sub-build, which is not instrumented tensor
    by tensor, registers an estimate), and ``peak`` is what the budget
    check reads.  On the card, ``allocated_peak`` records the allocator's
    own count above its level at the start as a cross-check.
    """

    def __init__(self, device: torch.device):
        self.live: dict[str, int] = {}
        self.peak = 0
        self.device = device
        self.base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        self.allocated_peak = 0 if device.type == "cuda" else None

    def _note(self) -> None:
        self.peak = max(self.peak, sum(self.live.values()))
        if self.allocated_peak is not None:
            self.allocated_peak = max(self.allocated_peak, torch.cuda.memory_allocated(self.device) - self.base)

    def add(self, tag: str, *tensors) -> None:
        self.live[tag] = sum(_nbytes(t) for t in tensors)
        self._note()

    def add_bytes(self, tag: str, nbytes: int) -> None:
        """Register an estimate for the allocations of a sub-call that is
        not instrumented tensor by tensor."""
        self.live[tag] = int(nbytes)
        self._note()

    def drop(self, tag: str) -> None:
        self.live.pop(tag, None)


def compact_on_disk(
    source_paths: list,
    out_path: str,
    config: GraphConfig | None = None,
    per_source_candidates: int = 32,
    wave: int = 256,
    live: "list[np.ndarray | None] | None" = None,
    save_fused: bool = False,
    add_hierarchy: bool | None = None,
    block: int = 262_144,
    device_budget_bytes: int | None = None,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> tuple[list[np.ndarray], dict]:
    """N:1 compaction of saved segments with bounded device memory, on
    ``device`` (default: the card).

    The streaming counterpart of :func:`compact_indexes` (reference
    ``OnDiskGraphIndexCompactor.runBatchesWithBackpressure:1290`` +
    ``CompactWriter``): the merged graph never exists in device or host
    memory; output rows go straight into reserved file extents.  The device
    holds, by phase:

    1. the merged SQ4 codes (the quantizer fitted on a balanced
       proportional sample, every live vector encoded in host blocks);
    2. one other source's plain ``[N, R]`` adjacency and SQ4 codes at a time, which
       every other source's waves beam-search; the candidate ids gather on
       the host (their scores are recomputed in the prune);
    3. the prune waves: rescore, dedup and diversity prune, rows written
       in place in the file.

    Sources are container files with the ``inline_vectors`` feature (any
    L0 layout).  The output holds the inline vectors, a fresh ``fused_sq4``
    sidecar (codes, constants, scale, offset; the fused table too with
    ``save_fused=True``, built on the host from the written rows) and, with
    the hierarchy, its upper levels; every tier serves it.

    Returns ``(mappers, stats)``: per-source old -> new ordinal maps and a
    dict whose ``peak_device_bytes`` (the ledger's count) must stay within
    ``device_budget_bytes`` (``MemoryError`` otherwise).
    """
    dev = resolve_device(device)
    config = config or GraphConfig()
    m_deg = config.max_degree
    ledger = _DeviceLedger(dev)

    def check_budget(phase: str) -> None:
        if device_budget_bytes is not None and ledger.peak > device_budget_bytes:
            raise MemoryError(
                f"compact_on_disk exceeded device budget in {phase}: {ledger.peak} > {device_budget_bytes} bytes"
            )

    # ---- open the sources ----------------------------------------------------
    readers = [IndexFileReader(str(p)) for p in source_paths]
    n_src = len(readers)
    sims = {r.meta.get("similarity", "euclidean") for r in readers}
    if len(sims) != 1:
        raise ValueError(f"sources mix similarities {sorted(sims)}: compaction merges one similarity")
    sim = SimilarityFunction.parse(next(iter(sims)))
    nbrs_mm = [_read_l0_neighbors(r, mmap=True) for r in readers]  # any layout, as [N, R]
    vecs_mm = [r.read(f"feature/{FeatureId.INLINE_VECTORS}/vectors") for r in readers]
    dim = vecs_mm[0].shape[1]
    n_nodes = [int(r.meta["num_nodes"]) for r in readers]
    entries_src = [int(r.meta["entry_node"]) for r in readers]

    live_ids = []
    for i, r in enumerate(readers):
        mask = np.ones(n_nodes[i], bool)
        if r.has_array("graph/deleted"):
            mask &= ~np.asarray(r.read("graph/deleted"))[: n_nodes[i]]
        if live is not None and live[i] is not None:
            mask &= np.asarray(live[i][: n_nodes[i]], bool)
        live_ids.append(np.where(mask)[0].astype(np.int32))
    offsets = np.cumsum([0] + [len(x) for x in live_ids])
    total = int(offsets[-1])
    mappers = []
    for i in range(n_src):
        m = np.full(n_nodes[i], -1, np.int32)
        m[live_ids[i]] = np.arange(len(live_ids[i]), dtype=np.int32) + offsets[i]
        mappers.append(m)

    # ---- merged SQ4 fit (balanced proportional sample) + encode --------------
    rng = np.random.default_rng(seed)
    parts = []
    for ids, vm in zip(live_ids, vecs_mm):
        want = min(len(ids), max(1000, int(round(SQ_MAX_TRAINING_SET_SIZE * len(ids) / max(total, 1)))))
        parts.append(np.asarray(vm[np.sort(rng.choice(ids, size=want, replace=False))], np.float32))
    sq = ScalarQuantization4.compute(np.concatenate(parts, axis=0), device=dev)
    mp = sq.compressed_size

    def encode_host(vm, ids_or_range, n: int) -> np.ndarray:
        out = np.empty((n, mp), np.uint8)
        for a in range(0, n, block):
            rows = np.asarray(vm[ids_or_range[a : a + block]], np.float32)
            out[a : a + len(rows)] = sq.encode(rows).cpu().numpy()
        return out

    merged_codes = torch.as_tensor(
        np.concatenate([encode_host(vm, ids, len(ids)) for ids, vm in zip(live_ids, vecs_mm)]), device=dev
    )
    w2_m, norm2_m = sq.node_constants(merged_codes)
    const_m = norm2_m if sim == SimilarityFunction.COSINE else w2_m

    def aug_provider(codes: torch.Tensor, const: torch.Tensor) -> SQ4ScoreProvider:
        return SQ4ScoreProvider(
            codes_packed=None,
            node_w2=const,
            node_norm2=const,
            fused_packed=torch.zeros((1, 0), dtype=torch.uint8, device=dev),
            fused_w2=torch.zeros((1, 0), dtype=torch.float32, device=dev),
            scale=sq.scale,
            offset=sq.offset,
            codes_aug=sq4_aug_rows(codes, const),
            sim=sim,
        )

    merged_provider = aug_provider(merged_codes, const_m)
    ledger.add("merged_codes", merged_codes, merged_provider.codes_aug, const_m)
    check_budget("merged codes")

    # ---- candidate ids on the host -------------------------------------------
    r_src_max = max(int(nm.shape[1]) for nm in nbrs_mm)
    c = per_source_candidates
    c_tot = r_src_max + (n_src - 1) * c
    cand = np.full((total, c_tot), -1, np.int32)

    # same source: the existing neighbors, remapped (gatherFromSameSource)
    for i in range(n_src):
        ids = live_ids[i]
        for a in range(0, len(ids), block):
            rows = np.asarray(nbrs_mm[i][ids[a : a + block]])
            cand[offsets[i] + a : offsets[i] + a + len(rows), : rows.shape[1]] = np.where(
                rows >= 0, mappers[i][np.maximum(rows, 0)], -1
            )

    # other sources: beam searches, one resident source at a time
    for sj in range(n_src if n_src > 1 else 0):
        adj_j = torch.as_tensor(np.array(nbrs_mm[sj], np.int32), device=dev)
        codes_j = torch.as_tensor(encode_host(vecs_mm[sj], np.arange(n_nodes[sj]), n_nodes[sj]), device=dev)
        w2_j, norm2_j = sq.node_constants(codes_j)
        const_j = norm2_j if sim == SimilarityFunction.COSINE else w2_j
        prov_j = aug_provider(codes_j, const_j)
        ledger.add("source", adj_j, codes_j, prov_j.codes_aug, const_j)
        check_budget(f"source {sj} working set")
        for si in range(n_src):
            if si == sj:
                continue
            # this (si searching sj) pair's column block: stable per sj order
            kj = sum(1 for x in range(n_src) if x != si and x < sj)
            cols = slice(r_src_max + kj * c, r_src_max + (kj + 1) * c)
            ids = live_ids[si]
            for a in range(0, len(ids), wave):
                batch = ids[a : a + wave]
                b = len(batch)
                # the tail wave is padded to the full width; -1 entries are inert
                qv = np.zeros((wave, dim), np.float32)
                qv[:b] = np.asarray(vecs_mm[si][batch], np.float32)
                ent = np.full(wave, -1, np.int32)
                ent[:b] = entries_src[sj]
                beam = search_layer(
                    adj_j, prov_j, prov_j.prepare(torch.as_tensor(qv, device=dev)), torch.as_tensor(ent, device=dev),
                    beam_width=max(c, m_deg), max_iters=config.max_build_iters,
                    expand_per_iter=config.build_expand,
                )
                got = beam.ids[:b, :c].cpu().numpy()
                cand[offsets[si] + a : offsets[si] + a + b, cols] = np.where(
                    got >= 0, mappers[sj][np.maximum(got, 0)], -1
                )
        del adj_j, codes_j, prov_j, w2_j, norm2_j, const_j
        ledger.drop("source")

    # ---- prune + rows streamed into reserved extents ---------------------------
    f = FeatureId.FUSED_SQ4
    vec_name = f"feature/{FeatureId.INLINE_VECTORS}/vectors"
    writer = IndexFileWriter(out_path)
    try:
        writer.reserve_array("graph/L0/neighbors", (total, m_deg), np.int32)
        writer.reserve_array("graph/L0/counts", (total,), np.int32)
        writer.reserve_array(vec_name, (total, dim), np.float32)
        for a in range(0, total, wave):
            b = min(wave, total - a)
            rows_np = np.full(wave, -1, np.int32)
            rows_np[:b] = np.arange(a, a + b, dtype=np.int32)
            cids = np.full((wave, c_tot), -1, np.int32)
            cids[:b] = cand[a : a + b]
            p_ids, _, p_count = _prune_wave_streamed(
                merged_provider, torch.as_tensor(rows_np, device=dev), torch.as_tensor(cids, device=dev),
                m_deg, config.alphas,
            )
            writer.write_rows("graph/L0/neighbors", a, p_ids[:b].cpu().numpy())
            writer.write_rows("graph/L0/counts", a, p_count[:b].to(torch.int32).cpu().numpy())

        # inline vectors: a host stream, never on the device
        for i, ids in enumerate(live_ids):
            for a in range(0, len(ids), block):
                writer.write_rows(vec_name, int(offsets[i]) + a, np.asarray(vecs_mm[i][ids[a : a + block]], np.float32))

        # entry: the node nearest the streamed centroid
        acc = np.zeros(dim, np.float64)
        for ids, vm in zip(live_ids, vecs_mm):
            for a in range(0, len(ids), block):
                acc += np.asarray(vm[ids[a : a + block]], np.float64).sum(axis=0)
        centroid = torch.as_tensor((acc / max(total, 1))[None, :], dtype=torch.float32, device=dev)
        qs = merged_provider.prepare(centroid)
        best_id, best_sc = 0, -np.inf
        for a in range(0, total, 1 << 20):
            b = min(1 << 20, total - a)
            sc = merged_provider.score(qs, (a + torch.arange(b, dtype=torch.int32, device=dev))[None, :])[0]
            j = int(torch.argmax(sc))
            if float(sc[j]) > best_sc:
                best_id, best_sc = a + j, float(sc[j])
        entry = int(best_id)

        # the SQ4 sidecar (codes + constants; the fused table on request)
        codes_np = merged_codes.cpu().numpy()
        const_np = const_m.cpu().numpy().astype(np.float32)
        writer.add_array(f"feature/{f}/codes_packed", codes_np)
        writer.add_array(f"feature/{f}/node_const", const_np)
        writer.add_array(f"feature/{f}/scale", sq.scale.cpu().numpy())
        writer.add_array(f"feature/{f}/offset", sq.offset.cpu().numpy())

        num_levels = 1
        hier = config.add_hierarchy if add_hierarchy is None else add_hierarchy
        if hier and total > 1:
            levels = assign_levels(total, m_deg, seed)
            sub_ids = np.where(levels >= 1)[0].astype(np.int32)
            if len(sub_ids):
                # only the upper-level nodes' vectors (about N / M of them)
                sub_vecs = np.empty((len(sub_ids), dim), np.float32)
                for i, ids in enumerate(live_ids):
                    lo, hi = int(offsets[i]), int(offsets[i + 1])
                    sel = np.where((sub_ids >= lo) & (sub_ids < hi))[0]
                    sub_vecs[sel] = vecs_mm[i][ids[sub_ids[sel] - lo]]
                shell = GraphIndex(
                    layers=(empty_layer(8, 8, dev),),
                    level_node_ids=(),
                    entry_node=torch.tensor(entry, dtype=torch.int32, device=dev),
                    num_nodes=torch.tensor(total, dtype=torch.int32, device=dev),
                    deleted=torch.zeros((8,), dtype=torch.bool, device=dev),
                )
                sub_dev = torch.as_tensor(sub_vecs, device=dev)
                ledger.add("hier", sub_dev)
                # the sub-build's own tables (unpacked neighbors + scores):
                # an estimate, the sub-build is not instrumented
                ledger.add_bytes("hier_build", len(sub_ids) * config.row_cap * 8 * 2)
                check_budget("hierarchy")
                shell = GraphIndexBuilder(config).build_hierarchy_from_subset(
                    shell, sub_ids, sub_dev, levels[sub_ids], sim
                )
                ledger.drop("hier")
                ledger.drop("hier_build")
                for lv in range(1, shell.num_levels):
                    writer.add_array(f"graph/L{lv}/neighbors", shell.layers[lv].neighbors.cpu().numpy())
                    writer.add_array(f"graph/L{lv}/counts", shell.layers[lv].counts.cpu().numpy())
                    writer.add_array(f"graph/L{lv}/node_ids", shell.level_node_ids[lv - 1].cpu().numpy())
                num_levels = shell.num_levels

        if save_fused:
            writer.reserve_array(f"feature/{f}/fused_packed", (total, m_deg * mp), np.uint8)
            writer.reserve_array(f"feature/{f}/fused_w2", (total, m_deg), np.float32)
            # re-read the just-written adjacency rows from the file, in blocks
            e = writer._arrays["graph/L0/neighbors"]
            for a in range(0, total, block):
                b = min(block, total - a)
                writer._f.flush()
                adj_rows = np.fromfile(out_path, dtype=np.int32, count=b * m_deg,
                                       offset=e.offset + a * m_deg * 4).reshape(b, m_deg)
                fp, fw = build_fused_sq4_host(adj_rows, codes_np, const_np)
                writer.write_rows(f"feature/{f}/fused_packed", a, fp)
                writer.write_rows(f"feature/{f}/fused_w2", a, fw)

        writer.set_meta(
            num_levels=num_levels,
            entry_node=entry,
            num_nodes=total,
            features=[FeatureId.INLINE_VECTORS, f],
            similarity=sim.value,
            dimension=dim,
            compacted_from=[str(p) for p in source_paths],
        )
    finally:
        writer.close()

    stats = {"total": total, "peak_device_bytes": ledger.peak, "allocated_peak_bytes": ledger.allocated_peak,
             "sources": n_src}
    return mappers, stats
