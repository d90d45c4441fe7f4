"""The index lifecycle in the JAX package (the reference), on the CPU: the
recall figures ``chip_smoke.py``'s ``lifecycle`` phase holds the port to.

    JAX_PLATFORMS=cpu python experiments/torch_lifecycle_cpu.py
    JAX_PLATFORMS=cpu python experiments/torch_lifecycle_cpu.py --part nndescent
    JAX_PLATFORMS=cpu python experiments/torch_lifecycle_cpu.py --seeds 8

Two parts, one JSON line each; seconds are this CPU's:

- ``nndescent``: the SQ4 path's corpus, ``synthetic_dataset(200_000, 128,
  n_queries=8192, k=10, n_clusters=400, seed=0)``; the segment is the
  20,000 vectors the phase deletes (``np.sort(default_rng(11).choice(200_000,
  20_000, replace=False))``), built by ``nn_descent_build(segment,
  "euclidean", GraphConfig(max_degree=32, ef_construction=100))`` at its
  defaults (8 rounds, chunks of 16,384, seed 0); recall@10 of an exact
  first pass at beams 50 and 100 over the corpus's first 1024 queries,
  against the exact top-10 within the segment.
- ``pq_compaction``: ``synthetic_dataset(20_000, 128, n_queries=1024, k=10,
  n_clusters=64, seed=0)`` split 8,334 / 6,666 / 5,000 (the uneven split
  of ``tests/test_compaction.py``), each segment ``build_graph`` at the
  same config; a base PQ (m = 16, K = 256, centred) trained on the first
  segment; ``compact_indexes(sources, cfg, "euclidean", pq=base_pq)`` with
  host-array sources and the retrain (``retrain_pq``: all 20,000 live rows,
  under the 131,072-row cap); recall@10 of the merged graph's ADC first
  pass with exact rerank at ``rerank_k = beam``, beams 50 and 100, over the
  1024 queries, against the ground truth mapped through the mappers.
  ``--seeds K`` repeats the compaction (on the same three segments) with
  the retrain's k-means drawn from seeds 0..K-1 (``retrain_pq`` trains
  with ``ProductQuantization.compute``'s default seed 0; the port cannot
  reproduce ``jax.random``'s draws, so the spread over seeds is the
  reference's own), and adds the mean and range.  ``carried`` is the same
  compaction with ``retrain=False`` on codebooks both packages draw alike
  without training (:func:`carried_codebooks`: each subspace's 256
  centroids are rows of the first segment, ``default_rng(11)``, no
  centring), the like-for-like figure the port is held to tightly.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jvector_tpu.quantization.pq as jpq  # noqa: E402
from jvector_tpu.disk import CompactionSource, compact_indexes  # noqa: E402
from jvector_tpu.graph import ExactScoreProvider, GraphConfig, build_graph, search  # noqa: E402
from jvector_tpu.graph.nndescent import nn_descent_build  # noqa: E402
from jvector_tpu.quantization import ProductQuantization  # noqa: E402
import jvector_tpu.util.datasets as jds  # noqa: E402
from jvector_tpu.util.datasets import exact_ground_truth, recall_at_k, synthetic_dataset  # noqa: E402

CFG = dict(max_degree=32, ef_construction=100)
BEAMS = (50, 100)
DELETE_SEED, N_DELETE, N_SQ4 = 11, 20_000, 200_000
PQ_N, PQ_SPLITS = 20_000, ((0, 8_334), (8_334, 15_000), (15_000, 20_000))


def carried_codebooks(rows: np.ndarray, m: int = 16, k: int = 256, seed: int = DELETE_SEED) -> np.ndarray:
    """``[m, k, d/m]`` codebooks drawn from ``rows`` (no training): the
    centroids of subspace i are k distinct rows' i-th slices."""
    rng = np.random.default_rng(seed)
    s = rows.shape[1] // m
    return np.stack([rows[rng.choice(len(rows), k, replace=False), i * s : (i + 1) * s] for i in range(m)])


def _corpus_without_ground_truth(**kw):
    """``synthetic_dataset``'s draws without its ground truth (a [8192,
    200,000] score matrix would take ~7 GB here; the part needs the
    segment's own)."""
    real = jds.exact_ground_truth
    jds.exact_ground_truth = lambda base, queries, k, *a, **k2: np.zeros((len(queries), k), np.int32)
    try:
        return synthetic_dataset(**kw)
    finally:
        jds.exact_ground_truth = real


def nndescent_part() -> dict:
    t0 = time.time()
    ds = _corpus_without_ground_truth(n=N_SQ4, dim=128, n_queries=8192, k=10, n_clusters=N_SQ4 // 500, seed=0)
    deleted = np.sort(np.random.default_rng(DELETE_SEED).choice(N_SQ4, N_DELETE, replace=False))
    seg = ds.base[deleted]
    queries = ds.queries[:1024]
    gt = exact_ground_truth(seg, queries, 10)
    t1 = time.time()
    graph, prov = nn_descent_build(seg, "euclidean", GraphConfig(**CFG))
    build_s = time.time() - t1
    recall = {b: recall_at_k(np.asarray(search(graph, prov, jnp.asarray(queries), top_k=10, beam_width=b).ids), gt, 10)
              for b in BEAMS}
    return {"part": "nndescent", "n": N_DELETE, "recall": recall, "build_seconds": build_s,
            "seconds": time.time() - t0}


def pq_compaction_part(seeds: int) -> dict:
    t0 = time.time()
    ds = synthetic_dataset(n=PQ_N, dim=128, n_queries=1024, k=10, n_clusters=64, seed=0)
    cfg = GraphConfig(**CFG)
    sources = [CompactionSource(graph=build_graph(ds.base[a:b], "euclidean", cfg)[0], vectors=ds.base[a:b])
               for a, b in PQ_SPLITS]
    base_pq = ProductQuantization.compute(ds.base[: PQ_SPLITS[0][1]], m=16, clusters=256)
    compute = jpq.ProductQuantization.compute

    def recall(merged, prov, mappers):
        new_of_old = np.concatenate(mappers)
        merged_vecs = np.empty_like(ds.base)
        merged_vecs[new_of_old] = ds.base
        exact = ExactScoreProvider(vectors=jnp.asarray(merged_vecs))
        gt = new_of_old[ds.ground_truth[:, :10]]
        return {b: recall_at_k(np.asarray(search(merged, prov, jnp.asarray(ds.queries), top_k=10, beam_width=b,
                                                 rerank_k=b, reranker=exact).ids), gt, 10) for b in BEAMS}

    by_seed, compact_s = {}, []
    for seed in range(seeds):
        jpq.ProductQuantization.compute = staticmethod(lambda *a, _s=seed, **k: compute(*a, **k, seed=_s))
        try:
            t1 = time.time()
            merged, prov, mappers = compact_indexes(sources, cfg, "euclidean", pq=base_pq)
            compact_s.append(time.time() - t1)
        finally:
            jpq.ProductQuantization.compute = staticmethod(compute)
        by_seed[seed] = recall(merged, prov, mappers)
    carried = ProductQuantization(codebooks=jnp.asarray(carried_codebooks(ds.base[: PQ_SPLITS[0][1]])), center=None,
                                  original_dim=ds.base.shape[1])
    t1 = time.time()
    merged, prov, mappers = compact_indexes(sources, cfg, "euclidean", pq=carried, retrain=False)
    out = {"part": "pq_compaction", "n": PQ_N, "recall": by_seed[0], "compact_seconds": compact_s,
           "carried": {"recall": recall(merged, prov, mappers), "compact_seconds": time.time() - t1},
           "seconds": time.time() - t0}
    if seeds > 1:
        out["recall_by_seed"] = by_seed
        out["recall_mean"] = {b: float(np.mean([r[b] for r in by_seed.values()])) for b in BEAMS}
        out["recall_range"] = {b: [min(r[b] for r in by_seed.values()), max(r[b] for r in by_seed.values())]
                               for b in BEAMS}
    return out


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--part", choices=("nndescent", "pq_compaction", "both"), default="both")
    p.add_argument("--seeds", type=int, default=1, help="retrain seeds of the PQ compaction (0..K-1)")
    args = p.parse_args()
    if args.part in ("nndescent", "both"):
        print(json.dumps(nndescent_part()), flush=True)
    if args.part in ("pq_compaction", "both"):
        print(json.dumps(pq_compaction_part(args.seeds)), flush=True)


if __name__ == "__main__":
    main()
