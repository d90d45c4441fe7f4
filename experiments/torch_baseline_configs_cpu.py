"""BASELINE configs 3 and 4 in the JAX package (the reference), on the CPU:
the recall figures ``chip_smoke.py``'s ``baseline_configs`` phase holds the
port to at n = 20,000.

    JAX_PLATFORMS=cpu python experiments/torch_baseline_configs_cpu.py
    JAX_PLATFORMS=cpu python experiments/torch_baseline_configs_cpu.py --n 20000 --config 3

The corpora and quantizers of ``experiments/baseline_configs_demo.py``:

- config 3 (deep1M-like): ``synthetic_dataset(n, 96, n_queries=8192, k=10,
  sim="dot_product", n_clusters=max(64, n // 500), seed=7)``, base and
  queries L2-normalized, ``build_graph(base, "dot_product",
  GraphConfig(max_degree=32, ef_construction=100))``; serves (a)
  anisotropic PQ (m = 24, K = 256, uncentred, T = 0.2) through
  ``build_fused_codes`` / ``FusedADCScoreProvider``, (b) the same PQ with
  T = -1, (c) anisotropic SQ4 (``encode_anisotropic(threshold=0.2)``)
  through ``provider_for_graph`` and plain SQ4 beside it;
- config 4 (ada-002-like): ``synthetic_dataset(n, 1536, n_queries=8192,
  k=10, sim="cosine", n_clusters=max(64, n // 500), seed=8)``, normalized,
  built the same way with ``"dot_product"``; BQ first pass with NVQ rerank,
  and with FP32 rerank.

Every serve reranks exactly-or-NVQ at ``rerank_k = beam`` (E = 1, no
repack); recall@10 over the first 512 queries against the exact dot-product
top-10, at beams 20, 30, 40, 60, 80 and 120.  NVQ encodes in row blocks
(each vector's codes depend on that vector alone), which bounds the CPU
memory of its growth-rate sweep at d = 1536.  One JSON line per config;
seconds are this CPU's.
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

from jvector_tpu.graph import (  # noqa: E402
    FusedADCScoreProvider,
    GraphConfig,
    build_fused_codes,
    build_graph,
    search,
)
from jvector_tpu.quantization import (  # noqa: E402
    BinaryQuantization,
    NVQuantization,
    ProductQuantization,
    ScalarQuantization4,
)
from jvector_tpu.quantization.nvq import NVQVectors  # noqa: E402
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

BEAMS = (20, 30, 40, 60, 80, 120)
GT_QUERIES, TOP_K = 512, 10
NVQ_BLOCK = 2048


def corpus(n: int, dim: int, sim: str, seed: int):
    ds = synthetic_dataset(n=n, dim=dim, n_queries=8192, k=TOP_K, sim=sim, n_clusters=max(64, n // 500), seed=seed)
    base = np.asarray(ds.base)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    qs = np.asarray(ds.queries)[:GT_QUERIES]
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    gt = np.argsort(-(qs @ base.T), axis=1, kind="stable")[:, :TOP_K]
    return base, qs, gt


def pad_rows(codes, capacity: int):
    codes = jnp.asarray(codes)
    return jnp.concatenate([codes, jnp.zeros((capacity - codes.shape[0], codes.shape[1]), codes.dtype)])


def sweep(graph, prov, reranker, qs, gt) -> dict:
    q = jnp.asarray(qs)
    out = {}
    for b in BEAMS:
        res = search(graph, prov, q, top_k=TOP_K, beam_width=b, rerank_k=b, reranker=reranker)
        out[str(b)] = recall_at_k(np.asarray(res.ids), gt, TOP_K)
    return out


def config3(n: int) -> dict:
    base, qs, gt = corpus(n, 96, "dot_product", 7)
    t0 = time.time()
    graph, exact = build_graph(base, "dot_product", GraphConfig(max_degree=32, ef_construction=100))
    jax.block_until_ready(graph.base.neighbors)
    row = {"config": 3, "n": n, "dim": 96, "build_seconds_cpu": time.time() - t0, "recall": {}}
    for name, thr in (("aniso_pq", 0.2), ("plain_pq", -1.0)):
        pq = ProductQuantization.compute(base, m=24, clusters=256, globally_center=False, anisotropic_threshold=thr)
        codes = pad_rows(pq.encode(base), graph.capacity)
        prov = FusedADCScoreProvider(codes=codes, fused_codes=build_fused_codes(graph.base.neighbors, codes),
                                     codebooks=pq.codebooks, center=pq.center, sim="dot_product")
        row["recall"][name] = sweep(graph, prov, exact, qs, gt)
    sq = ScalarQuantization4.compute(base)
    for name, codes in (("aniso_sq4", sq.encode_anisotropic(base, threshold=0.2)), ("plain_sq4", sq.encode(base))):
        prov = sq.provider_for_graph(pad_rows(codes, graph.capacity), graph.base.neighbors, "dot_product")
        row["recall"][name] = sweep(graph, prov, exact, qs, gt)
    return row


def config4(n: int) -> dict:
    base, qs, gt = corpus(n, 1536, "cosine", 8)
    t0 = time.time()
    graph, exact = build_graph(base, "dot_product", GraphConfig(max_degree=32, ef_construction=100))
    jax.block_until_ready(graph.base.neighbors)
    row = {"config": 4, "n": n, "dim": 1536, "build_seconds_cpu": time.time() - t0, "recall": {}}
    bq = BinaryQuantization.compute(base)
    bq_prov = bq.provider(bq.encode(base))
    nvq = NVQuantization.compute(base)
    parts = [nvq.encode(base[i : i + NVQ_BLOCK]) for i in range(0, n, NVQ_BLOCK)]
    vecs = NVQVectors(codes=jnp.concatenate([p.codes for p in parts]),
                      params=jnp.concatenate([p.params for p in parts]), nvq=nvq)
    row["nvq_compressed_size"] = vecs.compressed_size
    row["recall"]["bq_nvq"] = sweep(graph, bq_prov, vecs.provider("dot_product"), qs, gt)
    row["recall"]["bq_fp32"] = sweep(graph, bq_prov, exact, qs, gt)
    return row


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--config", type=int, choices=(3, 4), action="append", help="default: both")
    args = p.parse_args()
    for c in args.config or (3, 4):
        print(json.dumps({"package": "jax", **(config3 if c == 3 else config4)(args.n)}), flush=True)


if __name__ == "__main__":
    main()
