"""Microbenchmarks of the port's hot primitives (counterpart of
``jvector_tpu/bench/micro.py``; reference: benchmarks-jmh).

    python -m jvector_tpu_torch.bench.micro [--n 100000 --dim 128 --q 1024 --reps 5]
                                            [--out rows.jsonl] [--device cuda]

Times each primitive on one device and prints one JSON row each, with the
run's provenance (:func:`jvector_tpu_torch.bench.diagnostics.run_metadata`),
in the JAX package's order and under its names, units and work counts:
exact block scoring, PQ train + encode, 8-bit PQ ADC (K5), LUT16 ADC (K6),
SQ4 encode, the graph build (waves of 256), SQ4 fused edge scoring and a
two-pass search wave (SQ4 first pass, exact rerank at beam 40).  Timed
calls end in a device synchronize.  ``--device cpu`` runs the kernels'
plain twins (for tests, not for numbers).  The streamed-compaction row
(``--compact``) needs compaction, which is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from jvector_tpu_torch.bench.diagnostics import run_metadata
from jvector_tpu_torch.graph import GraphConfig, LUT16ScoreProvider, build_graph, search
from jvector_tpu_torch.ops.adc16 import pack_nibbles
from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel
from jvector_tpu_torch.ops.similarity import pairwise_scores
from jvector_tpu_torch.quantization import ProductQuantization, ScalarQuantization4
from jvector_tpu_torch.util.datasets import synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timeit(fn, dev: torch.device, reps: int = 5, warmup: int = 2) -> float:
    """Mean seconds per call of ``fn`` over ``reps`` calls, after ``warmup``."""
    for _ in range(warmup):
        fn()
    _sync(dev)
    t0 = time.time()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.time() - t0) / reps


def run_micro(n: int = 100_000, dim: int = 128, q: int = 1024, reps: int = 5,
              device: torch.device | str = "cuda") -> list[dict]:
    """The eight benchmark rows (see the module docstring)."""
    dev = resolve_device(device)
    rows = []
    meta = run_metadata({"n": n, "dim": dim, "q": q}, dev)

    def emit(name, seconds, work, unit):
        rows.append({"benchmark": name, "seconds": round(seconds, 6), "value": round(work / seconds, 1),
                     "unit": unit, **{k: meta[k] for k in ("git_sha", "device", "timestamp")}})

    def timeit(fn):
        return _timeit(fn, dev, reps=reps)

    ds = synthetic_dataset(n=n, dim=dim, n_queries=q, k=10, n_clusters=max(64, n // 500), seed=0, device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    queries = torch.as_tensor(ds.queries, device=dev)

    # exact block scoring (the VectorUtil dot/L2 surface, batched)
    nq = min(q, 256)
    blk = base[:4096]
    emit("exact_block_score", timeit(lambda: pairwise_scores(queries[:nq], blk, "euclidean")), nq * blk.shape[0],
         "pairs/s")

    # PQ train + encode + 8-bit ADC (K5)
    t0 = time.time()
    pq = ProductQuantization.compute(base, m=dim // 4, clusters=256)
    codes = pq.encode(base)
    _sync(dev)
    emit("pq_train_encode", time.time() - t0, n, "vectors/s")
    luts = pq.provider(codes, "euclidean").prepare(queries[:nq])
    cand = torch.as_tensor(np.random.default_rng(0).integers(0, n, (nq, 64)), dtype=torch.int32, device=dev)
    emit("adc8_score", timeit(lambda: adc_score_kernel(luts, codes[cand.long()])), nq * 64, "candidates/s")

    # LUT16 (4-bit PQ) ADC (K6)
    pq16 = ProductQuantization.compute(base, m=dim // 2, clusters=16)
    prov16 = LUT16ScoreProvider(codes_packed=pack_nibbles(pq16.encode(base)), fused_packed=None,
                                codebooks=pq16.codebooks, center=pq16.center, sim="euclidean")
    luts16 = prov16.prepare(queries[:nq])
    emit("lut16_adc_score", timeit(lambda: prov16.score(luts16, cand)), nq * 64, "candidates/s")

    # SQ4 encode + fused edge scoring over a built graph
    t0 = time.time()
    sq = ScalarQuantization4.compute(base)
    sq_codes = sq.encode(base)
    _sync(dev)
    emit("sq4_encode", time.time() - t0, n, "vectors/s")

    cfg = GraphConfig(max_degree=32, ef_construction=100, wave_size=256)
    t0 = time.time()
    graph, exact = build_graph(base, "euclidean", cfg)
    _sync(dev)
    emit("graph_build", time.time() - t0, n, "nodes/s")

    sq_codes = torch.nn.functional.pad(sq_codes, (0, 0, 0, graph.capacity - sq_codes.shape[0]))
    prov = sq.provider_for_graph(sq_codes, graph.base.neighbors, "euclidean")
    qs = prov.prepare(queries[:q])
    sel = torch.as_tensor(np.random.default_rng(1).integers(0, n, (q, 4)), dtype=torch.int32, device=dev)
    emit("sq4_fused_edge_score", timeit(lambda: prov.score_edges(qs, sel)), q * 4 * graph.row_cap, "edges/s")

    # full two-pass search wave
    def wave():
        return search(graph, prov, queries[:q], top_k=10, beam_width=40, rerank_k=40, reranker=exact).ids

    emit("search_wave_sq4_rerank", timeit(wave), q, "queries/s")
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="append the rows to this JSONL file")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--q", type=int, default=1024)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (the kernels' plain twins)")
    p.add_argument("--compact", action="store_true", help="the streamed-compaction row (not ported)")
    args = p.parse_args(argv)
    if args.compact:
        raise NotImplementedError("the compaction benchmark needs disk/compaction.py, not ported yet (ROADMAP.md)")
    rows = run_micro(n=args.n, dim=args.dim, q=args.q, reps=args.reps, device=args.device)
    out = "\n".join(json.dumps(r) for r in rows)
    print(out)
    if args.out:
        with open(args.out, "a") as f:
            f.write(out + "\n")
    return rows


if __name__ == "__main__":
    main()
