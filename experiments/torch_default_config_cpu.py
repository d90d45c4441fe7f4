"""The default configuration's recall in the JAX package (the reference),
on the CPU, for corpora too large for the tests.

    JAX_PLATFORMS=cpu python experiments/torch_default_config_cpu.py --n 50000
    JAX_PLATFORMS=cpu python experiments/torch_default_config_cpu.py --n 20000 --queries 512 --port

Builds ``synthetic_dataset(n, dim=128, n_queries=queries, k=10,
n_clusters=max(64, n // 500), seed=0)`` (the corpora of ``chip_smoke.py``'s
default-config path: 8192 queries, or 512 for its 20k parity cell) with
PQ M=16, K=256, uncentered, trained by the JAX
package, ``GraphConfig(max_degree=32, ef_construction=100,
neighbor_overflow=1.2, add_hierarchy=True)`` and the PQ provider, then
prints recall@10 over the first 1024 queries (or all): the PQ first pass + FP32
rerank at beam = rerank_k = 10/20/50/100, and an exact first pass at beam
100 over the same graph.  ``--port`` builds the same graph in the PyTorch
port on the CPU from the JAX-trained PQ and prints its recall beside.
One JSON line per result.
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

from jvector_tpu.graph import GraphConfig, build_graph, search  # noqa: E402
from jvector_tpu.graph.index import bucket_capacity  # noqa: E402
from jvector_tpu.graph.score import ExactScoreProvider  # noqa: E402
from jvector_tpu.quantization import ProductQuantization  # noqa: E402
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

BEAMS = (10, 20, 50, 100)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=50_000)
    p.add_argument("--queries", type=int, default=8192, help="queries drawn (recall over the first 1024)")
    p.add_argument("--port", action="store_true", help="also build and search with the PyTorch port on the CPU")
    args = p.parse_args()
    n = args.n
    ds = synthetic_dataset(n=n, dim=128, n_queries=args.queries, k=10, n_clusters=max(64, n // 500), seed=0)
    gt, queries = ds.ground_truth[:1024], ds.queries[:1024]
    cfg = dict(max_degree=32, ef_construction=100, neighbor_overflow=1.2, add_hierarchy=True)
    t0 = time.time()
    pq = ProductQuantization.compute(ds.base, m=16, clusters=256, globally_center=False)
    n_cap = bucket_capacity(n)
    codes = np.zeros((n_cap, 16), np.uint8)
    codes[:n] = np.asarray(pq.encode(ds.base))
    graph, _ = build_graph(ds.base, "euclidean", GraphConfig(**cfg), provider=pq.provider(jnp.asarray(codes), "euclidean"))
    build_s = time.time() - t0
    pv = np.zeros((n_cap, 128), np.float32)
    pv[:n] = ds.base
    exact = ExactScoreProvider(vectors=jnp.asarray(pv))
    first = pq.provider(jnp.asarray(codes[:n]), "euclidean")
    row = {"package": "jax", "n": n, "build_seconds_cpu": build_s, "levels": graph.num_levels,
           "level_sizes": [n] + [int(x.shape[0]) for x in graph.level_node_ids],
           "average_degree": float(np.asarray(graph.base.counts)[:n].mean())}
    for beam in BEAMS:
        r = search(graph, first, jnp.asarray(queries), top_k=10, beam_width=beam, rerank_k=beam, reranker=exact)
        row[f"recall_pq_{beam}"] = recall_at_k(np.asarray(r.ids), gt, 10)
    r = search(graph, exact, jnp.asarray(queries), top_k=10, beam_width=100)
    row["recall_exact_first_pass_100"] = recall_at_k(np.asarray(r.ids), gt, 10)
    print(json.dumps(row), flush=True)

    if args.port:
        import torch

        from jvector_tpu_torch import convert
        from jvector_tpu_torch.graph import ExactScoreProvider as TExact
        from jvector_tpu_torch.graph import GraphConfig as TConfig
        from jvector_tpu_torch.graph import build_graph as tbuild
        from jvector_tpu_torch.graph import search as tsearch

        tpq = convert.pq_from_numpy(np.asarray(pq.codebooks), None, 128, device="cpu")
        t0 = time.time()
        tg, _ = tbuild(ds.base, "euclidean", TConfig(**cfg), provider=tpq.provider(torch.as_tensor(codes), "euclidean"),
                       device="cpu")
        row = {"package": "port", "n": n, "build_seconds_cpu": time.time() - t0, "levels": tg.num_levels,
               "level_sizes": [n] + [int(x.shape[0]) for x in tg.level_node_ids],
               "average_degree": tg.average_degree()}
        texact = TExact(vectors=torch.as_tensor(pv))
        tfirst = tpq.provider(torch.as_tensor(codes[:n]), "euclidean")
        tq = torch.as_tensor(queries)
        for beam in BEAMS:
            r = tsearch(tg, tfirst, tq, top_k=10, beam_width=beam, rerank_k=beam, reranker=texact)
            row[f"recall_pq_{beam}"] = recall_at_k(r.ids.numpy(), gt, 10)
        r = tsearch(tg, texact, tq, top_k=10, beam_width=100)
        row["recall_exact_first_pass_100"] = recall_at_k(r.ids.numpy(), gt, 10)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
