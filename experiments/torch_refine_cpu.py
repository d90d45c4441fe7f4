"""The default configuration's graph before and after ``refine_graph`` in
the JAX package (the reference), on the CPU, and the port's refine of the
same graph.

    JAX_PLATFORMS=cpu python experiments/torch_refine_cpu.py --n 20000 --port
    JAX_PLATFORMS=cpu python experiments/torch_refine_cpu.py --n 200000 --queries 8192

Builds the default-config graph of ``experiments/torch_default_config_cpu.py``
(``synthetic_dataset(n, dim=128, n_queries=queries, k=10,
n_clusters=max(64, n // 500), seed=0)``; 8192 queries draws
``chip_smoke.py``'s 200k queries), PQ M=16, K=256, uncentered,
``GraphConfig(max_degree=32, ef_construction=100, neighbor_overflow=1.2,
add_hierarchy=True)``) in the JAX package, then refines its base layer
with the PQ provider in chunks of 1024, as ``chip_smoke.py``'s search-API
phase does, and prints recall@10 at beam 100 (PQ first pass + FP32 rerank,
over the first 1024 queries) before and after, and the average degree.
``--port`` carries the JAX graph and codebooks into the PyTorch port and
refines there too (on the CPU, K5's twin).  One JSON line per package.
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
from jvector_tpu.graph.builder import refine_graph  # noqa: E402
from jvector_tpu.graph.index import bucket_capacity  # noqa: E402
from jvector_tpu.graph.score import ExactScoreProvider  # noqa: E402
from jvector_tpu.quantization import ProductQuantization  # noqa: E402
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

CFG = dict(max_degree=32, ef_construction=100, neighbor_overflow=1.2, add_hierarchy=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--queries", type=int, default=1024, help="queries drawn (recall over the first 1024)")
    p.add_argument("--port", action="store_true", help="also refine the same graph in the PyTorch port")
    args = p.parse_args()
    n = args.n
    ds = synthetic_dataset(n=n, dim=128, n_queries=args.queries, k=10, n_clusters=max(64, n // 500), seed=0)
    gt, queries = ds.ground_truth[:1024], ds.queries[:1024]
    pq = ProductQuantization.compute(ds.base, m=16, clusters=256, globally_center=False)
    n_cap = bucket_capacity(n)
    codes = np.zeros((n_cap, 16), np.uint8)
    codes[:n] = np.asarray(pq.encode(ds.base))
    build_prov = pq.provider(jnp.asarray(codes), "euclidean")
    graph, _ = build_graph(ds.base, "euclidean", GraphConfig(**CFG), provider=build_prov)
    pv = np.zeros((n_cap, 128), np.float32)
    pv[:n] = ds.base
    exact = ExactScoreProvider(vectors=jnp.asarray(pv))
    first = pq.provider(jnp.asarray(codes[:n]), "euclidean")

    def recall(g):
        r = search(g, first, jnp.asarray(queries), top_k=10, beam_width=100, rerank_k=100, reranker=exact)
        return recall_at_k(np.asarray(r.ids), gt, 10)

    t0 = time.time()
    refined = refine_graph(graph, build_prov, jnp.asarray(ds.base), GraphConfig(**CFG), chunk=1024)
    jax.block_until_ready(refined.base.neighbors)
    row = {"package": "jax", "n": n, "recall_100_before": recall(graph), "recall_100_after": recall(refined),
           "refine_seconds_cpu": time.time() - t0,
           "average_degree_before": float(np.asarray(graph.base.counts)[:n].mean()),
           "average_degree_after": float(np.asarray(refined.base.counts)[:n].mean())}
    print(json.dumps(row), flush=True)

    if args.port:
        import torch

        from jvector_tpu_torch import convert
        from jvector_tpu_torch.graph import ExactScoreProvider as TExact
        from jvector_tpu_torch.graph import GraphConfig as TConfig
        from jvector_tpu_torch.graph import search as tsearch
        from jvector_tpu_torch.graph.builder import refine_graph as trefine

        upper = [(np.asarray(l.neighbors), np.asarray(l.scores), np.asarray(l.counts)) for l in graph.layers[1:]]
        tg = convert.graph_from_numpy(
            np.asarray(graph.base.neighbors), np.asarray(graph.base.scores), np.asarray(graph.base.counts),
            int(graph.entry_node), int(graph.num_nodes), np.asarray(graph.deleted), device="cpu",
            upper_layers=upper, level_node_ids=[np.asarray(i) for i in graph.level_node_ids],
        )
        tpq = convert.pq_from_numpy(np.asarray(pq.codebooks), None, 128, device="cpu")
        tbuild = tpq.provider(torch.as_tensor(codes), "euclidean")
        tfirst = tpq.provider(torch.as_tensor(codes[:n]), "euclidean")
        texact = TExact(vectors=torch.as_tensor(pv))

        def trecall(g):
            r = tsearch(g, tfirst, torch.as_tensor(queries), top_k=10, beam_width=100, rerank_k=100, reranker=texact)
            return recall_at_k(r.ids.numpy(), gt, 10)

        t0 = time.time()
        tr = trefine(tg, tbuild, ds.base, TConfig(**CFG), chunk=1024)
        row = {"package": "port", "n": n, "recall_100_before": trecall(tg), "recall_100_after": trecall(tr),
               "refine_seconds_cpu": time.time() - t0, "average_degree_before": tg.average_degree(),
               "average_degree_after": tr.average_degree()}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
