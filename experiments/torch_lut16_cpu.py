"""LUT16 (4-bit PQ) first pass with exact rerank in the JAX package (the
reference), on the CPU: the figures ``chip_smoke.py``'s LUT16 cells hold
the port to.

    JAX_PLATFORMS=cpu python experiments/torch_lut16_cpu.py
    JAX_PLATFORMS=cpu python experiments/torch_lut16_cpu.py --n 200000 --corpus headline-128d
    JAX_PLATFORMS=cpu python experiments/torch_lut16_cpu.py --port

For each corpus: ``build_graph`` at ``GraphConfig(max_degree=32,
ef_construction=100)`` (SQ4 build scoring), PQ at m = d/2 with 16
clusters (``ProductQuantization.compute(base, m, clusters=16)``), codes
packed two to a byte and padded to the graph's capacity,
``build_fused_codes_lut16`` over the base layer, ``LUT16ScoreProvider``,
then the two-pass search (LUT16 first pass, exact rerank at
``rerank_k = beam``, E = 1, no repack) with recall@10 over 1024 queries
against exact ground truth at beams 40, 100 and 200:

- ``headline-128d``: ``synthetic_dataset(n, dim=128, n_queries=1024, k=10,
  n_clusters=max(64, n // 500), seed=0)``, euclidean, m = 64;
- ``mips-96d``: ``synthetic_dataset(n, dim=96, n_queries=1024, k=10,
  sim="dot_product", n_clusters=max(64, n // 500), seed=4)``, m = 48.

One JSON line per corpus and package.  ``--port`` builds and serves the
same corpora with the PyTorch port on the CPU (its own k-means draws) and
prints its line beside.  ``chip_smoke.py`` holds the port on the card to
this script's 20k ``headline-128d`` figure at beam 100
(``JAX_LUT16_RECALL_20K``).
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
from jvector_tpu.graph.score import LUT16ScoreProvider, build_fused_codes_lut16  # noqa: E402
from jvector_tpu.ops.pallas.adc16_kernel import pack_nibbles  # noqa: E402
from jvector_tpu.quantization import ProductQuantization  # noqa: E402
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

QUERIES, TOP_K = 1024, 10
BEAMS = (40, 100, 200)
CFG = dict(max_degree=32, ef_construction=100)
CORPORA = {  # name -> (dim, sim, seed)
    "headline-128d": (128, "euclidean", 0),
    "mips-96d": (96, "dot_product", 4),
}


def _jax_row(name: str, ds, dim: int, sim: str) -> dict:
    n = ds.base.shape[0]
    t0 = time.time()
    graph, exact = build_graph(ds.base, sim, GraphConfig(**CFG))
    jax.block_until_ready(graph.base.neighbors)
    build_s = time.time() - t0
    base = jnp.asarray(ds.base)
    pq = ProductQuantization.compute(base, m=dim // 2, clusters=16)
    packed = pack_nibbles(pq.encode(base))
    packed = jnp.concatenate([packed, jnp.zeros((graph.capacity - n, packed.shape[1]), jnp.uint8)])
    fused = build_fused_codes_lut16(graph.base.neighbors, packed)
    prov = LUT16ScoreProvider(codes_packed=packed, fused_packed=fused, codebooks=pq.codebooks,
                              center=pq.center, sim=sim)
    row = {"package": "jax", "corpus": name, "n": n, "sim": sim, "m": dim // 2, "build_seconds_cpu": build_s,
           "fused_table": list(fused.shape), "average_degree": float(np.asarray(graph.base.counts)[:n].mean())}
    q = jnp.asarray(ds.queries)
    for beam in BEAMS:
        res = search(graph, prov, q, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=exact)
        row[f"recall_{beam}"] = recall_at_k(np.asarray(res.ids), ds.ground_truth, TOP_K)
    return row


def _port_row(name: str, ds, dim: int, sim: str) -> dict:
    import torch

    from jvector_tpu_torch.graph import GraphConfig as TConfig
    from jvector_tpu_torch.graph import LUT16ScoreProvider as TProvider
    from jvector_tpu_torch.graph import build_fused_codes_lut16 as tfused
    from jvector_tpu_torch.graph import build_graph as tbuild
    from jvector_tpu_torch.graph import search as tsearch
    from jvector_tpu_torch.ops.adc16 import pack_nibbles as tpack
    from jvector_tpu_torch.quantization import ProductQuantization as TPQ

    n = ds.base.shape[0]
    t0 = time.time()
    base = torch.as_tensor(ds.base)
    graph, exact = tbuild(base, sim, TConfig(**CFG), device="cpu")
    build_s = time.time() - t0
    pq = TPQ.compute(base, m=dim // 2, clusters=16, device="cpu")
    packed = torch.nn.functional.pad(tpack(pq.encode(base)), (0, 0, 0, graph.capacity - n))
    prov = TProvider(codes_packed=packed, fused_packed=tfused(graph.base.neighbors, packed),
                     codebooks=pq.codebooks, center=pq.center, sim=sim)
    row = {"package": "port", "corpus": name, "n": n, "sim": sim, "m": dim // 2, "build_seconds_cpu": build_s,
           "average_degree": graph.average_degree()}
    q = torch.as_tensor(ds.queries)
    for beam in BEAMS:
        res = tsearch(graph, prov, q, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=exact)
        row[f"recall_{beam}"] = recall_at_k(res.ids.numpy(), ds.ground_truth, TOP_K)
    return row


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--corpus", choices=sorted(CORPORA), action="append",
                   help="corpus to run (repeatable; default: both)")
    p.add_argument("--port", action="store_true", help="also build and serve with the PyTorch port on the CPU")
    args = p.parse_args()
    for name in args.corpus or list(CORPORA):
        dim, sim, seed = CORPORA[name]
        ds = synthetic_dataset(n=args.n, dim=dim, n_queries=QUERIES, k=TOP_K, sim=sim,
                               n_clusters=max(64, args.n // 500), seed=seed)
        print(json.dumps(_jax_row(name, ds, dim, sim)), flush=True)
        if args.port:
            print(json.dumps(_port_row(name, ds, dim, sim)), flush=True)


if __name__ == "__main__":
    main()
