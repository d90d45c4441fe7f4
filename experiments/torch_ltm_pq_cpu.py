"""The PQ stream build's recall in the JAX package (the reference), on the
CPU: the figure ``chip_smoke.py``'s ``ltm_path`` holds the port's PQ stream
build to.

    JAX_PLATFORMS=cpu python experiments/torch_ltm_pq_cpu.py
    JAX_PLATFORMS=cpu python experiments/torch_ltm_pq_cpu.py --port

Builds ``synthetic_dataset(n=20_000, dim=128, n_queries=512, k=10,
n_clusters=64, seed=0)`` with ``build_on_disk_ltm(compression="pq",
config=GraphConfig(max_degree=32, ef_construction=100), seed=0)`` (PQ
M = d/8 = 16, K = 256, trained inside the build on its 65,536-row sample)
into a temporary file, then prints recall@10 over the 512 queries of
``search_with_host_rerank`` (PQ-ADC first pass, exact rerank of
``rerank_k = beam`` rows gathered on the host) at beams 10/20/50/100.
``--port`` runs the same build and serve in the PyTorch port on the CPU
(its own k-means draws) and prints its recall beside.  One JSON line per
package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jvector_tpu.disk.host_tier import HostVectorStore, search_with_host_rerank  # noqa: E402
from jvector_tpu.disk.ltm import build_on_disk_ltm  # noqa: E402
from jvector_tpu.graph import GraphConfig  # noqa: E402
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

N, DIM, QUERIES, CLUSTERS = 20_000, 128, 512, 64
BEAMS = (10, 20, 50, 100)
CFG = dict(max_degree=32, ef_construction=100)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--port", action="store_true", help="also build and serve with the PyTorch port on the CPU")
    args = p.parse_args()
    ds = synthetic_dataset(n=N, dim=DIM, n_queries=QUERIES, k=10, n_clusters=CLUSTERS, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        graph, prov = build_on_disk_ltm(os.path.join(tmp, "jax.jvtpu"), ds.base, N, DIM, config=GraphConfig(**CFG),
                                        compression="pq", seed=0)
        row = {"package": "jax", "n": N, "build_seconds_cpu": time.time() - t0,
               "average_degree": float(np.asarray(graph.base.counts)[:N].mean())}
        store = HostVectorStore(vectors=ds.base)
        for beam in BEAMS:
            r = search_with_host_rerank(graph, prov, store, jnp.asarray(ds.queries), top_k=10, beam_width=beam)
            row[f"recall_{beam}"] = recall_at_k(np.asarray(r.ids), ds.ground_truth, 10)
        print(json.dumps(row), flush=True)

        if args.port:
            import torch

            from jvector_tpu_torch.disk import HostVectorStore as TStore
            from jvector_tpu_torch.disk import build_on_disk_ltm as tbuild
            from jvector_tpu_torch.disk.host_tier import search_with_host_rerank as tsearch
            from jvector_tpu_torch.graph import GraphConfig as TConfig

            t0 = time.time()
            tg, tprov = tbuild(os.path.join(tmp, "port.jvtpu"), ds.base, N, DIM, config=TConfig(**CFG),
                               compression="pq", seed=0, device="cpu")
            row = {"package": "port", "n": N, "build_seconds_cpu": time.time() - t0,
                   "average_degree": tg.average_degree()}
            tstore, tq = TStore(vectors=ds.base), torch.as_tensor(ds.queries)
            for beam in BEAMS:
                r = tsearch(tg, tprov, tstore, tq, top_k=10, beam_width=beam)
                row[f"recall_{beam}"] = recall_at_k(r.ids.numpy(), ds.ground_truth, 10)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
