"""The JAX package's sharded build and sharded serve (the reference) on a
virtual CPU mesh: the recall figures that ``chip_smoke.py``'s ``sharding``
phase holds the port to.

    python experiments/torch_sharding_cpu.py                 # 100,000 x 128 on 4 devices
    python experiments/torch_sharding_cpu.py --n 20000 --devices 4

The corpus is the ``sharding`` phase's: ``synthetic_dataset(n, dim=128,
n_queries=4096, k=10, n_clusters=max(64, n // 500), seed=0)``, recall@10
over its first 1024 queries against exact ground truth.  ``sharded_build``
at ``GraphConfig(max_degree=32, ef_construction=100)`` with the default
SQ4 build (the packed regime: 4 shards of 25,000 at 100k), then
``sharded_graph_search`` at beams 20 / 50 / 100 with ``rerank_k = beam``,
and once at beam 100 with ``floor_slack = 0.0``.  Prints one JSON line
with the seconds of each step.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
p.add_argument("--n", type=int, default=100_000)
p.add_argument("--devices", type=int, default=4)
ARGS = p.parse_args()

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={ARGS.devices}"
).strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jvector_tpu.graph import GraphConfig  # noqa: E402
from jvector_tpu.parallel import make_mesh, sharded_build, sharded_graph_search  # noqa: E402
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset  # noqa: E402

QUERIES, GT_QUERIES, TOP_K = 4096, 1024, 10
BEAMS = (20, 50, 100)


def main() -> None:
    n = ARGS.n
    t0 = time.time()
    ds = synthetic_dataset(n=n, dim=128, n_queries=QUERIES, k=TOP_K, n_clusters=max(64, n // 500), seed=0)
    data_s = time.time() - t0
    mesh = make_mesh(ARGS.devices, "shard")
    t0 = time.time()
    idx = sharded_build(ds.base, mesh, GraphConfig(max_degree=32, ef_construction=100))
    jax.block_until_ready(idx.graphs.layers[0].neighbors)
    build_s = time.time() - t0
    q = jnp.asarray(ds.queries[:GT_QUERIES])
    gt = ds.ground_truth[:GT_QUERIES]
    recall, serve_s = {}, {}
    for beam in BEAMS:
        t0 = time.time()
        ids, _ = sharded_graph_search(idx, q, mesh, top_k=TOP_K, beam_width=beam, rerank_k=beam)
        recall[str(beam)] = recall_at_k(np.asarray(ids), gt, TOP_K)
        serve_s[str(beam)] = time.time() - t0
    ids, _ = sharded_graph_search(idx, q, mesh, top_k=TOP_K, beam_width=100, rerank_k=100, floor_slack=0.0)
    print(json.dumps({
        "package": "jax", "n": n, "dim": 128, "devices": ARGS.devices, "n_local": idx.n_local,
        "packed": idx.search_providers is not None and idx.search_providers.fused_w2.dtype == jnp.int32,
        "recall": recall, "recall_floor_slack_0_beam_100": recall_at_k(np.asarray(ids), gt, TOP_K),
        "data_seconds": data_s, "build_seconds": build_s, "serve_seconds": serve_s,
        "platform": jax.devices()[0].platform,
    }), flush=True)


if __name__ == "__main__":
    main()
