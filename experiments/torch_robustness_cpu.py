"""Recall of the JAX package (the reference) on ``bench.py``'s robustness
corpora, on the CPU, at sizes the tests cannot reach.

    JAX_PLATFORMS=cpu python experiments/torch_robustness_cpu.py --n 200000
    JAX_PLATFORMS=cpu python experiments/torch_robustness_cpu.py --n 20000 --port

For each corpus, ``bench.py``'s robustness row: ``build_graph`` at
``GraphConfig(max_degree=32, ef_construction=100)`` (SQ4 build scoring),
SQ4 ``provider_for_graph``, and the two-pass search (SQ4 first pass, exact
rerank at ``rerank_k = beam``, repack cut at 1.6 x beam, E = 1, one entry
seed), recall@10 over the first 1024 of 4096 queries against exact
ground truth:

- ``clustered-adversarial``: ``bench.clustered_adversarial(n, 128, 4096)``
  (seed 7), euclidean;
- ``mips-96d``: ``synthetic_dataset(n, dim=96, n_queries=4096, k=10,
  sim="dot_product", n_clusters=max(64, n // 500), seed=4)``.

Prints one JSON line per corpus and package: recall@10 at every beam of
``bench.py``'s list up to the first that clears 0.95, and at beams 100
and 200.  ``--port`` builds and searches the same corpora with the PyTorch
port on the CPU (``jvector_tpu_torch.bench.headline``).  ``chip_smoke.py``
holds the port on the card to this script's clustered-adversarial figures
at beams 100 and 200.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jvector_tpu.graph import GraphConfig, build_graph, search  # noqa: E402
from jvector_tpu.quantization import ScalarQuantization4  # noqa: E402
from jvector_tpu.util.datasets import exact_ground_truth, recall_at_k, synthetic_dataset  # noqa: E402

N_QUERIES, GT_QUERIES, TOP_K, FLOOR = 4096, 1024, 10, 0.95


def _bench():
    """``bench.py`` loaded by path (it imports JAX only inside ``main``)."""
    spec = importlib.util.spec_from_file_location("bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def corpora(n: int) -> dict:
    adv_base, adv_q = _bench().clustered_adversarial(n, 128, N_QUERIES)
    mips = synthetic_dataset(n=n, dim=96, n_queries=N_QUERIES, k=TOP_K, sim="dot_product",
                             n_clusters=max(64, n // 500), seed=4)
    return {"clustered-adversarial": (adv_base, adv_q, "euclidean"),
            "mips-96d": (np.asarray(mips.base), np.asarray(mips.queries), "dot_product")}


def sweep(recall_at, beams) -> dict:
    """recall@10 at each beam up to the first clearing the floor, and at 100
    and 200."""
    out, smallest = {}, None
    for beam in beams:
        out[beam] = recall_at(beam)
        if out[beam] >= FLOOR:
            smallest = beam
            break
    for beam in (100, 200):
        if beam not in out:
            out[beam] = recall_at(beam)
    return {"recall": {str(b): r for b, r in sorted(out.items())}, "smallest_beam_clearing_0.95": smallest}


def jax_row(name, base, queries, sim, beams) -> dict:
    t0 = time.time()
    graph, exact = build_graph(base, sim, GraphConfig(max_degree=32, ef_construction=100))
    jax.block_until_ready(graph.base.neighbors)
    build_s = time.time() - t0
    sq = ScalarQuantization4.compute(base)
    codes = np.zeros((graph.capacity, (base.shape[1] + 1) // 2), np.uint8)
    codes[: base.shape[0]] = np.asarray(sq.encode(base))
    sq4 = sq.provider_for_graph(jnp.asarray(codes), graph.base.neighbors, sim)
    gt = exact_ground_truth(base, queries[:GT_QUERIES], TOP_K)
    q = jnp.asarray(queries[:GT_QUERIES])

    def recall_at(beam):
        r = search(graph, sq4, q, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=exact,
                   repack_after=max(8, int(1.6 * beam)))
        return recall_at_k(np.asarray(r.ids), gt, TOP_K)

    return {"package": "jax", "corpus": name, "n": base.shape[0], "build_seconds_cpu": build_s,
            **sweep(recall_at, beams)}


def port_row(name, base, queries, sim, beams) -> dict:
    import torch

    from jvector_tpu_torch.bench import headline
    from jvector_tpu_torch.util.datasets import exact_ground_truth as texact_gt

    dev = torch.device("cpu")
    graph, exact, sq4, _, build_s, _ = headline.build_flagship(base, sim, dev)
    gt = texact_gt(base, queries[:GT_QUERIES], TOP_K, device=dev)
    q = torch.as_tensor(queries[:GT_QUERIES])

    def recall_at(beam):
        r = headline.search(graph, sq4, q, top_k=TOP_K, beam_width=beam, rerank_k=beam, reranker=exact,
                            repack_after=headline.repack_cut(beam))
        return recall_at_k(r.ids.numpy(), gt, TOP_K)

    return {"package": "port", "corpus": name, "n": base.shape[0], "build_seconds_cpu": build_s,
            **sweep(recall_at, beams)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--port", action="store_true", help="also build and search with the PyTorch port on the CPU")
    args = p.parse_args()
    beams = _bench().BEAMS
    for name, (base, queries, sim) in corpora(args.n).items():
        print(json.dumps(jax_row(name, base, queries, sim, beams)), flush=True)
        if args.port:
            print(json.dumps(port_row(name, base, queries, sim, beams)), flush=True)


if __name__ == "__main__":
    main()
