"""The flagship serving stack (SQ4) at three tiers on the PyTorch/CUDA port
(the counterpart of ``examples/sq4_serving.py``).

1. In HBM: fused SQ4 first pass + exact f32 rerank.
2. Host rerank tier: the beam on codes on the device, the full-resolution
   vectors on the host.
3. Bounded memory: adjacency + fused codes on the host too, streamed per
   expansion (``HostGraphIndex``), the larger-than-memory serving mode.

Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_sq4_serving.py [--device cpu]
"""

import argparse
import os
import tempfile
import time

import torch

from jvector_tpu_torch.disk.host_graph import HostGraphIndex, write_sq4_index
from jvector_tpu_torch.disk.host_tier import HostVectorStore, search_with_host_rerank
from jvector_tpu_torch.graph import GraphConfig, build_graph, search
from jvector_tpu_torch.quantization import ScalarQuantization4
from jvector_tpu_torch.util.datasets import exact_ground_truth, recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def main(n=20_000, dim=64, device=None):
    dev = resolve_device(device)
    ds = synthetic_dataset(n=n, dim=dim, n_queries=256, k=10, n_clusters=max(64, n // 500), seed=3, device=dev)
    gt = exact_ground_truth(ds.base, ds.queries, 10, device=dev)
    q = torch.as_tensor(ds.queries, device=dev)

    print(f"building {n} x {dim} ...")
    graph, exact = build_graph(ds.base, "euclidean", GraphConfig(max_degree=32, ef_construction=100), device=dev)

    # SQ4: fit, encode, build the fused neighbour-code tables
    sq = ScalarQuantization4.compute(ds.base, device=dev)
    codes = sq.encode(ds.base)
    codes = torch.nn.functional.pad(codes, (0, 0, 0, graph.capacity - codes.shape[0]))
    prov = sq.provider_for_graph(codes, graph.base.neighbors, "euclidean")

    # --- tier 1: everything in HBM -----------------------------------------
    t0 = time.time()
    res = search(graph, prov, q, top_k=10, beam_width=40, rerank_k=40, reranker=exact)
    r1 = recall_at_k(res.ids.cpu().numpy(), gt, 10)
    qps = q.shape[0] / (time.time() - t0)
    print(f"tier 1 (in-HBM fused SQ4 + f32 rerank): recall {r1:.4f} ({qps:.0f} QPS cold)")

    # --- tier 2: full-resolution vectors on the host ----------------------
    store = HostVectorStore(vectors=ds.base, sim="euclidean")
    res2 = search_with_host_rerank(graph, prov, store, q, top_k=10, beam_width=40)
    r2 = recall_at_k(res2.ids.cpu().numpy(), gt, 10)
    print(f"tier 2 (host rerank tier): recall {r2:.4f}")

    # --- tier 3: graph + codes on the host too (bounded device memory) ----
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "index.jvtpu")
        write_sq4_index(path, graph, sq, codes, prov, "euclidean")
        hg = HostGraphIndex.load(path, device=dev)
        budget = hg.hbm_bytes(n_queries=256, beam_width=40, expand=4)
        res3 = hg.search(q, top_k=10, beam_width=40, expand=4, rerank=store)
        r3 = recall_at_k(res3.ids.cpu().numpy(), gt, 10)
        full = hg.fused_packed.size + hg.neighbors.size * 4
        print(f"tier 3 (bounded-memory streaming): recall {r3:.4f}, device "
              f"working set ~{budget/1e6:.0f} MB vs {full/1e6:.0f} MB of graph arrays kept on host")
    return {"recall_tier1": r1, "qps_tier1_cold": qps, "recall_tier2": r2, "recall_tier3": r3,
            "device_working_set_bytes": budget, "host_graph_bytes": full}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
