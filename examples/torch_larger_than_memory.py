"""Tutorial 3 on the PyTorch/CUDA port: a larger-than-memory build (the
counterpart of ``examples/larger_than_memory.py``; reference
tutorial/LargerThanMemory).

The PQ codes are the only full-corpus working set on the device; the
full-resolution vectors stream to the output file wave by wave while the
graph is built with PQ-approximate scores (the K5 kernel on the card).  The
serve keeps the full vectors on the host, memmapped off the index file.
Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_larger_than_memory.py [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from jvector_tpu_torch.disk import FeatureId, load_index
from jvector_tpu_torch.disk.host_tier import HostVectorStore, search_with_host_rerank
from jvector_tpu_torch.disk.ltm import build_on_disk_ltm
from jvector_tpu_torch.graph import GraphConfig
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def main(path=None, n=50_000, dim=128, device=None):
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        return _run(path or os.path.join(tmp, "ltm_intro.jvtpu"), n, dim, dev)


def _run(path, n, dim, dev):
    ds = synthetic_dataset(n=n, dim=dim, n_queries=100, k=100, device=dev)

    def loader(a, b):  # in production: read a chunk from object storage
        return ds.base[a:b]

    graph, pq_provider = build_on_disk_ltm(
        path, loader, n=ds.base.shape[0], dim=ds.dimension, config=GraphConfig(), pq_m=16, device=dev,
    )
    print(f"LTM build complete: {int(graph.num_nodes)} nodes on disk at {path}")

    # serve: the PQ working set on the device, the full vectors memmapped
    # straight off the index file on the host
    odi = load_index(path)
    store = HostVectorStore.from_index_file(odi.reader, f"feature/{FeatureId.INLINE_VECTORS}/vectors",
                                            ds.similarity)
    res = search_with_host_rerank(graph, pq_provider, store, torch.as_tensor(ds.queries, device=dev),
                                  top_k=10, beam_width=150)
    r = recall_at_k(res.ids.cpu().numpy(), ds.ground_truth, 10)
    print("host-tier recall@10 =", r)
    return {"nodes": int(graph.num_nodes), "recall": r}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
