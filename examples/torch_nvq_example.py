"""Tutorial 4 on the PyTorch/CUDA port: BQ first pass + NVQ rerank (the
counterpart of ``examples/nvq_example.py``; reference tutorial/NvqExample,
BASELINE config 4: high-dimensional embeddings with a binary first pass).
Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_nvq_example.py [--device cpu]
"""

import argparse

import torch

from jvector_tpu_torch.graph import GraphConfig, build_graph, search
from jvector_tpu_torch.quantization import BinaryQuantization, NVQuantization
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def main(n=20_000, dim=256, device=None):
    dev = resolve_device(device)
    ds = synthetic_dataset(n=n, dim=dim, n_queries=100, k=100, device=dev)
    graph, _ = build_graph(ds.base, ds.similarity, GraphConfig(), device=dev)

    bq = BinaryQuantization.compute(ds.base, device=dev)
    bq_provider = bq.provider(bq.encode(ds.base))
    print(f"BQ: {bq.compressed_size} bytes/vector (vs {ds.dimension * 4} fp32)")

    nvq = NVQuantization.compute(ds.base, num_subvectors=2, device=dev)
    nvq_vectors = nvq.encode(ds.base)
    print(f"NVQ: {nvq_vectors.compressed_size} bytes/vector")
    nvq_reranker = nvq_vectors.provider(ds.similarity)

    res = search(graph, bq_provider, torch.as_tensor(ds.queries, device=dev), top_k=10,
                 beam_width=200, rerank_k=200, reranker=nvq_reranker)
    r = recall_at_k(res.ids.cpu().numpy(), ds.ground_truth, 10)
    print("BQ->NVQ recall@10 =", r)
    return {"bq_bytes": bq.compressed_size, "nvq_bytes": nvq_vectors.compressed_size, "recall": r}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
