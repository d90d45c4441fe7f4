"""HelloVectorWorld on the PyTorch/CUDA port: the smallest end-to-end usage
(the counterpart of ``examples/hello_vector_world.py``).

Build an index over a few vectors, search it, print the neighbours.  Runs
on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_hello_vector_world.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from jvector_tpu_torch import GraphConfig, build_graph, search
from jvector_tpu_torch.util.device import resolve_device


def main(n=1000, dim=16, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    vectors = rng.normal(size=(n, dim)).astype(np.float32)
    graph, provider = build_graph(vectors, "euclidean", GraphConfig(max_degree=8), device=dev)

    query = torch.as_tensor(vectors[42:43] + 0.01, device=dev)
    result = search(graph, provider, query, top_k=3)
    ids, scores = result.ids.cpu().numpy()[0], result.scores.cpu().numpy()[0]
    print("nearest to a noisy copy of vector 42:", ids)
    print("scores:", np.round(scores, 4))
    return {"ids": ids.tolist(), "scores": scores.tolist()}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
