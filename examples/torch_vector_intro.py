"""Tutorial 1 on the PyTorch/CUDA port: in-memory build + search (the
counterpart of ``examples/vector_intro.py``; reference tutorial/VectorIntro).

Build a Vamana graph with its hierarchy over an in-memory corpus, run a
query wave, measure recall against exact ground truth.  The corpus is
siftsmall where its base vectors exist on disk, else a synthetic one, as in
the JAX script.  Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_vector_intro.py [--device cpu]
"""

import argparse

import torch

from jvector_tpu_torch.graph import GraphConfig, build_graph, search
from jvector_tpu_torch.util.datasets import load_siftsmall, recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def main(n=10_000, dim=128, device=None):
    dev = resolve_device(device)
    ds = load_siftsmall() or synthetic_dataset(n=n, dim=dim, n_queries=100, k=100, device=dev)
    print(f"dataset {ds.name}: {ds.base.shape[0]} x {ds.dimension}")

    config = GraphConfig(
        max_degree=32,  # reference outDegree
        ef_construction=100,  # reference efConstruction
        neighbor_overflow=1.2,
        alpha=1.2,
        add_hierarchy=True,
    )
    graph, provider = build_graph(ds.base, ds.similarity, config, device=dev)
    print(f"built {int(graph.num_nodes)} nodes, {graph.num_levels} levels, "
          f"avg degree {graph.average_degree():.1f}")

    res = search(graph, provider, torch.as_tensor(ds.queries, device=dev), top_k=10, beam_width=100)
    r = recall_at_k(res.ids.cpu().numpy(), ds.ground_truth, 10)
    visited = float(res.visited_count.float().mean())
    print(f"recall@10 = {r:.4f}  (mean visited {visited:.0f})")
    return {"dataset": ds.name, "nodes": int(graph.num_nodes), "levels": graph.num_levels,
            "average_degree": graph.average_degree(), "recall": r, "mean_visited": visited}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
