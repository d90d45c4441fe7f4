"""Tutorial 2 on the PyTorch/CUDA port: persist, reload, two-pass search (the
counterpart of ``examples/disk_intro.py``; reference tutorial/DiskIntro).

PQ-compress the corpus, save graph + features to one index file, reload it
and run the compressed first pass (PQ ADC, the K5 kernel on the card) with
an exact rerank.  Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_disk_intro.py [--device cpu]
"""

import argparse
import os
import tempfile

import torch

from jvector_tpu_torch.disk import FeatureId, load_index, write_index
from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, build_graph, search
from jvector_tpu_torch.graph.score import ADCScoreProvider
from jvector_tpu_torch.quantization import ProductQuantization
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def main(path=None, n=20_000, dim=128, device=None):
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        return _run(path or os.path.join(tmp, "disk_intro.jvtpu"), n, dim, dev)


def _run(path, n, dim, dev):
    ds = synthetic_dataset(n=n, dim=dim, n_queries=100, k=100, device=dev)
    graph, _ = build_graph(ds.base, ds.similarity, GraphConfig(), device=dev)

    pq = ProductQuantization.compute(ds.base, m=16, clusters=256, device=dev)
    codes = pq.encode(ds.base)
    write_index(
        path,
        graph,
        features={
            FeatureId.INLINE_VECTORS: {"vectors": ds.base},
            FeatureId.PQ_CODES: {
                "codes": codes.cpu().numpy(),
                "codebooks": pq.codebooks.cpu().numpy(),
                "center": pq.center.cpu().numpy(),
            },
        },
        similarity=str(ds.similarity.value),
        dimension=ds.dimension,
    )

    odi = load_index(path)
    print("features on disk:", odi.features)
    g2, feats = odi.to_device(dev)
    pq_prov = ADCScoreProvider(
        codes=feats[FeatureId.PQ_CODES]["codes"],
        codebooks=feats[FeatureId.PQ_CODES]["codebooks"],
        center=feats[FeatureId.PQ_CODES]["center"],
        sim=ds.similarity,
    )
    reranker = ExactScoreProvider(vectors=feats[FeatureId.INLINE_VECTORS]["vectors"], sim=ds.similarity)
    res = search(g2, pq_prov, torch.as_tensor(ds.queries, device=dev), top_k=10,
                 beam_width=100, rerank_k=100, reranker=reranker)
    r = recall_at_k(res.ids.cpu().numpy(), ds.ground_truth, 10)
    print("two-pass recall@10 =", r)
    return {"features": list(odi.features), "recall": r}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
