"""The 100M pipeline at toy scale on the PyTorch/CUDA port: sharded stream
builds + merged serving (the counterpart of
``examples/sharded_ltm_pipeline.py``).

Every shard is a self-contained larger-than-memory build (SQ4 working set
on the device, full-resolution vectors streamed to the shard file), and
serving holds no more than O(wave x beam) graph data on the device:
``ShardedHostIndex`` searches each shard off its file, globalizes the ids
by shard offset, reranks exactly per shard and merges one top-k.
Runs on the card unless asked for the CPU:

    PYTHONPATH=. python examples/torch_sharded_ltm_pipeline.py [--device cpu]
"""

import argparse
import tempfile

import torch

from jvector_tpu_torch.disk.host_graph import ShardedHostIndex
from jvector_tpu_torch.graph import GraphConfig
from jvector_tpu_torch.parallel import sharded_build_on_disk
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset
from jvector_tpu_torch.util.device import resolve_device


def main(directory=None, n=40_000, dim=64, device=None):
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        return _run(directory or tmp, n, dim, dev)


def _run(directory, n, dim, dev):
    ds = synthetic_dataset(n=n, dim=dim, n_queries=100, k=10, device=dev)

    def loader(a, b):  # in production: read a chunk from object storage
        return ds.base[a:b]

    man = sharded_build_on_disk(
        directory, loader, n=ds.base.shape[0], dim=ds.dimension, shards=4,
        config=GraphConfig(), sim=ds.similarity,
        checkpoint_every=32,  # each shard build survives process loss
        device=dev,
    )
    print(f"built {man['n_shards']} shard containers in {directory}")

    sharded = ShardedHostIndex.load(directory, device=dev)
    res = sharded.search(torch.as_tensor(ds.queries, device=dev), top_k=10, beam_width=48, expand=2)
    r = recall_at_k(res.ids.cpu().numpy(), ds.ground_truth, 10)
    print(f"merged recall@10 over {man['n_shards']} shards: {r:.4f}")
    return {"n_shards": man["n_shards"], "recall": r}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None)
    main(device=p.parse_args().device)
