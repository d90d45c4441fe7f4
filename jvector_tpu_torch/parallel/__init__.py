"""Mesh sharding: query-parallel search waves, node-sharded scoring, the
sharded builds, serving and persistence (PyTorch counterpart of
``jvector_tpu.parallel``).

One process drives a :class:`~jvector_tpu_torch.parallel.sharding.Mesh`
of torch devices: each shard's work runs on its device with the port's
ordinary functions, and per-shard top-k lists merge on the first device.
"""

from jvector_tpu_torch.parallel.sharding import (
    Mesh,
    make_mesh,
    replicate,
    shard_queries,
    sharded_brute_force,
    sharded_search,
)
from jvector_tpu_torch.parallel.build import (
    ShardedIndex,
    load_sharded,
    save_sharded,
    sharded_build,
    sharded_build_on_disk,
    sharded_graph_search,
)

__all__ = [
    "make_mesh",
    "shard_queries",
    "replicate",
    "sharded_search",
    "sharded_brute_force",
    "ShardedIndex",
    "sharded_build",
    "sharded_graph_search",
    "sharded_build_on_disk",
    "save_sharded",
    "load_sharded",
    "Mesh",
]
