"""Persistence and the larger-than-memory path (PyTorch counterpart of
``jvector_tpu.disk``): the index container shared with the JAX package
(``format``), the stream build (``ltm``), the host rerank tier
(``host_tier``), bounded-memory host serving (``host_graph``), the
device-resident serving tier (``device_tier``) and N:1 compaction
(``compaction``); ``ShardedHostIndex`` serves a sharded directory of
host-served shards.
"""

from jvector_tpu_torch.disk.compaction import CompactionSource, compact_indexes, compact_on_disk
from jvector_tpu_torch.disk.device_tier import DeviceTierIndex
from jvector_tpu_torch.disk.format import (
    FeatureId,
    IndexFileReader,
    IndexFileWriter,
    OnDiskIndex,
    load_index,
    write_index,
)
from jvector_tpu_torch.disk.host_graph import HostGraphIndex, ShardedHostIndex, write_sq4_index
from jvector_tpu_torch.disk.host_tier import HostVectorStore, search_with_host_rerank
from jvector_tpu_torch.disk.ltm import build_on_disk_ltm

__all__ = [
    "DeviceTierIndex",
    "FeatureId",
    "IndexFileReader",
    "IndexFileWriter",
    "OnDiskIndex",
    "load_index",
    "write_index",
    "CompactionSource",
    "compact_indexes",
    "compact_on_disk",
    "HostGraphIndex",
    "ShardedHostIndex",
    "write_sq4_index",
    "HostVectorStore",
    "search_with_host_rerank",
    "build_on_disk_ltm",
]
