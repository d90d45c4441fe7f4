"""Persistence and the larger-than-memory path (PyTorch counterpart of
``jvector_tpu.disk``): the index container shared with the JAX package
(``format``), the stream build (``ltm``), the host rerank tier
(``host_tier``) and bounded-memory host serving (``host_graph``).

Not ported yet: ``device_tier`` and compaction (ROADMAP queue 1 item 6),
``ShardedHostIndex`` (item 7).
"""

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
    "FeatureId",
    "IndexFileReader",
    "IndexFileWriter",
    "OnDiskIndex",
    "load_index",
    "write_index",
    "HostGraphIndex",
    "ShardedHostIndex",
    "write_sq4_index",
    "HostVectorStore",
    "search_with_host_rerank",
    "build_on_disk_ltm",
]
