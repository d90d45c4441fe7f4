"""jvector_tpu_torch — the PyTorch/CUDA port of ``jvector_tpu``.

The same layout and public names as the JAX package, for the slices ported
so far: the SQ4 graph builds (packed and fused wave loops), the PQ-scored
build, the HNSW hierarchy, two-pass search with an SQ4 or PQ-ADC first
pass and an exact rerank, the index container, the larger-than-memory
stream build and bounded-memory host serving, the other quantizers
(anisotropic PQ and SQ4, BQ, NVQ, compressor files), the grid runner, the
index lifecycle and sharding over a mesh of devices.  The port imports
``torch`` and never ``jax``; the JAX package stays the reference that the
port's tests hold it against.

- ``ops``           — similarity measures; ``ops/kernels`` holds the Python
  wrappers of the hand-written CUDA kernels (sources in ``csrc/``) with
  their plain PyTorch twins
- ``quantization``  — SQ4 (4-bit scalar quantization), PQ (k-means
  codebooks, plain and anisotropic), BQ, NVQ, compressor files
- ``graph``         — graph data model, score providers, robust prune,
  query-wave beam search, wave builders, hierarchy
- ``disk``          — the index container (shared with the JAX package), the
  larger-than-memory stream build, host-tier rerank and host serving
- ``util``          — synthetic corpora, exact ground truth, recall, host IO
- ``parallel``      — a mesh of torch devices: query-parallel search,
  node-sharded brute force, the sharded builds (in memory and on disk),
  sharded serving and persistence
- ``convert``       — the JAX package's state (as numpy) -> the port's
- ``entry``         — a search step and the multi-device dry run
- ``bench``         — the bench script, micro-benchmarks and the grid runner
"""

from jvector_tpu_torch.disk import (
    HostGraphIndex,
    HostVectorStore,
    build_on_disk_ltm,
    load_index,
    write_index,
)
from jvector_tpu_torch.graph import (
    GraphConfig,
    GraphIndex,
    SearchResult,
    build_graph,
    search,
)
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization import (
    BinaryQuantization,
    NVQuantization,
    ProductQuantization,
    ScalarQuantization4,
)

__all__ = [
    "SimilarityFunction",
    "GraphConfig",
    "GraphIndex",
    "SearchResult",
    "build_graph",
    "search",
    "ScalarQuantization4",
    "ProductQuantization",
    "BinaryQuantization",
    "NVQuantization",
    "build_on_disk_ltm",
    "HostGraphIndex",
    "HostVectorStore",
    "load_index",
    "write_index",
]
