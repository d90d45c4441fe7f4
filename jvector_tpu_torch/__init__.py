"""jvector_tpu_torch — the PyTorch/CUDA port of ``jvector_tpu``.

The same layout and public names as the JAX package: the SQ4 graph
builds (packed and fused wave loops), the PQ-scored build, the HNSW
hierarchy, two-pass search with an SQ4 or PQ-ADC first pass and an exact
rerank, the index container, the larger-than-memory stream build and
bounded-memory host serving, the other quantizers (anisotropic PQ and SQ4,
BQ, NVQ, compressor files), the grid runner, the index lifecycle, sharding
over a mesh of devices, and the harness (the IPC service, the bench CLI
over YAML catalogs, dataset IO, memory accounting).  The port imports
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
- ``util``          — synthetic corpora, exact ground truth, recall, host IO,
  fvecs / ivecs / bvecs files, dataset catalogs, the YAML reader, memory
  accounting
- ``parallel``      — a mesh of torch devices: query-parallel search,
  node-sharded brute force, the sharded builds (in memory and on disk),
  sharded serving and persistence
- ``convert``       — the JAX package's state (as numpy) -> the port's
- ``entry``         — a search step and the multi-device dry run
- ``bench``         — the bench script, micro-benchmarks, the grid runner,
  the IPC service and the bench CLI
- ``tracing``       — the port's own spans and counters (the beam loop's):
  host stamps of the last unprofiled request, and a window of spans and
  counters while a PyTorch profiler collects
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
    resume,
    search,
)
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.quantization import (
    BinaryQuantization,
    NVQuantization,
    ProductQuantization,
    ScalarQuantization4,
)

__version__ = "0.2.0"

__all__ = [
    "SimilarityFunction",
    "GraphConfig",
    "GraphIndex",
    "SearchResult",
    "build_graph",
    "search",
    "resume",
    "ScalarQuantization4",
    "ProductQuantization",
    "BinaryQuantization",
    "NVQuantization",
    "build_on_disk_ltm",
    "HostGraphIndex",
    "HostVectorStore",
    "load_index",
    "write_index",
    "__version__",
]
