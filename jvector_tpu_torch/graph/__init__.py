"""Graph core: graph data model, score providers (exact, SQ4, PQ-ADC,
LUT16, BQ), robust prune, query-wave beam search (filtered, threshold and
resumable), the wave builders and the hierarchy (PyTorch counterpart of
``jvector_tpu.graph``).  ``builder.refine_graph``, ``builder.rescore_graph``,
``multi.multi_search``, the ``mutation`` functions (``mark_deleted``,
``remove_deleted``, ``add_nodes``) and ``nndescent.nn_descent_build`` are
imported from their modules, as in the JAX package."""

from jvector_tpu_torch.graph.builder import GraphIndexBuilder, build_graph
from jvector_tpu_torch.graph.index import GraphConfig, GraphIndex
from jvector_tpu_torch.graph.score import (
    ADCScoreProvider,
    BQScoreProvider,
    ExactScoreProvider,
    FusedADCScoreProvider,
    LUT16ScoreProvider,
    SQ4ScoreProvider,
    build_fused_codes,
    build_fused_codes_lut16,
    build_fused_sq4,
)
from jvector_tpu_torch.graph.searcher import BeamState, SearchResult, resume, search

__all__ = [
    "GraphIndex",
    "GraphConfig",
    "ExactScoreProvider",
    "SQ4ScoreProvider",
    "ADCScoreProvider",
    "BQScoreProvider",
    "FusedADCScoreProvider",
    "LUT16ScoreProvider",
    "build_fused_codes",
    "build_fused_codes_lut16",
    "build_fused_sq4",
    "search",
    "resume",
    "SearchResult",
    "BeamState",
    "GraphIndexBuilder",
    "build_graph",
]
