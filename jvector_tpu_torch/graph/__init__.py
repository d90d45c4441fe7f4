"""Graph core: graph data model, score providers, robust prune, query-wave
beam search, the wave builders and the hierarchy (PyTorch counterpart of
``jvector_tpu.graph``)."""

from jvector_tpu_torch.graph.builder import GraphIndexBuilder, build_graph
from jvector_tpu_torch.graph.index import GraphConfig, GraphIndex
from jvector_tpu_torch.graph.score import (
    ADCScoreProvider,
    ExactScoreProvider,
    FusedADCScoreProvider,
    SQ4ScoreProvider,
    build_fused_codes,
    build_fused_sq4,
)
from jvector_tpu_torch.graph.searcher import BeamState, SearchResult, search

__all__ = [
    "GraphIndex",
    "GraphConfig",
    "ExactScoreProvider",
    "SQ4ScoreProvider",
    "ADCScoreProvider",
    "FusedADCScoreProvider",
    "build_fused_codes",
    "build_fused_sq4",
    "search",
    "SearchResult",
    "BeamState",
    "GraphIndexBuilder",
    "build_graph",
]
