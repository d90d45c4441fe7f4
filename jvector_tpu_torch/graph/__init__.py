"""Graph core: graph data model, score providers (exact, SQ4, PQ-ADC,
LUT16), robust prune, query-wave beam search, the wave builders and the
hierarchy (PyTorch counterpart of ``jvector_tpu.graph``)."""

from jvector_tpu_torch.graph.builder import GraphIndexBuilder, build_graph
from jvector_tpu_torch.graph.index import GraphConfig, GraphIndex
from jvector_tpu_torch.graph.score import (
    ADCScoreProvider,
    ExactScoreProvider,
    FusedADCScoreProvider,
    LUT16ScoreProvider,
    SQ4ScoreProvider,
    build_fused_codes,
    build_fused_codes_lut16,
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
    "LUT16ScoreProvider",
    "build_fused_codes",
    "build_fused_codes_lut16",
    "build_fused_sq4",
    "search",
    "SearchResult",
    "BeamState",
    "GraphIndexBuilder",
    "build_graph",
]
