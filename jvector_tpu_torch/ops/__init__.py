"""Vector math (PyTorch counterpart of ``jvector_tpu.ops``); ``ops/kernels``
holds the wrappers of the hand-written CUDA kernels and their plain twins."""

from jvector_tpu_torch.ops.adc import adc_score, build_partial_sums
from jvector_tpu_torch.ops.hamming import bq_similarity, hamming_distance, pack_bits
from jvector_tpu_torch.ops.similarity import (
    SimilarityFunction,
    cosine,
    dot_product,
    l2_normalize,
    normalize_score,
    pairwise_raw,
    pairwise_scores,
    squared_l2,
)

__all__ = [
    "SimilarityFunction",
    "dot_product",
    "cosine",
    "squared_l2",
    "pairwise_scores",
    "pairwise_raw",
    "normalize_score",
    "l2_normalize",
    "build_partial_sums",
    "adc_score",
    "hamming_distance",
    "pack_bits",
    "bq_similarity",
]
