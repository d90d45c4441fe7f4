"""Batched similarity measures (PyTorch counterpart of
``jvector_tpu/ops/similarity.py``).

Score normalization matches the reference exactly
(``jv/quantization/PQDecoder.java:83-136`` and ``VectorSimilarityFunction``):

- DOT_PRODUCT: ``(1 + dot) / 2``
- EUCLIDEAN:   ``1 / (1 + ||a-b||^2)``
- COSINE:      ``(1 + cos) / 2``

Higher is always better.  The batched shape is the only one that matters:
a wave of queries ``[Q, D]`` against a block of candidates ``[C, D]`` in one
matrix product.
"""

from __future__ import annotations

import enum

import torch


class SimilarityFunction(str, enum.Enum):
    """Mirror of the reference's ``VectorSimilarityFunction`` enum."""

    DOT_PRODUCT = "dot_product"
    EUCLIDEAN = "euclidean"
    COSINE = "cosine"

    @classmethod
    def parse(cls, v: "SimilarityFunction | str") -> "SimilarityFunction":
        if isinstance(v, cls):
            return v
        return cls(str(getattr(v, "value", v)).lower())  # also the JAX package's enum


def dot_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis (broadcasts leading axes)."""
    return torch.sum(a * b, dim=-1)


def squared_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance over the last axis."""
    d = a - b
    return torch.sum(d * d, dim=-1)


def cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity over the last axis."""
    num = torch.sum(a * b, dim=-1)
    den = torch.sqrt(torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    return num / torch.clamp(den, min=1e-30)


def l2_normalize(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Reference: ``VectorUtil.l2normalize``."""
    n = torch.sqrt(torch.sum(a * a, dim=axis, keepdim=True))
    return a / torch.clamp(n, min=1e-30)


def normalize_score(raw: torch.Tensor, sim: SimilarityFunction | str) -> torch.Tensor:
    """Raw measure -> similarity score (higher = closer)."""
    sim = SimilarityFunction.parse(sim)
    if sim == SimilarityFunction.EUCLIDEAN:
        return 1.0 / (1.0 + raw)  # raw is a squared distance
    return (1.0 + raw) / 2.0


def pairwise_raw(
    queries: torch.Tensor,
    base: torch.Tensor,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
) -> torch.Tensor:
    """Raw measure between every query and every base vector.

    queries ``[..., Q, D]``, base ``[..., C, D]`` -> ``[..., Q, C]`` float32.
    L2 uses the ``||a||^2 + ||b||^2 - 2ab`` expansion, so all three
    measures ride one matrix product.
    """
    sim = SimilarityFunction.parse(sim)
    queries = queries.float()
    base = base.float()
    dots = queries @ base.transpose(-1, -2)
    if sim == SimilarityFunction.DOT_PRODUCT:
        return dots
    if sim == SimilarityFunction.COSINE:
        qn = torch.sqrt(torch.sum(queries * queries, dim=-1))[..., :, None]
        bn = torch.sqrt(torch.sum(base * base, dim=-1))[..., None, :]
        return dots / torch.clamp(qn * bn, min=1e-30)
    q2 = torch.sum(queries * queries, dim=-1)[..., :, None]
    b2 = torch.sum(base * base, dim=-1)[..., None, :]
    return torch.clamp(q2 + b2 - 2.0 * dots, min=0.0)


def pairwise_scores(
    queries: torch.Tensor,
    base: torch.Tensor,
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
) -> torch.Tensor:
    """Normalized similarity scores ``[..., Q, C]``, higher = closer."""
    sim = SimilarityFunction.parse(sim)
    return normalize_score(pairwise_raw(queries, base, sim), sim)
