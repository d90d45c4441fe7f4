"""PQ asymmetric distance computation (counterpart of ``jvector_tpu/ops/adc.py``).

1. :func:`build_partial_sums` — per query, a ``[M, K]`` lookup table whose
   entry ``(m, k)`` is centroid ``k`` of subspace ``m``'s contribution to the
   query's raw measure (one batched product for the whole wave).
2. :func:`adc_score` — assemble-and-sum: gather one LUT entry per subspace
   and sum.  It is the plain twin of the K5 kernel
   (``ops/kernels/adc.py``), which the score providers call, on CPU
   tensors; :func:`adc_score_ordered` is the same function in K5's own
   summation order, which the kernel equals bit for bit.

Callers apply ``normalize_score``; COSINE also needs
:func:`partial_squared_magnitudes`.
"""

from __future__ import annotations

import torch

from jvector_tpu_torch.ops.similarity import SimilarityFunction


def build_partial_sums(
    queries: torch.Tensor,  # [Q, D_pad] (D_pad = M * S)
    codebooks: torch.Tensor,  # [M, K, S]
    sim: SimilarityFunction | str = SimilarityFunction.EUCLIDEAN,
) -> torch.Tensor:
    """Per-query ADC lookup tables ``[Q, M, K]`` of raw partial measures:
    ``dot(q_m, c_mk)`` for DOT_PRODUCT / COSINE, ``||q_m - c_mk||^2`` for
    EUCLIDEAN."""
    sim = SimilarityFunction.parse(sim)
    m, k, s = codebooks.shape
    qs = queries.float().reshape(queries.shape[0], m, s)
    dots = torch.einsum("qms,mks->qmk", qs, codebooks)
    if sim in (SimilarityFunction.DOT_PRODUCT, SimilarityFunction.COSINE):
        return dots.contiguous()  # the einsum may hand back a permuted view; K5 reads [M, K] rows
    q2 = torch.sum(qs * qs, dim=-1)[:, :, None]
    c2 = torch.sum(codebooks * codebooks, dim=-1)[None, :, :]
    return torch.clamp(q2 + c2 - 2.0 * dots, min=0.0)


def partial_squared_magnitudes(codebooks: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` squared centroid norms (the cosine denominator table)."""
    return torch.sum(codebooks * codebooks, dim=-1)


def adc_score(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """``out[q, c] = sum_m luts[q, m, codes[q, c, m]]``.

    luts ``[Q, M, K]`` float32, codes ``[Q, C, M]`` of any integer type ->
    raw measures ``[Q, C]``.  One flat gather over ``[Q, M*K]`` and a sum
    over M.
    """
    q, m, k = luts.shape
    c = codes.shape[1]
    flat_idx = codes.long() + torch.arange(m, device=codes.device) * k  # [Q, C, M]
    gathered = torch.gather(luts.reshape(q, m * k), 1, flat_idx.reshape(q, c * m))
    return gathered.reshape(q, c, m).sum(dim=-1)


def adc_score_ordered(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """:func:`adc_score` with K5's summation order: one float32 accumulator
    per candidate, starting at 0 and adding ``luts[q, m, codes[q, c, m]]``
    for m ascending (the Pallas kernel's loop), so the K5 kernel's output
    equals this bit for bit."""
    idx = codes.long()
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32, device=codes.device)
    for m in range(luts.shape[1]):
        acc = acc + torch.gather(luts[:, m], 1, idx[:, :, m])
    return acc


def adc_score_shared(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """ADC where every query scores the same candidates: luts ``[Q, M, K]``,
    codes ``[C, M]`` -> ``[Q, C]``."""
    idx = codes.long().t()[None].expand(luts.shape[0], -1, -1)  # [Q, M, C]
    return torch.gather(luts, 2, idx).sum(dim=1)
