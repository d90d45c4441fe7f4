"""Binary-quantization (BQ) bit packing and hamming similarity (counterpart
of ``jvector_tpu/ops/hamming.py``).

Reference: 1-bit sign quantization (``BinaryQuantization.java:88-110``) and
``similarity = 1 - hamming / d`` (``BQVectors.java:116-118``).  Bits are
packed 32 dims a word, little-endian within a word (bit j of word w covers
dim ``32*w + j``), as in the JAX package.

torch has no full set of uint32 operations, so a word is an int32 read bit
for bit as the JAX package's uint32: word ``w`` here is
``np.uint32(w_jax).view(np.int32)``.  Integer adds and subtracts wrap in
two's complement as uint32's do, ``>>`` is arithmetic, so every shift is
masked, and numpy code views the words as ``np.uint32`` only at its edge
(``convert``, files).
"""

from __future__ import annotations

import numpy as np
import torch


def packed_words(dim: int) -> int:
    return (dim + 31) // 32


def pack_bits(vectors: torch.Tensor) -> torch.Tensor:
    """Sign-quantize ``[..., D]`` float vectors into ``[..., ceil(D/32)]``
    int32 words: a dim contributes a 1 bit iff its value > 0.  Each word is
    the OR of its 32 shifted bits, so bit 31 lands as the sign bit."""
    d = vectors.shape[-1]
    w = packed_words(d)
    bits = vectors > 0
    if w * 32 > d:
        bits = torch.nn.functional.pad(bits, (0, w * 32 - d))
    bits = bits.reshape(*vectors.shape[:-1], w, 32)
    out = torch.zeros(bits.shape[:-1], dtype=torch.int32, device=vectors.device)
    for j in range(32):
        out |= bits[..., j].to(torch.int32) << j
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 words read as uint32 -> int32 counts."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + ((x >> 8) & 0x00FF00FF)
    return (x + ((x >> 16) & 0xFF)) & 0x3F


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed codes, reduced over the last axis
    (int32)."""
    return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)


def bits_similarity(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """``1 - hamming(a, b) / dim`` over broadcast packed codes (float32),
    rounded as the JAX package's compiled expression rounds it: the count
    times the float32 reciprocal of ``dim``, subtracted from 1 with one
    rounding (a fused multiply-add).  The float64 product and difference
    are exact, so the float32 cast is that one rounding."""
    recip = float(np.float32(1.0 / dim))
    return (1.0 - hamming_distance(a, b).double() * recip).float()


def bq_similarity(query_codes: torch.Tensor, base_codes: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """``1 - hamming/d`` between queries ``[Q, W]`` and base ``[C, W]`` ->
    ``[Q, C]``.  ``dim`` defaults to ``W * 32``; pass the true dimension
    when D % 32 != 0."""
    d = dim if dim is not None else base_codes.shape[-1] * 32
    return bits_similarity(query_codes[:, None, :], base_codes[None, :, :], d)
