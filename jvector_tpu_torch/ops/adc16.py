"""LUT16 (4-bit PQ) layouts and the plain assemble-and-sum (counterpart of
the helpers in ``jvector_tpu/ops/pallas/adc16_kernel.py``).

With K = 16 centroids per subspace, two codes pack into one byte, and the
two subspaces of a byte share one 32-entry table row:

- ``luts  [Q, MP, 32]`` float32: row ``j`` holds the 16 entries of
  subspace ``2j`` then the 16 entries of subspace ``2j+1``;
- ``codes [Q, MP, C]`` uint8, subspace-major: byte ``j`` of candidate ``c``
  is ``code[2j] | code[2j+1] << 4``.

``scores[q, c] = sum_j luts[q, j, lo(codes[q,j,c])] + luts[q, j, 16 + hi(...)]``

:func:`adc16_ref` is the plain twin of the K6 kernel
(``ops/kernels/adc16.py``), which the LUT16 provider calls on the CPU;
:func:`adc16_ordered` is the same function in the Pallas kernel's
summation order, which the K6 kernel equals bit for bit.
"""

from __future__ import annotations

import torch

from jvector_tpu_torch.quantization.sq import pack_nibble_rows, unpack_nibble_rows

K16 = 16


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """``[N, M]`` 4-bit codes (values < 16) -> packed ``[N, M/2]`` uint8."""
    if codes.shape[-1] % 2:
        raise ValueError(f"subspace count must be even to pack nibbles, got {codes.shape[-1]}")
    return pack_nibble_rows(codes)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., MP]`` uint8 -> ``[..., 2*MP]`` 4-bit codes (uint8)."""
    return unpack_nibble_rows(packed).to(torch.uint8)


def lut_pairs(luts: torch.Tensor) -> torch.Tensor:
    """``[Q, M, 16]`` LUT -> paired ``[Q, M/2, 32]`` kernel layout."""
    q, m, k = luts.shape
    if k != K16 or m % 2:
        raise ValueError(f"need [Q, M, 16] with M even, got {tuple(luts.shape)}")
    return luts.reshape(q, m // 2, 2 * K16)


def adc16_ref(luts_paired: torch.Tensor, codes_packed: torch.Tensor) -> torch.Tensor:
    """luts ``[Q, MP, 32]``, codes ``[Q, MP, C]`` -> raw measures ``[Q, C]``:
    two gathers (low and high nibbles) and a sum over MP.  ``luts`` may be
    an expanded view of one shared table."""
    lo = (codes_packed & 0xF).long()
    hi = (codes_packed >> 4).long()
    g_lo = torch.gather(luts_paired[:, :, :K16], 2, lo)
    g_hi = torch.gather(luts_paired[:, :, K16:], 2, hi)
    return torch.sum(g_lo + g_hi, dim=1)


def adc16_ordered(luts_paired: torch.Tensor, codes_packed: torch.Tensor) -> torch.Tensor:
    """:func:`adc16_ref` in the Pallas kernel's summation order: one float32
    accumulator a candidate, starting at 0, j ascending, and for each byte
    the entry of its smaller nibble added first (the low one on a tie).
    The Pallas kernel walks k = 0..15 adding the low nibble's entry where
    ``lo == k``, then the high one's where ``hi == k``, and zeros elsewhere,
    which is exact; the K6 kernel equals this bit for bit."""
    q, mp, _ = luts_paired.shape
    acc = torch.zeros((q, codes_packed.shape[2]), dtype=torch.float32, device=codes_packed.device)
    for j in range(mp):
        byte = codes_packed[:, j]
        lo, hi = (byte & 0xF).long(), (byte >> 4).long()
        e_lo = torch.gather(luts_paired[:, j, :K16], 1, lo)
        e_hi = torch.gather(luts_paired[:, j, K16:], 1, hi)
        hi_first = hi < lo
        acc = acc + torch.where(hi_first, e_hi, e_lo)
        acc = acc + torch.where(hi_first, e_lo, e_hi)
    return acc
