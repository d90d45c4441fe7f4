"""K6: LUT16 (4-bit PQ) assemble-and-sum (counterpart of ``adc16_pallas`` in
``jvector_tpu/ops/pallas/adc16_kernel.py``).

:func:`adc16_score_kernel` launches the CUDA kernel in ``csrc/adc16.cu``
for CUDA tensors and runs the plain twin
:func:`jvector_tpu_torch.ops.adc16.adc16_ref` for CPU tensors:

    out[q, c] = sum_j luts[q, j, lo(codes[q, j, c])] + luts[q, j, 16 + hi(codes[q, j, c])]

The kernel sums over j in ascending order in float32; the twin's order may
differ, so the two agree to float32 rounding (bit-equal on integer tables).
"""

from __future__ import annotations

import ctypes

import torch

from jvector_tpu_torch.ops.adc16 import adc16_ref
from jvector_tpu_torch.ops.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_ARGTYPES += [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("adc16.cu", {"jv_adc16_score": _ARGTYPES})


def adc16_score_kernel(luts_paired: torch.Tensor, codes_packed: torch.Tensor) -> torch.Tensor:
    """luts ``[Q, MP, 32]`` float32 (each query's ``[MP, 32]`` table
    contiguous; a query stride of 0 shares one table), codes ``[Q, MP, C]``
    contiguous uint8 -> ``[Q, C]`` float32.

    CUDA tensors launch K6 (and count one launch); CPU tensors run the
    twin.  Any other device, or a call the kernel does not take, raises.
    """
    luts, codes = luts_paired, codes_packed
    if luts.device.type == "cpu":
        return adc16_ref(luts, codes)
    if luts.device.type != "cuda":
        raise ValueError(f"adc16_score_kernel: unsupported device {luts.device}")
    if luts.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"need luts [Q, MP, 32] and codes [Q, MP, C], got {tuple(luts.shape)}, {tuple(codes.shape)}")
    q, mp, k2 = luts.shape
    c = codes.shape[2]
    if k2 != 32:
        raise ValueError(f"paired LUT16 tables have 32 entries a row, got {k2}")
    if codes.shape[:2] != (q, mp):
        raise ValueError(f"codes {tuple(codes.shape)} do not match luts {tuple(luts.shape)}")
    if luts.dtype != torch.float32 or luts.stride(2) != 1 or luts.stride(1) != 32:
        raise ValueError("luts must be float32 with each [MP, 32] table contiguous")
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8, got {codes.dtype}")
    if codes.device != luts.device:
        raise ValueError(f"codes on {codes.device}, luts on {luts.device}")
    out = torch.empty((q, c), dtype=torch.float32, device=luts.device)
    if q == 0 or c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(luts.device):
        err = lib.jv_adc16_score(
            luts.data_ptr(), luts.stride(0), codes.data_ptr(), out.data_ptr(), q, mp, c,
            torch.cuda.current_stream(luts.device).cuda_stream,
        )
    _build.check(err, "adc16_score_kernel")
    adc16_score_kernel.launches += 1
    return out


adc16_score_kernel.launches = 0  # kernel launches (CUDA calls only)
