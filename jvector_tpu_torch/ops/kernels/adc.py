"""K5: PQ assemble-and-sum (counterpart of ``adc_score_pallas`` in
``jvector_tpu/ops/pallas/adc_kernel.py``).

:func:`adc_score_kernel` launches the CUDA kernel in ``csrc/adc.cu`` for
CUDA tensors and runs the plain twin :func:`jvector_tpu_torch.ops.adc.adc_score`
for CPU tensors:

    out[q, c] = sum_m luts[q, m, codes[q, c, m]]

The kernel sums over m in ascending order in float32; the twin's order may
differ, so the two agree to float32 rounding (bit-equal on integer tables).
"""

from __future__ import annotations

import ctypes

import torch

from jvector_tpu_torch.ops.adc import adc_score
from jvector_tpu_torch.ops.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_ARGTYPES += [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("adc.cu", {"jv_adc_score": _ARGTYPES})


def adc_score_kernel(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts ``[Q, M, K]`` float32 (each query's ``[M, K]`` table contiguous;
    a query stride of 0 shares one table), codes ``[Q, C, M]`` -> ``[Q, C]``.

    CUDA tensors launch K5 (and count one launch); it takes uint8 codes
    with K <= 256, and codes >= K are the caller's fault.  CPU tensors run
    the twin.  Any other device raises.
    """
    if luts.device.type == "cpu":
        return adc_score(luts, codes)
    if luts.device.type != "cuda":
        raise ValueError(f"adc_score_kernel: unsupported device {luts.device}")
    if luts.dim() != 3 or codes.dim() != 3:
        raise ValueError(f"need luts [Q, M, K] and codes [Q, C, M], got {tuple(luts.shape)}, {tuple(codes.shape)}")
    q, m, k = luts.shape
    c = codes.shape[1]
    if codes.shape[0] != q or codes.shape[2] != m:
        raise ValueError(f"codes {tuple(codes.shape)} do not match luts {tuple(luts.shape)}")
    if luts.dtype != torch.float32 or luts.stride(2) != 1 or luts.stride(1) != k:
        raise ValueError("luts must be float32 with each [M, K] table contiguous")
    if codes.dtype != torch.uint8 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8, got {codes.dtype}")
    if k > 256:
        raise ValueError(f"uint8 codes address at most 256 centroids, got K={k}")
    if codes.device != luts.device:
        raise ValueError(f"codes on {codes.device}, luts on {luts.device}")
    out = torch.empty((q, c), dtype=torch.float32, device=luts.device)
    if q == 0 or c == 0:
        return out
    lib = _lib()
    with torch.cuda.device(luts.device):
        err = lib.jv_adc_score(
            luts.data_ptr(), luts.stride(0), codes.data_ptr(), out.data_ptr(), q, c, m, k,
            torch.cuda.current_stream(luts.device).cuda_stream,
        )
    _build.check(err, "adc_score_kernel")
    adc_score_kernel.launches += 1
    return out


adc_score_kernel.launches = 0  # kernel launches (CUDA calls only)
