"""K5: PQ assemble-and-sum (counterpart of ``adc_score_pallas`` in
``jvector_tpu/ops/pallas/adc_kernel.py``).

:func:`adc_score_kernel` launches the CUDA kernel in ``csrc/adc.cu`` for
CUDA tensors and runs the plain twin :func:`jvector_tpu_torch.ops.adc.adc_score`
for CPU tensors:

    out[q, c] = sum_m luts[q, m, codes[q, c, m]]

The kernel sums over m in ascending order in float32, so it equals
:func:`jvector_tpu_torch.ops.adc.adc_score_ordered` bit for bit; the CPU
twin's order may differ, so the two agree to float32 rounding (bit-equal
on integer tables).  :func:`plan` sizes each launch (see ``csrc/adc.cu``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple

import torch

from jvector_tpu_torch.ops.adc import adc_score
from jvector_tpu_torch.ops.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_ARGTYPES += [ctypes.c_int] * 12 + [ctypes.c_void_p]

SMS = 132  # H100 SXM
SMEM_PER_BLOCK = 232_448  # Hopper's opt-in dynamic shared memory a block
SMEM_PER_SM = 233_472  # of which the runtime keeps 1 KB a block
BAR_BYTES = 128  # csrc/adc.cu's barriers, before the ring
MAX_STAGES = 2  # deeper rings measured no faster than more resident blocks (PERF.md)
CHUNK_ALIGN = 16  # M-chunks are whole 16-byte code vectors
SHARED_SLICE = 2048  # candidates a block scores per walk step off a shared table


def _blocks_per_sm(smem: int, threads: int) -> int:
    return max(1, min(SMEM_PER_SM // (smem + 1024), 2048 // threads, 32))


class Plan(NamedTuple):
    """One K5 launch (see ``csrc/adc.cu``)."""

    m_chunk: int  # subspaces a ring stage holds (M unless the table outgrows a block)
    n_chunks: int
    split: int  # slices a query's candidates are cut into; an item is one slice
    slice: int  # candidates a slice
    stages: int  # ring depth
    threads: int  # a block: the producer warp and one consumer a candidate (all consumers off a shared table)
    blocks: int
    vec: int  # bytes a code load
    bulk: bool  # tables by TMA bulk copy, else 4-byte cp.async
    shared: bool  # one table for every query, copied once a block
    smem: int  # dynamic shared memory a block


@functools.lru_cache(maxsize=1024)
def plan(q: int, c: int, m: int, k: int, *, shared: bool = False, lut_aligned: bool = True,
         code_align: int = 16) -> Plan:
    """K5's launch plan for luts ``[q, m, k]`` and codes ``[q, c, m]``.

    ``shared``: one table serves every query (a query stride of 0, or
    Q = 1); ``lut_aligned``: the tables' base and query stride are
    multiples of 16 bytes; ``code_align``: the largest of 16, 8, 1 that
    divides the codes' address.

    A ring stage holds a whole ``[m, k]`` table wherever one fits in a
    block's shared memory, else 112-subspace M-chunks (at K = 256, from
    M = 227).  The ring is two stages deep, or one for a shared table,
    copied once a block.  The grid is as many blocks as fit on the SMs at
    once, never more than the items.  An item is one query's candidates;
    with fewer than 2 x 132 queries, a slice of them, cut so that the
    resident blocks have one each; off a shared table, slices of 2048.
    Deeper rings with fewer blocks, slices of at most 256 candidates and
    code blocks carried through the ring measured no faster (``PERF.md``).
    """
    budget = SMEM_PER_BLOCK - BAR_BYTES
    lut_bytes = -(-m * k // 32) * 128
    m_chunk = m if lut_bytes <= budget else budget // 2 // (k * 4) // CHUNK_ALIGN * CHUNK_ALIGN
    n_chunks = -(-m // m_chunk)
    shared = shared and n_chunks == 1
    stage = -(-m_chunk * k // 32) * 128
    stages = 1 if shared else min(MAX_STAGES, budget // stage)
    smem = BAR_BYTES + stages * stage
    vec = next(v for v in (16, 8, 1) if m % v == 0 and code_align % v == 0)
    last = (m - (n_chunks - 1) * m_chunk) * k * 4
    bulk = lut_aligned and (m_chunk * k * 4) % 16 == 0 and last % 16 == 0
    producer = 0 if shared else 32
    if shared:
        split = -(-c // SHARED_SLICE)
    elif q >= 2 * SMS:
        split = 1
    else:
        split = max(1, min(-(-SMS * _blocks_per_sm(smem, 256 + producer) // q), -(-c // 32)))
    slice_ = -(-c // split)
    split = -(-c // slice_)
    threads = min(256, -(-slice_ // 32) * 32) + producer
    blocks = min(q * split, SMS * _blocks_per_sm(smem, threads))
    return Plan(m_chunk, n_chunks, split, slice_, stages, threads, blocks, vec, bulk, shared, smem)


def plan_for(luts: torch.Tensor, codes: torch.Tensor) -> Plan:
    """:func:`plan` for these tensors: a query stride of 0, or one query,
    shares the table."""
    q, m, k = luts.shape
    stride = 0 if q == 1 else luts.stride(0)
    return plan(q, codes.shape[1], m, k, shared=stride == 0,
                lut_aligned=luts.data_ptr() % 16 == 0 and stride * 4 % 16 == 0,
                code_align=math.gcd(codes.data_ptr(), 16))


def _lib() -> ctypes.CDLL:
    return _build.load("adc.cu", {"jv_adc_score_planned": _ARGTYPES})


def adc_score_kernel(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts ``[Q, M, K]`` float32 (each query's ``[M, K]`` table contiguous;
    a query stride of 0 shares one table), codes ``[Q, C, M]`` -> ``[Q, C]``.

    CUDA tensors launch K5 (and count one launch, and one for the shape
    ``(Q, C, M)`` in ``adc_score_kernel.by_shape``); it takes uint8 codes
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
    p = plan_for(luts, codes)
    lib = _lib()
    with torch.cuda.device(luts.device):
        err = lib.jv_adc_score_planned(
            luts.data_ptr(), 0 if p.shared else luts.stride(0), codes.data_ptr(), out.data_ptr(), q, c, m, k,
            p.m_chunk, p.split, p.slice, p.stages, p.threads, p.blocks, p.vec, int(p.bulk),
            torch.cuda.current_stream(luts.device).cuda_stream,
        )
    _build.check(err, "adc_score_kernel")
    adc_score_kernel.launches += 1
    adc_score_kernel.by_shape[(q, c, m)] += 1
    return out


adc_score_kernel.launches = 0  # kernel launches (CUDA calls only)
adc_score_kernel.by_shape = collections.Counter()  # the same launches by (Q, C, M)
