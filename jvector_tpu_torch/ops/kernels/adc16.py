"""K6: LUT16 (4-bit PQ) assemble-and-sum (counterpart of ``adc16_pallas`` in
``jvector_tpu/ops/pallas/adc16_kernel.py``).

:func:`adc16_score_kernel` launches the CUDA kernel in ``csrc/adc16.cu``
for CUDA tensors and runs the plain twin
:func:`jvector_tpu_torch.ops.adc16.adc16_ref` for CPU tensors:

    out[q, c] = sum_j luts[q, j, lo(codes[q, j, c])] + luts[q, j, 16 + hi(codes[q, j, c])]

The kernel keeps the Pallas kernel's summation order, so it equals
:func:`jvector_tpu_torch.ops.adc16.adc16_ordered` bit for bit; the CPU
twin's order may differ, so the two agree to float32 rounding (bit-equal
on integer tables).  :func:`plan` sizes each launch (see
``csrc/adc16.cu``).  The launch costs the host little: one function
checks the tensors and passes the plan to the C entry, bound once and
kept (:func:`_entry`), with the device index and the raw stream handle.
"""

from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from jvector_tpu_torch.ops.adc16 import adc16_ref
from jvector_tpu_torch.ops.kernels import _build

# jv_adc16(luts, lut_q_stride, codes, out, q, mp, c, plan, device, stream); plan: int32[8] (Plan.c_plan)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
_ARGTYPES += [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_adc16_fn = None  # jv_adc16 once bound (_entry)
_c_plans: dict = {}  # ((Q, MP, C), query stride, codes' address mod 16) -> the plan's int32[8], built once
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # device index -> cudaStream_t (CUDA builds)
_F32, _U8 = torch.float32, torch.uint8

SMS = 132  # H100 SXM
MAX_THREADS = 1024  # a block
THREADS, SHARED_THREADS = 128, 256  # a block's target: small blocks, larger off a shared table
SHARED_BLOCKS_PER_SM = 4  # off a shared table the grid is at most this many blocks an SM, each copying it once
WIDE_MIN_THREADS = SMS * 128  # two candidates a thread only where that still leaves 4 warps an SM
DIRECT_MAX_C = 4  # up to this many candidates a query gather from device memory, copying no tables
SMEM = 48 * 1024  # a block's dynamic shared memory (the default limit)
BAR_BYTES = 16  # the mbarrier, before the tables


class Plan(NamedTuple):
    """One K6 launch (see ``csrc/adc16.cu``)."""

    direct: bool  # one thread a candidate (tpq threads a block), gathering from device memory
    v: int  # candidates a thread: 1 or 2 (a byte or half-word of each code row)
    tpq: int  # threads an item (whole warps); an item is one query's tpq * v candidates
    qpb: int  # items a block
    tiles: int  # items a query
    rows: int  # table rows copied at a time (MP unless one query's tables outgrow the block)
    stage_codes: bool  # code rows by a bulk copy beside the tables, else read from device memory
    shared: bool  # one table for every query, copied once a block
    smem: int  # dynamic shared memory a block
    blocks: int  # each walks item groups b, b + blocks, ...

    def c_plan(self):
        """The plan as ``jv_adc16`` reads it: int32[8]."""
        fields = (self.direct, self.v, self.tpq, self.qpb, self.rows, self.stage_codes, self.shared, self.blocks)
        return (ctypes.c_int * 8)(*map(int, fields))


def smem_bytes(c: int, qpb: int, rows: int, stage_codes: bool, shared: bool) -> int:
    """A block's dynamic shared memory (``csrc/adc16.cu``'s layout: the
    barrier, the tables' rows, the code rows)."""
    return BAR_BYTES + (1 if shared else qpb) * rows * 128 + (qpb * rows * c if stage_codes else 0)


def plan(q: int, mp: int, c: int, *, shared: bool = False, code_align: int = 16) -> Plan:
    """K6's launch plan for luts ``[q, mp, 32]`` and codes ``[q, mp, c]``.

    ``shared``: one table serves every query (a query stride of 0, or
    Q = 1); ``code_align``: the largest of 16, 2, 1 that divides the codes'
    address.

    With at most four candidates a query, each thread gathers one
    candidate's entries from device memory, in blocks of 128 threads (32
    where the grid would have fewer than two blocks an SM).  Otherwise a
    thread takes two candidates (two chains of adds, a half-word of each
    code row) where C and the codes' address are even and the grid still
    has 4 warps an SM (faster at the serve and recall waves, slower at the
    micro's 256 queries: ``PERF.md``), else one; an item is as many whole warps as cover
    C, at most 1024 threads.  A block holds 128 threads' worth of items
    (256 off a shared table), halved while the grid would have fewer than
    two blocks an SM or the block more than 48 KB.  Code rows come by bulk
    copy where an item is a whole query, C a multiple of 16 and the codes
    16-byte aligned.  One query whose tables outgrow 48 KB copies them in
    chunks of whole 8-row groups (off a shared table too, then copied by
    each item).  The grid is one block an item group, or, off a shared
    table, at most four blocks an SM.
    """
    if c <= DIRECT_MAX_C:
        threads = THREADS if q * c >= 2 * SMS * THREADS else 32  # one warp a block where that fills more SMs
        return Plan(True, 1, threads, 1, 1, mp, False, shared, 0, -(-q * c // threads))
    v = 2 if q * (c // 2) >= WIDE_MIN_THREADS and c % 2 == 0 and code_align % 2 == 0 else 1
    per_query = -(-c // v)  # threads that cover one query's candidates
    tpq = min(MAX_THREADS, -(-per_query // 32) * 32)
    tiles = -(-c // (tpq * v))
    items = q * tiles
    stage_codes = tiles == 1 and c % 16 == 0 and code_align % 16 == 0
    shared = shared and smem_bytes(c, 1, mp, False, True) <= SMEM
    qpb = max(1, (SHARED_THREADS if shared else THREADS) // tpq)
    while qpb > 1 and (-(-items // qpb) < 2 * SMS or smem_bytes(c, qpb, mp, stage_codes, shared) > SMEM):
        qpb //= 2
    rows = mp
    if smem_bytes(c, 1, mp, stage_codes, shared) > SMEM:  # one query, its tables in chunks
        rows = (SMEM - BAR_BYTES) // (128 + (c if stage_codes else 0)) // 8 * 8
        if rows < 8:
            stage_codes = False  # not even 8 code rows fit beside their tables
            rows = (SMEM - BAR_BYTES) // 128 // 8 * 8
    groups = -(-items // qpb)
    return Plan(False, v, tpq, qpb, tiles, rows, stage_codes, shared, smem_bytes(c, qpb, rows, stage_codes, shared),
                min(groups, SMS * SHARED_BLOCKS_PER_SM) if shared else groups)


def plan_for(luts: torch.Tensor, codes: torch.Tensor) -> Plan:
    """:func:`plan` for these tensors: a query stride of 0, or one query,
    shares the table."""
    q, mp, _ = luts.shape
    return plan(q, mp, codes.shape[2], shared=q == 1 or luts.stride(0) == 0, code_align=_align(codes.data_ptr()))


def _align(ptr: int) -> int:
    return 16 if ptr % 16 == 0 else 2 if ptr % 2 == 0 else 1


def _entry():
    """K6's C entry ``jv_adc16``: built and bound at the first call, then kept."""
    global _adc16_fn
    if _adc16_fn is None:
        _adc16_fn = _build.load("adc16.cu", {"jv_adc16": _ARGTYPES}).jv_adc16
    return _adc16_fn


def adc16_score_kernel(luts_paired: torch.Tensor, codes_packed: torch.Tensor) -> torch.Tensor:
    """luts ``[Q, MP, 32]`` float32 (each query's ``[MP, 32]`` table
    contiguous; a query stride of 0 shares one table), codes ``[Q, MP, C]``
    contiguous uint8 -> ``[Q, C]`` float32.

    CUDA tensors launch K6 (and count one launch, and one for the shape
    ``(Q, MP, C)`` in ``adc16_score_kernel.by_shape``); CPU tensors run
    the twin.  Any other device, or a call the kernel does not take,
    raises before any launch.
    """
    luts, codes = luts_paired, codes_packed
    d = luts.get_device()  # -1 off the card
    if d < 0:
        if luts.device.type == "cpu":
            return adc16_ref(luts, codes)
        raise ValueError(f"adc16_score_kernel: unsupported device {luts.device}")
    shape, c_shape = luts.shape, codes.shape
    if len(shape) != 3 or len(c_shape) != 3:
        raise ValueError(f"need luts [Q, MP, 32] and codes [Q, MP, C], got {tuple(shape)}, {tuple(c_shape)}")
    q, mp, k2 = shape
    qmc = (q, mp, c_shape[2])
    if k2 != 32:
        raise ValueError(f"paired LUT16 tables have 32 entries a row, got {k2}")
    if c_shape[:2] != shape[:2]:
        raise ValueError(f"codes {tuple(c_shape)} do not match luts {tuple(shape)}")
    stride = luts.stride()
    if luts.dtype != _F32 or stride[1:] != (32, 1):
        raise ValueError("luts must be float32 with each [MP, 32] table contiguous")
    if codes.dtype != _U8 or not codes.is_contiguous():
        raise ValueError(f"codes must be contiguous uint8, got {codes.dtype}")
    if codes.get_device() != d:
        raise ValueError(f"codes on {codes.device}, luts on {luts.device}")
    out = luts.new_empty(qmc[::2])
    if not out.numel():
        return out
    lut_stride = 0 if q == 1 else stride[0]
    cp = codes.data_ptr()
    c_plan = _c_plans.get((qmc, lut_stride, cp & 15)) or _c_plan(qmc, lut_stride, cp)
    err = (_adc16_fn or _entry())(luts.data_ptr(), lut_stride, cp, out.data_ptr(), *qmc, c_plan, d, _raw_stream(d))
    if err:
        _build.check(err, "adc16_score_kernel")
    adc16_score_kernel.launches += 1
    by_shape = adc16_score_kernel.by_shape
    by_shape[qmc] = by_shape.get(qmc, 0) + 1
    return out


def _c_plan(qmc: tuple, lut_stride: int, cp: int):
    """The wrapper's plan for shape ``qmc`` = (Q, MP, C), as ``jv_adc16``
    reads it, built once for each shape, sharing and codes' alignment."""
    c_plan = _c_plans[(qmc, lut_stride, cp & 15)] = plan(*qmc, shared=lut_stride == 0, code_align=_align(cp)).c_plan()
    return c_plan


adc16_score_kernel.launches = 0  # kernel launches (CUDA calls only)
adc16_score_kernel.by_shape = collections.Counter()  # the same launches by (Q, MP, C)
