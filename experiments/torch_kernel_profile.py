"""Device time of the port's K1/K2/K3/K4a/K4b/K5/K6/K7 CUDA kernels alone, and their register use.

    python experiments/torch_kernel_profile.py
    python experiments/torch_kernel_profile.py --k5 [--rounds 2]
    python experiments/torch_kernel_profile.py --parent DIR [--rounds 3]
    python experiments/torch_kernel_profile.py --k6-plans [--rounds 2]

With ``--parent``, DIR holds another revision's kernel sources (for
instance ``git show REV:jvector_tpu_torch/csrc/adc.cu > DIR/adc.cu``, in a
git-ignored directory such as ``_scratch/``): the script builds those it
finds beside the tree's, checks that both give the same results, and
times them through the same calls in turns, parent, change, change,
parent, ``--rounds`` times over, printing every sample and the medians.
``packed_adj.cu`` with ``fused_update.cu``: K1, K3 and K2 device time
with the launch floor and the host time per call.  ``adc.cu``: K5 at
every ``chip_smoke.K5_SHAPES`` shape and the refine and BASELINE config 3
shapes at Q = 2048 and 4096 (:func:`k5_profile`).  ``scatter_rows.cu``
with its wrapper module ``scatter_rows.py`` (``git show
REV:jvector_tpu_torch/ops/kernels/scatter_rows.py > DIR/scatter_rows.py``):
K7, K4b and K4a at ``chip_smoke.py``'s five scatter cases through each
revision's own wrapper, device us, CUDA-event ms and host us a call
beside the library call's, the byte bound, the sector bound and the
launch floor (:func:`compare_scatter`).  ``adc16.cu`` with its wrapper
module ``adc16.py``: K6 at every ``chip_smoke.K6_SHAPES`` shape through
each revision's own wrapper, both held to ``adc16_ordered`` (the tree's
bit for bit), then device us (warm, back to back; and cold, clean-cold and
warm from ``chip_smoke.cold_warm_us``), CUDA-event ms and host us a call
beside the library call's, the sector bound and the whole-table byte
bound (:func:`compare_adc16`).

``--k6-plans`` runs K6 through its wrapper at every ``chip_smoke.K6_SHAPES``
shape under its own launch plan and under :data:`K6_VARIANTS` (the
planner's thresholds set for one or two candidates a thread, the staged
kernel at every C), each bit-checked against ``adc16_ordered``, and prints
device us (warm, back to back, and cold) of each in turns with the
wrapper's plan (:func:`k6_plans`).

``--k5`` alone runs :func:`k5_profile` on the tree's K5: each shape's
device us a call with a cold L2 (256 MB written before every call,
outside the timed span) and a warm one (back to back), from CUDA events
and torch.profiler, beside its byte bound, its share of that bound, the
library call's event times and the wrapper's launch plan.

Without either, compiles ``jvector_tpu_torch/csrc/*.cu`` once more with
``-Xptxas -v`` and prints each kernel's register and spill lines, then
times 20 calls of each wrapper at the 1M path shapes of ``chip_smoke.py``
(K5 at its serve, build-search and centroid-scan shapes; K6 at its timed
serve, micro and shared-table shapes; K4a, K4b and K7, one-element f32
and 48-byte u8 slots, at the 1M mips-96d build shapes of its scatter
check) under ``torch.profiler`` and prints
the device time per call of each (``chip_smoke.device_us``: the sum over
the kernels a call launches, with their names and counts per call) and
its host time per call (``chip_smoke.host_us``), with its bound (bytes
over 3.35 TB/s) beside it, and the launch floor,
then the device time per call of the library calls that ``chip_smoke.py``
times as yardsticks (``index_copy_``, ``index_put_``, gather + sum).
``chip_smoke.py``'s CUDA-event times include the wrapper's host-side
checks and the ctypes call; these do not.  Ends with the card's name and
power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from jvector_tpu_torch.ops.adc import adc_score_ordered  # noqa: E402
from jvector_tpu_torch.ops.adc16 import adc16_ordered  # noqa: E402
from jvector_tpu_torch.ops.kernels import _build  # noqa: E402
from jvector_tpu_torch.ops.kernels import adc as tadc  # noqa: E402
from jvector_tpu_torch.ops.kernels import adc16 as tadc16  # noqa: E402
from jvector_tpu_torch.ops.kernels import packed_adj as tpa  # noqa: E402
from jvector_tpu_torch.ops.kernels import scatter_rows as tsr  # noqa: E402
from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel  # noqa: E402
from jvector_tpu_torch.ops.kernels.adc16 import adc16_score_kernel  # noqa: E402
from jvector_tpu_torch.ops.kernels.packed_adj import packed_adj_only_update_inplace, packed_adj_update_inplace  # noqa: E402,E501
from jvector_tpu_torch.ops.kernels.scatter_rows import (  # noqa: E402
    fused_update_inplace,
    scatter_rows3_inplace,
    scatter_rows_inplace,
    scatter_slots_inplace,
)


def ptxas_usage(source: str) -> list[str]:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-o", os.path.join(tmp, "k.so"), os.path.join(_build.CSRC, source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]


def _parent_lib(src_dir: str, out_dir: str, source: str, functions: dict) -> ctypes.CDLL:
    """Build ``src_dir/source`` and bind ``functions`` (name -> argtypes)."""
    out = os.path.join(out_dir, f"parent_{source}.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(src_dir, source)], check=True)
    lib = ctypes.CDLL(out)
    for name, argtypes in functions.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def parent_libs(src_dir: str, out_dir: str) -> dict:
    """Build K1/K3's and K2's sources from ``src_dir`` (same C entry points as
    the tree's) and bind them with the tree's wrappers' argument types."""
    return {"packed_adj.cu": _parent_lib(src_dir, out_dir, "packed_adj.cu", {
                "jv_packed_adj_update": tpa._ARGTYPES, "jv_packed_adj_only_update": tpa._ONLY_ARGTYPES}),
            "fused_update.cu": _parent_lib(src_dir, out_dir, "fused_update.cu", {"jv_fused_update": tsr._ARGTYPES})}


@contextlib.contextmanager
def using(libs: dict | None):
    """Route the K1/K3 and K2 wrappers to ``libs`` (None: the tree's own)."""
    if libs is None:
        yield
        return
    own = tpa._lib, tsr._lib
    tpa._lib, tsr._lib = (lambda: libs["packed_adj.cu"]), (lambda: libs["fused_update.cu"])
    try:
        yield
    finally:
        tpa._lib, tsr._lib = own


# K5 beyond chip_smoke.K5_SHAPES: the refine's and BASELINE config 3's shapes
# at more queries, to see whether the share of the bound follows Q
K5_Q_SWEEP = {f"{name}_q{q}": (q, c, m, 256)
              for name, c, m in (("refine_search_rescore", 56, 16), ("baseline_config3_serve", 64, 24))
              for q in (2048, 4096)}


def parent_k5(src_dir: str, out_dir: str):
    """A call ``(luts, codes) -> out`` through ``src_dir/adc.cu``: through
    the tree's wrapper where that source takes the wrapper's launch plan,
    else through the entry ``jv_adc_score(luts, lut_q_stride, codes, out,
    q, c, m, k, stream)`` of the kernel before the plan."""
    with open(os.path.join(src_dir, "adc.cu")) as f:
        planned = "jv_adc_score_planned" in f.read()
    if planned:
        lib = _parent_lib(src_dir, out_dir, "adc.cu", {"jv_adc_score_planned": tadc._ARGTYPES})

        def call(luts, codes):
            own = tadc._lib
            tadc._lib = lambda: lib
            try:
                return tadc.adc_score_kernel(luts, codes)
            finally:
                tadc._lib = own
        return call
    argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
    lib = _parent_lib(src_dir, out_dir, "adc.cu", {"jv_adc_score": argtypes + [ctypes.c_void_p]})

    def call(luts, codes):
        q, m, k = luts.shape
        out = torch.empty((q, codes.shape[1]), dtype=torch.float32, device=luts.device)
        err = lib.jv_adc_score(luts.data_ptr(), luts.stride(0), codes.data_ptr(), out.data_ptr(), q, codes.shape[1],
                               m, k, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "parent adc_score")
        return out
    return call


def k5_profile(parent=None, rounds: int = 2) -> None:
    """K5 at every ``chip_smoke.K5_SHAPES`` shape and :data:`K5_Q_SWEEP`:
    output bit-equal to ``adc_score_ordered`` (and to the parent's, with
    ``parent``), then ``chip_smoke.cold_warm_us`` of each version in turns
    (parent, change, change, parent with a parent), ``rounds`` times; one
    JSON line a shape with every sample, the medians, the byte bound and
    each median's share of it, the library call's times and the plan."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    versions = {"change": tadc.adc_score_kernel}
    order = ("change",)
    if parent is not None:
        versions["parent"] = parent
        order = ("parent", "change", "change", "parent")
    for name, shape in {**chip_smoke.K5_SHAPES, **K5_Q_SWEEP}.items():
        luts, codes = chip_smoke._k5_inputs(gen, *shape)
        want = adc_score_ordered(luts, codes)
        outs = {v: f(luts, codes) for v, f in versions.items()}
        torch.cuda.synchronize()
        bound_us = chip_smoke.bound_ms(chip_smoke._k5_bytes(luts, codes)) * 1e3
        row = {"shape": name, "QCMK": list(shape), "bound_us": bound_us, "plan": tadc.plan_for(luts, codes)._asdict(),
               "bit_equal_to_ordered": {v: bool(torch.equal(o, want)) for v, o in outs.items()},
               "max_abs_diff_to_ordered": {v: float((o - want).abs().max()) for v, o in outs.items()}}
        samples = {v: [] for v in versions}
        for _ in range(rounds):
            for v in order:
                samples[v].append(chip_smoke.cold_warm_us(lambda f=versions[v]: f(luts, codes), "adc", flush))
        med = {v: {key: float(np.median([s[key] for s in xs if s[key] is not None]))
                   if any(s[key] is not None for s in xs) else None for key in xs[0]} for v, xs in samples.items()}
        row["median_us"] = med
        row["share_of_bound"] = {v: {key: (bound_us / t if t else None) for key, t in m.items()} for v, m in med.items()}
        row["library_us"] = chip_smoke.cold_warm_us(lambda: chip_smoke._k5_library(luts, codes), None, flush)
        row["samples_us"] = samples
        print(json.dumps(row), flush=True)
        del luts, codes, want, outs
    print(json.dumps({"launch_floor_us": chip_smoke.launch_floor_us()}), flush=True)


class ParentBuild:
    """Stands in for ``_build`` inside a parent's wrapper module, handing out
    the parent's library as the parent's ``_build.load`` did: under a lock
    on every call."""

    check = staticmethod(_build.check)

    def __init__(self, path: str):
        self.lib, self.lock = ctypes.CDLL(path), threading.Lock()

    def load(self, source: str, functions: dict) -> ctypes.CDLL:
        with self.lock:
            for name, argtypes in functions.items():
                getattr(self.lib, name).argtypes = argtypes
                getattr(self.lib, name).restype = ctypes.c_int
            return self.lib


def parent_module(src_dir: str, out_dir: str, name: str):
    """The parent's wrapper module ``src_dir/<name>.py``, loaded under
    another name, its ``_build`` routed to ``src_dir/<name>.cu`` built into
    ``out_dir``."""
    out = os.path.join(out_dir, f"parent_{name}.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(src_dir, f"{name}.cu")],
                   check=True)
    spec = importlib.util.spec_from_file_location(f"parent_{name}", os.path.join(src_dir, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._build = ParentBuild(out)
    return mod


def sector_bytes(table: torch.Tensor, args: tuple) -> int:
    """A scatter's least traffic counted in the 32-byte sectors that HBM and
    the L2 move: the index streams and the landed payload rows read once,
    and each destination sector that a landed item touches written once,
    and read first (filled) unless the landed items cover all 32 bytes of
    it.  Items are distinct slots or rows (duplicates carry identical
    images and count once), as in ``chip_smoke.py``'s cases."""
    idx, payload = args[0], args[-1]
    esize = table.element_size()
    row_bytes, item = table[0].numel() * esize, payload[0].numel() * payload.element_size()
    ok = (idx >= 0) & (idx < table.shape[0])
    start = idx.long() * row_bytes
    if len(args) == 3:
        off = args[1].long() * esize
        ok &= (off >= 0) & (off + item <= row_bytes)
        start = start + off
    start = torch.unique(start[ok])
    end = start + item
    first, last = start // 32, (end - 1) // 32
    two = last > first
    ids = torch.cat([first, last[two]])
    covered = torch.cat([torch.minimum(end, (first + 1) * 32) - start, (end - last * 32)[two]])
    sectors, inverse = torch.unique(ids, return_inverse=True)
    per_sector = torch.zeros(sectors.numel(), dtype=torch.long, device=ids.device).index_add_(0, inverse, covered)
    full = int((per_sector >= 32).sum()) + int((last - first - 1).clamp(min=0).sum())
    partial = sectors.numel() - int((per_sector >= 32).sum())
    streams = sum(x.numel() * x.element_size() for x in args[:-1])
    return streams + start.numel() * item + full * 32 + partial * 64


def scatter_cases(rng: np.random.Generator, dev) -> dict:
    """``chip_smoke.py``'s five scatter cases: name -> (wrapper name, table,
    args).  The two tables: the 1M mips-96d fused table ``[1M, 24, 128]``
    u8 (and its 2-D view) and ``[1M, 64]`` f32."""
    fused96, k4a_args = chip_smoke._scatter_rows_case(rng, dev, (24, 128), torch.uint8)
    flat96 = fused96.view(fused96.shape[0], -1)
    k4b_u8 = (k4a_args[0], k4a_args[1].view(k4a_args[1].shape[0], -1))
    k7_u8 = chip_smoke._scatter_slots_case(rng, dev, flat96, 48)
    w2, k4b_f32 = chip_smoke._scatter_rows_case(rng, dev, (64,), torch.float32)
    k7_f32 = chip_smoke._scatter_slots_case(rng, dev, w2, 1)
    return {"K7 f32 one-element slots [1M, 64]": ("scatter_slots_inplace", w2, k7_f32),
            "K7 u8 48-byte slots [1M, 3072]": ("scatter_slots_inplace", flat96, k7_u8),
            "K4b f32 [1M, 64]": ("scatter_rows_inplace", w2, k4b_f32),
            "K4b u8 [1M, 3072]": ("scatter_rows_inplace", flat96, k4b_u8),
            "K4a u8 [1M, 24, 128]": ("scatter_rows3_inplace", fused96, k4a_args)}


def compare_scatter(parent, rounds: int) -> None:
    """K7, K4b and K4a through the parent's wrapper module and the tree's in
    turns at :func:`scatter_cases`: both bit-equal to the twin first, then
    per version device us (``chip_smoke.device_us``), CUDA-event ms
    (``chip_smoke.median_ms``) and host us a call (``chip_smoke.host_us``),
    and the library call's event ms, device us and host us once a round."""
    dev = torch.device("cuda")
    floor = chip_smoke.launch_floor_us()
    versions = {"parent": parent, "change": tsr}
    for name, (fn_name, table, args) in scatter_cases(np.random.default_rng(4321), dev).items():
        twin = tsr.scatter_slots_ref if len(args) == 3 else tsr.scatter_rows_ref
        library = (chip_smoke.index_put if len(args) == 3 else chip_smoke.index_copy)(table, *args)
        want = twin(table.clone(), *args)
        copies = {v: getattr(m, fn_name)(table.clone(), *args) for v, m in versions.items()}
        torch.cuda.synchronize()
        row = {"case": name, "B": int(args[0].shape[0]), "item_bytes": args[-1][0].numel() * args[-1].element_size(),
               "bit_equal_to_twin": {v: bool(torch.equal(t, want)) for v, t in copies.items()},
               "bound_us": chip_smoke.bound_ms(chip_smoke._scatter_bytes(table, args)) * 1e3,
               "sector_bound_us": chip_smoke.bound_ms(sector_bytes(table, args)) * 1e3, "launch_floor_us": floor}
        del want
        samples = {v: {"device_us": [], "ms": [], "host_us": []} for v in versions}
        lib = {"device_us": [], "ms": [], "host_us": []}
        for _ in range(rounds):
            for v in ("parent", "change", "change", "parent"):
                call = (lambda f=getattr(versions[v], fn_name), t=copies[v]: f(t, *args))
                samples[v]["device_us"].append(chip_smoke.device_us(call)["device_us"])
                samples[v]["ms"].append(chip_smoke.median_ms(call))
                samples[v]["host_us"].append(chip_smoke.host_us(call))
            lib["device_us"].append(chip_smoke.device_us(lambda: library(copies["change"]))["device_us"])
            lib["ms"].append(chip_smoke.median_ms(lambda: library(copies["change"])))
            lib["host_us"].append(chip_smoke.host_us(lambda: library(copies["change"])))
        med = lambda xs: float(np.median([x for x in xs if x is not None])) if any(x is not None for x in xs) else None  # noqa: E731,E501
        row["median"] = {v: {k: med(xs) for k, xs in m.items()} for v, m in samples.items()}
        row["library_median"] = {k: med(xs) for k, xs in lib.items()}
        row["samples"] = samples
        print(json.dumps(row), flush=True)
        del copies, table, args
        torch.cuda.empty_cache()


def compare_adc16(parent, rounds: int) -> None:
    """K6 through the parent's wrapper module and the tree's in turns at
    every ``chip_smoke.K6_SHAPES`` shape: both against ``adc16_ordered``
    first (the tree's must be bit-equal), then per version device us
    (``chip_smoke.device_us``, back to back), CUDA-event ms
    (``chip_smoke.median_ms``), host us a call (``chip_smoke.host_us``) and
    ``chip_smoke.cold_warm_us``, and the library call's once a round; one
    JSON line a shape with every sample, the medians, the sector bound
    (shares are of it), the whole-table byte bound and the change's launch
    plan."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    versions = {"parent": parent.adc16_score_kernel, "change": tadc16.adc16_score_kernel}
    med = lambda xs: float(np.median([x for x in xs if x is not None])) if any(x is not None for x in xs) else None  # noqa: E731,E501
    for name, shape in chip_smoke.K6_SHAPES.items():
        luts, codes = chip_smoke._k6_inputs(gen, *shape)
        want = adc16_ordered(luts, codes)
        outs = {v: f(luts, codes) for v, f in versions.items()}
        torch.cuda.synchronize()
        row = {"shape": name, "Q_MP_C_shared": list(shape), "plan": tadc16.plan_for(luts, codes)._asdict(),
               "bound_us": chip_smoke.bound_ms(chip_smoke._k6_sector_bytes(luts, codes)) * 1e3,
               "table_bound_us": chip_smoke.bound_ms(chip_smoke._k6_bytes(luts, codes)) * 1e3,
               "bit_equal_to_ordered": {v: bool(torch.equal(o, want)) for v, o in outs.items()},
               "max_abs_diff_to_ordered": {v: float((o - want).abs().max()) for v, o in outs.items()}}
        keys = ("device_us", "ms", "host_us", "event_cold_us", "event_clean_cold_us", "event_warm_us",
                "device_cold_us", "device_clean_cold_us", "device_warm_us")
        samples = {v: {k: [] for k in keys} for v in versions}
        lib = {k: [] for k in keys}
        for _ in range(rounds):
            for v in ("parent", "change", "change", "parent", "library"):
                call = (lambda: chip_smoke._k6_library(luts, codes)) if v == "library" else (
                    lambda f=versions[v]: f(luts, codes))
                got = {"device_us": chip_smoke.device_us(call)["device_us"], "ms": chip_smoke.median_ms(call),
                       "host_us": chip_smoke.host_us(call),
                       **chip_smoke.cold_warm_us(call, None if v == "library" else "adc16", flush)}
                for k in keys:
                    (lib if v == "library" else samples[v])[k].append(got.get(k))
        row["median"] = {v: {k: med(xs) for k, xs in m.items()} for v, m in samples.items()}
        row["library_median"] = {k: med(xs) for k, xs in lib.items()}
        row["share_of_bound"] = {v: {k: (row["bound_us"] / m[k] if m[k] else None)
                                     for k in ("device_us", "device_cold_us", "device_clean_cold_us")}
                                 for v, m in row["median"].items()}
        row["samples"] = samples
        print(json.dumps(row), flush=True)
        del luts, codes, want, outs
    print(json.dumps({"launch_floor_us": chip_smoke.launch_floor_us()}), flush=True)


# K6 plans beside the wrapper's: the planner's thresholds set so that every
# shape takes the staged kernel with one candidate a thread, or two
# (``ops/kernels/adc16.py``'s ``DIRECT_MAX_C`` and ``WIDE_MIN_THREADS``)
K6_VARIANTS = {"v1": {"DIRECT_MAX_C": 0, "WIDE_MIN_THREADS": 1 << 62},
               "v2": {"DIRECT_MAX_C": 0, "WIDE_MIN_THREADS": 0}}


@contextlib.contextmanager
def k6_variant(knobs: dict):
    """The K6 wrapper planning under ``knobs`` (its cached plans cleared on
    the way in and out)."""
    kept = {k: getattr(tadc16, k) for k in knobs}
    tadc16._c_plans.clear()
    for k, value in knobs.items():
        setattr(tadc16, k, value)
    try:
        yield
    finally:
        for k, value in kept.items():
            setattr(tadc16, k, value)
        tadc16._c_plans.clear()


def k6_plans(rounds: int) -> None:
    """K6 through its wrapper under its own plan and under each
    :data:`K6_VARIANTS` plan at every ``chip_smoke.K6_SHAPES`` shape:
    bit-equal to ``adc16_ordered`` or marked so, then device us
    (``chip_smoke.device_us``, back to back) and cold
    (``chip_smoke.cold_warm_us``), the wrapper's plan timed between every
    variant; one JSON line a shape."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    med = lambda xs: float(np.median([x for x in xs if x is not None])) if any(x is not None for x in xs) else None  # noqa: E731,E501
    variants = {"wrapper": {}, **K6_VARIANTS}
    call = lambda: adc16_score_kernel(luts, codes)  # noqa: E731
    for name, shape in chip_smoke.K6_SHAPES.items():
        luts, codes = chip_smoke._k6_inputs(gen, *shape)
        want = adc16_ordered(luts, codes)
        row = {"shape": name, "Q_MP_C_shared": list(shape),
               "bound_us": chip_smoke.bound_ms(chip_smoke._k6_sector_bytes(luts, codes)) * 1e3, "plans": {}}
        samples = {k: {"device_us": [], "device_cold_us": []} for k in variants}
        for _ in range(rounds):
            for k in variants:
                for v in (("wrapper", k) if k != "wrapper" else ("wrapper",)):
                    with k6_variant(variants[v]):
                        samples[v]["device_us"].append(chip_smoke.device_us(call)["device_us"])
                        samples[v]["device_cold_us"].append(
                            chip_smoke.cold_warm_us(call, "adc16", flush)["device_cold_us"])
        for k, knobs in variants.items():
            with k6_variant(knobs):
                out = call()
                row["plans"][k] = {"plan": tadc16.plan_for(luts, codes)._asdict(),
                                   "bit_equal": bool(torch.equal(out, want)),
                                   **{m: med(xs) for m, xs in samples[k].items()}}
        print(json.dumps(row), flush=True)
        del luts, codes, want, out


def compare_parent(src_dir: str, rounds: int) -> None:
    if os.path.exists(os.path.join(src_dir, "adc16.cu")):
        with tempfile.TemporaryDirectory() as tmp:
            compare_adc16(parent_module(src_dir, tmp, "adc16"), rounds)
    if os.path.exists(os.path.join(src_dir, "adc.cu")):
        with tempfile.TemporaryDirectory() as tmp:
            k5_profile(parent_k5(src_dir, tmp), rounds)
    if os.path.exists(os.path.join(src_dir, "scatter_rows.cu")):
        with tempfile.TemporaryDirectory() as tmp:
            compare_scatter(parent_module(src_dir, tmp, "scatter_rows"), rounds)
    if not os.path.exists(os.path.join(src_dir, "packed_adj.cu")):
        return
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    adj, w2t, k1_args = chip_smoke._k1_inputs(rng, dev)
    k3_args = chip_smoke._k3_args(k1_args)
    table, k2_args = chip_smoke._k2_inputs(rng, dev)
    with tempfile.TemporaryDirectory() as tmp:
        versions = {"parent": parent_libs(src_dir, tmp), "change": None}
        cases = {
            "K1 packed_adj_update_inplace": ((adj, w2t), lambda t: tpa.packed_adj_update_inplace(*t, *k1_args),
                                             chip_smoke._k1_bytes(adj, k1_args)),
            "K3 packed_adj_only_update_inplace": ((adj,), lambda t: tpa.packed_adj_only_update_inplace(*t, *k3_args),
                                                  chip_smoke._k3_bytes(adj, k3_args)),
            "K2 fused_update_inplace": ((table,), lambda t: tsr.fused_update_inplace(*t, *k2_args),
                                        chip_smoke._k2_bytes(table, k2_args)),
        }
        for name, (tables, call, n_bytes) in cases.items():
            out = {}
            for version, libs in versions.items():
                copies = tuple(x.clone() for x in tables)
                with using(libs):
                    call(copies)
                out[version] = copies
            same = all(torch.equal(a, b) for a, b in zip(out["parent"], out["change"]))
            samples = {"parent": [], "change": []}
            kernels, host = {}, {"parent": [], "change": []}
            for _ in range(rounds):
                for version in ("parent", "change", "change", "parent"):
                    with using(versions[version]):
                        dev_t = chip_smoke.device_us(lambda: call(out[version]))
                        host[version].append(chip_smoke.host_us(lambda: call(out[version])))
                    samples[version].append(dev_t["device_us"])
                    kernels[version] = dev_t["kernels_per_call"]
            med = {v: (float(np.median([x for x in xs if x is not None])) if any(x is not None for x in xs) else None)
                   for v, xs in samples.items()}
            print(json.dumps({"kernel": name, "same_tables": same, "device_us": samples, "median_device_us": med,
                              "kernels_per_call": kernels, "host_us": {v: float(np.median(h)) for v, h in host.items()},
                              "bound_us": chip_smoke.bound_ms(n_bytes) * 1e3}), flush=True)
            del out
    print(json.dumps({"launch_floor_us": chip_smoke.launch_floor_us()}), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", help="directory with another revision's adc.cu, packed_adj.cu and "
                                     "fused_update.cu, and / or scatter_rows.cu with scatter_rows.py, and / or "
                                     "adc16.cu with adc16.py")
    p.add_argument("--k5", action="store_true", help="K5's cold and warm times at every shape, no parent")
    p.add_argument("--k6-plans", action="store_true", help="K6 under other launch plans at every shape")
    p.add_argument("--rounds", type=int, default=3, help="parent, change, change, parent rounds (with --parent)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for src in ("packed_adj.cu", "fused_update.cu", "scatter_rows.cu", "adc.cu", "adc16.cu"):
        print(json.dumps({"source": src, "ptxas": ptxas_usage(src)}), flush=True)
    if args.parent or args.k5 or args.k6_plans:
        if args.parent:
            compare_parent(args.parent, args.rounds)
        if args.k6_plans:
            k6_plans(args.rounds)
        if args.k5:
            k5_profile(rounds=args.rounds)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip(), flush=True)
        return

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    adj, w2t, k1_args = chip_smoke._k1_inputs(rng, dev)
    k3_adj, k3_args = adj.clone(), chip_smoke._k3_args(k1_args)
    table, k2_args = chip_smoke._k2_inputs(rng, dev)
    calls = [
        ("K1 packed_adj_update_inplace", lambda: packed_adj_update_inplace(adj, w2t, *k1_args)),
        ("K3 packed_adj_only_update_inplace", lambda: packed_adj_only_update_inplace(k3_adj, *k3_args)),
        ("K2 fused_update_inplace", lambda: fused_update_inplace(table, *k2_args)),
    ]
    gen = torch.Generator(device=dev).manual_seed(7)
    bounds = {"K1 packed_adj_update_inplace": chip_smoke.bound_ms(chip_smoke._k1_bytes(adj, k1_args)) * 1e3,
              "K3 packed_adj_only_update_inplace": chip_smoke.bound_ms(chip_smoke._k3_bytes(k3_adj, k3_args)) * 1e3,
              "K2 fused_update_inplace": chip_smoke.bound_ms(chip_smoke._k2_bytes(table, k2_args)) * 1e3}
    fused96, k4a_args = chip_smoke._scatter_rows_case(rng, dev, (24, 128), torch.uint8)
    flat96 = fused96.view(fused96.shape[0], -1)
    k4b_args = (k4a_args[0], k4a_args[1].view(k4a_args[1].shape[0], -1))
    k7_u8_args = chip_smoke._scatter_slots_case(rng, dev, flat96, 48)
    w2, k4b_f32_args = chip_smoke._scatter_rows_case(rng, dev, (64,), torch.float32)
    k7_args = chip_smoke._scatter_slots_case(rng, dev, w2, 1)
    calls += [
        ("K4a scatter_rows3_inplace", lambda: scatter_rows3_inplace(fused96, *k4a_args)),
        ("K4b scatter_rows_inplace u8", lambda: scatter_rows_inplace(flat96, *k4b_args)),
        ("K4b scatter_rows_inplace f32", lambda: scatter_rows_inplace(w2, *k4b_f32_args)),
        ("K7 scatter_slots_inplace f32", lambda: scatter_slots_inplace(w2, *k7_args)),
        ("K7 scatter_slots_inplace u8 48B", lambda: scatter_slots_inplace(flat96, *k7_u8_args)),
    ]
    for name, (dst, args) in {"K4a scatter_rows3_inplace": (fused96, k4a_args),
                              "K4b scatter_rows_inplace u8": (flat96, k4b_args),
                              "K4b scatter_rows_inplace f32": (w2, k4b_f32_args),
                              "K7 scatter_slots_inplace f32": (w2, k7_args),
                              "K7 scatter_slots_inplace u8 48B": (flat96, k7_u8_args)}.items():
        bounds[name] = chip_smoke.bound_ms(chip_smoke._scatter_bytes(dst, args)) * 1e3
    for shape in ("serve", "build_search", "centroid_scan"):
        luts, codes = chip_smoke._k5_inputs(gen, *chip_smoke.K5_SHAPES[shape])
        name = f"K5 adc_score_kernel {shape}"
        bounds[name] = chip_smoke.bound_ms(chip_smoke._k5_bytes(luts, codes)) * 1e3
        calls.append((name, lambda luts=luts, codes=codes: adc_score_kernel(luts, codes)))
    for shape in ("serve_200k", "serve_mips_1m", "micro", "cosine_norm_shared"):
        luts, codes = chip_smoke._k6_inputs(gen, *chip_smoke.K6_SHAPES[shape])
        name = f"K6 adc16_score_kernel {shape}"
        bounds[name] = chip_smoke.bound_ms(chip_smoke._k6_sector_bytes(luts, codes)) * 1e3
        calls.append((name, lambda luts=luts, codes=codes: adc16_score_kernel(luts, codes)))
    # the library calls that compute the same functions (chip_smoke.py's yardsticks)
    calls += [
        ("library index_copy_ (K4b f32)", lambda f=chip_smoke.index_copy(w2, *k4b_f32_args): f(w2)),
        ("library index_put_ (K7 f32)", lambda f=chip_smoke.index_put(w2, *k7_args): f(w2)),
        ("library index_put_ (K7 u8 48B)", lambda f=chip_smoke.index_put(flat96, *k7_u8_args): f(flat96)),
        ("library index_copy_ (K4a)", lambda f=chip_smoke.index_copy(fused96, *k4a_args): f(fused96)),
    ]
    luts, codes = chip_smoke._k5_inputs(gen, *chip_smoke.K5_SHAPES["serve"])
    calls.append(("library gather + sum (K5 serve)", lambda: chip_smoke._k5_library(luts, codes)))
    luts16, codes16 = chip_smoke._k6_inputs(gen, *chip_smoke.K6_SHAPES["serve_200k"])
    calls.append(("library gather + sum (K6 serve_200k)", lambda: chip_smoke._k6_library(luts16, codes16)))
    for name, fn in calls:
        dev_t = chip_smoke.device_us(fn)  # a window with no device time reports null, not 0
        print(json.dumps({"kernel": name, "bound_us": bounds.get(name), "device_us_per_call": dev_t["device_us"],
                          "kernels_per_call": dev_t["kernels_per_call"], "host_us": chip_smoke.host_us(fn)}),
              flush=True)
    print(json.dumps({"launch_floor_us": chip_smoke.launch_floor_us()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
