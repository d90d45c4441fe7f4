"""Device time of the port's K1/K2/K3/K4a/K4b/K5/K6/K7 CUDA kernels alone, and their register use.

    python experiments/torch_kernel_profile.py
    python experiments/torch_kernel_profile.py --parent DIR [--rounds 3]

With ``--parent``, DIR holds another revision's ``packed_adj.cu`` and
``fused_update.cu`` (for instance ``git show REV:jvector_tpu_torch/csrc/packed_adj.cu
> DIR/packed_adj.cu``, in a git-ignored directory such as ``_scratch/``):
the script builds them beside the tree's, checks that both give the same
tables, and times K1, K3 and K2 through the same wrappers in turns,
parent, change, change, parent, ``--rounds`` times over, printing every
sample and the medians with the launch floor and the host time per call.

Compiles ``jvector_tpu_torch/csrc/*.cu`` once more with ``-Xptxas -v`` and
prints each kernel's register and spill lines, then times 20 calls of each
wrapper at the 1M path shapes of ``chip_smoke.py`` (K5 at its serve,
build-search and centroid-scan shapes; K6 at its timed serve, micro and
shared-table shapes; K4a, K4b and K7 at the 1M mips-96d build shapes of
its scatter check) under ``torch.profiler`` and prints
the device time per call of each (``chip_smoke.device_us``: the sum over
the kernels a call launches, with their names and counts per call), with
its bound (bytes over 3.35 TB/s) beside it, and the launch floor,
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
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from jvector_tpu_torch.ops.kernels import _build  # noqa: E402
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


def parent_libs(src_dir: str, out_dir: str) -> dict:
    """Build K1/K3's and K2's sources from ``src_dir`` (same C entry points as
    the tree's) and bind them with the tree's wrappers' argument types."""
    libs = {}
    for source, functions in (
        ("packed_adj.cu", {"jv_packed_adj_update": tpa._ARGTYPES, "jv_packed_adj_only_update": tpa._ONLY_ARGTYPES}),
        ("fused_update.cu", {"jv_fused_update": tsr._ARGTYPES}),
    ):
        out = os.path.join(out_dir, f"parent_{source}.so")
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", out, os.path.join(src_dir, source)], check=True)
        lib = ctypes.CDLL(out)
        for name, argtypes in functions.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[source] = lib
    return libs


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


def compare_parent(src_dir: str, rounds: int) -> None:
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
    p.add_argument("--parent", help="directory with another revision's packed_adj.cu and fused_update.cu")
    p.add_argument("--rounds", type=int, default=3, help="parent, change, change, parent rounds (with --parent)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for src in ("packed_adj.cu", "fused_update.cu", "scatter_rows.cu", "adc.cu", "adc16.cu"):
        print(json.dumps({"source": src, "ptxas": ptxas_usage(src)}), flush=True)
    if args.parent:
        compare_parent(args.parent, args.rounds)
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
    w2, k4b_f32_args = chip_smoke._scatter_rows_case(rng, dev, (64,), torch.float32)
    k7_args = chip_smoke._scatter_slots_case(rng, dev, w2, 1)
    calls += [
        ("K4a scatter_rows3_inplace", lambda: scatter_rows3_inplace(fused96, *k4a_args)),
        ("K4b scatter_rows_inplace u8", lambda: scatter_rows_inplace(flat96, *k4b_args)),
        ("K4b scatter_rows_inplace f32", lambda: scatter_rows_inplace(w2, *k4b_f32_args)),
        ("K7 scatter_slots_inplace f32", lambda: scatter_slots_inplace(w2, *k7_args)),
    ]
    for name, (dst, args) in {"K4a scatter_rows3_inplace": (fused96, k4a_args),
                              "K4b scatter_rows_inplace u8": (flat96, k4b_args),
                              "K4b scatter_rows_inplace f32": (w2, k4b_f32_args),
                              "K7 scatter_slots_inplace f32": (w2, k7_args)}.items():
        bounds[name] = chip_smoke.bound_ms(chip_smoke._scatter_bytes(dst, args)) * 1e3
    for shape in ("serve", "build_search", "centroid_scan"):
        luts, codes = chip_smoke._k5_inputs(gen, *chip_smoke.K5_SHAPES[shape])
        name = f"K5 adc_score_kernel {shape}"
        bounds[name] = chip_smoke.bound_ms(luts.numel() * 4 + codes.numel() + codes.shape[0] * codes.shape[1] * 4) * 1e3
        calls.append((name, lambda luts=luts, codes=codes: adc_score_kernel(luts, codes)))
    for shape in ("serve_200k", "serve_mips_1m", "micro", "cosine_norm_shared"):
        luts, codes = chip_smoke._k6_inputs(gen, *chip_smoke.K6_SHAPES[shape])
        name = f"K6 adc16_score_kernel {shape}"
        bounds[name] = chip_smoke.bound_ms(chip_smoke._k6_bytes(luts, codes)) * 1e3
        calls.append((name, lambda luts=luts, codes=codes: adc16_score_kernel(luts, codes)))
    # the library calls that compute the same functions (chip_smoke.py's yardsticks)
    calls += [
        ("library index_copy_ (K4b f32)", lambda f=chip_smoke.index_copy(w2, *k4b_f32_args): f(w2)),
        ("library index_put_ (K7 f32)", lambda f=chip_smoke.index_put(w2, *k7_args): f(w2)),
        ("library index_copy_ (K4a)", lambda f=chip_smoke.index_copy(fused96, *k4a_args): f(fused96)),
    ]
    luts, codes = chip_smoke._k5_inputs(gen, *chip_smoke.K5_SHAPES["serve"])
    calls.append(("library gather + sum (K5 serve)", lambda: chip_smoke._k5_library(luts, codes)))
    luts16, codes16 = chip_smoke._k6_inputs(gen, *chip_smoke.K6_SHAPES["serve_200k"])
    calls.append(("library gather + sum (K6 serve_200k)", lambda: chip_smoke._k6_library(luts16, codes16)))
    for name, fn in calls:
        dev_t = chip_smoke.device_us(fn)  # a window with no device time reports null, not 0
        print(json.dumps({"kernel": name, "bound_us": bounds.get(name), "device_us_per_call": dev_t["device_us"],
                          "kernels_per_call": dev_t["kernels_per_call"]}), flush=True)
    print(json.dumps({"launch_floor_us": chip_smoke.launch_floor_us()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
