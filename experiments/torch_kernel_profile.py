"""Device time of the port's K1/K2/K3/K4a/K4b/K5/K6/K7 CUDA kernels alone, and their register use.

    python experiments/torch_kernel_profile.py

Compiles ``jvector_tpu_torch/csrc/*.cu`` once more with ``-Xptxas -v`` and
prints each kernel's register and spill lines, then times 20 calls of each
wrapper at the 1M path shapes of ``chip_smoke.py`` (K5 at its serve,
build-search and centroid-scan shapes; K6 at its timed serve, micro and
shared-table shapes; K4a, K4b and K7 at the 1M mips-96d build shapes of
its scatter check) under ``torch.profiler`` and prints
the CUDA self time per launch of each kernel (K1/K2/K3: one launch per
phase) and per call, with its bound (bytes over 3.35 TB/s) beside it,
then the device time per call of the library calls that ``chip_smoke.py``
times as yardsticks (``index_copy_``, ``index_put_``, gather + sum).
``chip_smoke.py``'s CUDA-event times include the wrapper's host-side
checks and the ctypes call; these do not.  Ends with the card's name and
power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from jvector_tpu_torch.ops.kernels import _build  # noqa: E402
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for src in ("packed_adj.cu", "fused_update.cu", "scatter_rows.cu", "adc.cu", "adc16.cu"):
        print(json.dumps({"source": src, "ptxas": ptxas_usage(src)}), flush=True)

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
        fn()  # build and warm up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total / e.count, e.count)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        # a window in which the profiler recorded no device time reports null, not 0
        per_call = sum(t * c for _, t, c in rows) / 20 if rows else None
        print(json.dumps({"kernel": name, "device_us_per_launch": rows, "bound_us": bounds.get(name),
                          "device_us_per_call": per_call}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
