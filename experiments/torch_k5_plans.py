"""K5 under other launch plans than its planner's, on the card.

    python experiments/torch_k5_plans.py

For the serve, refine, BASELINE config 3, intra-wave and centroid-scan
shapes of ``chip_smoke.K5_SHAPES``: the planner's plan
(``ops/kernels/adc.py`` ``plan_for``), then the same kernel with the ring
1 to 4 stages deep (as many blocks as fit), with the grid cut to one and
two blocks an SM, and with the candidates cut into other slices.  Each
plan's output is held bit for bit to ``adc_score_ordered``; one JSON line
a plan with ``chip_smoke.cold_warm_us``'s device us (cold, clean-cold,
warm).  Ends with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from jvector_tpu_torch.ops.adc import adc_score_ordered  # noqa: E402
from jvector_tpu_torch.ops.kernels import _build  # noqa: E402
from jvector_tpu_torch.ops.kernels import adc as tadc  # noqa: E402

SHAPES = ("serve", "refine_search_rescore", "baseline_config3_serve", "build_intra_wave", "centroid_scan")


def run(luts: torch.Tensor, codes: torch.Tensor, p: tadc.Plan) -> torch.Tensor:
    q, m, k = luts.shape
    out = torch.empty((q, codes.shape[1]), dtype=torch.float32, device=luts.device)
    err = tadc._lib().jv_adc_score_planned(
        luts.data_ptr(), 0 if p.shared else luts.stride(0), codes.data_ptr(), out.data_ptr(), q, codes.shape[1],
        m, k, p.m_chunk, p.split, p.slice, p.stages, p.threads, p.blocks, p.vec, int(p.bulk),
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, f"K5 with {p}")
    return out


def variants(p: tadc.Plan, q: int, c: int) -> dict:
    """Other plans for the same call: ring depth, blocks an SM, slices."""
    stage = (p.smem - tadc.BAR_BYTES) // p.stages
    out = {"planned": p}

    def resized(stages: int = p.stages, slice_: int = p.slice, per_sm: int | None = None) -> tadc.Plan:
        split = -(-c // slice_)
        slice_ = -(-c // split)
        threads = min(256, -(-slice_ // 32) * 32) + (0 if p.shared else 32)
        smem = tadc.BAR_BYTES + stages * stage
        per_sm = per_sm or tadc._blocks_per_sm(smem, threads)
        return p._replace(stages=stages, split=split, slice=slice_, threads=threads, smem=smem,
                          blocks=min(q * split, tadc.SMS * per_sm))

    if not p.shared:
        for stages in (1, 2, 3, 4):
            if stages != p.stages and tadc.BAR_BYTES + stages * stage <= tadc.SMEM_PER_BLOCK:
                out[f"stages{stages}"] = resized(stages)
        out["one_block_an_sm"] = resized(per_sm=1)
        out["two_blocks_an_sm"] = resized(per_sm=2)
    for slice_ in (64, 128, 256, 512, 1024, 4096):
        if slice_ < c and slice_ != p.slice:
            out[f"slice{slice_}"] = resized(slice_=slice_)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for name in SHAPES:
        q, c, m, k = chip_smoke.K5_SHAPES[name]
        luts, codes = chip_smoke._k5_inputs(gen, q, c, m, k)
        want = adc_score_ordered(luts, codes)
        bound_us = chip_smoke.bound_ms(chip_smoke._k5_bytes(luts, codes)) * 1e3
        for label, p in variants(tadc.plan_for(luts, codes), q, c).items():
            equal = bool(torch.equal(run(luts, codes, p), want))
            times = chip_smoke.cold_warm_us(lambda p=p: run(luts, codes, p), "adc_ring_kernel", flush)
            print(json.dumps({"shape": name, "plan_label": label, "bit_equal": equal, "bound_us": bound_us,
                              **{key: v for key, v in times.items() if key.startswith("device")},
                              "plan": p._asdict()}), flush=True)
        del luts, codes, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
