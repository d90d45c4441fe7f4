"""Where a short kernel call's time goes on the host: the scatter wrappers,
K6's and K8's against the PyTorch calls they stand in for.

    python experiments/torch_launch_cost.py [--rounds 7]

At ``chip_smoke.py``'s K4b f32 and K7 f32 cases (``[1M, 64]`` f32, 17,408
rows and 16,384 one-element slots) it takes, for each call below, the
CUDA-event span of one call (``chip_smoke.median_ms``) and the host time
a call (``chip_smoke.host_us``), the calls in turns, ``--rounds`` times
over, and prints one JSON line a call with every sample and the medians:

- ``events alone``: ``a.record(); b.record()`` with nothing between, the
  floor of every event span;
- ``torch zero_``: one PyTorch launch on a one-element tensor;
- ``K4b entry alone``: the bound C entry called with the arguments that
  the K4b wrapper passes it, taken beforehand (the ctypes call and the
  launch, no checks, no plan);
- the K4b and K7 wrappers, and ``index_copy_`` / ``index_put_`` on the
  same inputs (``chip_smoke.index_copy`` / ``index_put``);
- at K6's serve_200k shape (``chip_smoke.K6_SHAPES``): ``torch.empty`` of
  its ``[4096, 64]`` float32 output alone, ``K6 entry alone`` (the bound C
  entry with the arguments the wrapper passes it, into one output taken
  beforehand), the K6 wrapper, and the gather-and-sum library call
  (``chip_smoke._k6_library``);
- at K8's bq_serve shape (``chip_smoke.K8_SHAPES``, the BQ cell's share of
  active pops): ``K8 outputs alone`` (the wrapper's three output
  allocations), ``K8 entry alone`` (the bound C entry with the arguments
  the wrapper passes it, into outputs taken beforehand), the K8 wrapper,
  and its plain twin, the ATen chain the beam step ran before K8.

A span this short is host time: the event after the call is enqueued
only when the host returns, after the kernel has run.  Ends with the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from jvector_tpu_torch.ops.kernels import _build  # noqa: E402
from jvector_tpu_torch.ops.kernels import adc16 as tadc16  # noqa: E402
from jvector_tpu_torch.ops.kernels import frontier as tfr  # noqa: E402
from jvector_tpu_torch.ops.kernels import scatter_rows as tsr  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=7)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(4321)
    w2, (idx, pay) = chip_smoke._scatter_rows_case(rng, dev, (64,), torch.float32)
    k7 = chip_smoke._scatter_slots_case(rng, dev, w2, 1)
    entry = tsr._scatter_entry()
    sent = []  # the arguments the K4b wrapper passes, taken from one call that launches nothing
    tsr._scatter_fn = lambda *a: sent.append(a) or 0
    try:
        tsr.scatter_rows_inplace(w2, idx, pay)
    finally:
        tsr._scatter_fn = entry
    sent = sent[0]
    luts, codes = chip_smoke._k6_inputs(torch.Generator(device=dev).manual_seed(7),
                                        *chip_smoke.K6_SHAPES["serve_200k"])
    k6_entry = tadc16._entry()
    k6_sent = []  # the arguments the K6 wrapper passes, taken from one call that launches nothing
    tadc16._adc16_fn = lambda *a: k6_sent.append(a) or 0
    try:
        tadc16.adc16_score_kernel(luts, codes)
    finally:
        tadc16._adc16_fn = k6_entry
    k6_out = torch.empty((luts.shape[0], codes.shape[2]), device=dev)  # the wrapper's own output was freed
    k6_sent = (*k6_sent[0][:3], k6_out.data_ptr(), *k6_sent[0][4:])
    q, e, r, l, t = chip_smoke.K8_SHAPES["bq_serve"]
    k8_in = [torch.as_tensor(x, device=dev) for x in chip_smoke.frontier_case(rng, q, e, r, l, t,
                                                                                chip_smoke.K8_ACTIVE["bq_serve"])]
    k8_args = (k8_in[0], k8_in[1], r, k8_in[2], k8_in[3])
    k8_entry = tfr._entry()
    k8_sent = []  # the arguments the K8 wrapper passes, taken from one call that launches nothing
    tfr._frontier_fn = lambda *a: k8_sent.append(a) or 0
    try:
        tfr.frontier_filter(*k8_args)
    finally:
        tfr._frontier_fn = k8_entry
    nbrs = k8_in[0]

    def k8_outputs():
        return nbrs.new_empty(nbrs.shape, dtype=torch.bool), torch.empty_like(nbrs), torch.empty_like(nbrs)

    k8_out = k8_outputs()  # the wrapper's own outputs were freed
    k8_sent = (*k8_sent[0][:4], *(x.data_ptr() for x in k8_out), *k8_sent[0][7:])
    one = torch.zeros(1, device=dev)
    copy, put = chip_smoke.index_copy(w2, idx, pay), chip_smoke.index_put(w2, *k7)
    calls = {"events alone": lambda: None,
             "torch zero_": one.zero_,
             "K4b entry alone": lambda: _build.check(entry(*sent), "K4b entry"),
             "K4b wrapper": lambda: tsr.scatter_rows_inplace(w2, idx, pay),
             "index_copy_": lambda: copy(w2),
             "K7 wrapper": lambda: tsr.scatter_slots_inplace(w2, *k7),
             "index_put_": lambda: put(w2),
             "torch.empty [4096, 64] f32": lambda: torch.empty((4096, 64), device=dev),
             "K6 entry alone": lambda: _build.check(k6_entry(*k6_sent), "K6 entry"),
             "K6 wrapper": lambda: tadc16.adc16_score_kernel(luts, codes),
             "K6 gather + sum": lambda: chip_smoke._k6_library(luts, codes),
             "K8 outputs alone": k8_outputs,
             "K8 entry alone": lambda: _build.check(k8_entry(*k8_sent), "K8 entry"),
             "K8 wrapper": lambda: tfr.frontier_filter(*k8_args),
             "K8 twin": lambda: tfr.frontier_filter_ref(*k8_args)}
    samples = {name: {"event_us": [], "host_us": []} for name in calls}
    for _ in range(args.rounds):
        for name, call in calls.items():
            samples[name]["event_us"].append(chip_smoke.median_ms(call) * 1e3)
            samples[name]["host_us"].append(chip_smoke.host_us(call))
    for name, xs in samples.items():
        print(json.dumps({"call": name, "median": {k: float(np.median(v)) for k, v in xs.items()}, "samples": xs}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
