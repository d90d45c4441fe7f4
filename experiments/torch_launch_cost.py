"""Where a short kernel call's time goes on the host: the scatter wrappers
against the PyTorch calls they stand in for.

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
  same inputs (``chip_smoke.index_copy`` / ``index_put``).

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
    one = torch.zeros(1, device=dev)
    copy, put = chip_smoke.index_copy(w2, idx, pay), chip_smoke.index_put(w2, *k7)
    calls = {"events alone": lambda: None,
             "torch zero_": one.zero_,
             "K4b entry alone": lambda: _build.check(entry(*sent), "K4b entry"),
             "K4b wrapper": lambda: tsr.scatter_rows_inplace(w2, idx, pay),
             "index_copy_": lambda: copy(w2),
             "K7 wrapper": lambda: tsr.scatter_slots_inplace(w2, *k7),
             "index_put_": lambda: put(w2)}
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
