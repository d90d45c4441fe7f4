"""On the card: a toy copy of each cell runs through the CUDA kernels and
comes out correct, its traced run reads the device trace, and its control
does not.  Skips without a card."""

import json
import os

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_toy_cell_on_the_card(toy_root, cuda_device, cell):
    kw = dict(device="cuda", root=toy_root, bench_dir=os.path.join(toy_root, "benchmark"))
    r = harness.run_cell(cell, 5, 0.5, True, **kw)
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > r["device"]["busy_s"]
    c = harness.load_cell(cell, toy_root, kw["bench_dir"])
    assert set(r["metrics"]) == {m["name"] for m in c.per_layer}
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
    assert harness.run_cell(cell, 5, 0.5, False, control=True, **kw)["correct"] is False
