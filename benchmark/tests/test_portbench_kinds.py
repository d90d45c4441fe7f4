"""Each traffic kind runs at a toy size on the CPU (the port's plain
twins) and gives a result line with the keys a result must carry."""

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import harness

CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))["workloads"]]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(toy_root, cell, trace, seed=2**33 + 5):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        r = harness.run_cell(cell, seed, 0.5, trace, device="cpu", root=toy_root,
                             bench_dir=os.path.join(toy_root, "benchmark"))
        harness.emit(r)
    return json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue().strip().splitlines()


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_kind_runs_at_a_toy_size(toy_root, cell, trace):
    line, err = _run(toy_root, cell, trace)
    assert list(line)[-1] == "checks"
    assert set(line) - {"checks", "breakdown"} == KEYS
    assert ("breakdown" in line) == trace
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    c = harness.load_cell(cell, toy_root, os.path.join(toy_root, "benchmark"))
    if trace:
        want = {m["name"] for m in c.per_layer if "device_trace" != m["source"]}  # no device trace on the CPU
    else:
        want = {m["name"] for m in c.end_to_end}
    assert want <= set(line["metrics"]) <= {m["name"] for m in c.per_layer + c.end_to_end}
    for m in line["metrics"].values():
        assert isinstance(m["value"], (int, float)) and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert [e.split(":")[0] for e in err[-3:]] == ["check recall", "check score_gap", "check bad_ids"]


def test_same_seed_same_answers(toy_root):
    a, _ = _run(toy_root, "euclidean-sq4-batch", False, seed=77)
    b, _ = _run(toy_root, "euclidean-sq4-batch", False, seed=77)
    assert a["checks"] == b["checks"]
