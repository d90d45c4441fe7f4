"""Every cell of BENCHMARK.json loads from its files, and the file keeps
to the benchmark's contract in what a test can check."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests import toy

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_from_its_files(cell, tmp_path):
    root = toy.make(str(tmp_path))
    c = harness.load_cell(cell, root, os.path.join(root, "benchmark"))
    assert c.chips == 1
    assert c.kind_module().run and c.index_module().prepare and c.index_module().control
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and "recall_at_10" in names and len(names) >= 3
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in names
        reader = harness.load_module(harness.reader_path(c.bench_dir, m["name"]), m["name"])
        assert callable(reader.read)
    for key in ("recall_min", "score_gap_max", "bad_ids_max"):
        assert key in c.config["checks"]


@pytest.mark.parametrize("bench", [BENCH], ids=["committed"])
def test_benchmark_json_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    for entry in bench["configs"] + bench["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert m["bound"] >= 0.01
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len({e["name"] for e in metrics}) == len(metrics)
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(harness.ROOT, c["file"])) and c["file"].startswith("benchmark/")
        cfg = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert set(c["reduced"]) <= set(cfg["source"]), "a reduced key names a size of the source"
        for key in c["reduced"]:
            assert cfg[key] != cfg["source"][key]
    assert len(json.dumps(bench)) < 64 * 1024


def test_an_unknown_name_fails_with_the_name():
    with pytest.raises(harness.CellError, match="no-such-cell"):
        harness.load_cell("no-such-cell")


def test_a_split_name_falls_back_to_its_quantity(tmp_path):
    (tmp_path / "layer_metrics").mkdir()
    (tmp_path / "layer_metrics" / "rate.py").write_text("")
    (tmp_path / "layer_metrics" / "rate.b.py").write_text("")
    assert harness.reader_path(str(tmp_path), "rate.a").endswith("layer_metrics/rate.py")
    assert harness.reader_path(str(tmp_path), "rate.b").endswith("layer_metrics/rate.b.py")
    with pytest.raises(harness.CellError, match="other.a"):
        harness.load_module(harness.reader_path(str(tmp_path), "other.a"), "per-layer metric 'other.a'")
