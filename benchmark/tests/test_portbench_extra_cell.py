"""A cell made only of files (a configuration, a traffic mix, their
BENCHMARK.json entries) runs without an edit to the benchmark's code."""

import json
import os

from benchmark import harness
from benchmark.tests import toy


def test_a_cell_of_files_only_runs(toy_root, tmp_path):
    root = toy.make(str(tmp_path))
    bench = toy.load(os.path.join(root, "BENCHMARK.json"))
    cfg = toy.load(os.path.join(root, "benchmark", "configs", "random-s-100-euclidean-sq4.json"))
    toy.dump(os.path.join(root, "benchmark", "configs", "blobs-mips-sq4.json"),
             {**cfg, "similarity": "dot_product", "dataset": {**cfg["dataset"], "normalize": True},
              "serve": {**cfg["serve"], "beam": 64, "rerank_k": 64}})
    toy.dump(os.path.join(root, "benchmark", "traffic", "batch64.json"),
             {"kind": "batch_search", "wave": 64, "trace_after_waves": 0, "trace_waves": 1})
    bench["configs"].append({"name": "blobs-mips-sq4", "source": "a test", "file": "benchmark/configs/blobs-mips-sq4.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mips-batch", "config": "blobs-mips-sq4", "traffic": "batch64", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "euclidean-sq4-batch" in m.get("workloads", []):
            m["workloads"].append("mips-batch")
    toy.dump(os.path.join(root, "BENCHMARK.json"), bench)
    r = harness.run_cell("mips-batch", 9, 0.3, False, device="cpu", root=root,
                         bench_dir=os.path.join(root, "benchmark"))
    assert r["correct"] and set(r["metrics"]) == {"qps.sq4", "recall_at_10", "device_peak_gib", "setup_s"}
    assert json.dumps(r)
