"""The run fails, and prints no result, where a module of JAX or the JAX
package is loaded, without a card, or without the port beside it."""

import os
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness
from benchmark.tests import toy


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen", "jvector_tpu", "jvector_tpu.graph"])
def test_forbidden_top_level_names_are_found(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [name.split(".")[0]]


def test_the_port_is_not_the_jax_package(monkeypatch):
    import jvector_tpu_torch  # noqa: F401

    monkeypatch.setitem(sys.modules, "jvector_tpu_torchx", types.ModuleType("jvector_tpu_torchx"))
    assert harness.forbidden_modules() == []


def test_a_run_with_jax_loaded_fails(toy_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(RuntimeError, match="jax"):
        harness.run_cell("euclidean-sq4-batch", 1, 0.1, False, device="cpu", root=toy_root,
                         bench_dir=os.path.join(toy_root, "benchmark"))


def test_a_reader_that_imports_jax_fails_the_traced_run(tmp_path, monkeypatch):
    """The check comes after the per-layer readers are loaded: a reader that
    imports (a stub of) ``jax`` fails the traced run, and only that run."""
    root = toy.make(str(tmp_path))
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(stub))
    bench = toy.load(os.path.join(root, "BENCHMARK.json"))
    cell = bench["workloads"][0]["name"]
    bench["per_layer"].append({"name": "jax_probe", "unit": "count", "better": "lower", "source": "program_counter",
                               "layer": "device", "moves": "qps", "workloads": [cell]})
    toy.dump(os.path.join(root, "BENCHMARK.json"), bench)
    with open(os.path.join(root, "benchmark", "layer_metrics", "jax_probe.py"), "w") as f:
        f.write("import jax  # noqa: F401\n\n\ndef read(rec):\n    return 1.0\n")
    kw = dict(device="cpu", root=root, bench_dir=os.path.join(root, "benchmark"))
    try:
        assert harness.run_cell(cell, 3, 0.1, False, **kw)["correct"] is True
        with pytest.raises(RuntimeError, match="jax"):
            harness.run_cell(cell, 3, 0.1, True, **kw)
    finally:
        for name in [m for m in sys.modules if m.split(".")[0] == "jax"]:
            del sys.modules[name]  # the stub goes with the test


def test_no_result_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "euclidean-sq4-batch", "--seed", "1", "--seconds", "1"],
                       cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert p.returncode != 0 and p.stdout == "" and "CUDA" in p.stderr


def test_no_result_without_the_port(tmp_path):
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "euclidean-sq4-batch", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_the_benchmark_imports_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.harness, benchmark.readings, benchmark.corpus;"
            "import benchmark.reference.exact, jvector_tpu_torch;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'jvector_tpu'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and p.stdout.strip() == "[]"
