"""The port's micro-benchmark entry point against the JAX package's.

``jvector_tpu_torch.bench.micro.run_micro`` on the CPU (the kernels'
plain twins, so its numbers are not device numbers) must yield the JAX
``micro.py``'s rows by name, in its order, with finite positive values,
and each row's provenance must name the device and carry no JAX key.
"""

import ast
import inspect
import math

import pytest
import torch

from jvector_tpu.bench import micro as jmicro
from jvector_tpu_torch.bench import diagnostics, micro


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_benchmark_names() -> list[str]:
    """The names ``run_micro`` of the JAX package emits, in order (read from
    its source: running it would build a graph in JAX)."""
    tree = ast.parse(inspect.getsource(jmicro.run_micro))
    return [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "emit"]


def test_run_micro_rows_match_jax_names():
    names = _jax_benchmark_names()
    assert len(names) == 8
    rows = micro.run_micro(n=768, dim=32, q=64, reps=1, device="cpu")
    assert [r["benchmark"] for r in rows] == names
    for r in rows:
        assert math.isfinite(r["seconds"]) and r["seconds"] > 0, r
        assert math.isfinite(r["value"]) and r["value"] > 0, r
        assert r["device"] == "cpu" and r["unit"].endswith("/s")
        assert {"git_sha", "timestamp"} <= set(r)


def test_run_metadata_names_device_and_no_jax():
    meta = diagnostics.run_metadata({"n": 1}, "cpu")
    assert meta["device"] == "cpu" and meta["backend"] == "cpu"
    assert meta["torch_version"] == torch.__version__ and len(meta["config_hash"]) == 12
    assert not any("jax" in k for k in meta)
    assert "config_hash" not in diagnostics.run_metadata(device="cpu")


def test_compact_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        micro.main(["--compact", "--device", "cpu"])
