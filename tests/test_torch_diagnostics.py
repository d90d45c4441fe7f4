"""The port's profiling and diagnostics hooks (``bench/diagnostics.py``)
on the CPU: the same report keys as the JAX package's, the section
timer's accounting, the disk delta, and a trace file from
``torch.profiler``.  ``chip_smoke.py``'s ``sharding`` phase reads them on
the card (peak memory per device, step seconds)."""

import json
import os
import time

import pytest

from jvector_tpu.bench import diagnostics as jdiag
from jvector_tpu_torch.bench import diagnostics as tdiag


def test_step_timer_accumulates_sections():
    timer = tdiag.StepTimer("cpu")
    for _ in range(2):
        with timer.section("a"):
            time.sleep(0.01)
    with pytest.raises(RuntimeError, match="inside"):
        with timer.section("b"):
            raise RuntimeError("inside")
    rep = timer.report()
    assert sorted(rep) == ["a", "b"] and rep["a"] >= 0.02 and rep["b"] >= 0.0
    jtimer = jdiag.StepTimer()
    with jtimer.section("a"):
        pass
    assert sorted(jtimer.report()) == ["a"]


def test_system_and_disk_monitors_match_jax_keys(tmp_path):
    with tdiag.SystemMonitor(interval_s=0.01) as mon:
        time.sleep(0.1)
    rep = mon.report()
    assert sorted(rep) == sorted(jdiag.SystemMonitor().report())
    assert 0.0 <= rep["cpu_avg"] <= rep["cpu_max"] <= 1.0 and rep["mem_min_available_mb"] > 0
    with tdiag.DiskUsageMonitor(tmp_path) as disk:
        (tmp_path / "a.bin").write_bytes(b"x" * 1000)
        os.makedirs(tmp_path / "sub")
        (tmp_path / "sub" / "b.bin").write_bytes(b"y" * 24)
    assert disk.delta_bytes() == 1024


def test_device_memory_stats_and_profile_trace(tmp_path):
    assert tdiag.device_memory_stats("cpu") == {}
    import torch

    with tdiag.profile_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
