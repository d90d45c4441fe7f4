"""Profiling and diagnostics hooks (counterpart of
``jvector_tpu/bench/diagnostics.py``; reference
``benchmarks/diagnostics/`` SystemMonitor / PerformanceAnalyzer,
``reporting/JfrRecorder``, ``GitInfo`` / ``SysInfoWriter``).

- :func:`profile_trace`: a ``torch.profiler`` trace around a block;
- :func:`device_memory_stats`: a card's allocator bytes in use and peak;
- :class:`StepTimer`: section seconds, the device synced at both ends;
- :class:`SystemMonitor` / :class:`DiskUsageMonitor`: host CPU and memory,
  and the disk bytes a run added under a path (stdlib only);
- :func:`run_metadata`: run provenance for benchmark rows.

Every row a benchmark emits carries the git sha, the device it ran on and
the library versions, so a number can be traced to the code, machine and
parameters that produced it.  On a CUDA device, ``device`` is the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import platform
import subprocess
import tempfile
import threading
import time

import torch

from jvector_tpu_torch.util.device import resolve_device

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_label(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if dev.type != "cuda":
        return str(dev)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0] if len(out) == 1 else out[dev.index or 0]


def _git(*args: str) -> str:
    try:
        return subprocess.run(["git", *args], capture_output=True, timeout=5, cwd=_ROOT).stdout.decode().strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run_metadata(config: dict | None = None, device: torch.device | str = "cuda") -> dict:
    """Git sha and dirty flag, the device, torch and CUDA versions, host
    info and, with ``config``, a hash of it."""
    dev = torch.device(device)
    meta = {
        "git_sha": _git("rev-parse", "HEAD")[:12],
        "git_dirty": bool(_git("status", "--porcelain")),
        "device": device_label(dev),
        "backend": dev.type,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "hostname": platform.node(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if config is not None:
        blob = json.dumps(config, sort_keys=True, default=str).encode()
        meta["config_hash"] = hashlib.sha256(blob).hexdigest()[:12]
    return meta


@contextlib.contextmanager
def profile_trace(log_dir: str | None = None):
    """A ``torch.profiler`` trace (host and, with a card, device activity)
    around a block, written as a Chrome trace ``trace.json`` under
    ``log_dir`` (default: a folder in the temporary directory); yields the
    folder."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "jvtpu_torch_profile")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats(device: torch.device | str | None = None) -> dict:
    """The caching allocator's bytes in use and peak on a card, and the
    card's memory (SystemMonitor's max_heap analog); empty on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    ms = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": ms.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": ms.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


class StepTimer:
    """Section seconds on the host clock (PerformanceAnalyzer-lite); on a
    card the device is synced at both ends of a section, so its queued
    work counts where it was issued."""

    def __init__(self, device: torch.device | str | None = None):
        self.device = torch.device(device) if device is not None else None
        self.sections: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def section(self, name: str):
        self._sync()
        t0 = time.time()
        try:
            yield
        finally:
            self._sync()
            self.sections[name] = self.sections.get(name, 0.0) + time.time() - t0

    def report(self) -> dict[str, float]:
        return dict(self.sections)


class SystemMonitor:
    """Background host CPU and memory sampler (reference ``SystemMonitor``):
    samples ``/proc/stat`` and ``/proc/meminfo`` on a thread; ``report()``
    gives the mean and peak CPU utilisation and the least available
    memory over the run."""

    def __init__(self, interval_s: float = 1.0):
        self.interval_s = interval_s
        self._samples: list[tuple[float, int]] = []  # (cpu utilisation, available kB)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    @staticmethod
    def _cpu_times() -> tuple[int, int]:
        with open("/proc/stat") as f:
            vals = [int(x) for x in f.readline().split()[1:]]
        return vals[3] + (vals[4] if len(vals) > 4 else 0), sum(vals)

    @staticmethod
    def _mem_available_kb() -> int:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1])
        return 0

    def _loop(self) -> None:
        prev_idle, prev_total = self._cpu_times()
        while not self._stop.wait(self.interval_s):
            idle, total = self._cpu_times()
            util = 1.0 - (idle - prev_idle) / max(total - prev_total, 1)
            prev_idle, prev_total = idle, total
            self._samples.append((util, self._mem_available_kb()))

    def __enter__(self) -> "SystemMonitor":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=2 * self.interval_s + 1)

    def report(self) -> dict:
        if not self._samples:
            return {"cpu_avg": 0.0, "cpu_max": 0.0, "mem_min_available_mb": 0.0}
        cpus = [c for c, _ in self._samples]
        return {
            "cpu_avg": sum(cpus) / len(cpus),
            "cpu_max": max(cpus),
            "mem_min_available_mb": min(m for _, m in self._samples) / 1024,
        }


class DiskUsageMonitor:
    """Bytes added under a path across a run (reference
    ``DiskUsageMonitor``)."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._start = 0

    @staticmethod
    def _usage(path: str) -> int:
        total = 0
        for root, _, files in os.walk(path):
            for f in files:
                try:
                    total += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass  # removed while walking
        return total

    def __enter__(self) -> "DiskUsageMonitor":
        self._start = self._usage(self.path)
        return self

    def __exit__(self, *exc) -> None:
        pass

    def delta_bytes(self) -> int:
        return self._usage(self.path) - self._start
