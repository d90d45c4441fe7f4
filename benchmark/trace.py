"""The benchmark's own spans and its reading of the device trace.

:class:`Spans` times the benchmark's calls into each layer of the port
(each build, each search wave, each quantizer's ``compute`` / ``encode``)
on the host clock and marks them in the profiler's timeline with
``record_function``.

:class:`Tracer` runs ``torch.profiler`` over a steady sub-window (CUDA
activity, the host's operations and the spans) and
reduces the profiler's raw events in memory, writing nothing to disk.  The
window is the host clock's ``time.time_ns()`` from the profiler's start to
the device's sync at its end, the clock the profiler stamps its events
with:

- ``busy_s``: the union of the device's kernels, copies and sets inside
  the window, ``window_s`` the window's length;
- ``device_ops``: device seconds by operation name;
- ``idle_gaps``: the seconds in which the device was idle, by what the
  host was doing then: the benchmark's innermost span at the gap's middle
  and the outermost host operation there (``python`` where none ran).

A window in which the profiler recorded no device activity keeps
``busy_s`` at None and says so on standard error; the idle share then
takes ``nvidia-smi``'s ``utilization.gpu``, sampled beside every traced
window (``nvml_util_pct``).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import subprocess
import sys
import threading
import time

import torch


class Spans:
    """Host-clock spans around the benchmark's calls; also marked in the
    profiler's timeline."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds: dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        with torch.profiler.record_function(f"bench:{name}"):
            yield
            self.sync()
        self.seconds[name] += time.perf_counter() - t


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float | None  # None: the profiler recorded no device activity
    device_ops: dict  # name -> device seconds
    idle_gaps: dict  # "span: host op" -> idle seconds
    nvml_util_pct: float | None = None


class _NvmlSampler:
    """``nvidia-smi``'s ``utilization.gpu`` sampled every 100 ms beside a
    window, in one child process that is stopped and waited for."""

    def __init__(self, index: int):
        self.values: list[float] = []
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--id={index}", "--query-gpu=utilization.gpu", "--format=csv,noheader,nounits",
                 "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
            return
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.values.append(float(line.strip()))
            except ValueError:
                pass

    def stop(self) -> float | None:
        if self.proc is None:
            return None
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.thread.join(timeout=10)
        return sum(self.values) / len(self.values) if self.values else None


DEVICE_ACTIVITY = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_ACTIVITY = frozenset({"cpu_op", "cuda_runtime", "cuda_driver"})


def _union(intervals, lo, hi):
    """Merged ``[start, end)`` intervals clipped to ``[lo, hi]``."""
    out = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(intervals):
    """The outermost of possibly nested ``(start, end, name)`` intervals."""
    out = []
    for s, e, name in sorted(intervals, key=lambda t: (t[0], -t[1])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _innermost_at(spans, t, default):
    """Name of the shortest span holding ``t`` (spans: (start, end, name))."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else default


def _classify(e) -> str:
    """``device`` (a kernel, copy or set), ``span`` (the benchmark's),
    ``host`` (a host operation or runtime call) or ``other``.  Where the
    profiler's events carry no activity type, device-side events are told
    by their device and the mirrors of ``record_function`` ranges by name."""
    name = e.name()
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        if kind in DEVICE_ACTIVITY:
            return "device"
        if kind == "user_annotation":
            return "span" if name.startswith("bench:") else "other"
        return "host" if kind in HOST_ACTIVITY else "other"
    annotation = name.startswith("bench:") or (hasattr(e, "is_user_annotation") and e.is_user_annotation())
    if e.device_type() != torch.autograd.DeviceType.CPU:
        return "other" if annotation else "device"
    if annotation:
        return "span" if name.startswith("bench:") else "other"
    return "host"


def _interval(e) -> tuple[int, int]:
    """An event's ``(start, end)`` in ns (older profilers carry no ``end_ns``)."""
    start = e.start_ns()
    return start, (e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns())


def summarize(events, lo: int, hi: int, tag: str) -> TraceSummary:
    """Reduce the profiler's raw events (``kineto_results.events()``) of one
    window ``[lo, hi]`` (ns, the profiler's clock: ``time.time_ns()``)."""
    dev, spans, host = [], [], []
    for e in events:
        kind = _classify(e)
        if kind == "other":
            continue
        iv = (*_interval(e), e.name())
        if kind == "device":
            dev.append(iv)
        elif kind == "span":
            spans.append((iv[0], iv[1], iv[2][len("bench:"):]))
        else:
            host.append(iv)
    merged = _union([(s, t) for s, t, _ in dev], lo, hi)
    ops = collections.Counter()
    for s, t, name in dev:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            ops[name] += (t - s) / 1e9
    if not merged:
        print(f"trace: the profiler recorded no device activity in the {tag} window", file=sys.stderr)
        return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=None, device_ops={}, idle_gaps={})
    host = _outermost(host)
    starts = [s for s, _, _ in host]
    gaps = collections.Counter()
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = _innermost_at(spans, mid, tag)
        if host:
            i = bisect.bisect_right(starts, mid) - 1
            name += ": " + (host[i][2] if i >= 0 and host[i][1] > mid else "python")
        gaps[name] += (b - a) / 1e9
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=sum(e - s for s, e in merged) / 1e9,
                        device_ops=dict(ops), idle_gaps=dict(gaps))


def busy_seconds(s: TraceSummary) -> float | None:
    """Device-busy seconds of a window: the profiler's, else NVML's sampled
    utilization times the window, else None."""
    if s.busy_s is not None:
        return s.busy_s
    if s.nvml_util_pct is not None:
        return s.window_s * s.nvml_util_pct / 100.0
    return None


class Tracer:
    """``torch.profiler`` over one sub-window at a time (``start`` /
    ``stop``, then ``reduce`` once the measured window has closed);
    :meth:`warm` runs it once in set-up.  It records the host's
    operations and the benchmark's spans beside the device's activity."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self):
        with torch.profiler.profile(activities=self._activities()):
            x = torch.ones(1024, device=self.device)
            (x * 2).sum().item()

    def start(self, tag: str):
        self._tag = tag
        self._nvml = _NvmlSampler(self.device.index or 0) if self.device.type == "cuda" else None
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.__enter__()
        self._lo = time.time_ns()

    def stop(self, sync):
        sync()
        self._hi = time.time_ns()
        t = time.perf_counter()
        self._prof.__exit__(None, None, None)
        self._stop_s = time.perf_counter() - t
        self._nvml_pct = self._nvml.stop() if self._nvml is not None else None

    def reduce(self) -> TraceSummary:
        """Summarize the last window (after the measured window has closed)."""
        t = time.perf_counter()
        events = self._prof.profiler.kineto_results.events()
        s = summarize(events, self._lo, self._hi, self._tag)
        s.nvml_util_pct = self._nvml_pct
        print(f"trace {self._tag}: {len(events)} events, profiler stop {self._stop_s:.2f} s, "
              f"reduced in {time.perf_counter() - t:.2f} s", file=sys.stderr)
        self._prof = None
        return s
