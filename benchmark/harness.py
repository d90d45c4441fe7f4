"""Run one benchmark cell and build its result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by its name in ``BENCHMARK.json``:

- a configuration: the JSON file that its entry names (sizes, corpus model,
  graph and serve parameters, the limits of its checks, its ``index``);
- its index: ``indexes/<index>.py`` (``prepare`` and ``control``);
- a traffic mix: ``traffic/<name>.json``, whose ``kind`` names the code
  that drives it, ``traffic/<kind>.py`` (``run(ctx) -> Record``);
- a per-layer metric: ``layer_metrics/<name>.py`` (``read(record)``, None
  where it finds nothing to read).

A metric named ``<quantity>.<part>`` is that quantity split by cells (each
part its own bound or its own ``moves``): where no file or value has the
whole name, it takes the quantity's (``layer_metrics/<quantity>.py``, the
traffic kind's ``<quantity>``).

A name that is not there fails with the name.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import sys
import time

import torch

from benchmark import judge
from benchmark.trace import Spans, Tracer, busy_seconds

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "jvector_tpu"})
GIB = 2**30
NAME_CHARS = 160  # a breakdown entry's name: demangled kernel names run to a kilobyte


class CellError(ValueError):
    """A name in ``BENCHMARK.json`` that has no file, or a malformed entry."""


def _load_json(path: str, what: str) -> dict:
    if not os.path.isfile(path):
        raise CellError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


_modules: dict[str, object] = {}


def load_module(path: str, what: str):
    """Import the file at ``path`` (once per process)."""
    if path in _modules:
        return _modules[path]
    if not os.path.isfile(path):
        raise CellError(f"{what}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{len(_modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _modules[path] = mod
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    bench_dir: str

    def index_module(self):
        return load_module(os.path.join(self.bench_dir, "indexes", f"{self.config['index']}.py"),
                           f"index {self.config['index']!r} of configuration {self.config['name']!r}")

    def kind_module(self):
        return load_module(os.path.join(self.bench_dir, "traffic", f"{self.traffic['kind']}.py"),
                           f"traffic kind {self.traffic['kind']!r}")


def _reports(metric: dict, cell: str, e2e_names: set | None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list,
    else every cell (an end-to-end metric, ``e2e_names`` None) or every
    cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(workload: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"), "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"unknown workload {workload!r} (BENCHMARK.json has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise CellError(f"workload {workload!r}: unknown config {w['config']!r}")
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]), f"config {w['config']!r}")
    config["name"] = w["config"]
    traffic = _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"), f"traffic {w['traffic']!r}")
    traffic["name"] = w["traffic"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, None)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, names)]
    return Cell(name=workload, chips=w["chips"], config=config, traffic=traffic, end_to_end=e2e, per_layer=layer,
                bench_dir=bench_dir)


@dataclasses.dataclass
class Record:
    """What a traffic kind hands back: end-to-end values by name, the
    numbers compared, counters and trace summaries for the per-layer
    readers, and the device's peak."""

    end_to_end: dict
    numbers: dict
    attempted: int
    failed: int
    memory_peak_bytes: int
    counters: dict = dataclasses.field(default_factory=dict)
    traces: dict = dataclasses.field(default_factory=dict)
    waves: list = dataclasses.field(default_factory=list)  # (offset into the window, seconds) of each wave


class RunContext:
    """What a traffic kind gets: the cell, the run's arguments, the device,
    the spans, the tracer (traced runs) and the peak-memory bookkeeping."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float,
                 control: bool):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds, self.trace, self.device, self.t0 = seed, seconds, trace, device, t0
        self.control = control
        self.spans = Spans(self.sync)
        self.tracer = Tracer(device) if trace else None
        self._peak = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def graph_config(self):
        from jvector_tpu_torch import GraphConfig

        return GraphConfig(**self.config["graph"])

    def serve_fn(self, graph, exact, base):
        """The configuration's search (or its control) over a built graph."""
        index = self.cell.index_module()
        return (index.control if self.control else index.prepare)(graph, exact, base, self.config, self.spans)

    def reset_peak(self) -> None:
        """Fold the peak so far into the process's and start a new one."""
        self._peak = max(self._peak, self.peak())
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def process_peak(self) -> int:
        return max(self._peak, self.peak())

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reader_path(bench_dir: str, name: str) -> str:
    """The reader of per-layer metric ``name``: ``layer_metrics/<name>.py``,
    else that of the quantity before its first dot."""
    path = os.path.join(bench_dir, "layer_metrics", f"{name}.py")
    quantity = os.path.join(bench_dir, "layer_metrics", f"{name.split('.')[0]}.py")
    return path if os.path.isfile(path) or not os.path.isfile(quantity) else quantity


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its kin's or the JAX
    package's (compared whole: ``jvector_tpu_torch`` is not ``jvector_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def wave_line(waves: list) -> str:
    """The window's wave times on one line: their count, p10, quartiles,
    p90, and the slowest with its offset into the window (seconds)."""
    if not waves:
        return "waves (s): none"
    times = [t for _, t in waves] * (1 if len(waves) > 1 else 2)  # quantiles need two points
    deciles, quartiles = statistics.quantiles(times, n=10), statistics.quantiles(times, n=4)
    offset, slowest = max(waves, key=lambda w: w[1])
    end = waves[-1][0] + waves[-1][1]
    return (f"waves (s): n {len(waves)}, p10 {deciles[0]:.6f}, q1 {quartiles[0]:.6f}, median {quartiles[1]:.6f}, "
            f"q3 {quartiles[2]:.6f}, p90 {deciles[8]:.6f}, slowest {slowest:.6f} at {offset:.3f} of {end:.3f}")


def _num(x):
    return x if isinstance(x, int) or math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", root: str = ROOT,
             bench_dir: str = BENCH_DIR, t0: float | None = None, control: bool = False) -> dict:
    """Run one cell and return its result line (a dict).  ``device='cpu'``
    and ``control`` are for tests and readings, never for a measurement;
    ``run.py`` refuses to run without a card."""
    t0 = time.time() if t0 is None else t0
    cell = load_cell(workload, root, bench_dir)
    dev = torch.device(device)
    ctx = RunContext(cell, seed, seconds, trace, dev, t0, control)
    rec = cell.kind_module().run(ctx)
    print(f"spans (s): {json.dumps(dict(ctx.spans.seconds))}", file=sys.stderr)
    print(wave_line(rec.waves), file=sys.stderr)
    chk = judge.checks(rec.numbers, cell.config["checks"])
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = load_module(reader_path(bench_dir, m["name"]), f"per-layer metric {m['name']!r}")
            value = reader.read(rec)
            if value is None:
                print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            key = m["name"] if m["name"] in rec.end_to_end else m["name"].split(".")[0]
            if key not in rec.end_to_end:
                raise RuntimeError(f"traffic kind {cell.traffic['kind']!r} gave no {m['name']!r}")
            metrics[m["name"]] = {"value": rec.end_to_end[key], "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": judge.passed(chk) and rec.failed == 0, "attempted": rec.attempted, "failed": rec.failed,
              "metrics": metrics, "device": device_info}
    if trace:
        summaries = list(rec.traces.values())
        device_info["window_s"] = sum(s.window_s for s in summaries)
        busy = [busy_seconds(s) for s in summaries]
        if all(b is not None for b in busy):
            device_info["busy_s"] = sum(busy)
        ops, gaps = {}, {}
        for s in summaries:
            for k, v in s.device_ops.items():
                ops[k] = ops.get(k, 0.0) + v
            for k, v in s.idle_gaps.items():
                gaps[k] = gaps.get(k, 0.0) + v
        result["breakdown"] = {
            "device_ops": sorted(([k[:NAME_CHARS], v] for k, v in ops.items()), key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k[:NAME_CHARS], v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:10],
        }
    result["checks"] = {k: {kk: _num(vv) for kk, vv in c.items()} for k, c in chk.items()}
    # last, once every reader is loaded: nothing of the run may have loaded JAX
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {found}")
    return result


def emit(result: dict) -> None:
    """Each number compared beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        lim = f">= {c['min']}" if "min" in c else f"<= {c['max']}"
        print(f"check {name}: {c['value']} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
