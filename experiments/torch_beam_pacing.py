"""The beam loop's pacing in a benchmark cell, with and without a profiler,
from the port's own spans (``jvector_tpu_torch.tracing``).

    python experiments/torch_beam_pacing.py [--cells angular-bq-batch ...]
        [--waves 4] [--rounds 4] [--seed 7] [--root DIR] [--device cuda]

For each cell it sets up what ``benchmark/run.py`` sets up (the dataset,
the index, the cell's serve and a warm-up wave; the first ``wave`` queries
in the seed's order) and then prints one JSON line a step below:

- ``before``: ``--waves`` waves with no profiler yet run in the process,
  each read from ``tracing.last_request()``: the wave's seconds, its
  steps, the mean host time to issue a step (``step_issue_us``) and the
  share of the wave blocked at the stop test (``stop_wait_pct``), the
  readings of the benchmark's readers;
- ``after-warm``: as many again after a profile of a few operations,
  dropped at once (what ``benchmark/trace.py``'s ``Tracer.warm`` runs in
  set-up);
- ``on-cost``: ``--rounds`` rounds of two waves under the benchmark's
  profiler (CPU and CUDA activity): with the port's spans and counters
  (``port``), with ``searcher.tracing`` replaced by a stub that records
  nothing (``stub``: the program as it was without them), and with the
  spans' ``record_function`` ranges left out (``no-ranges``), the order
  rotating by round; each gives the window's seconds (profiler start
  to the device's sync) and the seconds the garbage collector ran in it,
  and the other two their ``step_issue_us`` and ``stop_wait_pct`` under the
  profiler; each profile is dropped and collected after its round, outside
  the windows, but the last;
- ``held``: waves while the last such profile is still referenced (as
  the benchmark's window holds its profile until it reduces it);
- ``after``: waves once it is dropped and collected.

On the card it ends with the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import corpus, harness  # noqa: E402
from jvector_tpu_torch import build_graph, tracing  # noqa: E402
from jvector_tpu_torch.graph import searcher  # noqa: E402


class _Stub:
    """``tracing`` as the searcher saw it before it had spans: nothing."""

    @staticmethod
    def span(name):
        return contextlib.nullcontext()

    @staticmethod
    def add(name, n):
        pass


def _pacing(spans) -> dict:
    """A request's (or a window's) steps, host issue a step and stop wait."""
    d: dict[str, list] = {}
    for s in spans:
        d.setdefault(s.name, []).append((s.end_ns - s.start_ns) / 1e9)
    search, steps, stops = sum(d.get("search", [])), d.get("beam.step", []), d.get("beam.stop_test", [])
    return {"searches": len(d.get("search", [])), "steps": len(steps),
            "step_issue_us": 1e6 * sum(steps) / len(steps) if steps else None,
            "stop_wait_pct": 100 * sum(stops) / search if search else None}


class _NoRange:
    """``record_function`` that opens nothing: the port's spans with their
    stamps but without their ranges in the profiler's timeline."""

    def __init__(self, name):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _GcClock:
    """Seconds the cyclic garbage collector ran since the last ``take()``."""

    def __init__(self):
        self.total, self._t = 0.0, 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.total += time.perf_counter() - self._t

    def take(self) -> float:
        t, self.total = self.total, 0.0
        return t


VARIANTS = ("stub", "port", "no-ranges")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=["angular-bq-batch", "euclidean-sq4-batch"])
    ap.add_argument("--waves", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--root", default=harness.ROOT, help="where BENCHMARK.json is")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    acts = [torch.profiler.ProfilerActivity.CPU] + [torch.profiler.ProfilerActivity.CUDA] * (dev.type == "cuda")
    gc_clock = _GcClock()
    record_function = torch.profiler.record_function
    for name in args.cells:
        cell = harness.load_cell(name, args.root)
        ctx = harness.RunContext(cell, args.seed, 1.0, False, dev, time.time(), False)
        data = corpus.make(cell.config, dev)
        graph, exact = build_graph(data.base, cell.config["similarity"], ctx.graph_config())
        serve = ctx.serve_fn(graph, exact, data.base)
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed)
        q = data.queries[torch.randperm(data.queries.shape[0], generator=g, device=dev)][: cell.traffic["wave"]]
        serve(q).ids.cpu()

        def unprofiled(phase):
            for wave in range(args.waves):
                sync()
                t = time.perf_counter()
                serve(q).ids.cpu()
                row = {"cell": name, "phase": phase, "wave": wave, "wave_s": time.perf_counter() - t}
                print(json.dumps(row | _pacing(tracing.last_request().spans)), flush=True)

        unprofiled("before")
        with torch.profiler.profile(activities=acts):
            (torch.ones(1024, device=dev) * 2).sum().item()
        unprofiled("after-warm")
        for r in range(args.rounds):
            order = VARIANTS[r % 3:] + VARIANTS[:r % 3]
            for variant in order:
                searcher.tracing = _Stub if variant == "stub" else tracing
                torch.profiler.record_function = _NoRange if variant == "no-ranges" else record_function
                t0 = time.time_ns()  # a window may run on from the round before
                try:
                    with torch.profiler.profile(activities=acts) as prof:
                        sync()
                        gc_clock.take()
                        t = time.perf_counter()
                        for _ in range(2):
                            serve(q).ids.cpu()
                        sync()
                        window_s, gc_s = time.perf_counter() - t, gc_clock.take()
                finally:
                    searcher.tracing = tracing
                    torch.profiler.record_function = record_function
                row = {"cell": name, "phase": "on-cost", "round": r, "variant": variant, "window_s": window_s,
                       "gc_s": gc_s}
                if variant != "stub":
                    row |= _pacing([s for s in tracing.last_window().spans if s.start_ns >= t0])
                print(json.dumps(row), flush=True)
                if (r, variant) != (args.rounds - 1, order[-1]):
                    del prof  # its parsed events, collected outside the windows
                    gc.collect()
        unprofiled("held")
        del prof
        gc.collect()
        unprofiled("after")
        del serve, graph, exact, data
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
