"""A toy copy of the benchmark for the tests: the benchmark's own files
copied into a temporary root, with the cells' datasets and traffic cut to
sizes the CPU runs in seconds (every parameter but the sizes kept)."""

from __future__ import annotations

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# the width kept; 1,280 points around 16 centers, 256 of them held out
TOY_DATASET = {"n_samples": 1280, "centers": 16, "test_size": 256}
TOY_SIZES = {"n": 1024, "queries": 256}
TOY_WAVE = 256  # build waves
TOY_TRAFFIC = {"batch10k": {"wave": 128}}


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def dump(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(tmp: str) -> str:
    """A toy root under ``tmp``; returns its path."""
    root = os.path.join(tmp, "toy")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"), ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = load(os.path.join(ROOT, "BENCHMARK.json"))
    for c in bench["configs"]:
        path = os.path.join(root, c["file"])
        cfg = load(path)
        dump(path, {**cfg, **TOY_SIZES, "dataset": {**cfg["dataset"], **TOY_DATASET},
                    "graph": {**cfg["graph"], "wave_size": TOY_WAVE}})
    for name, sizes in TOY_TRAFFIC.items():
        path = os.path.join(root, "benchmark", "traffic", f"{name}.json")
        dump(path, {**load(path), **sizes})
    dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root
