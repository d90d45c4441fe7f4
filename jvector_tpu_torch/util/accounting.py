"""Memory accounting (counterpart of ``jvector_tpu/util/accounting.py``;
reference ``Accountable`` / ``RamUsageEstimator``).

Every structure reports the bytes of the tensors it holds: the sum over
its tensors of ``numel() * element_size()`` and over its numpy arrays of
``nbytes``, found by walking dataclasses, NamedTuples, dicts, lists and
tuples (where the JAX package walks a pytree's leaves).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def bytes_used(obj) -> int:
    """Total bytes of every tensor and numpy array that ``obj`` holds."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (np.ndarray, np.generic)):
        return int(obj.nbytes)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return sum(bytes_used(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    if isinstance(obj, dict):
        return sum(bytes_used(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):  # NamedTuples too
        return sum(bytes_used(v) for v in obj)
    return 0


def format_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}TB"


def graph_ram_report(graph, providers: dict | None = None) -> dict:
    """``Accountable``-style breakdown of an index and its score providers:
    ``graph_bytes``, ``layer{l}_bytes``, ``{name}_bytes`` per provider and
    ``total_bytes`` (the graph's plus the providers')."""
    report = {"graph_bytes": bytes_used(graph)}
    for level, layer in enumerate(graph.layers):
        report[f"layer{level}_bytes"] = bytes_used(layer)
    for name, p in (providers or {}).items():
        report[f"{name}_bytes"] = bytes_used(p)
    report["total_bytes"] = report["graph_bytes"] + sum(
        v for k, v in report.items() if k.endswith("_bytes") and not k.startswith(("graph", "layer", "total"))
    )
    return report
