"""Accuracy and latency metrics (a numpy-only copy of
``jvector_tpu/bench/metrics.py``, so the port imports nothing of the JAX
package).

Reference: ``jvector-examples/.../util/AccuracyMetrics.java`` (recall@k, MAP)
and ``benchmarks/LatencyBenchmark`` / ``ThroughputBenchmark`` statistics
(AVG/MEDIAN/MAX throughput; AVG/STD/P999 latency).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def recall_at_k(result_ids: np.ndarray, ground_truth: np.ndarray, k: int) -> float:
    """Fraction of true top-k found in the returned top-k."""
    hits = 0
    for row, gt in zip(result_ids[:, :k], ground_truth[:, :k]):
        hits += len(set(int(x) for x in row if x >= 0) & set(int(x) for x in gt))
    return hits / (result_ids.shape[0] * k)


def mean_average_precision(
    result_ids: np.ndarray, ground_truth: np.ndarray, k: int
) -> float:
    """MAP@k (reference ``AccuracyMetrics`` MAP)."""
    ap_sum = 0.0
    for row, gt in zip(result_ids[:, :k], ground_truth[:, :k]):
        want = set(int(x) for x in gt)
        hits = 0
        precision_sum = 0.0
        for i, node in enumerate(row[:k]):
            if int(node) in want:
                hits += 1
                precision_sum += hits / (i + 1)
        ap_sum += precision_sum / min(k, len(want)) if want else 0.0
    return ap_sum / result_ids.shape[0]


@dataclasses.dataclass
class AccuracyMetrics:
    recall: float
    map: float

    @staticmethod
    def compute(result_ids: np.ndarray, ground_truth: np.ndarray, k: int):
        return AccuracyMetrics(
            recall=recall_at_k(result_ids, ground_truth, k),
            map=mean_average_precision(result_ids, ground_truth, k),
        )


@dataclasses.dataclass
class LatencyStats:
    """Per-wave latency statistics (reference LatencyBenchmark AVG/STD/P999)."""

    avg_ms: float
    std_ms: float
    p999_ms: float
    qps_avg: float
    qps_median: float
    qps_max: float

    @staticmethod
    def compute(wave_seconds: list[float], wave_sizes: list[int]) -> "LatencyStats":
        lat = np.asarray(wave_seconds) * 1e3
        qps = np.asarray(wave_sizes) / np.asarray(wave_seconds)
        return LatencyStats(
            avg_ms=float(lat.mean()),
            std_ms=float(lat.std()),
            p999_ms=float(np.percentile(lat, 99.9)),
            qps_avg=float(qps.mean()),
            qps_median=float(np.median(qps)),
            qps_max=float(qps.max()),
        )
