"""Benchmarks of the port.

- ``headline`` — the counterpart of the repository's ``bench.py``: the
  headline corpus (QPS at recall@10 >= 0.95 with margin), small-batch
  latency and the robustness corpora, one JSON line with ``bench.py``'s
  keys.  ``python -m jvector_tpu_torch.bench.headline``.
- ``micro`` — the counterpart of ``jvector_tpu/bench/micro.py``: one JSON
  row per hot primitive (exact block scoring, PQ train/encode, the K5 and
  K6 ADC kernels, SQ4 encode, the build, fused edge scoring, a search
  wave).  ``python -m jvector_tpu_torch.bench.micro``.
- ``grid`` — the counterpart of ``jvector_tpu/bench/grid.py``: the YAML
  grid (``GridConfig``, ``Grid``, ``run_yaml``) over construction and
  search compression (PQ, BQ, SQ4, FUSED_PQ), reranking (FP32, NVQ) and
  topK x overquery, with the trained-compressor cache.
- ``metrics`` — recall@k, MAP and latency statistics (numpy).
- ``diagnostics`` — ``run_metadata``, the provenance every row carries;
  ``profile_trace``, ``device_memory_stats``, ``StepTimer``,
  ``SystemMonitor`` and ``DiskUsageMonitor``.
- ``ipc`` — the counterpart of ``jvector_tpu/bench/ipc.py``: the text
  protocol over a Unix socket (``IPCService``, ``IPCClient``).
- ``__main__`` — the bench CLI, ``python -m jvector_tpu_torch.bench
  [patterns] --config ... --catalog ... --output ... [--device cpu]``:
  catalog-selected datasets x YAML configs through ``run_yaml``.
"""

from jvector_tpu_torch.bench.grid import Grid, GridConfig, run_yaml
from jvector_tpu_torch.bench.metrics import AccuracyMetrics, LatencyStats, mean_average_precision, recall_at_k

__all__ = [
    "AccuracyMetrics",
    "LatencyStats",
    "recall_at_k",
    "mean_average_precision",
    "Grid",
    "GridConfig",
    "run_yaml",
]
