"""Benchmarks of the port.

- ``headline`` — the counterpart of the repository's ``bench.py``: the
  headline corpus (QPS at recall@10 >= 0.95 with margin), small-batch
  latency and the robustness corpora, one JSON line with ``bench.py``'s
  keys.  ``python -m jvector_tpu_torch.bench.headline``.
"""
