"""Benchmarks of the port.

- ``headline`` — the counterpart of the repository's ``bench.py``: the
  headline corpus (QPS at recall@10 >= 0.95 with margin), small-batch
  latency and the robustness corpora, one JSON line with ``bench.py``'s
  keys.  ``python -m jvector_tpu_torch.bench.headline``.
- ``micro`` — the counterpart of ``jvector_tpu/bench/micro.py``: one JSON
  row per hot primitive (exact block scoring, PQ train/encode, the K5 and
  K6 ADC kernels, SQ4 encode, the build, fused edge scoring, a search
  wave).  ``python -m jvector_tpu_torch.bench.micro``.
- ``diagnostics`` — ``run_metadata``, the provenance every row carries.
"""
