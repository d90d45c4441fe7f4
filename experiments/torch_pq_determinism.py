"""Is a PQ path's run-to-run spread the kernel's or the training's?  On the card.

    python experiments/torch_pq_determinism.py

Trains ``ProductQuantization.compute`` twice from the same seed on the
same data (the default configuration's PQ, m = 16 on 128-d, and BASELINE
config 3's anisotropic PQ, m = 24 on 96-d; 131,072 rows of
``synthetic_dataset``), and runs K5 twice on the same tables and codes.
One JSON line each: whether the two results are equal bit for bit and
their largest difference.  The k-means updates sum each cluster's rows in
a fixed order (``quantization.kmeans._segment_sum``); with the float32
atomics of ``scatter_add_`` / ``index_add_`` they used before, two
trainings came out 0.0019 (m = 16) and 0.0048 (config 3) apart.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jvector_tpu_torch.ops.adc import build_partial_sums  # noqa: E402
from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel  # noqa: E402
from jvector_tpu_torch.quantization import ProductQuantization  # noqa: E402
from jvector_tpu_torch.util.datasets import synthetic_dataset  # noqa: E402


def same(a: torch.Tensor, b: torch.Tensor) -> dict:
    return {"bit_equal": bool(torch.equal(a, b)), "max_abs_diff": float((a.float() - b.float()).abs().max())}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    for name, dim, m, threshold in (("default_config_pq", 128, 16, None), ("config3_anisotropic_pq", 96, 24, 0.2)):
        ds = synthetic_dataset(n=131_072, dim=dim, n_queries=1024, k=10, n_clusters=262, seed=0, device=dev)
        base = torch.as_tensor(ds.base, device=dev)
        kw = {} if threshold is None else {"anisotropic_threshold": threshold}
        books = [ProductQuantization.compute(base, m=m, clusters=256, globally_center=False, **kw).codebooks
                 for _ in range(2)]
        print(json.dumps({"what": f"{name} codebooks, trained twice", **same(*books)}), flush=True)
        pq = ProductQuantization.compute(base, m=m, clusters=256, globally_center=False, **kw)
        luts = build_partial_sums(torch.as_tensor(ds.queries, device=dev), pq.codebooks, "euclidean")
        codes = pq.encode(base)[torch.randint(0, base.shape[0], (1024 * 64,), device=dev)].reshape(1024, 64, m)
        print(json.dumps({"what": f"K5 on {name}'s tables, run twice",
                          **same(adc_score_kernel(luts, codes), adc_score_kernel(luts, codes))}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
