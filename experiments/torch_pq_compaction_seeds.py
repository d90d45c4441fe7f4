"""The port's 20k PQ-sidecar compaction (``chip_smoke.py``'s lifecycle step
7) with the retrain's k-means drawn from seeds 0..K-1, on the card.

    python experiments/torch_pq_compaction_seeds.py [--seeds 8]

``compact_indexes(pq=...)`` retrains with ``ProductQuantization.compute``'s
default seed; here each run sets it to one of 0..K-1 (the base PQ, whose
codebooks the retrain replaces, takes the same seed).  One JSON line a
seed (recall@10 with exact rerank at beams 50 and 100, seconds, K5
launches), then the mean and range a beam: the port's spread over its own
draws, beside ``experiments/torch_lifecycle_cpu.py --seeds K``'s for the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import jvector_tpu_torch.quantization.pq as tpq  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, default=8)
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cs.phase_env()
    cs.phase_build()
    compute = tpq.ProductQuantization.compute
    recalls = {}
    for seed in range(args.seeds):
        tpq.ProductQuantization.compute = staticmethod(lambda *a, _s=seed, **k: compute(*a, **{**k, "seed": _s}))
        try:
            t = time.time()
            r = cs._lifecycle_pq_compaction(dev)
        finally:
            tpq.ProductQuantization.compute = staticmethod(compute)
        recalls[seed] = r["recall"]
        print(json.dumps({"seed": seed, "recall": r["recall"], "seconds": time.time() - t,
                          "k5_launches": r["launches"]["adc_score_kernel"]}), flush=True)
    for b in (50, 100):
        v = [recalls[s][b] for s in recalls]
        print(json.dumps({"beam": b, "mean": float(np.mean(v)), "min": min(v), "max": max(v)}), flush=True)


if __name__ == "__main__":
    main()
