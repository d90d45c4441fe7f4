"""PQ codebook quality of the port's k-means against the JAX package's, on
the CPU, over several training seeds.

    JAX_PLATFORMS=cpu python experiments/torch_pq_training_cpu.py [--n 20000] [--seeds 14]

Trains PQ M=16, K=256, uncentered (the default configuration's) on
``synthetic_dataset(n, dim=128, n_clusters=64, seed=0)`` with training
seeds 0..seeds-1 in both packages and prints one JSON line per seed with
both ``reconstruction_error``s and their ratio (port / JAX), then a
summary line: the ratio's mean, least and largest value and how many
seeds fall above and below 1.  The two packages draw k-means++ from
different generators (``torch.Generator`` against ``jax.random``), so a
seed gives each a different codebook; a systematic gap in quality would
show as ratios on one side of 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from jvector_tpu.quantization import ProductQuantization  # noqa: E402
from jvector_tpu.util.datasets import synthetic_dataset  # noqa: E402
from jvector_tpu_torch.quantization import ProductQuantization as TorchPQ  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--seeds", type=int, default=14)
    args = p.parse_args()
    base = synthetic_dataset(n=args.n, dim=128, n_queries=16, k=10, n_clusters=64, seed=0).base
    ratios = []
    for seed in range(args.seeds):
        jax_err = ProductQuantization.compute(base, m=16, clusters=256, globally_center=False, seed=seed)
        jax_err = float(jax_err.reconstruction_error(base))
        port_err = TorchPQ.compute(base, m=16, clusters=256, globally_center=False, seed=seed, device="cpu")
        port_err = float(port_err.reconstruction_error(base))
        ratios.append(port_err / jax_err)
        print(json.dumps({"seed": seed, "jax": jax_err, "port": port_err, "port_over_jax": ratios[-1]}), flush=True)
    r = np.array(ratios)
    print(json.dumps({"n": args.n, "seeds": args.seeds, "mean_ratio": float(r.mean()), "min_ratio": float(r.min()),
                      "max_ratio": float(r.max()), "above_1": int((r > 1).sum()), "below_1": int((r < 1).sum())}),
          flush=True)


if __name__ == "__main__":
    main()
