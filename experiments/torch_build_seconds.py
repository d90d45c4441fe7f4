"""Seconds of one SQ4 build of the port on the card, to compare two
revisions in one call.

    python experiments/torch_build_seconds.py --n 200000 [--tree DIR]

Builds ``synthetic_dataset(n, dim=128, n_clusters=max(64, n // 500),
seed=0)`` with ``build_graph`` at ``GraphConfig(max_degree=32,
ef_construction=100)`` (``chip_smoke.py``'s SQ4 path, no per-phase
timers) and prints one JSON line: the build seconds (host clock, the
device synced), the waves, K1's and K2's launches, the package's path
and the card's name and power limit.  ``--tree DIR`` imports
``jvector_tpu_torch`` from the checkout at DIR (for instance a ``git
archive`` of the parent in the git-ignored ``_scratch/``) instead of this
one; run it in turns, parent, change, change, parent, one process each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=200_000)
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   help="checkout whose jvector_tpu_torch is built (default: this one)")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    import jvector_tpu_torch
    from jvector_tpu_torch.graph import GraphConfig, build_graph
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.ops.kernels import fused_update_inplace, packed_adj_update_inplace
    from jvector_tpu_torch.util.datasets import synthetic_dataset

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = GraphConfig(max_degree=32, ef_construction=100)
    ds = synthetic_dataset(n=args.n, dim=128, n_queries=16, k=10, n_clusters=max(64, args.n // 500), seed=0,
                           device=dev)
    base = torch.as_tensor(ds.base, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    build_graph(base, "euclidean", cfg)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"package": os.path.dirname(jvector_tpu_torch.__file__), "n": args.n,
                      "n_waves": len(_shuffled_wave_starts(args.n, cfg.wave_size)), "build_seconds": seconds,
                      "launches": {"packed_adj_update_inplace": packed_adj_update_inplace.launches,
                                   "fused_update_inplace": fused_update_inplace.launches},
                      "device": smi}), flush=True)


if __name__ == "__main__":
    main()
