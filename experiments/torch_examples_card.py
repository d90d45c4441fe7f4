"""Run the port's eight examples (``examples/torch_*.py``) once each at their
default sizes on the card, one process, and print one JSON line per example
with its seconds and the figures its ``main`` returned, after a line with
the card's name and power limit.

    python experiments/torch_examples_card.py                  # all eight
    python experiments/torch_examples_card.py --only disk_intro nvq_example

The JAX scripts' figures at the same sizes come from
``experiments/torch_harness_cpu.py --part examples``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
EXAMPLES = ("hello_vector_world", "vector_intro", "disk_intro", "larger_than_memory", "nvq_example",
            "sharded_ltm_pipeline", "sharded_vs_global", "sq4_serving")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--only", nargs="*", default=list(EXAMPLES), choices=EXAMPLES)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "device": torch.cuda.get_device_name(0)}), flush=True)
    for name in args.only:
        spec = importlib.util.spec_from_file_location(f"torch_{name}", os.path.join(ROOT, "examples", f"torch_{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        torch.cuda.synchronize()
        t0 = time.time()
        figures = mod.main()
        torch.cuda.synchronize()
        print(json.dumps({"example": name, "seconds": time.time() - t0, "figures": figures}), flush=True)


if __name__ == "__main__":
    main()
