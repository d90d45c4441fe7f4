"""Run one cell of the port's benchmark on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``jvector_tpu_torch``.  Prints one
JSON line as the last line of standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; ``breakdown`` with ``--trace 1``;
``checks`` last), and each number compared beside its limit as the last
lines of standard error.  Exits non-zero, with no result, without a CUDA
card (or fewer than the cell asks for), without the port beside it, or
when a module of JAX or the JAX package was loaded.
"""

import time

T0 = time.time()  # set-up is counted from here, before the heavy imports

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with few threads: the host loops set the pace, and idle
# worker threads spinning beside them only add noise (set before torch and
# numpy start their pools; a value in the environment wins)
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "jvector_tpu_torch")):
        print(f"no jvector_tpu_torch beside the benchmark in {ROOT}: nothing to measure", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
