"""The JAX package's harness on the CPU: the figures that the port's bench
CLI and examples are held to.

    python experiments/torch_harness_cpu.py                    # both parts
    python experiments/torch_harness_cpu.py --part cli         # the CLI rows only
    python experiments/torch_harness_cpu.py --part examples    # the examples only

``--part cli`` runs ``python -m jvector_tpu.bench synth-100k --config
yaml-configs/sq4.yml --catalog yaml-configs/dataset-catalogs/local.yml``
in-process (``jvector_tpu.bench.__main__.main``, reports into a temporary
directory) and prints one JSON line per report row, then one with the run's
seconds; ``chip_smoke.py``'s ``harness`` phase holds the port's CLI rows
to these recalls.  ``--part examples`` runs each ``examples/*.py``'s
``main()`` at its own sizes (temporary paths where it writes files) and
prints one JSON line per example with its seconds and what it printed.
The process runs JAX on the CPU with 8 virtual devices, as
``examples/sharded_vs_global.py`` asks.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
import time

p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
p.add_argument("--part", choices=("cli", "examples", "all"), default="all")
p.add_argument("--dataset", default="synth-100k", help="the catalog entry of the CLI run")
ARGS = p.parse_args()

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

EXAMPLES = ("hello_vector_world", "vector_intro", "disk_intro", "larger_than_memory", "nvq_example",
            "sharded_ltm_pipeline", "sharded_vs_global", "sq4_serving")
PATH_ARGS = {"disk_intro": "disk_intro.jvtpu", "larger_than_memory": "ltm_intro.jvtpu",
             "sharded_ltm_pipeline": "sharded_ltm_intro"}


def run_cli() -> None:
    from jvector_tpu.bench.__main__ import main

    with tempfile.TemporaryDirectory() as out:
        t0 = time.time()
        rc = main([ARGS.dataset, "--config", os.path.join(ROOT, "yaml-configs", "sq4.yml"),
                   "--catalog", os.path.join(ROOT, "yaml-configs", "dataset-catalogs", "local.yml"),
                   "--output", out])
        secs = time.time() - t0
        for name in sorted(os.listdir(out)):
            if name.endswith(".jsonl"):
                with open(os.path.join(out, name)) as f:
                    for line in f:
                        row = json.loads(line)
                        print(json.dumps({"part": "cli", **{k: row[k] for k in (
                            "dataset", "compression", "reranking", "topK", "overquery", "recall", "MAP",
                            "index_build_time_s")}}), flush=True)
    print(json.dumps({"part": "cli", "rc": rc, "seconds": secs}), flush=True)


def run_examples() -> None:
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stdout(buf):
            t0 = time.time()
            if name in PATH_ARGS:
                mod.main(os.path.join(tmp, PATH_ARGS[name]))
            else:
                mod.main()
            secs = time.time() - t0
        print(json.dumps({"part": "examples", "example": name, "seconds": secs, "printed": buf.getvalue()}),
              flush=True)


if __name__ == "__main__":
    if ARGS.part in ("cli", "all"):
        run_cli()
    if ARGS.part in ("examples", "all"):
        run_examples()
