"""Bench CLI: grid-run YAML configs over catalog-selected datasets
(counterpart of ``jvector_tpu/bench/__main__.py``; reference ``Bench.java``,
dataset-name regexes plus a YAML parameter file, CSV / JSONL reports)::

    python -m jvector_tpu_torch.bench 'synth.*' \\
        --config yaml-configs/sq4.yml \\
        --catalog yaml-configs/dataset-catalogs/local.yml \\
        --output bench_results/

- positional args: regexes matched against catalog entry names (default
  ``.*``, every entry, like the reference's no-argument run)
- ``--config``: reference-schema YAML (construction / search blocks); may
  be given several times, and each config runs over each selected dataset
- ``--catalog``: dataset catalog YAML (named fvecs / hdf5 / synthetic
  corpora); may be given several times
- ``--output``: directory for the CSV + JSONL reports, one pair per
  dataset x config, with run metadata on every row
- ``--device``: where the datasets' ground truth, the builds and the
  searches run; the card unless ``--device cpu``

Both YAML kinds are read by ``util.yaml_subset`` (no PyYAML).  Exits 2
when no catalog entry matches.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m jvector_tpu_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("patterns", nargs="*", default=[], help="dataset regexes")
    p.add_argument("--config", action="append", default=[])
    p.add_argument("--catalog", action="append", default=[])
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    from jvector_tpu_torch.bench.grid import run_yaml
    from jvector_tpu_torch.util.catalog import Catalog
    from jvector_tpu_torch.util.device import resolve_device

    def _default(*rel: str) -> str:
        """Resolve yaml-configs/ against the cwd, then the checkout."""
        roots = [os.getcwd(), os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))]
        tried = [os.path.join(r, *rel) for r in roots]
        for path in tried:
            if os.path.exists(path):
                return path
        raise SystemExit(f"no default {'/'.join(rel)} found; tried {tried}")

    configs = args.config or [_default("yaml-configs", "default.yml")]
    catalogs = args.catalog or [_default("yaml-configs", "dataset-catalogs", "local.yml")]
    patterns = args.patterns or [".*"]

    selected: list[tuple[str, Catalog]] = []
    for cpath in catalogs:
        cat = Catalog.load(cpath)
        names = sorted({n for pat in patterns for n in cat.select(pat)})
        selected.extend((n, cat) for n in names)
    if not selected:
        print(f"no datasets match {patterns} in {catalogs}", file=sys.stderr)
        return 2

    device = resolve_device(args.device)
    for name, cat in selected:
        ds = cat.open(name, device=device)
        for cfg in configs:
            print(f"=== {name} x {os.path.basename(cfg)} ===", flush=True)
            for row in run_yaml(cfg, ds, out_dir=args.output, device=device):
                print(row, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
