"""Dataset catalogs: YAML-described named datasets and on-disk discovery
(counterpart of ``jvector_tpu/util/catalog.py``).

Reference: ``benchmarks/datasets/DataSets`` / ``DataSetLoader``: the bench
harness resolves regex-selected dataset names against YAML catalogs, each
entry naming a format and file locations (environment variables
expanded), fetching missing files first.  Entries resolve against the local
filesystem, define synthetic corpora with exact ground truth computed on
the caller's device, or carry ``url`` / ``urls`` to fetch missing files
(``file://``, ``http(s)``, and ``s3://`` / ``gs://`` through the buckets'
public HTTPS endpoints).  Catalogs are read by ``util.yaml_subset``.

Catalog schema (one YAML file, top-level ``datasets:`` map)::

    datasets:
      siftsmall:
        format: fvecs          # X_base.fvecs / X_query.fvecs / X_groundtruth.ivecs
        prefix: ${DATA}/siftsmall/siftsmall
        similarity: euclidean
        urls:                  # optional fetch of missing files
          base: s3://my-bucket/siftsmall_base.fvecs
      glove-100:
        format: hdf5
        path: ${DATA}/glove-100-angular.hdf5
        url: http://ann-benchmarks.com/glove-100-angular.hdf5
        similarity: cosine
      synth-1m:
        format: synthetic
        n: 1000000
        dim: 128
        n_queries: 8192
        k: 100
        similarity: euclidean
        seed: 0
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import tempfile

import torch

from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.util import yaml_subset
from jvector_tpu_torch.util.datasets import DataSet, load_dataset, load_hdf5, synthetic_dataset


def resolve_url(url: str) -> str:
    """Rewrite cloud-scheme URLs to their public HTTPS endpoints (anonymous
    reads, no SDK)."""
    if url.startswith("s3://"):
        bucket, _, key = url[len("s3://") :].partition("/")
        return f"https://{bucket}.s3.amazonaws.com/{key}"
    if url.startswith("gs://"):
        bucket, _, key = url[len("gs://") :].partition("/")
        return f"https://storage.googleapis.com/{bucket}/{key}"
    return url


def fetch(url: str, dest: str, fetcher=None) -> str:
    """Download ``url`` to ``dest``; a no-op when ``dest`` exists.

    The transfer goes to a temporary file of a unique name in ``dest``'s
    directory, which is renamed onto ``dest`` only after the transfer
    returned, and removed when it raised: a failed or concurrent fetch
    never leaves a partial ``dest``.  ``fetcher(url, tmp_path)`` overrides
    the transport (tests inject one; deployments plug authenticated
    clients); by default ``file://`` copies and anything else goes through
    urllib (``s3://`` / ``gs://`` rewritten by :func:`resolve_url`).
    """
    if os.path.exists(dest):
        return dest
    directory = os.path.dirname(dest) or "."
    os.makedirs(directory, exist_ok=True)
    url = resolve_url(url)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(dest) + ".", suffix=".part", dir=directory)
    os.close(fd)
    try:
        if fetcher is not None:
            fetcher(url, tmp)
        elif url.startswith("file://"):
            import shutil

            shutil.copyfile(url[len("file://") :], tmp)
        else:
            import urllib.request

            urllib.request.urlretrieve(url, tmp)  # noqa: S310 (catalog-declared)
        os.replace(tmp, dest)
    except BaseException:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise
    return dest


@dataclasses.dataclass
class Catalog:
    """A parsed dataset catalog."""

    entries: dict[str, dict]

    @staticmethod
    def load(path: str | os.PathLike) -> "Catalog":
        y = yaml_subset.load_file(path) or {}
        return Catalog(entries=dict(y.get("datasets") or {}))

    def names(self) -> list[str]:
        return sorted(self.entries)

    def select(self, pattern: str) -> list[str]:
        """Regex dataset selection (the reference ``Bench``'s regex args)."""
        rx = re.compile(pattern)
        return [n for n in self.names() if rx.search(n)]

    def open(self, name: str, fetcher=None, device: torch.device | str | None = None) -> DataSet:
        """Resolve one entry to a loaded :class:`DataSet`.

        Synthetic entries are drawn as the JAX package draws them, with
        their exact ground truth computed on ``device`` (the card unless the
        caller asks for the CPU).  Entries with ``url`` (hdf5) / ``urls``
        (fvecs: keys base / query / groundtruth) fetch missing files first;
        ``fetcher`` overrides the transport (see :func:`fetch`).
        """
        if name not in self.entries:
            raise KeyError(f"dataset {name!r} not in catalog ({self.names()})")
        e = dict(self.entries[name])
        fmt = e.get("format", "fvecs")
        sim = SimilarityFunction.parse(e.get("similarity", "euclidean"))
        if fmt == "synthetic":
            return synthetic_dataset(
                n=int(e["n"]),
                dim=int(e["dim"]),
                n_queries=int(e.get("n_queries", 1000)),
                k=int(e.get("k", 100)),
                n_clusters=int(e.get("n_clusters", max(64, int(e["n"]) // 500))),
                seed=int(e.get("seed", 0)),
                sim=sim,
                name=name,
                device=device,
            )
        if fmt == "hdf5":
            path = os.path.expandvars(e["path"])
            if not os.path.exists(path) and e.get("url"):
                fetch(os.path.expandvars(e["url"]), path, fetcher)
            return load_hdf5(path, name=name)
        if fmt == "fvecs":
            prefix = os.path.expandvars(e["prefix"])
            suffixes = {"base": "_base.fvecs", "query": "_query.fvecs", "groundtruth": "_groundtruth.ivecs"}
            for key, url in (e.get("urls") or {}).items():
                if key not in suffixes:
                    raise ValueError(f"{name!r}: unknown urls key {key!r} (expected {sorted(suffixes)})")
                fetch(os.path.expandvars(url), prefix + suffixes[key], fetcher)
            ds = load_dataset(prefix)
            if ds is None:
                raise FileNotFoundError(f"dataset files missing for {prefix!r}")
            return dataclasses.replace(ds, similarity=sim)
        raise ValueError(f"unknown dataset format {fmt!r} for {name!r}")


def discover(directory: str | os.PathLike) -> dict[str, dict]:
    """Find loadable datasets under a directory: TEXMEX fvecs triples and
    ann-benchmarks HDF5 files, as catalog-shaped entries."""
    found: dict[str, dict] = {}
    for root, _, files in os.walk(directory):
        for f in files:
            if f.endswith("_base.fvecs"):
                prefix = os.path.join(root, f[: -len("_base.fvecs")])
                if os.path.exists(prefix + "_query.fvecs"):
                    found[os.path.basename(prefix)] = {"format": "fvecs", "prefix": prefix,
                                                       "similarity": "euclidean"}
            elif f.endswith((".hdf5", ".h5")):
                found[os.path.splitext(f)[0]] = {"format": "hdf5", "path": os.path.join(root, f),
                                                 "similarity": "euclidean"}
    return found
