"""Standalone compressor files and the compressor cache (counterpart of
``jvector_tpu/quantization/serialize.py``).

Reference: ``ProductQuantization.write/load`` version PQ codebooks apart
from any index (``ProductQuantization.java:560-693``), and ``Grid.java``'s
pqCacheDir caches trained compressors across bench rows with an atomic
commit.  Every trained compressor (PQ, SQ4, BQ, NVQ) goes through the
index container (``disk/format.py``) with the JAX package's array names and
meta keys, so a file either package writes loads in the other, and
:class:`CompressorCache` names the same file for one key in both.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from jvector_tpu_torch.util.device import resolve_device

_KIND_KEY = "compressor_kind"


def save_compressor(path: str | os.PathLike, comp) -> None:
    """Persist a trained compressor to ``path`` (container format)."""
    from jvector_tpu_torch.disk.format import IndexFileWriter
    from jvector_tpu_torch.quantization.bq import BinaryQuantization
    from jvector_tpu_torch.quantization.nvq import NVQuantization
    from jvector_tpu_torch.quantization.pq import ProductQuantization
    from jvector_tpu_torch.quantization.sq import ScalarQuantization4

    if not isinstance(comp, (ProductQuantization, ScalarQuantization4, BinaryQuantization, NVQuantization)):
        raise TypeError(f"unknown compressor type {type(comp)!r}")
    with IndexFileWriter(path) as w:
        if isinstance(comp, ProductQuantization):
            w.add_array("codebooks", comp.codebooks)
            if comp.center is not None:
                w.add_array("center", comp.center)
            w.set_meta(**{_KIND_KEY: "pq"}, original_dim=comp.original_dim,
                       anisotropic_threshold=comp.anisotropic_threshold)
        elif isinstance(comp, ScalarQuantization4):
            w.add_array("scale", comp.scale)
            w.add_array("offset", comp.offset)
            w.set_meta(**{_KIND_KEY: "sq4"}, original_dim=comp.original_dim)
        elif isinstance(comp, BinaryQuantization):
            w.add_array("center", comp.center)
            w.set_meta(**{_KIND_KEY: "bq"}, original_dim=comp.original_dim)
        else:
            w.add_array("mean", comp.mean)
            w.set_meta(**{_KIND_KEY: "nvq"}, original_dim=comp.original_dim,
                       num_subvectors=comp.num_subvectors, bits=comp.bits)


def load_compressor(path: str | os.PathLike, device: torch.device | str | None = None):
    """Load any compressor saved by :func:`save_compressor` (by either
    package) onto ``device`` (default: the card)."""
    from jvector_tpu_torch.disk.format import IndexFileReader
    from jvector_tpu_torch.quantization.bq import BinaryQuantization
    from jvector_tpu_torch.quantization.nvq import NVQuantization
    from jvector_tpu_torch.quantization.pq import ProductQuantization
    from jvector_tpu_torch.quantization.sq import ScalarQuantization4

    r = IndexFileReader(path)
    kind = r.meta.get(_KIND_KEY)
    if kind not in ("pq", "sq4", "bq", "nvq"):
        raise ValueError(f"not a compressor file (kind={kind!r}): {path}")
    device = resolve_device(device)

    def arr(name):
        return torch.as_tensor(np.array(r.read(name), np.float32), device=device)

    dim = int(r.meta["original_dim"])
    if kind == "pq":
        return ProductQuantization(codebooks=arr("codebooks"), center=arr("center") if r.has_array("center") else None,
                                   original_dim=dim, anisotropic_threshold=float(r.meta["anisotropic_threshold"]))
    if kind == "sq4":
        return ScalarQuantization4(scale=arr("scale"), offset=arr("offset"), original_dim=dim)
    if kind == "bq":
        return BinaryQuantization(center=arr("center"), original_dim=dim)
    return NVQuantization(mean=arr("mean"), original_dim=dim, num_subvectors=int(r.meta["num_subvectors"]),
                          bits=int(r.meta["bits"]))


class CompressorCache:
    """Keyed on-disk cache of trained compressors (the reference Grid's
    pqCacheDir).  A key names its file by a hash of ``json.dumps(key,
    sort_keys=True, default=str)``, as in the JAX package, so both packages
    share a directory; writes go to a temporary file and ``os.replace``, so
    concurrent grid rows can share it too.  Loads land on ``device``."""

    def __init__(self, directory: str | os.PathLike, device: torch.device | str | None = None):
        self.directory = os.fspath(directory)
        self.device = device
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: dict) -> str:
        blob = json.dumps(key, sort_keys=True, default=str).encode()
        return os.path.join(self.directory, f"compressor-{hashlib.sha256(blob).hexdigest()[:24]}.jvtpu")

    def get_or_train(self, key: dict, train):
        """The cached compressor for ``key``, or ``train()``'s, committed.
        ``train`` is a zero-argument callable returning the compressor."""
        path = self._path(key)
        if os.path.exists(path):
            return load_compressor(path, self.device)
        comp = train()
        tmp = f"{path}.tmp.{os.getpid()}"
        save_compressor(tmp, comp)
        os.replace(tmp, path)
        return comp
