"""fvecs / ivecs / bvecs dataset IO (counterpart of ``jvector_tpu/util/io.py``).

The TEXMEX formats: each vector is ``[int32 dim][dim * elem]``
little-endian.  ``read_fvecs`` takes the native parallel parser
(``util.native``) where it loaded; the numpy path is its fallback and the
reference.  Every reader raises ``ValueError`` on a malformed file: a
non-positive dimension, a size that is not a whole number of rows, or rows
of different dimensions.  (The JAX package's ``read_ivecs`` and
``read_bvecs`` drop a truncated last row silently.)
"""

from __future__ import annotations

import os

import numpy as np


def _rows(words: np.ndarray, d: int, row: int, max_vectors: int | None, path) -> np.ndarray:
    """A file's elements as ``[n, row]`` rows (at most ``max_vectors``) of
    dimension ``d``; raises unless the file is a whole number of rows."""
    if d <= 0:
        raise ValueError(f"bad vecs dim {d} in {path}")
    if words.size % row != 0:
        raise ValueError(f"corrupt vecs file {path}: {words.size} elements, dim {d}")
    n = words.size // row
    if max_vectors is not None:
        n = min(n, max_vectors)
    return words[: n * row].reshape(n, row)


def read_fvecs(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """Read a .fvecs file into a float32 ``[N, D]`` array."""
    from jvector_tpu_torch.util import native

    out = native.read_fvecs_native(str(path), max_vectors)
    if out is not None:
        return out
    return read_fvecs_numpy(path, max_vectors)


def read_fvecs_numpy(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """The numpy fvecs reader: ``read_fvecs``'s fallback and reference."""
    data = np.fromfile(path, dtype=np.int32)
    if data.size == 0:
        return np.zeros((0, 0), np.float32)
    d = int(data[0])
    mat = _rows(data, d, d + 1, max_vectors, path)
    if not (mat[:, 0] == d).all():
        raise ValueError(f"non-uniform dims in {path}")
    return mat[:, 1:].view(np.float32).copy()


def read_ivecs(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """Read a .ivecs file into an int32 ``[N, D]`` array."""
    data = np.fromfile(path, dtype=np.int32)
    if data.size == 0:
        return np.zeros((0, 0), np.int32)
    d = int(data[0])
    mat = _rows(data, d, d + 1, max_vectors, path)
    if not (mat[:, 0] == d).all():
        raise ValueError(f"non-uniform dims in {path}")
    return mat[:, 1:].copy()


def read_bvecs(path: str | os.PathLike, max_vectors: int | None = None) -> np.ndarray:
    """Read a .bvecs file into a uint8 ``[N, D]`` array."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.zeros((0, 0), np.uint8)
    if raw.size < 4:
        raise ValueError(f"corrupt bvecs file {path}: {raw.size} bytes")
    d = int(raw[:4].view("<i4")[0])
    mat = _rows(raw, d, 4 + d, max_vectors, path)
    if not (mat[:, :4].copy().view("<i4")[:, 0] == d).all():
        raise ValueError(f"non-uniform dims in {path}")
    return mat[:, 4:].copy()


def write_fvecs(path: str | os.PathLike, vectors: np.ndarray) -> None:
    v = np.asarray(vectors, np.float32)
    n, d = v.shape
    out = np.empty((n, d + 1), np.int32)
    out[:, 0] = d
    out[:, 1:] = v.view(np.int32)
    out.tofile(path)


def write_ivecs(path: str | os.PathLike, vectors: np.ndarray) -> None:
    v = np.asarray(vectors, np.int32)
    n, d = v.shape
    out = np.empty((n, d + 1), np.int32)
    out[:, 0] = d
    out[:, 1:] = v
    out.tofile(path)
