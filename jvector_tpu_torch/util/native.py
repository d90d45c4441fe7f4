"""Host IO helpers over the repo's native library (counterpart of
``jvector_tpu/util/native.py``: ``crc32_file``, ``read_fvecs_native``,
``pwrite_rows`` and ``gather_rows``).

``native/jvtpu_io.cpp`` is compiled with the host C++ compiler at first use
into ``jvector_tpu_torch/_build/`` (listed in ``.gitignore``) and bound with
``ctypes``.  This is host IO, not a device kernel: where no compiler is
present, or the build fails, both functions take their numpy fallback, and
:func:`backend` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import zlib

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG), "native", "jvtpu_io.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_LD_FLAGS = ["-lz", "-pthread"]

_lib = None
_load_failed = False
_lock = threading.Lock()


def _build() -> str:
    """Compile the native source (once per source + flags hash)."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS + _LD_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"libjvtpu_io-{digest}.so")
    if os.path.exists(out):
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run([cxx, *_CXX_FLAGS, _SOURCE, "-o", tmp, *_LD_FLAGS], check=True, capture_output=True, timeout=300)
    os.replace(tmp, out)
    return out


def _load() -> "ctypes.CDLL | None":
    global _lib, _load_failed
    with _lock:
        if _lib is None and not _load_failed:
            try:
                lib = ctypes.CDLL(_build())
                lib.jvtpu_crc32.argtypes = [
                    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
                ]
                lib.jvtpu_crc32.restype = ctypes.c_int
                lib.jvtpu_gather_rows.argtypes = [
                    ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_void_p, ctypes.c_int,
                ]
                lib.jvtpu_gather_rows.restype = ctypes.c_int
                lib.jvtpu_fvecs_info.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
                ]
                lib.jvtpu_fvecs_info.restype = ctypes.c_int
                lib.jvtpu_fvecs_to_dense.argtypes = [
                    ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                ]
                lib.jvtpu_fvecs_to_dense.restype = ctypes.c_int
                lib.jvtpu_pwrite_rows.argtypes = [
                    ctypes.c_char_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int,
                ]
                lib.jvtpu_pwrite_rows.restype = ctypes.c_int
                _lib = lib
            except (OSError, RuntimeError, subprocess.SubprocessError):
                _load_failed = True
        return _lib


def backend() -> str:
    """``"native"`` when the C++ library loaded, else ``"numpy"``."""
    return "native" if _load() is not None else "numpy"


def crc32_file(path: str, offset: int, length: int, n_threads: int = 8) -> int:
    """Parallel CRC32 of a file range; falls back to zlib streaming."""
    lib = _load()
    if lib is not None:
        out = ctypes.c_uint32(0)
        if lib.jvtpu_crc32(str(path).encode(), offset, length, n_threads, ctypes.byref(out)) == 0:
            return int(out.value)
    crc = 0
    with open(path, "rb") as f:
        f.seek(offset)
        left = length
        while left > 0:
            chunk = f.read(min(4 << 20, left))
            if not chunk:
                raise IOError(f"short read in {path}")
            crc = zlib.crc32(chunk, crc)
            left -= len(chunk)
    return crc & 0xFFFFFFFF


_EBADMSG, _EINVAL = -74, -22  # the native library's error returns


def read_fvecs_native(path: str, max_vectors: int | None = None) -> "np.ndarray | None":
    """Parallel fvecs load into float32 ``[N, D]``; None when the native
    library is unavailable or the read fails for another reason than the
    file's contents, which raise ``ValueError``."""
    lib = _load()
    if lib is None:
        return None
    dim, count = ctypes.c_int32(0), ctypes.c_int64(0)
    rc = lib.jvtpu_fvecs_info(str(path).encode(), ctypes.byref(dim), ctypes.byref(count))
    if rc == _EBADMSG:
        raise ValueError(f"corrupt fvecs file {path}")
    if rc == _EINVAL:
        raise ValueError(f"bad fvecs dim in {path}")
    if rc != 0:
        return None
    n = int(count.value) if max_vectors is None else min(int(count.value), max_vectors)
    if n == 0:
        return np.zeros((0, 0), np.float32)
    out = np.empty((n, int(dim.value)), np.float32)
    rc = lib.jvtpu_fvecs_to_dense(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, os.cpu_count() or 4
    )
    if rc == _EBADMSG:
        raise ValueError(f"corrupt fvecs file {path}")
    return out if rc == 0 else None


def pwrite_rows(path: str, base_offset: int, data: np.ndarray, start_row: int, n_threads: int = 8) -> bool:
    """Positional parallel write of ``data``'s rows into a reserved extent
    of ``path`` (row ``start_row`` at ``base_offset + start_row * row_bytes``);
    False when the native library is unavailable or the write failed."""
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data)
    row_bytes = data.dtype.itemsize * int(np.prod(data.shape[1:], dtype=np.int64))
    rc = lib.jvtpu_pwrite_rows(
        str(path).encode(), base_offset, data.ctypes.data_as(ctypes.c_void_p), row_bytes, data.shape[0],
        start_row, n_threads,
    )
    return rc == 0


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: int = 8, out: np.ndarray | None = None) -> np.ndarray:
    """Parallel ``src[idx]`` row gather into a contiguous array (``out`` when
    given, e.g. a view of pinned memory).  Out-of-range or negative indices
    give zero rows.  The host side of bounded-memory serving."""
    idx = np.ascontiguousarray(idx, np.int32)
    shape = (idx.shape[0],) + src.shape[1:]
    if out is None:
        out = np.empty(shape, src.dtype)
    elif out.shape != shape or out.dtype != src.dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous {src.dtype} array of shape {shape}")
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib = _load()
    if lib is not None and src.flags.c_contiguous and row_bytes > 0:
        rc = lib.jvtpu_gather_rows(
            src.ctypes.data_as(ctypes.c_void_p), row_bytes, idx.ctypes.data_as(ctypes.c_void_p), idx.shape[0],
            src.shape[0], out.ctypes.data_as(ctypes.c_void_p), n_threads,
        )
        if rc == 0:
            return out
    bad = (idx < 0) | (idx >= src.shape[0])
    out[...] = src[np.clip(idx, 0, max(src.shape[0] - 1, 0))]
    if bad.any():
        out[bad] = 0
    return out
