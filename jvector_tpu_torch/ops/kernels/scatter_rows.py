"""The row-scatter family of ``jvector_tpu/ops/pallas/scatter_rows.py``:
K2 (``fused_update_inplace``), K4a (``scatter_rows3_inplace``), K4b
(``scatter_rows_inplace``) and K7 (``scatter_slots_inplace``).

K2 updates the build's fused SQ4 code table, ``[N, T, 128]`` uint8: row i
holds the packed codes of node i's neighbors, adjacency slot s in bytes
``[s*MP, (s+1)*MP)``.  It launches the CUDA kernel in
``csrc/fused_update.cu`` for CUDA tensors and runs the plain twin
:func:`fused_update_ref` for CPU tensors.  Both update the table in place
(the JAX package donated it), in three phases whose order is the contract:
wave row images, then backlink slot patches (a row-sorted stream), then
enforce row images, which win.  Rows outside ``[0, N)`` are dropped.
Callers keep patches out of enforce rows and give each ``(row, slot)`` at
most one patch; duplicate enforce rows carry identical images.

K4a, K4b and K7 write whole rows (``table[idx[i]] = payload[i]``) or
slots of rows (``table[idx[i], off[i]:off[i]+Kp] = payload[i]``) in place
through ``csrc/scatter_rows.cu`` for CUDA tensors, and through the twins
:func:`scatter_rows_ref` / :func:`scatter_slots_ref` for CPU tensors.
Rows outside ``[0, N)`` drop, as does a slot that does not lie inside its
row.  Duplicate rows carry identical images (the kernel's copies land in
no fixed order, as the TPU kernel's DMAs do).
"""

from __future__ import annotations

import ctypes

import torch

from jvector_tpu_torch.ops.kernels import _build
from jvector_tpu_torch.ops.kernels.packed_adj import _check_cuda

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
_ARGTYPES += [ctypes.c_void_p] * 2 + [ctypes.c_int]
_ARGTYPES += [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int]
_ARGTYPES += [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]


_SCATTER_FUNCTIONS = {
    "jv_scatter_rows": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p],
    "jv_scatter_slots": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    return _build.load("fused_update.cu", {"jv_fused_update": _ARGTYPES})


def _scatter_lib() -> ctypes.CDLL:
    return _build.load("scatter_rows.cu", _SCATTER_FUNCTIONS)


def fused_update_ref(table, wave_rows, wave_img, patch_rows, patch_slots, patch_src, er_rows, er_img):
    """Plain PyTorch twin (``index_copy_`` / ``index_put_``), in place;
    follows ``fused_update_ref`` of the JAX package with the slot byte
    range ``[slot*MP, (slot+1)*MP)`` computed from the slot index."""
    n = table.shape[0]
    flat = table.view(n, -1)
    w_ok = (wave_rows >= 0) & (wave_rows < n)
    flat.index_copy_(0, wave_rows[w_ok].long(), wave_img.reshape(wave_img.shape[0], -1)[w_ok])
    mp = patch_src.shape[1]
    p_ok = (patch_rows >= 0) & (patch_rows < n)
    cols = patch_slots[p_ok].long()[:, None] * mp + torch.arange(mp, device=table.device)[None, :]
    rows = patch_rows[p_ok].long()[:, None].expand_as(cols)
    flat.index_put_((rows, cols), patch_src[p_ok])
    e_ok = (er_rows >= 0) & (er_rows < n)
    flat.index_copy_(0, er_rows[e_ok].long(), er_img.reshape(er_img.shape[0], -1)[e_ok])
    return table


def fused_update_inplace(
    table: torch.Tensor,  # [N, T, 128] uint8, updated in place
    wave_rows: torch.Tensor,  # [W] int32 (out of range = drop)
    wave_img: torch.Tensor,  # [W, T, 128] uint8
    patch_rows: torch.Tensor,  # [P] int32, SORTED by row (out of range = drop)
    patch_slots: torch.Tensor,  # [P] int32 slot index within the row
    patch_src: torch.Tensor,  # [P, MP] uint8 raw slot codes
    er_rows: torch.Tensor,  # [E] int32
    er_img: torch.Tensor,  # [E, T, 128] uint8
) -> torch.Tensor:
    """Apply one build wave's fused-table writes in place; returns the table.

    CUDA tensors launch the K2 kernel (and count one launch); CPU tensors
    run the twin.  Any other device raises.
    """
    if table.device.type == "cpu":
        return fused_update_ref(
            table, wave_rows, wave_img, patch_rows, patch_slots, patch_src, er_rows, er_img
        )
    if table.device.type != "cuda":
        raise ValueError(f"fused_update_inplace: unsupported device {table.device}")
    if table.dim() != 3 or table.shape[2] != 128:
        raise ValueError(f"table must be [N, T, 128], got {tuple(table.shape)}")
    n, t, _ = table.shape
    n_w, p, n_e = wave_rows.shape[0], patch_rows.shape[0], er_rows.shape[0]
    mp = patch_src.shape[1]
    if wave_img.shape != (n_w, t, 128) or er_img.shape != (n_e, t, 128):
        raise ValueError("wave_img/er_img must be [rows, T, 128] like the table")
    if patch_slots.shape != (p,) or patch_src.shape != (p, mp):
        raise ValueError("patch_slots must be [P] and patch_src [P, MP]")
    if mp % 16:
        raise ValueError(f"patch_src's slot width MP={mp} must be a multiple of 16 (16-byte copies)")
    dev = table.device
    u8 = dict(table=table, wave_img=wave_img, er_img=er_img, patch_src=patch_src)
    i32 = dict(wave_rows=wave_rows, patch_rows=patch_rows, patch_slots=patch_slots, er_rows=er_rows)
    for name, x in u8.items():
        _check_cuda(name, x, torch.uint8, dev)
    for name, x in i32.items():
        _check_cuda(name, x, torch.int32, dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.jv_fused_update(
            table.data_ptr(), n, t * 128,
            wave_rows.data_ptr(), wave_img.data_ptr(), n_w,
            patch_rows.data_ptr(), patch_slots.data_ptr(), patch_src.data_ptr(), p, mp,
            er_rows.data_ptr(), er_img.data_ptr(), n_e,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "fused_update_inplace")
    fused_update_inplace.launches += 1
    return table


fused_update_inplace.launches = 0  # kernel launches (CUDA calls only)


def scatter_rows_ref(table: torch.Tensor, idx: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K4a / K4b (``index_copy_`` of the in-range
    rows), in place; follows ``scatter_rows_ref`` of the JAX package."""
    ok = (idx >= 0) & (idx < table.shape[0])
    return table.index_copy_(0, idx[ok].long(), payload[ok])


def scatter_slots_ref(table: torch.Tensor, idx: torch.Tensor, off: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K7, in place; follows ``scatter_slots_ref`` of
    the JAX package, dropping a slot whole where it leaves its row."""
    n, k = table.shape
    kp = payload.shape[1]
    ok = (idx >= 0) & (idx < n) & (off >= 0) & (off <= k - kp)
    cols = off[ok].long()[:, None] + torch.arange(kp, device=table.device)[None, :]
    rows = idx[ok].long()[:, None].expand_as(cols)
    return table.index_put_((rows, cols), payload[ok])


def _check_scatter(what: str, table: torch.Tensor, payload: torch.Tensor, payload_shape: tuple, *ints) -> bool:
    """Shape / dtype / device checks shared by K4a, K4b and K7; True when the
    call goes to the kernel (CUDA), False for the twin (CPU)."""
    b = payload.shape[0]
    if payload.dtype != table.dtype or tuple(payload.shape) != payload_shape:
        raise ValueError(f"{what}: payload must be {payload_shape} {table.dtype}, "
                         f"got {tuple(payload.shape)} {payload.dtype}")
    for x in ints:
        if x.dtype != torch.int32 or tuple(x.shape) != (b,):
            raise ValueError(f"{what}: row indices and offsets must be int32 [{b}], got {x.dtype} {tuple(x.shape)}")
    devices = {t.device for t in (table, payload, *ints)}
    if len(devices) != 1:
        raise ValueError(f"{what}: tensors on several devices {sorted(map(str, devices))}")
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {table.device}")
    for t in (table, payload, *ints):
        if not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous")
    return True


def _launch_rows(what: str, table: torch.Tensor, idx: torch.Tensor, payload: torch.Tensor) -> None:
    n, b = table.shape[0], idx.shape[0]
    lib = _scatter_lib()
    with torch.cuda.device(table.device):
        err = lib.jv_scatter_rows(
            table.data_ptr(), n, table.stride(0) * table.element_size(), idx.data_ptr(), payload.data_ptr(), b,
            torch.cuda.current_stream(table.device).cuda_stream,
        )
    _build.check(err, what)


def scatter_rows3_inplace(
    table: torch.Tensor,  # [N, T, 128], updated in place
    idx: torch.Tensor,  # [B] int32 (out of range = drop)
    payload: torch.Tensor,  # [B, T, 128] same dtype as the table
) -> torch.Tensor:
    """K4a: ``table[idx[i]] = payload[i]`` on a rank-3 whole-tile table, in
    place; returns the table.  CUDA tensors launch the kernel (and count
    one launch when B > 0); CPU tensors run :func:`scatter_rows_ref`."""
    if table.dim() != 3 or table.shape[2] != 128:
        raise ValueError(f"scatter_rows3_inplace: table must be [N, T, 128], got {tuple(table.shape)}")
    if not _check_scatter("scatter_rows3_inplace", table, payload, (idx.shape[0], *table.shape[1:]), idx):
        return scatter_rows_ref(table, idx, payload)
    if idx.shape[0]:
        _launch_rows("scatter_rows3_inplace", table, idx, payload)
        scatter_rows3_inplace.launches += 1
    return table


def scatter_rows_inplace(
    table: torch.Tensor,  # [N, K], updated in place
    idx: torch.Tensor,  # [B] int32 (out of range = drop)
    payload: torch.Tensor,  # [B, K] same dtype as the table
) -> torch.Tensor:
    """K4b: ``table[idx[i]] = payload[i]`` on a 2-D table of any dtype, in
    place; returns the table.  CUDA tensors launch the kernel (and count
    one launch when B > 0); CPU tensors run :func:`scatter_rows_ref`."""
    if table.dim() != 2:
        raise ValueError(f"scatter_rows_inplace: table must be [N, K], got {tuple(table.shape)}")
    if not _check_scatter("scatter_rows_inplace", table, payload, (idx.shape[0], table.shape[1]), idx):
        return scatter_rows_ref(table, idx, payload)
    if idx.shape[0]:
        _launch_rows("scatter_rows_inplace", table, idx, payload)
        scatter_rows_inplace.launches += 1
    return table


def scatter_slots_inplace(
    table: torch.Tensor,  # [N, K], updated in place
    idx: torch.Tensor,  # [B] int32 row index (out of range = drop)
    off: torch.Tensor,  # [B] int32 element offset within the row
    payload: torch.Tensor,  # [B, Kp] same dtype as the table, Kp <= K
) -> torch.Tensor:
    """K7: ``table[idx[i], off[i]:off[i]+Kp] = payload[i]``, in place;
    returns the table.  CUDA tensors launch the kernel (and count one
    launch when B > 0); CPU tensors run :func:`scatter_slots_ref`."""
    if table.dim() != 2 or payload.dim() != 2 or payload.shape[1] > table.shape[1]:
        raise ValueError(f"scatter_slots_inplace: need table [N, K] and payload [B, Kp <= K], "
                         f"got {tuple(table.shape)} and {tuple(payload.shape)}")
    b, kp = payload.shape
    if not _check_scatter("scatter_slots_inplace", table, payload, (idx.shape[0], kp), idx, off):
        return scatter_slots_ref(table, idx, off, payload)
    if b:
        item = table.element_size()
        lib = _scatter_lib()
        with torch.cuda.device(table.device):
            err = lib.jv_scatter_slots(
                table.data_ptr(), table.shape[0], table.shape[1] * item, idx.data_ptr(), off.data_ptr(),
                item, kp * item, payload.data_ptr(), b, torch.cuda.current_stream(table.device).cuda_stream,
            )
        _build.check(err, "scatter_slots_inplace")
        scatter_slots_inplace.launches += 1
    return table


scatter_rows3_inplace.launches = 0  # kernel launches (CUDA calls only)
scatter_rows_inplace.launches = 0
scatter_slots_inplace.launches = 0
