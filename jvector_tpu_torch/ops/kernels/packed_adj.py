"""K1 and K3: in-place packed-adjacency wave updates (counterpart of
``jvector_tpu/ops/pallas/packed_adj.py``).

Layout: ``adj`` is ``[N/8, 8, 128]`` int32 with neighbor ids in lanes
``[0:R]`` and float32 edge-score bits in lanes ``[64:64+R]``; ``w2t`` has the
same shape with the neighbors' per-node constants (float32 bits) in lanes
``[0:R]``.

:func:`packed_adj_update_inplace` (K1) launches the CUDA kernel in
``csrc/packed_adj.cu`` for CUDA tensors and runs the plain twin
:func:`packed_adj_update_ref` for CPU tensors; :func:`packed_adj_only_update_inplace`
(K3, the larger-than-memory build) and its twin
:func:`packed_adj_only_update_ref` do the same without the w2 table.  All
update the tables in
place (the JAX package donated them) with the same phase semantics: wave
images, then the row-sorted patch stream, rows outside ``[0, n_prows)``
dropped.  Callers keep appends out of enforce rows and give each
``(row, sublane, lane)`` at most one append, which makes the result
independent of the order within a phase; the kernel applies the patches
in parallel and keeps no order among them.  In the stream, in-range rows
are sorted, a negative row (a drop) may sit anywhere, and a row
``>= n_prows`` (a drop) comes after every in-range row: the kernel's
wave-row owners find their patches by probing it (``csrc/row_owner.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from jvector_tpu_torch.ops.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
_ARGTYPES += [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
_ONLY_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
_ONLY_ARGTYPES += [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    return _build.load("packed_adj.cu", {"jv_packed_adj_update": _ARGTYPES, "jv_packed_adj_only_update": _ONLY_ARGTYPES})


def packed_adj_update_ref(
    adj, w2t, a_rows, a_adj, a_w2, p_prow, p_sub, p_slot, p_id, p_sc, p_w2, p_img, e_adj, e_w2
):
    """Plain PyTorch twin (``index_copy_`` / ``index_put_``), in place;
    follows ``packed_adj_update_ref`` of the JAX package."""
    n_pr = adj.shape[0]
    a_ok = (a_rows >= 0) & (a_rows < n_pr)
    rows = a_rows[a_ok].long()
    adj.index_copy_(0, rows, a_adj[a_ok])
    w2t.index_copy_(0, rows, a_w2[a_ok])
    ok = (p_prow >= 0) & (p_prow < n_pr)
    app = ok & (p_img < 0)
    r, s, slot = p_prow[app].long(), p_sub[app].long(), p_slot[app].long()
    adj.index_put_((r, s, slot), p_id[app])
    adj.index_put_((r, s, slot + 64), p_sc[app])
    w2t.index_put_((r, s, slot), p_w2[app])
    im = ok & (p_img >= 0)
    ri, si, img = p_prow[im].long(), p_sub[im].long(), p_img[im].long()
    adj.index_put_((ri, si), e_adj[img])
    w2t.index_put_((ri, si), e_w2[img])
    return adj, w2t


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: need a contiguous, 16-byte aligned {dtype} tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def packed_adj_update_inplace(
    adj: torch.Tensor,  # [N/8, 8, 128] int32, updated in place
    w2t: torch.Tensor,  # [N/8, 8, 128] int32, updated in place
    a_rows: torch.Tensor,  # [Wa] int32 physical rows of the wave images
    a_adj: torch.Tensor,  # [Wa, 8, 128] int32
    a_w2: torch.Tensor,  # [Wa, 8, 128] int32
    p_prow: torch.Tensor,  # [P] int32 physical rows, sorted (out of range = drop, see above)
    p_sub: torch.Tensor,  # [P] int32 sublane 0..7
    p_slot: torch.Tensor,  # [P] int32 lane of the id / w2 (score at 64+slot)
    p_id: torch.Tensor,  # [P] int32
    p_sc: torch.Tensor,  # [P] int32 float32 score bits
    p_w2: torch.Tensor,  # [P] int32 float32 w2 bits
    p_img: torch.Tensor,  # [P] int32 enforce-image index, or -1 for an append
    e_adj: torch.Tensor,  # [E, 128] int32 enforce sublane images
    e_w2: torch.Tensor,  # [E, 128] int32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply one build wave's adjacency writes in place; returns the tables.

    CUDA tensors launch the K1 kernel (and count one launch) unless there is
    nothing to write; CPU tensors run the twin.  Any other device raises.
    """
    if adj.device.type == "cpu":
        return packed_adj_update_ref(
            adj, w2t, a_rows, a_adj, a_w2, p_prow, p_sub, p_slot, p_id, p_sc, p_w2, p_img, e_adj, e_w2
        )
    if adj.device.type != "cuda":
        raise ValueError(f"packed_adj_update_inplace: unsupported device {adj.device}")
    if adj.dim() != 3 or adj.shape[1:] != (8, 128) or w2t.shape != adj.shape:
        raise ValueError(f"adj/w2t must be [N/8, 8, 128], got {tuple(adj.shape)} / {tuple(w2t.shape)}")
    n_a, p, n_e = a_rows.shape[0], p_prow.shape[0], e_adj.shape[0]
    if a_adj.shape != (n_a, 8, 128) or a_w2.shape != (n_a, 8, 128):
        raise ValueError("a_adj/a_w2 must be [Wa, 8, 128]")
    if e_adj.shape != (n_e, 128) or e_w2.shape != (n_e, 128):
        raise ValueError("e_adj/e_w2 must be [E, 128]")
    streams = dict(p_sub=p_sub, p_slot=p_slot, p_id=p_id, p_sc=p_sc, p_w2=p_w2, p_img=p_img)
    for name, t in streams.items():
        if t.shape != (p,):
            raise ValueError(f"{name} must be [P={p}], got {tuple(t.shape)}")
    dev = adj.device
    tensors = dict(adj=adj, w2t=w2t, a_rows=a_rows, a_adj=a_adj, a_w2=a_w2, p_prow=p_prow, e_adj=e_adj, e_w2=e_w2)
    for name, t in {**tensors, **streams}.items():
        _check_cuda(name, t, torch.int32, dev)
    if n_a == 0 and p == 0:
        return adj, w2t
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.jv_packed_adj_update(
            adj.data_ptr(), w2t.data_ptr(), adj.shape[0],
            a_rows.data_ptr(), a_adj.data_ptr(), a_w2.data_ptr(), n_a,
            p_prow.data_ptr(), p_sub.data_ptr(), p_slot.data_ptr(), p_id.data_ptr(),
            p_sc.data_ptr(), p_w2.data_ptr(), p_img.data_ptr(), p,
            e_adj.data_ptr(), e_w2.data_ptr(), n_e,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "packed_adj_update_inplace")
    packed_adj_update_inplace.launches += 1
    return adj, w2t


packed_adj_update_inplace.launches = 0  # kernel launches (CUDA calls only)


def packed_adj_only_update_ref(adj, a_rows, a_adj, p_prow, p_sub, p_slot, p_id, p_sc, p_img, e_adj):
    """Plain PyTorch twin of K3, in place; follows the JAX package's
    ``packed_adj_only_update_ref``."""
    n_pr = adj.shape[0]
    a_ok = (a_rows >= 0) & (a_rows < n_pr)
    adj.index_copy_(0, a_rows[a_ok].long(), a_adj[a_ok])
    ok = (p_prow >= 0) & (p_prow < n_pr)
    app = ok & (p_img < 0)
    r, s, slot = p_prow[app].long(), p_sub[app].long(), p_slot[app].long()
    adj.index_put_((r, s, slot), p_id[app])
    adj.index_put_((r, s, slot + 64), p_sc[app])
    im = ok & (p_img >= 0)
    adj.index_put_((p_prow[im].long(), p_sub[im].long()), e_adj[p_img[im].long()])
    return adj


def packed_adj_only_update_inplace(
    adj: torch.Tensor,  # [N/8, 8, 128] int32, updated in place
    a_rows: torch.Tensor,  # [Wa] int32 physical rows of the wave images
    a_adj: torch.Tensor,  # [Wa, 8, 128] int32
    p_prow: torch.Tensor,  # [P] int32 physical rows, sorted (out of range = drop, see above)
    p_sub: torch.Tensor,  # [P] int32 sublane 0..7
    p_slot: torch.Tensor,  # [P] int32 lane of the id (score at 64+slot)
    p_id: torch.Tensor,  # [P] int32
    p_sc: torch.Tensor,  # [P] int32 float32 score bits
    p_img: torch.Tensor,  # [P] int32 enforce-image index, or -1 for an append
    e_adj: torch.Tensor,  # [E, 128] int32 enforce sublane images
) -> torch.Tensor:
    """K3: K1's contract without the w2 table (the larger-than-memory build's
    wave apply); returns ``adj``.  CUDA tensors launch the kernel (and count
    one launch) unless there is nothing to write; CPU tensors run the twin.
    Any other device raises."""
    if adj.device.type == "cpu":
        return packed_adj_only_update_ref(adj, a_rows, a_adj, p_prow, p_sub, p_slot, p_id, p_sc, p_img, e_adj)
    if adj.device.type != "cuda":
        raise ValueError(f"packed_adj_only_update_inplace: unsupported device {adj.device}")
    if adj.dim() != 3 or adj.shape[1:] != (8, 128):
        raise ValueError(f"adj must be [N/8, 8, 128], got {tuple(adj.shape)}")
    n_a, p, n_e = a_rows.shape[0], p_prow.shape[0], e_adj.shape[0]
    if a_adj.shape != (n_a, 8, 128):
        raise ValueError("a_adj must be [Wa, 8, 128]")
    if e_adj.shape != (n_e, 128):
        raise ValueError("e_adj must be [E, 128]")
    streams = dict(p_sub=p_sub, p_slot=p_slot, p_id=p_id, p_sc=p_sc, p_img=p_img)
    for name, t in streams.items():
        if t.shape != (p,):
            raise ValueError(f"{name} must be [P={p}], got {tuple(t.shape)}")
    dev = adj.device
    for name, t in {**dict(adj=adj, a_rows=a_rows, a_adj=a_adj, p_prow=p_prow, e_adj=e_adj), **streams}.items():
        _check_cuda(name, t, torch.int32, dev)
    if n_a == 0 and p == 0:
        return adj
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.jv_packed_adj_only_update(
            adj.data_ptr(), adj.shape[0], a_rows.data_ptr(), a_adj.data_ptr(), n_a,
            p_prow.data_ptr(), p_sub.data_ptr(), p_slot.data_ptr(), p_id.data_ptr(), p_sc.data_ptr(),
            p_img.data_ptr(), p, e_adj.data_ptr(), n_e, torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(err, "packed_adj_only_update_inplace")
    packed_adj_only_update_inplace.launches += 1
    return adj


packed_adj_only_update_inplace.launches = 0  # kernel launches (CUDA calls only)
