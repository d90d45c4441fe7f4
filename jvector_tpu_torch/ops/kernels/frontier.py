"""K8: the beam step's frontier filter (no TPU kernel: the JAX package's
``_dedup_new`` and the mask around it in ``jvector_tpu/graph/searcher.py``,
fused there by XLA).

:func:`frontier_filter` takes a step's raw neighbour ids ``nbrs [Q, C]``
(C = E * R: the R-slot rows of the E popped nodes), the pops' ``active
[Q, E]`` flags, the beam ids ``[Q, L]`` and the history ring ``[Q, T]``
(after this step's write), and returns ``(fresh, new_ids, safe_nbrs)``:

- ``fresh [Q, C]`` bool: the candidate is valid (``nbrs >= 0`` and its
  pop active) and its id is in neither the beam nor the history nor among
  the valid candidates before it in the row;
- ``new_ids [Q, C]`` int32: the id where fresh, else -1;
- ``safe_nbrs [Q, C]`` int32: the id where fresh, else 0.

CUDA tensors launch the kernel in ``csrc/frontier.cu`` (one launch a call,
counted in ``frontier_filter.launches``); CPU tensors run the plain twin
:func:`frontier_filter_ref`, the composition the beam step used before
(``_dedup_new`` and the masks around it), bit for bit the same.  Any other
device, or a tensor the kernel does not take, raises before any launch;
nothing falls back.  The launch costs the host little: one function checks
the tensors, allocates the outputs and passes the plan to the C entry,
bound once and kept (:func:`_entry`), with the device index and the raw
stream handle.
"""

from __future__ import annotations

import ctypes

import torch

from jvector_tpu_torch.ops.kernels import _build

# jv_frontier(nbrs, active, beam, history, fresh, new_ids, safe, q, c, e, r, l, t, k, tile, device, stream)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p]
_frontier_fn = None  # jv_frontier once bound (_entry)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)  # device index -> cudaStream_t (CUDA builds)
_I32, _BOOL = torch.int32, torch.bool
MAX_TILE = 2048  # ids of shared memory a warp (32 KB a block of four warps)
MAX_K = 16  # candidates a lane in one chunk (512 a warp)


def _entry():
    """K8's C entry ``jv_frontier``: built and bound at the first call, then kept."""
    global _frontier_fn
    if _frontier_fn is None:
        _frontier_fn = _build.load("frontier.cu", {"jv_frontier": _ARGTYPES}).jv_frontier
    return _frontier_fn


def _strictly_lower(c: int, device) -> torch.Tensor:
    """``[c, c]`` mask, True where column < row (an earlier entry)."""
    return torch.ones((c, c), dtype=torch.bool, device=device).tril(diagonal=-1)


def _dedup_new(new_ids: torch.Tensor, beam_ids: torch.Tensor, history: torch.Tensor) -> torch.Tensor:
    """Fresh mask for ``new_ids [Q, C]`` vs beam ``[Q, L]``, history ``[Q, T]``
    and earlier same-step candidates.  Pure dense equality reductions."""
    n = new_ids[:, :, None]
    dup = (n == beam_ids[:, None, :]).any(dim=2)
    dup |= (n == history[:, None, :]).any(dim=2)
    eq = n == new_ids[:, None, :]
    dup |= (eq & _strictly_lower(new_ids.shape[1], new_ids.device)[None]).any(dim=2)
    return ~dup


def frontier_filter_ref(nbrs: torch.Tensor, active: torch.Tensor, r: int, beam: torch.Tensor,
                        history: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of K8: the beam step's masks and dedup as
    ``jvector_tpu/graph/searcher.py``'s ``_step`` writes them."""
    valid = (nbrs >= 0) & active.repeat_interleave(r, dim=1)
    nbrs = torch.where(valid, nbrs, -1)
    fresh = valid & _dedup_new(nbrs, beam, history)
    return fresh, torch.where(fresh, nbrs, -1), torch.where(fresh, nbrs, 0)


def plan(c: int, l: int, t: int) -> tuple[int, int]:
    """``(k, tile)`` for C candidates against L beam and T history ids: the
    least power-of-two candidates a lane (at most ``MAX_K``) that covers C
    in one chunk of 32k, and the ids of shared memory a warp, enough for the
    beam and the history each padded to a multiple of 4 (at most
    ``MAX_TILE``: beyond it the kernel walks them through the tile)."""
    lanes = -(-c // 32)
    k = 1 if lanes <= 1 else min(MAX_K, 1 << (lanes - 1).bit_length())
    return k, min(-(-l // 4) * 4 + -(-t // 4) * 4, MAX_TILE) or 4


def frontier_filter(nbrs: torch.Tensor, active: torch.Tensor, r: int, beam: torch.Tensor,
                    history: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(fresh, new_ids, safe_nbrs)`` of one beam step (module docstring):
    ``nbrs [Q, E * r]``, ``beam [Q, L]`` and ``history [Q, T]`` contiguous
    int32, ``active [Q, E]`` contiguous bool, all on one device."""
    try:
        (q, c), (aq, e), (bq, l), (hq, t) = nbrs.shape, active.shape, beam.shape, history.shape
    except ValueError:  # a tensor that is not 2-D
        q = None
    if (q is None or nbrs.dtype != _I32 or beam.dtype != _I32 or history.dtype != _I32 or active.dtype != _BOOL
            or aq != q or bq != q or hq != q or r < 1 or c != e * r):
        raise ValueError(f"frontier_filter: need nbrs [Q, E * R] (R = {r}), beam [Q, L], history [Q, T] int32 "
                         f"and active [Q, E] bool, got {nbrs.dtype} {tuple(nbrs.shape)}, {beam.dtype} "
                         f"{tuple(beam.shape)}, {history.dtype} {tuple(history.shape)}, {active.dtype} "
                         f"{tuple(active.shape)}")
    d = nbrs.get_device()  # -1 off the card
    if d < 0 or active.get_device() != d or beam.get_device() != d or history.get_device() != d:
        devices = {x.device for x in (nbrs, active, beam, history)}
        if len(devices) != 1:
            raise ValueError(f"frontier_filter: tensors on several devices {sorted(map(str, devices))}")
        if nbrs.device.type == "cpu":
            return frontier_filter_ref(nbrs, active, r, beam, history)
        raise ValueError(f"frontier_filter: unsupported device {nbrs.device}")
    if not (nbrs.is_contiguous() and active.is_contiguous() and beam.is_contiguous() and history.is_contiguous()):
        raise ValueError("frontier_filter: every tensor must be contiguous")
    fresh = nbrs.new_empty((q, c), dtype=_BOOL)
    new_ids, safe = torch.empty_like(nbrs), torch.empty_like(nbrs)
    if q and c:
        k, tile = plan(c, l, t)
        err = (_frontier_fn or _entry())(
            nbrs.data_ptr(), active.data_ptr(), beam.data_ptr(), history.data_ptr(), fresh.data_ptr(),
            new_ids.data_ptr(), safe.data_ptr(), q, c, e, r, l, t, k, tile, d, _raw_stream(d))
        if err:
            _build.check(err, "frontier_filter")
        frontier_filter.launches += 1
    return fresh, new_ids, safe


frontier_filter.launches = 0  # kernel launches (CUDA calls only)
