"""K8, the beam step's frontier filter (``ops/kernels/frontier.py``), on the
CPU: the wrapper runs its plain twin there.

Its outputs are held, bit for bit, to the JAX package's composition in
``jvector_tpu/graph/searcher.py`` (``valid & _dedup_new(where(valid, nbrs,
-1), beam, history)``, with ``new_ids`` / ``safe_nbrs`` derived from it)
and to a loop over each row written out here, on inputs whose ids come from
a small range (``chip_smoke.frontier_case``), so that candidates often
repeat a beam id, a history id or an earlier candidate, with -1 in every
input and a row with no active pop.  The wrapper's launch path is read
from the arguments it hands a stand-in C entry; its refusals, and that a
CPU call never builds the kernel, are checked too.  On the card
``tests/test_torch_kernels_cuda.py`` holds the kernel to the twin.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jvector_tpu.graph import searcher as jsearcher
from jvector_tpu_torch.ops.kernels import _build
from jvector_tpu_torch.ops.kernels import frontier as tfr
from test_torch_scatter import _on_card_zero

# (E, R, L, T, Q): every value of each axis appears, the serve shapes' rows
# among them; L + T beyond one tile (MAX_TILE ids) where L = 1,600 or T = 3,200
SHAPES = [
    (1, 8, 30, 128, 1),
    (1, 56, 90, 256, 513),
    (2, 56, 90, 256, 7),
    (2, 8, 1600, 3200, 7),
    (4, 8, 30, 3200, 513),
    (4, 56, 1600, 128, 7),
    (4, 56, 90, 256, 1),
    (2, 56, 30, 128, 513),
    (1, 8, 1600, 256, 1),
    (4, 8, 90, 128, 513),
]


def _loop(nbrs, active, r, beam, history):
    """Each row's filter, candidate by candidate, with Python sets."""
    q, c = nbrs.shape
    fresh = np.zeros((q, c), bool)
    for i in range(q):
        seen = set(beam[i].tolist()) | set(history[i].tolist())
        for j in range(c):
            x = int(nbrs[i, j])
            if x < 0 or not active[i, j // r]:
                continue
            fresh[i, j] = x not in seen
            seen.add(x)
    return fresh, np.where(fresh, nbrs, -1), np.where(fresh, nbrs, 0)


def _jax(nbrs, active, r, beam, history):
    """The JAX package's step: ``valid``, the masked ids, ``_dedup_new``."""
    valid = (jnp.asarray(nbrs) >= 0) & jnp.repeat(jnp.asarray(active), r, axis=1)
    masked = jnp.where(valid, jnp.asarray(nbrs), -1)
    fresh = valid & jsearcher._dedup_new(masked, jnp.asarray(beam), jnp.asarray(history))
    return np.asarray(fresh), np.asarray(jnp.where(fresh, masked, -1)), np.asarray(jnp.where(fresh, masked, 0))


@pytest.mark.parametrize("e, r, l, t, q", SHAPES)
def test_cpu_filter_equals_the_jax_step_and_a_loop(e, r, l, t, q):
    case = chip_smoke.frontier_case(np.random.default_rng(q * 7 + l + t + e * r), q, e, r, l, t)
    nbrs, active, beam, history = case
    got = tfr.frontier_filter(*(torch.as_tensor(x) for x in (nbrs, active)), r,
                              *(torch.as_tensor(x) for x in (beam, history)))
    assert [x.dtype for x in got] == [torch.bool, torch.int32, torch.int32]
    got = [x.numpy() for x in got]
    for want in (_jax(*case[:2], r, *case[2:]), _loop(*case[:2], r, *case[2:])):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    fresh = got[0]
    valid = (nbrs >= 0) & np.repeat(active, r, axis=1)
    assert 0 < fresh.sum() < valid.sum() or q == 1  # some candidates fresh, some valid ones duplicates
    if q > 1:
        assert not fresh[q // 2].any()  # the row with no active pop


@pytest.mark.parametrize(
    "e, r, l, t, q, k, tile",
    [
        (1, 56, 90, 256, 10_000, 2, 92 + 256),  # the BQ cell's serve: beam padded to 92
        (1, 56, 30, 128, 2_496, 2, 32 + 128),  # the SQ4 cell's tail
        (2, 56, 100, 256, 512, 4, 100 + 256),  # the build's wave search
        (1, 56, 1600, 3200, 64, 2, tfr.MAX_TILE),  # filtered widening: walked through the tile
        (1, 8, 1, 128, 3, 1, 4 + 128),  # a beam of one
        (4, 160, 90, 256, 5, tfr.MAX_K, 92 + 256),  # C = 640: two chunks of 512
    ],
)
def test_launch_path_hands_the_entry_its_plan(monkeypatch, e, r, l, t, q, k, tile):
    """The plan, read from the arguments the wrapper hands the C entry: the
    least power-of-two candidates a lane that covers C (at most
    ``MAX_K``), the beam and the history each padded to four ids (at most
    ``MAX_TILE`` ids a warp), and the tensors, shapes, device and stream
    the launch goes to."""
    sent = []
    monkeypatch.setattr(tfr, "_frontier_fn", None)  # bound anew through the stand-in below
    monkeypatch.setattr(_build, "load", lambda *a: SimpleNamespace(jv_frontier=lambda *args: sent.append(args) or 0))
    monkeypatch.setattr(tfr, "_raw_stream", lambda d: 0xC0FFEE)
    monkeypatch.setattr(tfr.frontier_filter, "launches", 0)  # restored after the test: no kernel ran
    nbrs = torch.zeros((q, e * r), dtype=torch.int32)
    active = torch.zeros((q, e), dtype=torch.bool)
    beam, history = torch.zeros((q, l), dtype=torch.int32), torch.zeros((q, t), dtype=torch.int32)
    fresh, new_ids, safe = tfr.frontier_filter(*_on_card_zero(nbrs, active), r, *_on_card_zero(beam, history))
    assert tfr.frontier_filter.launches == 1 and len(sent) == 1
    assert len(sent[0]) == len(tfr._ARGTYPES)
    names = ("nbrs", "active", "beam", "history", "fresh", "new_ids", "safe", "q", "c", "e", "r", "l", "t", "k",
             "tile", "device", "stream")
    assert dict(zip(names, sent[0])) == {
        "nbrs": nbrs.data_ptr(), "active": active.data_ptr(), "beam": beam.data_ptr(),
        "history": history.data_ptr(), "fresh": fresh.data_ptr(), "new_ids": new_ids.data_ptr(),
        "safe": safe.data_ptr(), "q": q, "c": e * r, "e": e, "r": r, "l": l, "t": t, "k": k, "tile": tile,
        "device": 0, "stream": 0xC0FFEE}
    assert (fresh.shape, fresh.dtype, new_ids.shape, safe.dtype) == ((q, e * r), torch.bool, (q, e * r), torch.int32)
    assert tile % 4 == 0 and 4 * tile * 4 <= 48 * 1024  # four warps a block in the default shared memory


@pytest.mark.parametrize("what", ["int64_ids", "float_active", "c_not_e_times_r", "rows_differ", "rank_3",
                                  "meta_device", "mixed_devices"])
def test_refuses_what_the_kernel_does_not_take(monkeypatch, what):
    """Each refusal raises before any launch or build, on the CPU path too."""
    def refuse(*args, **kwargs):
        raise AssertionError("a refused call reached the CUDA build or launcher")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tfr, "_frontier_fn", refuse)
    nbrs, active, beam, history = (torch.as_tensor(x)
                                   for x in chip_smoke.frontier_case(np.random.default_rng(9), 6, 2, 8, 30, 128))
    r = 8
    if what == "int64_ids":
        nbrs = nbrs.long()
    elif what == "float_active":
        active = active.float()
    elif what == "c_not_e_times_r":
        r = 7
    elif what == "rows_differ":
        history = history[:5]
    elif what == "rank_3":
        nbrs = nbrs.view(6, 2, 8)
    elif what == "meta_device":
        nbrs, active, beam, history = (x.to("meta") for x in (nbrs, active, beam, history))
    else:
        beam = beam.to("meta")
    with pytest.raises(ValueError):
        tfr.frontier_filter(nbrs, active, r, beam, history)


def test_cpu_tensors_never_reach_the_kernel_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build or launcher")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(tfr, "_frontier_fn", refuse)
    before = tfr.frontier_filter.launches
    case = chip_smoke.frontier_case(np.random.default_rng(5), 40, 2, 56, 90, 256)
    got = tfr.frontier_filter(*(torch.as_tensor(x) for x in case[:2]), 56, *(torch.as_tensor(x) for x in case[2:]))
    for g, w in zip(got, _loop(*case[:2], 56, *case[2:])):
        np.testing.assert_array_equal(g.numpy(), w)
    assert tfr.frontier_filter.launches == before
