"""K1 (packed adjacency), K3 (packed adjacency without w2) and K2 (fused
code table) in-place updates.

On the CPU the port's wrappers run their plain twins; these must equal the
JAX package's references and its Pallas kernels in interpret mode, byte for
byte: dropped rows, runs of patches to one row (including a run straddling
the TPU kernel's chunk boundary), patches on every wave row, enforce images
on wave rows that win, and K2's drop markers inside the sorted stream as
the builder emits them.  The kernel-vs-twin tests are in
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.ops.pallas import packed_adj as jpa
from jvector_tpu.ops.pallas import scatter_rows as jsr
from jvector_tpu_torch.ops.kernels import packed_adj as tpa
from jvector_tpu_torch.ops.kernels import scatter_rows as tsr
from test_torch_kernels_cuda import _DROP, _k1_straddling_case, _k1_wave_case, _k2_case, _k2_wave_case, _k3_args, _t


def test_k1_twin_matches_jax_reference_and_interpret_kernel():
    adj, w2t, args = _k1_straddling_case(0)
    ta, tw = _t(adj), _t(w2t)
    tpa.packed_adj_update_inplace(ta, tw, *(_t(a) for a in args))  # CPU -> twin
    ra, rw = jpa.packed_adj_update_ref(jnp.asarray(adj), jnp.asarray(w2t), *map(jnp.asarray, args))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
    ka, kw = jpa.packed_adj_update_inplace(
        jnp.asarray(adj), jnp.asarray(w2t), *map(jnp.asarray, args), interpret=True
    )
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ka))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(kw))
    assert tpa.packed_adj_update_inplace.launches == 0  # the twin is not a launch


def test_k3_twin_matches_jax_reference_and_interpret_kernel():
    adj, _, args = _k1_straddling_case(0)
    args = _k3_args(args)
    ta = _t(adj)
    tpa.packed_adj_only_update_inplace(ta, *(_t(a) for a in args))  # CPU -> twin
    ref = jpa.packed_adj_only_update_ref(jnp.asarray(adj), *map(jnp.asarray, args))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ref))
    kern = jpa.packed_adj_only_update_inplace(jnp.asarray(adj), *map(jnp.asarray, args), interpret=True)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(kern))
    assert (ta.numpy() != adj).any()
    assert tpa.packed_adj_only_update_inplace.launches == 0  # the twin is not a launch


def test_k2_twin_matches_jax_reference_and_interpret_kernel():
    table, args = _k2_case(1)
    wave_rows, wave_img, rows, slots, src, er_rows, er_img = args
    mp = src.shape[1]
    got = tsr.fused_update_inplace(_t(table), *(_t(a) for a in args))  # CPU -> twin
    want = jsr.fused_update_ref(
        jnp.asarray(table), jnp.asarray(wave_rows), jnp.asarray(wave_img), jnp.asarray(rows),
        jnp.asarray(slots * mp), jnp.asarray(slots * mp + mp), jnp.asarray(src),
        jnp.asarray(er_rows), jnp.asarray(er_img),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[30] == er_img[0]).all()  # the enforce image wins
    # the TPU kernel with a 64-patch chunk: runs straddle chunk boundaries
    q, lo, hi, last, img = jsr.fused_update_patch_meta(
        jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(src), mp, 64, table.shape[1]
    )
    kern = jsr.fused_update_inplace(
        jnp.asarray(table), jnp.asarray(wave_rows), jnp.asarray(wave_img), jnp.asarray(rows),
        q, lo, hi, last, img, jnp.asarray(er_rows), jnp.asarray(er_img),
        interpret=True, chunk_hint=64,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    assert tsr.fused_update_inplace.launches == 0


@pytest.mark.parametrize("mp", [16, 64])
def test_k2_twin_small_slots(mp):
    """MP = 16 (d = 32) slot patches: the byte range follows the slot index."""
    table, args = _k2_case(2, t3=8, mp=mp)
    wave_rows, wave_img, rows, slots, src, er_rows, er_img = args
    got = tsr.fused_update_ref(_t(table), *(_t(a) for a in args))
    want = jsr.fused_update_ref(
        jnp.asarray(table), jnp.asarray(wave_rows), jnp.asarray(wave_img), jnp.asarray(rows),
        jnp.asarray(slots * mp), jnp.asarray(slots * mp + mp), jnp.asarray(src),
        jnp.asarray(er_rows), jnp.asarray(er_img),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("w2", [True, False], ids=["k1", "k3"])
def test_k1_k3_twins_match_jax_with_patches_on_every_wave_row(w2):
    """Every wave row takes appends and some take enforce sublane images:
    the patches land over the wave image and the enforce image wins."""
    adj, w2t, args = _k1_wave_case(5)
    a_rows, prow, img = args[0], args[3], args[9]
    assert all(((prow == r) & (img < 0)).any() for r in a_rows if r >= 0)
    assert np.isin(prow[img >= 0], a_rows).any()
    if w2:
        ta, tw = _t(adj), _t(w2t)
        tpa.packed_adj_update_inplace(ta, tw, *(_t(a) for a in args))  # CPU -> twin
        for want in (
            jpa.packed_adj_update_ref(jnp.asarray(adj), jnp.asarray(w2t), *map(jnp.asarray, args)),
            jpa.packed_adj_update_inplace(jnp.asarray(adj), jnp.asarray(w2t), *map(jnp.asarray, args),
                                          interpret=True),
        ):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(tw.numpy(), np.asarray(want[1]))
    else:
        args = _k3_args(args)
        ta = _t(adj)
        tpa.packed_adj_only_update_inplace(ta, *(_t(a) for a in args))
        for want in (
            jpa.packed_adj_only_update_ref(jnp.asarray(adj), *map(jnp.asarray, args)),
            jpa.packed_adj_only_update_inplace(jnp.asarray(adj), *map(jnp.asarray, args), interpret=True),
        ):
            np.testing.assert_array_equal(ta.numpy(), np.asarray(want))
    assert (ta.numpy()[a_rows[a_rows >= 0]] != adj[a_rows[a_rows >= 0]]).any()


@pytest.mark.parametrize("tail", [-1, _DROP], ids=["jax_minus_one_tail", "port_drop_tail"])
def test_k2_twin_matches_jax_with_drops_inside_runs(tail):
    """-1 inside the row-sorted stream (an enforce row's whole run, overflow
    tails) as the builder emits it, a tail of invalid entries, patches on
    every wave row that is not an enforce row, enforce rows on wave rows."""
    table, args = _k2_wave_case(6, tail=tail)
    wave_rows, wave_img, rows, slots, src, er_rows, er_img = args
    mp = src.shape[1]
    inside = rows[: np.flatnonzero(rows >= 0)[-1]]
    assert (inside == -1).any() and (rows[-5:] == tail).all()
    assert all((rows == r).any() for r in wave_rows if r >= 0 and r not in er_rows)
    got = tsr.fused_update_inplace(_t(table), *(_t(a) for a in args))  # CPU -> twin
    want = jsr.fused_update_ref(
        jnp.asarray(table), jnp.asarray(wave_rows), jnp.asarray(wave_img), jnp.asarray(rows),
        jnp.asarray(slots * mp), jnp.asarray(slots * mp + mp), jnp.asarray(src),
        jnp.asarray(er_rows), jnp.asarray(er_img),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q, lo, hi, last, img = jsr.fused_update_patch_meta(
        jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(src), mp, 64, table.shape[1]
    )
    kern = jsr.fused_update_inplace(
        jnp.asarray(table), jnp.asarray(wave_rows), jnp.asarray(wave_img), jnp.asarray(rows),
        q, lo, hi, last, img, jnp.asarray(er_rows), jnp.asarray(er_img), interpret=True, chunk_hint=64,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern))
    assert (got.numpy()[wave_rows[2]] == er_img[0]).all()  # the enforce image wins on a wave row


def _assert_stream_contract(rows, n: int, what: str):
    """The patch-stream contract of the one-owner kernels
    (``csrc/row_owner.cuh``): int32, in-range rows sorted, negative drops
    anywhere, drops >= n only after every in-range row."""
    assert rows.dtype == torch.int32, f"{what}: {rows.dtype}"
    r = rows.numpy()
    live = (r >= 0) & (r < n)
    assert (np.diff(r[live]) >= 0).all(), f"{what}: in-range rows not sorted"
    if live.any():
        assert (r[: np.flatnonzero(live)[-1]] < n).all(), f"{what}: a drop >= n before an in-range row"


@pytest.mark.parametrize("loop", ["packed", "fused_slot_patch"])
def test_builder_streams_meet_the_kernels_contract(loop, monkeypatch):
    """Every K1 / K2 call of a CPU build gets int32 streams in the order the
    kernels' row owners rely on (the twins accept more): the packed loop
    (K1 + K2) and the unpacked fused loop's slot patches (K2)."""
    from jvector_tpu_torch.graph import GraphConfig, build_graph
    from jvector_tpu_torch.graph import builder as tb

    seen = {"k1": 0, "k2": 0}

    def k1(adj, w2t, *args):
        for x in args:
            assert x.dtype == torch.int32
        _assert_stream_contract(args[3], adj.shape[0], "K1 p_prow")
        seen["k1"] += 1
        return tpa.packed_adj_update_inplace(adj, w2t, *args)

    def k2(table, wave_rows, wave_img, patch_rows, patch_slots, patch_src, er_rows, er_img):
        for x in (wave_rows, patch_slots, er_rows):
            assert x.dtype == torch.int32
        _assert_stream_contract(patch_rows, table.shape[0], "K2 patch_rows")
        seen["k2"] += 1
        return tsr.fused_update_inplace(table, wave_rows, wave_img, patch_rows, patch_slots, patch_src, er_rows, er_img)

    monkeypatch.setattr(tb, "packed_adj_update_inplace", k1)
    monkeypatch.setattr(tb, "fused_update_inplace", k2)
    rng = np.random.default_rng(8)
    if loop == "packed":
        base, cfg = rng.normal(size=(2048, 32)).astype(np.float32), GraphConfig(max_degree=16, ef_construction=32,
                                                                                 wave_size=256)
    else:
        base, cfg = rng.normal(size=(400, 32)).astype(np.float32), GraphConfig(wave_size=64)
    build_graph(torch.as_tensor(base), "euclidean", cfg, device="cpu")
    assert seen["k2"] > 0 and (seen["k1"] > 0) == (loop == "packed")
