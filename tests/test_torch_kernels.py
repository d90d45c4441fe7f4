"""K1 (packed adjacency), K3 (packed adjacency without w2) and K2 (fused
code table) in-place updates.

On the CPU the port's wrappers run their plain twins; these must equal the
JAX package's references and its Pallas kernels in interpret mode, byte for
byte: dropped rows, runs of patches to one row (including a run straddling
the TPU kernel's chunk boundary), patches on wave rows, and enforce images
that win.  The kernel-vs-twin tests are in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from jvector_tpu.ops.pallas import packed_adj as jpa
from jvector_tpu.ops.pallas import scatter_rows as jsr
from jvector_tpu_torch.ops.kernels import packed_adj as tpa
from jvector_tpu_torch.ops.kernels import scatter_rows as tsr
from test_torch_kernels_cuda import _k1_straddling_case, _k2_case, _k3_args, _t


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
