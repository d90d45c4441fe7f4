"""The row-scatter kernels' plain twins (K4a, K4b, K7) against the JAX
package's Pallas kernels in interpret mode and its ``*_ref`` functions,
on the same numpy inputs, with exact equality.

A CPU tensor makes each wrapper run its twin, so the wrappers are called
here as the builder calls them.  Duplicate rows: the TPU kernel's DMAs
land in no fixed order, so a row written twice with different payloads
may hold either (``tests/test_scatter_rows.py``); rows written twice with
identical images, the builder's contract, must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.ops.pallas import scatter_rows as js
from jvector_tpu_torch.ops.kernels import (
    scatter_rows3_inplace,
    scatter_rows_inplace,
    scatter_rows_ref,
    scatter_slots_inplace,
    scatter_slots_ref,
)


def _t(x):
    return torch.as_tensor(np.array(x))


def _random(rng, shape, dtype):
    if dtype == np.float32:
        return rng.normal(size=shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def test_k4a_twin_matches_pallas_interpret():
    """K4a at ``[40, 24, 128]`` u8 (d = 96 build rows): drops on both sides
    of the range and a duplicate row carrying an identical image."""
    rng = np.random.default_rng(0)
    table = rng.integers(0, 256, (40, 24, 128), dtype=np.uint8)
    idx = np.array([3, -1, 10, 40, 3, 0, 39, 2**30, 17], np.int32)
    payload = rng.integers(0, 256, (idx.size, 24, 128), dtype=np.uint8)
    payload[4] = payload[0]  # duplicate row 3, identical image
    want = np.asarray(js.scatter_rows3_inplace(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(payload),
                                               interpret=True))
    got = scatter_rows3_inplace(_t(table), _t(idx), _t(payload))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(js.scatter_rows_nd_auto(jnp.asarray(table), jnp.asarray(idx),
                                                                           jnp.asarray(payload))))
    assert not np.array_equal(want, table)


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.float32], ids=["u8", "i32", "f32"])
def test_k4b_twin_matches_pallas_interpret(dtype):
    """K4b on a 2-D table of each dtype: ``tests/test_scatter_rows.py``'s
    case (a duplicate with different payloads, two drops)."""
    rng = np.random.default_rng(1)
    table = _random(rng, (64, 32), dtype)
    idx = np.array([3, -1, 10, 64, 3, 0], np.int32)
    payload = _random(rng, (6, 32), dtype)
    assert not np.array_equal(payload[0], payload[4])
    got = scatter_rows_inplace(_t(table), _t(idx), _t(payload)).numpy()
    want = np.asarray(js.scatter_rows_inplace(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(payload),
                                              interpret=True))
    ref = np.asarray(js.scatter_rows_ref(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(payload)))
    rest = np.arange(64) != 3
    for other in (want, ref):
        np.testing.assert_array_equal(got[rest], other[rest])
    assert any(np.array_equal(got[3], payload[i]) for i in (0, 4))
    # duplicates with identical images: every row exact
    payload[4] = payload[0]
    got = scatter_rows_ref(_t(table), _t(idx), _t(payload)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.scatter_rows_ref(jnp.asarray(table), jnp.asarray(idx),
                                                                      jnp.asarray(payload))))


@pytest.mark.parametrize(
    "case", ["scatter_rows_cases", "offsets_and_drops", "u8_unaligned"],
)
def test_k7_twin_matches_pallas_interpret(case):
    """K7 (slot scatter): ``tests/test_scatter_rows.py``'s case, offsets at
    every position of an f32 row with drops, and odd u8 slot widths."""
    rng = np.random.default_rng(2)
    if case == "scatter_rows_cases":
        table = rng.normal(size=(40, 24)).astype(np.float32)
        idx, off = np.array([5, 7, -1, 39], np.int32), np.array([0, 8, 4, 16], np.int32)
        payload = rng.normal(size=(4, 8)).astype(np.float32)
    elif case == "offsets_and_drops":
        table = rng.normal(size=(50, 64)).astype(np.float32)
        idx = rng.choice(50, 30, replace=False).astype(np.int32)
        idx[[2, 9]] = [-3, 50]
        off = rng.integers(0, 64 - 12 + 1, 30).astype(np.int32)
        payload = rng.normal(size=(30, 12)).astype(np.float32)
    else:
        table = rng.integers(0, 256, (30, 45), dtype=np.uint8)
        idx = rng.choice(30, 20, replace=False).astype(np.int32)
        off = rng.integers(0, 45 - 7 + 1, 20).astype(np.int32)
        payload = rng.integers(0, 256, (20, 7), dtype=np.uint8)
    args = [jnp.asarray(x) for x in (idx, off, payload)]
    want = np.asarray(js.scatter_slots_inplace(jnp.asarray(table), *args, interpret=True))
    ref = np.asarray(js.scatter_slots_ref(jnp.asarray(table), *args))
    got = scatter_slots_inplace(_t(table), _t(idx), _t(off), _t(payload)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(scatter_slots_ref(_t(table), _t(idx), _t(off), _t(payload)).numpy(), ref)


def test_k7_slot_leaving_its_row_drops_whole():
    """A slot that does not lie inside its row is dropped whole (the kernel
    and the twin agree; the TPU kernel's DMA has no such case)."""
    table = torch.zeros((4, 8))
    idx = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    off = torch.tensor([5, -1, 4, 0], dtype=torch.int32)
    scatter_slots_inplace(table, idx, off, torch.ones((4, 4)))
    assert table[:2].eq(0).all()
    assert table[2, 4:].eq(1).all() and table[2, :4].eq(0).all()
    assert table[3, :4].eq(1).all() and table[3, 4:].eq(0).all()


@pytest.mark.parametrize(
    "call",
    ["rank2_table_to_k4a", "i64_rows", "payload_dtype", "payload_rows", "slot_wider_than_row", "meta_device"],
)
def test_scatter_wrappers_refuse_bad_inputs(call):
    t3 = torch.zeros((4, 2, 128), dtype=torch.uint8)
    t2 = torch.zeros((4, 8))
    i = torch.tensor([0, 1], dtype=torch.int32)
    with pytest.raises(ValueError):
        if call == "rank2_table_to_k4a":
            scatter_rows3_inplace(t2, i, torch.zeros((2, 8)))
        elif call == "i64_rows":
            scatter_rows3_inplace(t3, i.long(), torch.zeros((2, 2, 128), dtype=torch.uint8))
        elif call == "payload_dtype":
            scatter_rows_inplace(t2, i, torch.zeros((2, 8), dtype=torch.float64))
        elif call == "payload_rows":
            scatter_rows_inplace(t2, i, torch.zeros((3, 8)))
        elif call == "slot_wider_than_row":
            scatter_slots_inplace(t2, i, i, torch.zeros((2, 9)))
        else:
            scatter_rows_inplace(t2.to("meta"), i.to("meta"), torch.zeros((2, 8), device="meta"))
