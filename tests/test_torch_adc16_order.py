"""K6's summation order and launch plan on the CPU.

``adc16_ordered`` (the twin whose order the K6 kernel keeps: one float32
accumulator a candidate, j ascending, the smaller nibble's entry first,
the low one on a tie) against the Pallas kernel in interpret mode, bit for
bit: the Pallas loop over k adds each entry where its nibble equals k and
exact zeros elsewhere, and its MP padding adds zeros.  ``adc16_ref``'s
single-term sum is not that order on the same inputs.  The wrapper's
planner (``ops/kernels/adc16.py``) at every ``chip_smoke.K6_SHAPES`` shape
and its corners: shared memory within a block's 48 KB, whole warps an item
(or one thread a candidate at C <= 4), and every (q, c) scored exactly
once by the kernel's walk, with one and with two candidates a thread; the
arguments the wrapper hands the C entry; CPU tensors never reach the
build.  The kernel itself runs only on the card
(``test_torch_kernels_cuda.py``).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jvector_tpu.ops.pallas.adc16_kernel import adc16_pallas
from jvector_tpu_torch.ops.adc16 import adc16_ordered, adc16_ref
from jvector_tpu_torch.ops.kernels import _build
from jvector_tpu_torch.ops.kernels import adc16 as kadc16


def _case(q: int, mp: int, c: int, shared: bool):
    rng = np.random.default_rng(q * c + mp)
    tables = (rng.normal(size=(1 if shared else q, mp, 32)) * 30).astype(np.float32)
    codes = rng.integers(0, 256, (q, mp, c)).astype(np.uint8)
    return tables, codes


@pytest.mark.parametrize(
    "q, mp, c, shared",
    [(12, 13, 70, False), (12, 16, 70, False), (9, 24, 64, False), (12, 32, 70, False), (10, 16, 33, True)],
    ids=["mp13", "mp16", "mp24", "mp32", "shared_table"],
)
def test_ordered_twin_equals_pallas_bit_for_bit(q, mp, c, shared):
    tables, codes = _case(q, mp, c, shared)
    luts = np.broadcast_to(tables, (q, mp, 32))
    want = np.asarray(adc16_pallas(jnp.asarray(luts), jnp.asarray(codes), interpret=True))
    got = adc16_ordered(torch.from_numpy(tables).expand(q, -1, -1), torch.from_numpy(codes)).numpy()
    assert np.array_equal(got, want)
    # adc16_ref adds (lo + hi) as one term: another order, which rounds
    # differently at most outputs of these tables
    ref = adc16_ref(torch.from_numpy(tables).expand(q, -1, -1), torch.from_numpy(codes)).numpy()
    assert (ref != want).mean() > 0.5
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=1e-3)


def _covered(p: kadc16.Plan, q: int, c: int) -> np.ndarray:
    """How many times the kernel's walk scores each (q, c) under plan ``p``:
    block b takes item groups b, b + blocks, ...; group g holds items
    g * qpb + s (s < qpb); item i is query i // tiles and candidates
    [(i % tiles) * tpq * v, + tpq * v), thread t of the item taking v of
    them from (i % tiles) * tpq * v + t * v, if that is below C."""
    hits = np.zeros((q, c), np.int64)
    if p.direct:  # thread i of the grid takes candidate i of the [Q, C] output, if i < Q * C
        np.add.at(hits.reshape(-1), np.arange(min(p.blocks * p.tpq, q * c)), 1)
        return hits
    items = q * p.tiles
    n_groups = -(-items // p.qpb)
    lane = np.arange(p.tpq)[:, None] * p.v + np.arange(p.v)[None, :]  # [tpq, v]
    for b in range(p.blocks):
        for g in range(b, n_groups, p.blocks):
            for s in range(p.qpb):
                item = g * p.qpb + s
                if item >= items:
                    continue
                cols = (item % p.tiles) * p.tpq * p.v + lane
                first = cols[:, 0] < c  # a thread takes its v candidates when its first one is below C
                np.add.at(hits[item // p.tiles], cols[first].ravel(), 1)
    return hits


PLAN_SHAPES = {
    **{name: shape for name, shape in chip_smoke.K6_SHAPES.items()},
    "mp_chunks_c_tiles": (2, 400, 300, False),
    "shared_table_in_chunks": (3, 900, 40, True),
    "one_query_wide": (1, 32, 5000, True),
    "c33_shared": (300, 16, 33, True),
    "c4_words": (40_000, 16, 4, False),
    "c5": (300, 16, 5, False),
    "c1_shared": (4096, 32, 1, True),
}


# the planner's thresholds set so that every shape takes the staged kernel
# with one candidate a thread (bytes), or two wherever C and the codes'
# address are even (half_words), beside the wrapper's own choice
PLAN_KNOBS = {"wrapper": {}, "bytes": {"DIRECT_MAX_C": 0, "WIDE_MIN_THREADS": 1 << 62},
              "half_words": {"DIRECT_MAX_C": 0, "WIDE_MIN_THREADS": 0}}


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
@pytest.mark.parametrize("knobs", list(PLAN_KNOBS))
def test_plan_fits_and_covers_every_candidate(monkeypatch, name, knobs):
    for knob, value in PLAN_KNOBS[knobs].items():
        monkeypatch.setattr(kadc16, knob, value)
    q, mp, c, shared = PLAN_SHAPES[name]
    p = kadc16.plan(q, mp, c, shared=shared)
    assert p.direct == (c <= kadc16.DIRECT_MAX_C)
    if knobs != "wrapper":
        assert p.v == (2 if knobs == "half_words" and c % 2 == 0 else 1)
    if p.direct:  # one thread a candidate, whole warps a block, the grid covering Q * C with no block to spare
        assert p.smem == 0 and p.tpq in (32, kadc16.THREADS) and p.blocks * p.tpq >= q * c > (p.blocks - 1) * p.tpq
        assert p.blocks >= min(2 * kadc16.SMS, -(-q * c // 32))
        assert (_covered(p, q, c) == 1).all()
        return
    assert p.smem == kadc16.smem_bytes(c, p.qpb, p.rows, p.stage_codes, p.shared) <= kadc16.SMEM
    assert p.shared == (shared and kadc16.smem_bytes(c, 1, mp, False, True) <= kadc16.SMEM)
    # only one query's tables come in chunks, of whole 8-row groups
    assert p.rows == mp or (p.qpb == 1 and not p.shared and p.rows % 8 == 0 and 8 <= p.rows < mp)
    # whole warps an item: a warp gathers from one table
    assert p.tpq % 32 == 0 and 32 <= p.tpq * p.qpb <= kadc16.MAX_THREADS
    if p.stage_codes:  # whole queries' code rows in one 16-byte bulk copy
        assert p.tiles == 1 and c % 16 == 0
    assert p.v in (1, 2) and c % p.v == 0
    items = q * p.tiles
    assert p.tiles * p.tpq * p.v >= c > (p.tiles - 1) * p.tpq * p.v
    groups = -(-items // p.qpb)
    assert p.blocks == (min(groups, kadc16.SMS * kadc16.SHARED_BLOCKS_PER_SM) if p.shared else groups)
    assert p.blocks >= min(2 * kadc16.SMS, items)  # the grid fills the card where there are items enough
    assert (_covered(p, q, c) == 1).all()


def test_plan_reads_alignment_and_sharing():
    """Codes off a 16-byte boundary, or C not a multiple of 16: code rows
    are read from device memory, not copied beside the tables; a thread
    takes two candidates only on a large grid, where C and the codes'
    address are even; one query, or a query stride of 0, shares the table,
    unless it outgrows a block's 48 KB; C <= 4 gathers directly."""
    assert kadc16.plan(4096, 32, 64).stage_codes
    assert kadc16.plan(4096, 32, 64).v == 2 and kadc16.plan(256, 32, 64).v == 1  # two chains only on large grids
    assert kadc16.plan(4096, 32, 1).direct and not kadc16.plan(4096, 32, 5).direct
    assert not kadc16.plan(4096, 32, 64, code_align=4).stage_codes
    assert not kadc16.plan(4096, 32, 70).stage_codes
    assert kadc16.plan(4096, 32, 64, code_align=1).v == 1 and kadc16.plan(4096, 32, 65).v == 1
    assert kadc16.plan(4096, 32, 66).v == 2 and kadc16.plan(1024, 32, 64).v == 2  # the recall waves take two
    assert kadc16.plan(4096, 32, 64, shared=True).shared and not kadc16.plan(3, 900, 40, shared=True).shared
    luts, codes = torch.zeros((1, 32, 32)), torch.zeros((1, 32, 64), dtype=torch.uint8)
    assert kadc16.plan_for(luts, codes).shared
    assert kadc16.plan_for(torch.zeros((1, 32, 32)).expand(8, -1, -1), codes.expand(8, -1, -1).contiguous()).shared
    assert not kadc16.plan_for(torch.zeros((8, 32, 32)), torch.zeros((8, 32, 64), dtype=torch.uint8)).shared


def _on_card_zero(*tensors):
    """CPU tensors that report card 0: the wrapper then takes its launch
    path (checks, plan, the C entry's arguments) as on a card."""
    for t in tensors:
        t.get_device = lambda: 0
    return tensors


@pytest.mark.parametrize("q, mp, c, shared", [(4096, 32, 64, False), (256, 32, 64, False), (64, 32, 64, True),
                                              (1, 24, 70, False), (4096, 32, 1, False)])
def test_wrapper_hands_the_plan_to_the_c_entry(monkeypatch, q, mp, c, shared):
    """The arguments the wrapper passes to the bound C entry: the tensors,
    the query stride (0 for a shared table or one query), the shape, the
    plan, the device and the stream; one launch counted, and one for the
    shape."""
    sent = []
    monkeypatch.setattr(kadc16, "_adc16_fn", None)  # bound anew through the stand-in below
    monkeypatch.setattr(_build, "load", lambda *a: SimpleNamespace(jv_adc16=lambda *args: sent.append(args) or 0))
    monkeypatch.setattr(kadc16, "_raw_stream", lambda d: 0xC0FFEE)
    monkeypatch.setattr(kadc16.adc16_score_kernel, "launches", 0)  # restored after the test: no kernel ran
    monkeypatch.setattr(kadc16.adc16_score_kernel, "by_shape", type(kadc16.adc16_score_kernel.by_shape)())
    luts = torch.zeros((1, mp, 32)).expand(q, -1, -1) if shared else torch.zeros((q, mp, 32))
    codes = torch.zeros((q, mp, c), dtype=torch.uint8)
    out = kadc16.adc16_score_kernel(*_on_card_zero(luts, codes))
    assert out.shape == (q, c) and out.dtype == torch.float32 and len(sent) == 1
    assert len(sent[0]) == len(kadc16._ARGTYPES)
    p = kadc16.plan(q, mp, c, shared=shared or q == 1)
    got = dict(zip(("luts", "stride", "codes", "out", "q", "mp", "c", "plan", "device", "stream"), sent[0]))
    assert list(got.pop("plan")) == list(p.c_plan())
    assert got == {"luts": luts.data_ptr(), "stride": 0 if shared or q == 1 else mp * 32,
                   "codes": codes.data_ptr(), "out": out.data_ptr(), "q": q, "mp": mp, "c": c, "device": 0,
                   "stream": 0xC0FFEE}
    assert kadc16.adc16_score_kernel.launches == 1
    assert dict(kadc16.adc16_score_kernel.by_shape) == {(q, mp, c): 1}


@pytest.mark.parametrize(
    "call",
    ["codes_int32", "rows_of_16", "codes_strided", "codes_rows", "luts_rank2", "luts_f64", "codes_off_card"],
)
def test_wrapper_refuses_before_any_launch(monkeypatch, call):
    """Each call the kernel does not take raises before the C entry is
    reached."""
    def refuse(*args, **kwargs):
        raise AssertionError("a refused call reached the C entry")

    monkeypatch.setattr(kadc16, "_adc16_fn", refuse)
    luts, codes = torch.zeros((8, 32, 32)), torch.zeros((8, 32, 64), dtype=torch.uint8)
    bad = {"codes_int32": (luts, codes.to(torch.int32)), "rows_of_16": (luts[:, :, :16].contiguous(), codes),
           "codes_strided": (luts, codes.transpose(1, 2).contiguous().transpose(1, 2)),
           "codes_rows": (luts, codes[:, :31].contiguous()), "luts_rank2": (luts[0], codes),
           "luts_f64": (luts.double(), codes), "codes_off_card": (luts, codes)}[call]
    _on_card_zero(bad[0]) if call == "codes_off_card" else _on_card_zero(*bad)
    with pytest.raises(ValueError):
        kadc16.adc16_score_kernel(*bad)


def test_cpu_tensors_run_adc16_ref_without_the_build(monkeypatch):
    """A CPU tensor runs ``adc16_ref`` (the CPU suite's results and times
    stay as they were), launches nothing and never builds or binds the
    CUDA library."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call reached the CUDA build or launcher")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(kadc16, "_adc16_fn", refuse)
    tables, codes = _case(7, 24, 40, False)
    luts, cd = torch.from_numpy(tables), torch.from_numpy(codes)
    before, shapes = kadc16.adc16_score_kernel.launches, dict(kadc16.adc16_score_kernel.by_shape)
    assert torch.equal(kadc16.adc16_score_kernel(luts, cd), adc16_ref(luts, cd))
    assert kadc16.adc16_score_kernel.launches == before
    assert dict(kadc16.adc16_score_kernel.by_shape) == shapes
