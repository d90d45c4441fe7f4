"""K5's summation order and launch plan on the CPU.

``adc_score_ordered`` (the twin whose order the K5 kernel keeps: one
float32 accumulator a candidate, m ascending) against the Pallas kernel
in interpret mode, bit for bit: each subspace's one-hot sum over K adds
one table entry to zeros, which is exact, and the Pallas loop over m is
ascending.  And the wrapper's planner (``ops/kernels/adc.py``) at every
``chip_smoke.K5_SHAPES`` shape and at M = 48, 64 and 96: shared memory
within Hopper's opt-in limit, a ring at least two deep wherever two
tables fit, and every (q, c) scored exactly once by the persistent walk.
The kernel itself runs only on the card (``test_torch_kernels_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from jvector_tpu.ops.pallas.adc_kernel import adc_score_pallas
from jvector_tpu_torch.ops.adc import adc_score_ordered
from jvector_tpu_torch.ops.kernels import adc as kadc


@pytest.mark.parametrize(
    "q, c, m, k, shared",
    [(6, 40, 16, 256, False), (5, 56, 24, 256, False), (13, 19, 5, 32, False), (3, 20, 64, 256, False),
     (4, 33, 16, 256, True)],
    ids=["m16", "m24", "m5_k32", "m64", "shared_table"],
)
def test_ordered_twin_equals_pallas_bit_for_bit(q, c, m, k, shared):
    rng = np.random.default_rng(q * c + m)
    tables = (rng.normal(size=(1 if shared else q, m, k)) * 30).astype(np.float32)
    luts = np.broadcast_to(tables, (q, m, k))
    codes = rng.integers(0, k, (q, c, m)).astype(np.uint8)
    got = adc_score_ordered(torch.from_numpy(tables).expand(q, -1, -1), torch.from_numpy(codes)).numpy()
    want = np.asarray(adc_score_pallas(jnp.asarray(luts), jnp.asarray(codes), interpret=True))
    assert np.array_equal(got, want)


def _covered(p: dict, q: int, c: int) -> np.ndarray:
    """How many times the kernel's walk scores each (q, c) under plan ``p``:
    block b takes items b, b + blocks, ...; item i is query i // split,
    candidates [(i % split) * slice, + slice) cut at c, one consumer thread
    a candidate, ``threads - 32`` of them striding the slice (``threads``
    off a shared table, whose block has no producer warp)."""
    hits = np.zeros(q * c, np.int64)
    nct = p.threads if p.shared else p.threads - 32
    for b in range(p.blocks):
        for item in range(b, q * p.split, p.blocks):
            lo = (item % p.split) * p.slice
            hi = min(c, lo + p.slice)
            for ct in range(min(nct, max(0, hi - lo))):
                hits[(item // p.split) * c + np.arange(lo + ct, hi, nct)] += 1
    return hits


PLAN_SHAPES = {**chip_smoke.K5_SHAPES, "m48": (64, 40, 48, 256), "m64": (3, 40, 64, 256), "m96": (300, 40, 96, 256),
               "m300_chunked": (5, 40, 300, 256)}


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
@pytest.mark.parametrize("shared", [False, True], ids=["own_tables", "shared_table"])
def test_plan_fits_and_covers_every_candidate(name, shared):
    q, c, m, k = PLAN_SHAPES[name]
    p = kadc.plan(q, c, m, k, shared=shared)
    stage = -(-p.m_chunk * k // 32) * 128
    assert p.smem == kadc.BAR_BYTES + p.stages * stage <= 232_448
    assert 1 <= p.stages <= kadc.MAX_STAGES
    if kadc.BAR_BYTES + 2 * stage <= 232_448 and not p.shared:
        assert p.stages >= 2
    assert p.shared == (shared and p.n_chunks == 1)
    if p.n_chunks > 1:  # only tables beyond one block's shared memory are cut, into whole code vectors
        assert kadc.BAR_BYTES + m * k * 4 > 232_448 and p.m_chunk % 16 == 0
    assert m % p.vec == 0 and p.m_chunk % p.vec == 0
    assert p.threads % 32 == 0 and (32 if p.shared else 64) <= p.threads <= 288
    assert 1 <= p.blocks <= q * p.split and p.split * p.slice >= c
    assert (_covered(p, q, c) == 1).all()


def test_plan_reads_alignment():
    """Codes off a 16-byte boundary take 8-byte or byte loads; tables off it
    take the cp.async copies instead of the bulk copy."""
    assert kadc.plan(1024, 56, 24, 256).vec == 8
    assert kadc.plan(1024, 56, 16, 256, code_align=8).vec == 8
    assert kadc.plan(1024, 56, 16, 256, code_align=1).vec == 1
    assert kadc.plan(13, 19, 5, 32).vec == 1
    assert kadc.plan(1024, 56, 16, 256).bulk and not kadc.plan(1024, 56, 16, 256, lut_aligned=False).bulk
    assert not kadc.plan(9, 33, 5, 10).bulk  # 200-byte tables


def test_plan_for_shares_the_table_of_one_query():
    """A query stride of 0, or a single query, plans one table copied once a
    block; the wrapper's own tensors decide alignment."""
    luts, codes = torch.zeros((1, 16, 256)), torch.zeros((1, 70_000, 16), dtype=torch.uint8)
    assert kadc.plan_for(luts, codes).shared
    assert kadc.plan_for(torch.zeros((1, 16, 256)).expand(8, -1, -1), codes.expand(8, -1, -1)).shared
    assert not kadc.plan_for(torch.zeros((8, 16, 256)), torch.zeros((8, 56, 16), dtype=torch.uint8)).shared
