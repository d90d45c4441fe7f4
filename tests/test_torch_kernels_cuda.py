"""K1, K2, K3, K4a, K4b, K5, K6 and K7 kernels against their plain twins on
a CUDA device.

The kernels have no CPU mode: without a card these tests skip, and
``chip_smoke.py`` runs the same comparison at the main-path shapes.  This
file imports no JAX, so on the GPU host it runs alone:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

The numpy case generators here also feed the CPU parity tests in
``test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from jvector_tpu_torch.ops.adc import adc_score
from jvector_tpu_torch.ops.adc16 import adc16_ref
from jvector_tpu_torch.ops.kernels import adc as tadc
from jvector_tpu_torch.ops.kernels import adc16 as tadc16
from jvector_tpu_torch.ops.kernels import packed_adj as tpa
from jvector_tpu_torch.ops.kernels import scatter_rows as tsr


def _t(x, device="cpu"):
    return torch.as_tensor(np.array(x), device=device)


def _k1_case(seed: int, n_pr: int = 40, p: int = 512, e: int = 16):
    """A K1 wave: 3 wave images (one dropped), a sorted patch stream of
    distinct (row, sublane, slot) appends in runs (one run straddles the
    TPU's 256-patch chunk), enforce images on rows no append touches, and
    dropped patches at the end."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(-(2**31), 2**31 - 1, (n_pr, 8, 128)).astype(np.int32)
    w2t = rng.integers(-(2**31), 2**31 - 1, (n_pr, 8, 128)).astype(np.int32)
    a_rows = np.array([4, -1, 5, n_pr], np.int32)
    a_adj = rng.integers(-(2**31), 2**31 - 1, (4, 8, 128)).astype(np.int32)
    a_w2 = rng.integers(-(2**31), 2**31 - 1, (4, 8, 128)).astype(np.int32)
    logical = rng.permutation(n_pr * 8)
    er_logical = logical[:e]
    app_logical = logical[e : e + 200]
    keys, slots = [], []
    for lr in app_logical:
        k = int(rng.integers(1, 5))
        keys += [lr] * k
        slots += list(rng.permutation(64)[:k])
    n_app = p - e - 20
    keys = np.array(keys[:n_app] + [2**30] * 20, np.int64)  # 20 dropped
    slots = np.array(slots[:n_app] + [0] * 20, np.int32)
    m_key = np.concatenate([keys, er_logical]).astype(np.int32)
    m_slot = np.concatenate([slots, np.zeros(e, np.int32)])
    m_img = np.concatenate([np.full(p - e, -1, np.int32), np.arange(e, dtype=np.int32)])
    order = np.argsort(m_key, kind="stable")
    m_key, m_slot, m_img = m_key[order], m_slot[order], m_img[order]
    prow = np.where(m_key < n_pr * 8, m_key >> 3, 2**30).astype(np.int32)
    assert prow[255] == prow[256]  # a run straddles the TPU chunk boundary
    rnd = lambda *s: rng.integers(-(2**31), 2**31 - 1, s).astype(np.int32)  # noqa: E731
    args = (
        a_rows, a_adj, a_w2, prow, (m_key & 7).astype(np.int32), m_slot,
        rnd(p), rnd(p), rnd(p), m_img, rnd(e, 128), rnd(e, 128),
    )
    return adj, w2t, args


def _k1_straddling_case(seed):
    for s in range(seed, seed + 200):
        try:
            return _k1_case(s)
        except AssertionError:
            continue
    raise AssertionError("no seed gives a chunk-straddling run")


def _k3_args(k1_args: tuple) -> tuple:
    """K3's arguments from a K1 case: the same streams without the w2 parts."""
    a_rows, a_adj, _, prow, sub, slot, p_id, p_sc, _, img, e_adj, _ = k1_args
    return a_rows, a_adj, prow, sub, slot, p_id, p_sc, img, e_adj


def _k2_case(seed: int, n: int = 48, t3: int = 8, mp: int = 64):
    """A K2 wave: wave rows (one dropped), row-sorted slot patches in runs
    (some on wave rows, a dropped tail), and enforce rows that also hit a
    wave row and repeat with identical images."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (n, t3, 128)).astype(np.uint8)
    wave_rows = np.array([2, 7, -1, 30, n], np.int32)
    wave_img = rng.integers(0, 256, (5, t3, 128)).astype(np.uint8)
    rows, slots = [], []
    for r in (2, 3, 7, 11, 12, 20, 21, 22, 40):
        k = int(rng.integers(3, 14))
        rows += [r] * k
        slots += list(rng.permutation(t3 * 128 // mp)[:k])
    rows[-1] = -1
    p_src = rng.integers(0, 256, (len(rows), mp)).astype(np.uint8)
    er_rows = np.array([30, -1, 9, 30], np.int32)
    er_img = rng.integers(0, 256, (4, t3, 128)).astype(np.uint8)
    er_img[3] = er_img[0]  # duplicate enforce rows carry identical images
    return table, (wave_rows, wave_img, np.array(rows, np.int32), np.array(slots, np.int32), p_src, er_rows, er_img)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); chip_smoke.py runs this check")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_kernel_matches_twin_on_card(cuda_device):
    adj, w2t, args = _k1_straddling_case(3)
    dev_args = [_t(a, cuda_device) for a in args]
    ka, kw = _t(adj, cuda_device), _t(w2t, cuda_device)
    before = tpa.packed_adj_update_inplace.launches
    tpa.packed_adj_update_inplace(ka, kw, *dev_args)
    ra, rw = tpa.packed_adj_update_ref(_t(adj, cuda_device), _t(w2t, cuda_device), *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and torch.equal(kw, rw)
    assert tpa.packed_adj_update_inplace.launches == before + 1


@pytest.mark.cuda
def test_k3_kernel_matches_twin_on_card(cuda_device):
    adj, _, args = _k1_straddling_case(3)
    dev_args = [_t(a, cuda_device) for a in _k3_args(args)]
    ka = _t(adj, cuda_device)
    before = tpa.packed_adj_only_update_inplace.launches
    tpa.packed_adj_only_update_inplace(ka, *dev_args)
    ra = tpa.packed_adj_only_update_ref(_t(adj, cuda_device), *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and not torch.equal(ka, _t(adj, cuda_device))
    assert tpa.packed_adj_only_update_inplace.launches == before + 1


@pytest.mark.cuda
def test_k3_rejects_bad_shapes_before_launch(cuda_device):
    adj, _, args = _k1_straddling_case(3)
    dev_args = [_t(a, cuda_device) for a in _k3_args(args)]
    before = tpa.packed_adj_only_update_inplace.launches
    with pytest.raises(ValueError, match="e_adj"):
        tpa.packed_adj_only_update_inplace(_t(adj, cuda_device), *dev_args[:-1], dev_args[-1][:, :64])
    with pytest.raises(ValueError, match="int32"):
        tpa.packed_adj_only_update_inplace(_t(adj, cuda_device), *dev_args[:-1], dev_args[-1].float())
    assert tpa.packed_adj_only_update_inplace.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mp", [16, 64])
def test_k2_kernel_matches_twin_on_card(cuda_device, mp):
    table, args = _k2_case(4, mp=mp)
    dev_args = [_t(a, cuda_device) for a in args]
    kt = tsr.fused_update_inplace(_t(table, cuda_device), *dev_args)
    rt = tsr.fused_update_ref(_t(table, cuda_device), *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(kt, rt)


@pytest.mark.cuda
def test_k2_rejects_slot_width_not_multiple_of_16(cuda_device):
    table, args = _k2_case(5, mp=8)
    dev_args = [_t(a, cuda_device) for a in args]
    before = tsr.fused_update_inplace.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        tsr.fused_update_inplace(_t(table, cuda_device), *dev_args)
    assert tsr.fused_update_inplace.launches == before


def _k5_case(seed: int, q: int, c: int, m: int, k: int):
    """LUTs ``[Q, M, K]`` and uint8 codes ``[Q, C, M]`` below K."""
    rng = np.random.default_rng(seed)
    luts = (rng.random((q, m, k)) * 50).astype(np.float32)
    codes = rng.integers(0, k, (q, c, m)).astype(np.uint8)
    return luts, codes


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q, c, m, k",
    [(4096, 56, 16, 256), (512, 112, 16, 256), (1, 70_000, 16, 256), (13, 19, 5, 32), (3, 40, 64, 256), (2, 9, 32, 16)],
    ids=["serve", "build", "scan", "unaligned", "m_chunks", "k16"],
)
def test_k5_kernel_matches_twin_on_card(cuda_device, q, c, m, k):
    """Only the order of the float32 sum differs (M = 64 stages the LUT in
    two M-chunks at K = 256)."""
    luts, codes = _k5_case(q + c, q, c, m, k)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    before = tadc.adc_score_kernel.launches
    got = tadc.adc_score_kernel(tl, tc)
    torch.cuda.synchronize()
    assert tadc.adc_score_kernel.launches == before + 1
    torch.testing.assert_close(got, adc_score(tl, tc), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_k5_shared_table_and_rejects(cuda_device):
    """A query stride of 0 shares one table (the cosine magnitude call);
    codes that are not uint8 and K > 256 are refused before any launch."""
    luts, codes = _k5_case(7, 1, 33, 16, 256)
    shared = _t(luts, cuda_device).expand(5, -1, -1)
    tc = _t(np.repeat(codes, 5, axis=0), cuda_device)
    torch.testing.assert_close(tadc.adc_score_kernel(shared, tc), adc_score(shared, tc), rtol=1e-5, atol=1e-4)
    before = tadc.adc_score_kernel.launches
    with pytest.raises(ValueError, match="uint8"):
        tadc.adc_score_kernel(shared, tc.to(torch.int32))
    with pytest.raises(ValueError, match="256"):
        tadc.adc_score_kernel(torch.zeros((5, 16, 512), device=cuda_device), tc)
    assert tadc.adc_score_kernel.launches == before


def _k6_case(seed: int, q: int, mp: int, c: int):
    """Paired LUTs ``[Q, MP, 32]`` and packed codes ``[Q, MP, C]`` (any byte)."""
    rng = np.random.default_rng(seed)
    luts = (rng.random((q, mp, 32)) * 50).astype(np.float32)
    codes = rng.integers(0, 256, (q, mp, c)).astype(np.uint8)
    return luts, codes


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q, mp, c, shared",
    [(4096, 32, 64, False), (4096, 24, 64, False), (256, 32, 64, False), (4096, 32, 64, True), (12, 13, 70, False),
     (2, 400, 300, False)],
    ids=["serve_200k", "serve_mips_1m", "micro", "cosine_norm_shared", "unaligned", "mp_chunks_c_tiles"],
)
def test_k6_kernel_matches_twin_on_card(cuda_device, q, mp, c, shared):
    """The chip check's shapes; a query stride of 0 shares one table (the
    cosine norm); MP = 400 stages the LUT in two MP-chunks and C = 300 takes
    two candidate tiles.  Only the order of the float32 sum differs."""
    luts, codes = _k6_case(q + mp + c, q, mp, c)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    if shared:
        tl = tl[:1].expand(q, -1, -1)
    before = tadc16.adc16_score_kernel.launches
    got = tadc16.adc16_score_kernel(tl, tc)
    torch.cuda.synchronize()
    assert tadc16.adc16_score_kernel.launches == before + 1
    torch.testing.assert_close(got, adc16_ref(tl, tc), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_k6_integer_tables_exact_and_rejects(cuda_device):
    """Integer tables sum exactly in any order; bad calls are refused
    before any launch."""
    luts, codes = _k6_case(3, 64, 32, 64)
    tl, tc = _t(np.round(luts), cuda_device), _t(codes, cuda_device)
    assert torch.equal(tadc16.adc16_score_kernel(tl, tc), adc16_ref(tl, tc))
    before = tadc16.adc16_score_kernel.launches
    with pytest.raises(ValueError, match="uint8"):
        tadc16.adc16_score_kernel(tl, tc.to(torch.int32))
    with pytest.raises(ValueError, match="32 entries"):
        tadc16.adc16_score_kernel(tl[:, :, :16].contiguous(), tc)
    with pytest.raises(ValueError, match="contiguous"):
        tadc16.adc16_score_kernel(tl, tc.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="do not match"):
        tadc16.adc16_score_kernel(tl, tc[:, :31].contiguous())
    assert tadc16.adc16_score_kernel.launches == before


def _scatter_case(seed: int, shape: tuple, b: int, dtype):
    """A row scatter: unique in-range rows, two dropped rows and a duplicate
    carrying an identical image (the builder's contract)."""
    rng = np.random.default_rng(seed)

    def rnd(*s):
        if dtype == np.float32:
            return rng.normal(size=s).astype(np.float32)
        return rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, s, dtype=dtype, endpoint=True)

    table = rnd(*shape)
    idx = rng.choice(shape[0], b, replace=False).astype(np.int32)
    idx[1], idx[5] = -1, shape[0]
    idx[7] = idx[3]
    payload = rnd(b, *shape[1:])
    payload[7] = payload[3]
    return table, idx, payload


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype",
    [((4096, 24, 128), np.uint8), ((512, 2, 128), np.uint8)],
    ids=["k4a_d96_rows", "k4a_small_rows"],
)
def test_k4a_kernel_matches_twin_on_card(cuda_device, shape, dtype):
    table, idx, payload = _scatter_case(11, shape, 300, dtype)
    args = (_t(idx, cuda_device), _t(payload, cuda_device))
    before = tsr.scatter_rows3_inplace.launches
    got = tsr.scatter_rows3_inplace(_t(table, cuda_device), *args)
    want = tsr.scatter_rows_ref(_t(table, cuda_device), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, _t(table, cuda_device))
    assert tsr.scatter_rows3_inplace.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, dtype",
    [((700, 64), np.uint8), ((700, 45), np.uint8), ((700, 33), np.int32), ((700, 40), np.float32)],
    ids=["u8_16B_rows", "u8_odd_rows", "i32_4B_rows", "f32_16B_rows"],
)
def test_k4b_kernel_matches_twin_on_card(cuda_device, shape, dtype):
    """Each copy width: 16-byte vectors, single bytes, 4-byte words."""
    table, idx, payload = _scatter_case(12, shape, 257, dtype)
    args = (_t(idx, cuda_device), _t(payload, cuda_device))
    before = tsr.scatter_rows_inplace.launches
    got = tsr.scatter_rows_inplace(_t(table, cuda_device), *args)
    want = tsr.scatter_rows_ref(_t(table, cuda_device), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, _t(table, cuda_device))
    assert tsr.scatter_rows_inplace.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, kp, dtype",
    [((600, 64), 16, np.float32), ((600, 64), 5, np.float32), ((600, 45), 7, np.uint8)],
    ids=["f32_aligned_slots", "f32_word_slots", "u8_byte_slots"],
)
def test_k7_kernel_matches_twin_on_card(cuda_device, shape, kp, dtype):
    """Slots at every offset (some leave their row and drop whole)."""
    table = _scatter_case(13, shape, 8, dtype)[0]
    payload = _scatter_case(14, (200, kp), 8, dtype)[0]
    rng = np.random.default_rng(15)
    idx = rng.choice(shape[0], 200, replace=False).astype(np.int32)  # unique rows: slots may overlap
    idx[1], idx[5] = -1, shape[0]
    off = rng.integers(-2, shape[1] - kp + 3, idx.size).astype(np.int32)
    args = (_t(idx, cuda_device), _t(off, cuda_device), _t(payload, cuda_device))
    before = tsr.scatter_slots_inplace.launches
    got = tsr.scatter_slots_inplace(_t(table, cuda_device), *args)
    want = tsr.scatter_slots_ref(_t(table, cuda_device), *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and not torch.equal(got, _t(table, cuda_device))
    assert tsr.scatter_slots_inplace.launches == before + 1


@pytest.mark.cuda
def test_scatter_rejects_non_contiguous_before_launch(cuda_device):
    table = torch.zeros((64, 2, 128), dtype=torch.uint8, device=cuda_device)
    idx = torch.arange(4, dtype=torch.int32, device=cuda_device)
    before = tsr.scatter_rows3_inplace.launches
    with pytest.raises(ValueError, match="contiguous"):
        tsr.scatter_rows3_inplace(table[::2], idx, torch.ones((4, 2, 128), dtype=torch.uint8, device=cuda_device))
    assert tsr.scatter_rows3_inplace.launches == before
