"""K1, K2, K3 and K5 kernels against their plain twins on a CUDA device.

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
from jvector_tpu_torch.ops.kernels import adc as tadc
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
