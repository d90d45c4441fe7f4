"""K1, K2, K3, K4a, K4b, K5, K6, K7 and K8 kernels against their plain twins
on a CUDA device (K1, K2 and K5 also at BASELINE configs 3 and 4's shapes;
K8 also inside a BQ search, once a beam step).

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

import chip_smoke
from jvector_tpu_torch.ops.adc import adc_score, adc_score_ordered
from jvector_tpu_torch.ops.adc16 import adc16_ordered, adc16_ref
from jvector_tpu_torch.ops.kernels import adc as tadc
from jvector_tpu_torch.ops.kernels import adc16 as tadc16
from jvector_tpu_torch.ops.kernels import frontier as tfr
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


_DROP = 2**30  # the builder's drop key: sorts after every in-range row


def _k1_wave_case(seed: int, p: int = 768, n_pr: int = 48, wa: int = 6, e: int = 16, max_run: int = 8):
    """A K1 wave shaped like the builder's: ``wa`` contiguous wave rows (one
    dropped), whose every physical row takes appends (they lead the stream
    before truncation to ``p``), enforce sublane images half of which land
    on wave rows (on sublanes without appends), runs of 1..``max_run``
    distinct slots, dropped appends and untaken enforce images keyed
    ``_DROP`` at the end (the defaults meet the TPU kernel's P % 256 == 0
    and E % 8 == 0)."""
    rng = np.random.default_rng(seed)
    rnd = lambda *s: rng.integers(-(2**31), 2**31 - 1, s).astype(np.int32)  # noqa: E731
    adj, w2t = rnd(n_pr, 8, 128), rnd(n_pr, 8, 128)
    a0 = int(rng.integers(0, n_pr - wa))
    a_rows = np.arange(a0, a0 + wa, dtype=np.int32)
    a_rows[int(rng.integers(wa))] = -1
    wave_logical = np.concatenate([np.arange(r * 8, r * 8 + 8) for r in a_rows if r >= 0])
    e = min(e, p)
    er = np.concatenate([rng.choice(wave_logical, e // 2, replace=False),
                         rng.choice(np.setdiff1d(np.arange(n_pr * 8), wave_logical), e - e // 2, replace=False)])
    free = np.setdiff1d(np.arange(n_pr * 8), er)
    on_wave = [rng.choice(np.intersect1d(free, np.arange(r * 8, r * 8 + 8))) for r in a_rows if r >= 0]
    targets = list(on_wave) + list(rng.permutation(np.setdiff1d(free, on_wave)))
    keys, slots = [], []
    for lr in targets:
        k = int(rng.integers(1, max_run + 1))
        keys += [lr] * k
        slots += list(rng.permutation(64)[:k])
        if len(keys) >= p - e:
            break
    n_app = p - e
    keys, slots = np.array(keys[:n_app], np.int64), np.array(slots[:n_app], np.int32)
    keys[rng.random(n_app) < 0.05] = _DROP
    er_key = er.astype(np.int64)
    er_key[rng.random(e) < 0.15] = _DROP
    m_key = np.concatenate([keys, er_key])
    m_slot = np.concatenate([slots, np.zeros(e, np.int32)])
    m_img = np.concatenate([np.full(n_app, -1, np.int32), np.arange(e, dtype=np.int32)])
    order = np.argsort(m_key, kind="stable")
    m_key, m_slot, m_img = m_key[order], m_slot[order], m_img[order]
    prow = np.where(m_key < n_pr * 8, m_key >> 3, _DROP).astype(np.int32)
    args = (
        a_rows, rnd(wa, 8, 128), rnd(wa, 8, 128), prow, (m_key & 7).astype(np.int32), m_slot,
        rnd(p), rnd(p), rnd(p), m_img, rnd(e, 128), rnd(e, 128),
    )
    return adj, w2t, args


def _k2_wave_case(seed: int, p: int = 500, n: int = 96, t3: int = 8, mp: int = 64, w: int = 8,
                  max_run: int = 8, tail: int = _DROP):
    """A K2 wave shaped like the builder's stream (``builder.py``'s
    ``f_p_rows``): contiguous wave rows (one dropped, two also enforce
    rows), every other wave row taking a run of slot patches, runs of
    1..``max_run`` distinct slots sorted by row, -1 inside the sequence for
    an enforce row's whole run and for some runs' overflow tails, then a
    tail of invalid entries (``tail``: -1 as the JAX package's builder
    emits, ``_DROP`` as the port's)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, 256, (n, t3, 128)).astype(np.uint8)
    w0 = int(rng.integers(0, n - w))
    wave_rows = np.arange(w0, w0 + w, dtype=np.int32)
    wave_rows[1] = -1
    others = rng.permutation(np.setdiff1d(np.arange(n), wave_rows))
    er_rows = np.array([wave_rows[2], wave_rows[5], others[0], others[1], -1, others[0]], np.int32)
    er_img = rng.integers(0, 256, (er_rows.size, t3, 128)).astype(np.uint8)
    er_img[5] = er_img[2]  # duplicate enforce rows carry identical images
    n_slots = t3 * 128 // mp
    targets = np.sort(np.concatenate([[r for r in wave_rows if r >= 0], others[2 : 2 + max(40, p // 4)]]))
    rows, slots = [], []
    for r in targets:
        k = int(rng.integers(1, max_run + 1))
        run = [r] * k
        if r in er_rows:
            run = [-1] * k  # an enforce row's run
        elif k > 1 and rng.random() < 0.3:
            run[-1] = -1  # an overflow tail
        rows += run
        slots += list(rng.permutation(n_slots)[:k])
    n_tail = p // 10
    rows = (rows[: p - n_tail] + [tail] * p)[:p]
    slots = (slots[: p - n_tail] + [0] * p)[:p]
    src = rng.integers(0, 256, (p, mp)).astype(np.uint8)
    wave_img = rng.integers(0, 256, (w, t3, 128)).astype(np.uint8)
    return table, (wave_rows, wave_img, np.array(rows, np.int32), np.array(slots, np.int32), src, er_rows, er_img)


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


@pytest.mark.cuda
@pytest.mark.parametrize("w2", [True, False], ids=["k1", "k3"])
def test_k1_k3_kernels_match_twins_with_patches_on_every_wave_row(cuda_device, w2):
    """The wave-row owners overlay their rows' appends and enforce sublane
    images, and the patch threads write the same bytes."""
    adj, w2t, args = _k1_wave_case(5)
    if not w2:
        args = _k3_args(args)
    dev_args = [_t(a, cuda_device) for a in args]
    ka, kw, ra, rw = (_t(x, cuda_device) for x in (adj, w2t, adj, w2t))
    kernel = tpa.packed_adj_update_inplace if w2 else tpa.packed_adj_only_update_inplace
    before = kernel.launches
    if w2:
        kernel(ka, kw, *dev_args)
        tpa.packed_adj_update_ref(ra, rw, *dev_args)
    else:
        kernel(ka, *dev_args)
        tpa.packed_adj_only_update_ref(ra, *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and torch.equal(kw, rw)
    assert kernel.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [-1, _DROP], ids=["jax_minus_one_tail", "port_drop_tail"])
def test_k2_kernel_matches_twin_with_drops_inside_runs(cuda_device, tail):
    """-1 inside the sorted stream and either tail: the owners' probes
    skip what they cannot read and still find every patch of their row."""
    table, args = _k2_wave_case(6, tail=tail)
    dev_args = [_t(a, cuda_device) for a in args]
    before = tsr.fused_update_inplace.launches
    kt = tsr.fused_update_inplace(_t(table, cuda_device), *dev_args)
    rt = tsr.fused_update_ref(_t(table, cuda_device), *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(kt, rt)
    assert tsr.fused_update_inplace.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0, 1, 37, 4000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_k2_k3_random_streams_on_card(cuda_device, seed, p):
    """Random waves at several stream lengths (P = 0: the owners alone),
    runs of up to 8 patches, K2 at MP = 16 / 32 / 64: each kernel equals its
    twin and launches once a call."""
    adj, w2t, args = _k1_wave_case(seed, p=p, n_pr=512, wa=16)
    dev_args = [_t(a, cuda_device) for a in args]
    ka, kw, ra, rw = (_t(x, cuda_device) for x in (adj, w2t, adj, w2t))
    before = tpa.packed_adj_update_inplace.launches
    tpa.packed_adj_update_inplace(ka, kw, *dev_args)
    tpa.packed_adj_update_ref(ra, rw, *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and torch.equal(kw, rw)
    assert tpa.packed_adj_update_inplace.launches == before + 1

    dev_args = [_t(a, cuda_device) for a in _k3_args(args)]
    ka, ra = _t(adj, cuda_device), _t(adj, cuda_device)
    before = tpa.packed_adj_only_update_inplace.launches
    tpa.packed_adj_only_update_inplace(ka, *dev_args)
    tpa.packed_adj_only_update_ref(ra, *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra)
    assert tpa.packed_adj_only_update_inplace.launches == before + 1

    table, args = _k2_wave_case(seed, p=p, n=2048, mp=(16, 32, 64)[seed], w=64, tail=(-1, _DROP)[seed % 2])
    dev_args = [_t(a, cuda_device) for a in args]
    before = tsr.fused_update_inplace.launches
    kt = tsr.fused_update_inplace(_t(table, cuda_device), *dev_args)
    rt = tsr.fused_update_ref(_t(table, cuda_device), *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(kt, rt)
    assert tsr.fused_update_inplace.launches == before + 1


@pytest.mark.cuda
def test_k1_k2_empty_calls_launch_nothing(cuda_device):
    adj, w2t, args = _k1_wave_case(0, p=0, wa=6)
    empty = [_t(a[:0], cuda_device) for a in args]
    before = tpa.packed_adj_update_inplace.launches
    ka = _t(adj, cuda_device)
    tpa.packed_adj_update_inplace(ka, _t(w2t, cuda_device), *empty)
    assert tpa.packed_adj_update_inplace.launches == before and torch.equal(ka, _t(adj, cuda_device))
    table, args = _k2_wave_case(0, p=0)
    empty = [_t(a[:0], cuda_device) for a in args]
    before = tsr.fused_update_inplace.launches
    tsr.fused_update_inplace(_t(table, cuda_device), *empty)
    assert tsr.fused_update_inplace.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_k2_match_twins_at_baseline_config4_width(cuda_device, seed):
    """BASELINE config 4 (d = 1536): K1 on the packed adjacency of its
    212,992-row capacity and K2 on 43,008-byte fused rows (MP = 768, 56
    slots; the owner stages the whole row in shared memory, above the
    default 48 KB only with the opt-in), each one launch equal to its twin."""
    adj, w2t, args = _k1_wave_case(seed, p=16_896, n_pr=212_992 // 8, wa=64)
    dev_args = [_t(a, cuda_device) for a in args]
    ka, kw, ra, rw = (_t(x, cuda_device) for x in (adj, w2t, adj, w2t))
    before = tpa.packed_adj_update_inplace.launches
    tpa.packed_adj_update_inplace(ka, kw, *dev_args)
    tpa.packed_adj_update_ref(ra, rw, *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and torch.equal(kw, rw)
    assert tpa.packed_adj_update_inplace.launches == before + 1

    table, args = _k2_wave_case(seed, p=2_000, n=1_024, t3=336, mp=768, w=64, tail=(-1, _DROP)[seed])
    dev_args = [_t(a, cuda_device) for a in args]
    before = tsr.fused_update_inplace.launches
    kt = tsr.fused_update_inplace(_t(table, cuda_device), *dev_args)
    rt = tsr.fused_update_ref(_t(table, cuda_device), *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(kt, rt) and not torch.equal(kt, _t(table, cuda_device))
    assert tsr.fused_update_inplace.launches == before + 1


def _k5_case(seed: int, q: int, c: int, m: int, k: int):
    """LUTs ``[Q, M, K]`` and uint8 codes ``[Q, C, M]`` below K."""
    rng = np.random.default_rng(seed)
    luts = (rng.random((q, m, k)) * 50).astype(np.float32)
    codes = rng.integers(0, k, (q, c, m)).astype(np.uint8)
    return luts, codes


@pytest.mark.cuda
@pytest.mark.parametrize(
    "q, c, m, k",
    [(4096, 56, 16, 256), (512, 112, 16, 256), (1, 70_000, 16, 256), (13, 19, 5, 32), (3, 40, 64, 256), (2, 9, 32, 16),
     (1024, 56, 16, 256), (1024, 56, 24, 256)],
    ids=["serve", "build", "scan", "unaligned", "m_chunks", "k16", "refine_rescore", "baseline_config3"],
)
def test_k5_kernel_matches_twin_on_card(cuda_device, q, c, m, k):
    """Against the CPU paths' twin only the order of the float32 sum
    differs; against ``adc_score_ordered`` nothing does."""
    luts, codes = _k5_case(q + c, q, c, m, k)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    before = tadc.adc_score_kernel.launches
    got = tadc.adc_score_kernel(tl, tc)
    torch.cuda.synchronize()
    assert tadc.adc_score_kernel.launches == before + 1
    torch.testing.assert_close(got, adc_score(tl, tc), rtol=1e-5, atol=1e-4)
    assert torch.equal(got, adc_score_ordered(tl, tc))


K5_EDGE_SHAPES = {**chip_smoke.K5_SHAPES, "m48": (64, 40, 48, 256), "m64": (3, 40, 64, 256), "m96": (300, 40, 96, 256),
                  "m300_chunked": (50, 40, 300, 256), "c1": (7, 1, 16, 256), "k10_cp_async": (9, 33, 5, 10),
                  "q1_one_warp": (1, 20, 16, 256)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K5_EDGE_SHAPES))
def test_k5_bit_equal_to_ordered_twin(cuda_device, name):
    """Every ``chip_smoke.K5_SHAPES`` shape, the opt-in shared memory (M = 48,
    64, 96), M-chunks (M = 300), one candidate, 200-byte tables (K = 10,
    no bulk copy) and one query's table shared by a one-warp block: bit for
    bit ``adc_score_ordered``, one launch counted under its shape."""
    q, c, m, k = K5_EDGE_SHAPES[name]
    luts, codes = _k5_case(q + m, q, c, m, k)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    before = tadc.adc_score_kernel.by_shape[(q, c, m)]
    got = tadc.adc_score_kernel(tl, tc)
    torch.cuda.synchronize()
    assert tadc.adc_score_kernel.by_shape[(q, c, m)] == before + 1
    assert torch.equal(got, adc_score_ordered(tl, tc))


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["shared_table", "shared_table_luts_offset_4", "codes_offset_1", "codes_offset_8",
                                  "luts_offset_4"])
def test_k5_bit_equal_on_shared_and_misaligned_inputs(cuda_device, what):
    """A stride-0 table (copied once a block), codes one and eight bytes off
    a 16-byte boundary (byte and 8-byte code loads) and tables four bytes
    off it (cp.async copies in place of the bulk copy, also for a shared
    table)."""
    q, c, m, k = 1024, 56, 16, 256
    luts, codes = _k5_case(11, q, c, m, k)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    if "luts_offset" in what:
        raw = torch.zeros(tl.numel() + 1, dtype=torch.float32, device=cuda_device)
        raw[1:] = tl.reshape(-1)
        tl = raw[1:].view(q, m, k)
    if what.startswith("shared_table"):
        tl = tl[:1].expand(q, -1, -1)
    elif what.startswith("codes_offset"):
        off = int(what.rsplit("_", 1)[1])
        raw = torch.zeros(tc.numel() + off, dtype=torch.uint8, device=cuda_device)
        raw[off:] = tc.reshape(-1)
        tc = raw[off:].view(q, c, m)
    assert torch.equal(tadc.adc_score_kernel(tl, tc), adc_score_ordered(tl, tc))


@pytest.mark.cuda
def test_k5_bit_equal_on_a_million_candidate_scan(cuda_device):
    """Q = 1, C = 1M (the cleanup's centroid scan): the candidates split over
    the card's blocks, each copying the one table."""
    luts, codes = _k5_case(12, 1, 1_000_000, 16, 256)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    assert torch.equal(tadc.adc_score_kernel(tl, tc), adc_score_ordered(tl, tc))


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


@pytest.mark.cuda
@pytest.mark.parametrize("sim", ["euclidean", "cosine"])
def test_adc_score_nodes_through_k5_on_card(cuda_device, sim):
    """The rescore's scorer at its shape (a chunk of 1024 rows, 56 neighbors
    each): ``ADCScoreProvider.score_nodes`` launches K5 (once, and once
    more for the cosine norm) and agrees with the same call on the CPU,
    which runs K5's twin."""
    from jvector_tpu_torch.graph.score import ADCScoreProvider

    rng = np.random.default_rng(5)
    books, codes = rng.normal(size=(16, 256, 8)).astype(np.float32), rng.integers(0, 256, (4096, 16)).astype(np.uint8)
    nodes, ids = rng.integers(0, 4096, 1024).astype(np.int32), rng.integers(0, 4096, (1024, 56)).astype(np.int32)

    def run(dev):
        prov = ADCScoreProvider(codes=_t(codes, dev), codebooks=_t(books, dev), center=None, sim=sim)
        return prov.score_nodes(_t(nodes, dev), _t(ids, dev))

    before = tadc.adc_score_kernel.launches
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert tadc.adc_score_kernel.launches == before + (2 if sim == "cosine" else 1)
    torch.testing.assert_close(got.cpu(), run("cpu"), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("sim", ["dot_product", "cosine", "euclidean"])
def test_adc_provider_serve_through_k5_at_baseline_config3(cuda_device, sim):
    """BASELINE config 3's first pass (m = 24 on d = 96, uncentred, a
    1024-query wave, 56 candidates each): ``prepare`` builds LUTs that K5
    reads (the dot-product tables come back from the einsum contiguous)
    and ``score`` agrees with the same call on the CPU."""
    from jvector_tpu_torch.graph.score import ADCScoreProvider

    rng = np.random.default_rng(6)
    books, codes = rng.normal(size=(24, 256, 4)).astype(np.float32), rng.integers(0, 256, (4096, 24)).astype(np.uint8)
    queries, ids = rng.normal(size=(1024, 96)).astype(np.float32), rng.integers(0, 4096, (1024, 56)).astype(np.int32)

    def run(dev):
        prov = ADCScoreProvider(codes=_t(codes, dev), codebooks=_t(books, dev), center=None, sim=sim)
        return prov.score(prov.prepare(_t(queries, dev)), _t(ids, dev))

    before = tadc.adc_score_kernel.launches
    got = run(cuda_device)
    torch.cuda.synchronize()
    assert tadc.adc_score_kernel.launches == before + (2 if sim == "cosine" else 1)
    torch.testing.assert_close(got.cpu(), run("cpu"), rtol=1e-5, atol=1e-4)


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
     (2, 400, 300, False), (1024, 32, 64, False), (4096, 32, 1, False), (3, 900, 40, True), (1, 32, 5000, False),
     (4096, 32, 1, True), (300, 13, 3, False)],
    ids=["serve_200k", "serve_mips_1m", "micro", "cosine_norm_shared", "unaligned", "mp_chunks_c_tiles",
         "recall_wave", "entry", "shared_table_in_chunks", "one_query_wide", "entry_shared", "direct_ragged"],
)
def test_k6_kernel_matches_twin_on_card(cuda_device, q, mp, c, shared):
    """The chip check's shapes and the launch plan's corners: a query stride
    of 0 shares one table (the cosine norm); MP = 400 and 900 copy the
    tables in chunks of rows, C = 300 takes two candidate tiles, C <= 4
    gathers from device memory (the entry scores).
    Bit for bit in the Pallas kernel's order (``adc16_ordered``), and
    within float32 rounding of ``adc16_ref``, whose order differs."""
    luts, codes = _k6_case(q + mp + c, q, mp, c)
    tl, tc = _t(luts, cuda_device), _t(codes, cuda_device)
    if shared:
        tl = tl[:1].expand(q, -1, -1)
    before = tadc16.adc16_score_kernel.launches
    got = tadc16.adc16_score_kernel(tl, tc)
    torch.cuda.synchronize()
    assert tadc16.adc16_score_kernel.launches == before + 1
    assert torch.equal(got, adc16_ordered(tl, tc))
    torch.testing.assert_close(got, adc16_ref(tl, tc), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("lut_shift, code_shift", [(1, 0), (4, 0), (0, 1), (0, 2), (1, 3)],
                         ids=["luts_4_bytes_off", "luts_16_bytes_off", "codes_1_byte_off", "codes_2_bytes_off",
                              "both_off"])
def test_k6_unaligned_tensors_on_card(cuda_device, lut_shift, code_shift):
    """Tables anywhere on a 4-byte boundary, and codes off a 16-byte
    boundary (read from device memory, not copied beside the tables), stay
    bit-equal to ``adc16_ordered``."""
    q, mp, c = 4096, 32, 64
    luts, codes = _k6_case(5, q, mp, c)
    lbuf = torch.zeros(q * mp * 32 + lut_shift, device=cuda_device)
    tl = lbuf[lut_shift:].view(q, mp, 32)
    tl.copy_(_t(luts, cuda_device))
    cbuf = torch.zeros(q * mp * c + code_shift, dtype=torch.uint8, device=cuda_device)
    tc = cbuf[code_shift:].view(q, mp, c)
    tc.copy_(_t(codes, cuda_device))
    assert torch.equal(tadc16.adc16_score_kernel(tl, tc), adc16_ordered(tl, tc))
    assert tadc16.plan_for(tl, tc).stage_codes == (code_shift == 0)


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
    [((700, 64), np.uint8), ((700, 45), np.uint8), ((700, 33), np.int32), ((700, 40), np.float32),
     ((700, 1), np.float32), ((700, 16), np.uint8), ((700, 64), np.float32), ((700, 3072), np.uint8)],
    ids=["u8_16B_rows", "u8_odd_rows", "i32_4B_rows", "f32_16B_rows",
         "rows_4B_one_lane", "rows_16B_one_lane", "rows_256B_16_lanes", "rows_3072B_32_lanes"],
)
def test_k4b_kernel_matches_twin_on_card(cuda_device, shape, dtype):
    """Each copy width (16-byte vectors, single bytes, 4-byte words) and each
    lane-group size from 1 to 32; B = 257 rows, so a lane group ends
    mid-warp and the last warp is partial."""
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
    [((600, 64), 16, np.float32), ((600, 64), 5, np.float32), ((600, 45), 7, np.uint8),
     ((600, 96), 1, np.float32), ((600, 96), 3, np.float32), ((600, 96), 12, np.float32),
     ((600, 96), 64, np.float32), ((600, 300), 4, np.uint8), ((600, 300), 12, np.uint8),
     ((600, 300), 48, np.uint8), ((600, 300), 256, np.uint8)],
    ids=["f32_aligned_slots", "f32_word_slots", "u8_byte_slots", "f32_4B_slots", "f32_12B_slots", "f32_48B_slots",
         "f32_256B_slots", "u8_4B_slots", "u8_12B_slots", "u8_48B_slots", "u8_256B_slots"],
)
def test_k7_kernel_matches_twin_on_card(cuda_device, shape, kp, dtype):
    """Slots at every offset, so most are misaligned and some leave their row
    and drop whole; rows -1 and N drop; one duplicate slot carries an
    identical image.  B = 203 slots: no lane-group size fills the last warp."""
    b = 203
    table = _scatter_case(13, shape, 8, dtype)[0]
    payload = _scatter_case(14, (b, kp), 8, dtype)[0]
    rng = np.random.default_rng(15)
    idx = rng.choice(shape[0], b, replace=False).astype(np.int32)  # unique rows: slots may overlap
    idx[1], idx[5] = -1, shape[0]
    off = rng.integers(-2, shape[1] - kp + 3, idx.size).astype(np.int32)
    idx[7], off[3], off[7], payload[7] = idx[3], 1, 1, payload[3]
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


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [-1.0, 0.2], ids=["plain_pq", "anisotropic_pq"])
def test_pq_training_on_card_is_a_function_of_its_seed(cuda_device, threshold):
    """``ProductQuantization.compute`` twice from one seed on the card gives
    bit-equal codebooks: the k-means sums run in a fixed order
    (``quantization.kmeans._segment_sum``), with no float atomics.  Plain PQ
    at m = 16 on 128-d, and BASELINE config 3's anisotropic PQ (m = 24 on
    96-d, T = 0.2), on 32,768 rows (``chip_smoke.py`` holds 131,072)."""
    from jvector_tpu_torch.quantization import ProductQuantization

    dim, m = (128, 16) if threshold < 0 else (96, 24)
    data = torch.as_tensor(np.random.default_rng(11).normal(size=(32_768, dim)).astype(np.float32), device=cuda_device)
    books = [ProductQuantization.compute(data, m=m, clusters=256, globally_center=False,
                                         anisotropic_threshold=threshold).codebooks for _ in range(2)]
    assert torch.equal(books[0], books[1])


@pytest.mark.cuda
def test_sharded_packed_build_launches_k1_k2_per_shard_wave(cuda_device):
    """A 2-shard packed sharded build on one card named twice
    (``["cuda:0"] * 2``): K1 and K2 launch once per shard per wave, and the
    sharded serve clears recall 0.95 against the exact top-10."""
    from jvector_tpu_torch.graph import GraphConfig
    from jvector_tpu_torch.graph.builder import _shuffled_wave_starts
    from jvector_tpu_torch.parallel import make_mesh, sharded_build, sharded_graph_search
    from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

    ds = synthetic_dataset(n=8192, dim=128, n_queries=256, k=10, n_clusters=32, seed=0, device=cuda_device)
    mesh = make_mesh(2, "shard", devices=[cuda_device] * 2)
    cfg = GraphConfig(max_degree=32, ef_construction=100)
    before = tpa.packed_adj_update_inplace.launches, tsr.fused_update_inplace.launches
    idx = sharded_build(ds.base, mesh, cfg)
    torch.cuda.synchronize()
    waves = len(_shuffled_wave_starts(idx.n_local, cfg.wave_size))
    assert tpa.packed_adj_update_inplace.launches - before[0] == 2 * waves
    assert tsr.fused_update_inplace.launches - before[1] == 2 * waves
    assert idx.search_providers[0].fused_w2.dtype == torch.int32  # the packed regime
    ids, _ = sharded_graph_search(idx, ds.queries, mesh, top_k=10, beam_width=100)
    assert recall_at_k(ids.cpu().numpy(), ds.ground_truth, 10) >= 0.95


K8_EDGE_SHAPES = {**{name: (shape, False) for name, shape in chip_smoke.K8_SHAPES.items()},
                  "descent_beam_1": ((300, 1, 56, 1, 128), False),  # a hierarchy level's beam of 1
                  "two_chunks": ((200, 4, 160, 90, 256), False),  # C = 640: two chunks of 512 candidates
                  "unaligned_history": ((333, 2, 8, 30, 130), True)}  # rows 4 bytes off 16-byte boundaries


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(K8_EDGE_SHAPES))
def test_k8_kernel_matches_twin_on_card(cuda_device, name):
    """K8 against ``frontier_filter_ref`` on the card at each caller's
    shape (``chip_smoke.K8_SHAPES``), a beam of one, a C of two chunks and
    histories off the 16-byte boundary: every output equal, one launch."""
    (q, e, r, l, t), shift = K8_EDGE_SHAPES[name]
    nbrs, active, beam, history = (_t(x, cuda_device)
                                   for x in chip_smoke.frontier_case(np.random.default_rng(8), q, e, r, l, t))
    if shift:
        buf = torch.empty(history.numel() + 1, dtype=torch.int32, device=cuda_device)
        buf[1:] = history.flatten()
        history = buf[1:].view(q, t)
        assert history.data_ptr() % 16 and history.is_contiguous()
    before = tfr.frontier_filter.launches
    got = tfr.frontier_filter(nbrs, active, r, beam, history)
    want = tfr.frontier_filter_ref(nbrs, active, r, beam, history)
    torch.cuda.synchronize()
    assert tfr.frontier_filter.launches == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert 0 < int(got[0].sum()) < got[0].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["int64_ids", "float_active", "c_not_e_times_r", "rows_differ", "beam_strided",
                                  "history_on_cpu"])
def test_k8_rejects_before_launch(cuda_device, what):
    nbrs, active, beam, history = (_t(x, cuda_device)
                                   for x in chip_smoke.frontier_case(np.random.default_rng(9), 16, 2, 8, 30, 128))
    r = 8
    if what == "int64_ids":
        nbrs = nbrs.long()
    elif what == "float_active":
        active = active.float()
    elif what == "c_not_e_times_r":
        r = 7
    elif what == "rows_differ":
        beam = beam[:15]
    elif what == "beam_strided":
        beam = torch.cat([beam, beam], dim=1)[:, ::2]
    else:
        history = history.cpu()
    before = tfr.frontier_filter.launches
    with pytest.raises(ValueError):
        tfr.frontier_filter(nbrs, active, r, beam, history)
    assert tfr.frontier_filter.launches == before


@pytest.mark.cuda
def test_k8_once_a_beam_step_in_a_bq_search(cuda_device, monkeypatch):
    """A BQ search on the card (beam 90, rerank 90, no repack: the
    ``angular-bq-batch`` cell's serving) launches K8 once for each beam
    step, as the wrapper's count, the ``beam.frontier_kernel`` counter and
    the profiler's kernel events all read; its ids and scores are the
    same bits as with the plain twin in K8's place."""
    from jvector_tpu_torch import BinaryQuantization, GraphConfig, build_graph, tracing
    from jvector_tpu_torch.graph import searcher

    g = torch.Generator().manual_seed(19)
    centers = torch.randn(32, 100, generator=g) * 4
    data = centers[torch.randint(0, 32, (2048 + 512,), generator=g)] + torch.randn(2048 + 512, 100, generator=g)
    data = torch.nn.functional.normalize(data, dim=1)
    base, queries = data[:2048].to(cuda_device), data[2048:].to(cuda_device)
    graph, exact = build_graph(base, "dot_product", GraphConfig(max_degree=32, ef_construction=100, wave_size=512),
                               device=cuda_device)
    bq = BinaryQuantization.compute(base)
    first = bq.provider(bq.encode(base))

    def run():
        return searcher.search(graph, first, queries, top_k=10, beam_width=90, rerank_k=90, reranker=exact)

    run().ids.cpu()  # warm
    before = tfr.frontier_filter.launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = run()
        torch.cuda.synchronize()
    w = tracing.last_window()
    steps = sum(s.name == "beam.step" for s in w.spans)
    assert steps > 0
    assert tfr.frontier_filter.launches - before == steps
    assert w.counters["beam.frontier_kernel"] == steps
    events = sum(e.count for e in prof.key_averages() if "frontier_kernel" in e.key and e.self_device_time_total > 0)
    assert events == steps
    def plain(*args):
        return tfr.frontier_filter_ref(*args)

    plain.launches = 0
    monkeypatch.setattr(searcher, "frontier_filter", plain)
    plain = run()
    assert torch.equal(res.ids, plain.ids) and torch.equal(res.scores, plain.scores)
    assert torch.equal(res.expanded_count, plain.expanded_count)
