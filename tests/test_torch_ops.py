"""Parity of the PyTorch port's building blocks with the JAX package on the
CPU: similarity, datasets, SQ4 codes and constants, the score providers
(both ``score`` branches and both ``score_edges`` layouts), the tie-break
jitter, dedup and the robust prune.

Inputs are made with numpy from a seed and handed to both packages.
Integer outputs must be equal; float scores agree to rtol=atol=1e-5 (the two
frameworks sum float32 products in different orders).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import diversity as jdiv
from jvector_tpu.graph import score as jscore
from jvector_tpu.ops import similarity as jsim
from jvector_tpu.quantization import sq as jsq
from jvector_tpu.util import datasets as jds
from jvector_tpu_torch.graph import diversity as tdiv
from jvector_tpu_torch.graph import score as tscore
from jvector_tpu_torch.ops import similarity as tsim
from jvector_tpu_torch.quantization import sq as tsq
from jvector_tpu_torch.util import datasets as tds

TOL = dict(rtol=1e-5, atol=1e-5)
SIMS = ["euclidean", "dot_product", "cosine"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_import_without_jax():
    code = (
        "import sys, jvector_tpu_torch, jvector_tpu_torch.convert, jvector_tpu_torch.disk.ltm, "
        "jvector_tpu_torch.disk.host_graph, jvector_tpu_torch.util.native, jvector_tpu_torch.bench.headline, "
        "jvector_tpu_torch.ops.adc16, jvector_tpu_torch.ops.kernels.adc16, jvector_tpu_torch.bench.micro, "
        "jvector_tpu_torch.bench.diagnostics; "
        "print('jax' in sys.modules, any(m.split('.')[0] == 'jvector_tpu' for m in sys.modules))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False False"


@pytest.mark.parametrize("sim", SIMS)
def test_pairwise_scores_match(sim):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    b = rng.normal(size=(3, 11, 24)).astype(np.float32)
    want = np.asarray(jsim.pairwise_scores(q[None], b, sim))
    got = tsim.pairwise_scores(_t(q)[None], _t(b), sim).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    raw = np.asarray(jsim.pairwise_raw(q, b[0], sim))
    np.testing.assert_allclose(tsim.pairwise_raw(_t(q), _t(b[0]), sim).numpy(), raw, **TOL)
    assert tsim.SimilarityFunction.parse(sim).value == jsim.SimilarityFunction.parse(sim).value


def test_synthetic_dataset_and_recall_match():
    kw = dict(n=3000, dim=24, n_queries=40, k=10, n_clusters=16, seed=5)
    a = jds.synthetic_dataset(**kw)
    b = tds.synthetic_dataset(**kw, device="cpu")
    np.testing.assert_array_equal(a.base, b.base)
    np.testing.assert_array_equal(a.queries, b.queries)
    np.testing.assert_array_equal(a.ground_truth, b.ground_truth)
    gt = tds.exact_ground_truth(b.base, b.queries, 10, block=700, device="cpu")
    np.testing.assert_array_equal(gt, a.ground_truth)
    ids = a.ground_truth.copy()
    ids[:, 3] = -1
    assert tds.recall_at_k(ids, a.ground_truth, 10) == jds.recall_at_k(ids, a.ground_truth, 10)


def _sq4_pair(d=32, n=600, seed=2):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)).astype(np.float32)
    return data, jsq.ScalarQuantization4.compute(data), tsq.ScalarQuantization4.compute(data, device="cpu")


@pytest.mark.parametrize("d", [32, 17])
def test_sq4_codes_and_constants_match(d):
    """Host-path fit (numpy quantiles in both) -> identical quantizer,
    byte-equal codes, matching per-node constants and decode."""
    data, jq, tq = _sq4_pair(d=d)
    np.testing.assert_array_equal(_bits(jq.scale), _bits(tq.scale))
    np.testing.assert_array_equal(_bits(jq.offset), _bits(tq.offset))
    assert jq.original_dim == tq.original_dim == d
    jc = np.asarray(jq.encode(data))
    tc = tq.encode(data)
    np.testing.assert_array_equal(tc.numpy(), jc)
    for a, b in zip(jq.node_constants(jnp.asarray(jc)), tq.node_constants(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    np.testing.assert_allclose(tq.decode(tc).numpy(), np.asarray(jq.decode(jnp.asarray(jc))), **TOL)
    lv = tsq.unpack_nibble_rows(tc)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jsq.unpack_nibble_rows(jnp.asarray(jc))))
    np.testing.assert_array_equal(tsq.pack_nibble_rows(lv).numpy(), jc)
    np.testing.assert_array_equal(
        tsq.unpack_nibble_rows_grouped(tc).numpy(),
        np.asarray(jsq.unpack_nibble_rows_grouped(jnp.asarray(jc))),
    )
    np.testing.assert_array_equal(
        tsq.group_dims(_t(data)).numpy(), np.asarray(jsq.group_dims(jnp.asarray(data)))
    )


def test_sq4_device_fit_close_to_host_fit():
    """A tensor is fitted on its device (sorted-sample quantiles); the ranges
    agree with numpy's to float32 rounding."""
    data, _, tq = _sq4_pair(n=900)
    dq = tsq.ScalarQuantization4.compute(torch.as_tensor(data))
    np.testing.assert_allclose(dq.scale.numpy(), tq.scale.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dq.offset.numpy(), tq.offset.numpy(), rtol=1e-5, atol=1e-6)


def _providers(sim, d=32, n=600, r=16, seed=2):
    data, jq, tq = _sq4_pair(d=d, n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    nbrs = rng.integers(0, n, (n, r)).astype(np.int32)
    nbrs[rng.random((n, r)) < 0.2] = -1
    jc = jq.encode(data)
    jp = jq.provider_for_graph(jc, jnp.asarray(nbrs), sim)
    tp = tq.provider_for_graph(_t(jc), _t(nbrs), sim)
    return data, nbrs, jp, tp


@pytest.mark.parametrize("sim", SIMS)
def test_sq4_provider_tables_and_scores_match(sim):
    data, nbrs, jp, tp = _providers(sim)
    np.testing.assert_array_equal(tp.fused_packed.numpy(), np.asarray(jp.fused_packed))
    np.testing.assert_allclose(tp.fused_w2.numpy(), np.asarray(jp.fused_w2), **TOL)
    np.testing.assert_array_equal(tp.codes_aug[:, :-4].numpy(), np.asarray(jp.codes_aug)[:, :-4])
    rng = np.random.default_rng(9)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    ids = rng.integers(0, data.shape[0], (5, 13)).astype(np.int32)
    jqs, tqs = jp.prepare(jnp.asarray(q)), tp.prepare(_t(q))
    for a, b in zip(jqs, tqs):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    want = np.asarray(jp.score(jqs, jnp.asarray(ids)))
    np.testing.assert_allclose(tp.score(tqs, _t(ids)).numpy(), want, **TOL)
    # the separate-gather branch (no aug rows) gives the same scores
    import dataclasses

    tsep = dataclasses.replace(tp, codes_aug=None)
    jsep = dataclasses.replace(jp, codes_aug=None)
    np.testing.assert_allclose(tsep.score(tqs, _t(ids)).numpy(), want, **TOL)
    np.testing.assert_allclose(np.asarray(jsep.score(jqs, jnp.asarray(ids))), want, **TOL)
    # 2-D fused layout, [Q] and [Q, E] expansions
    for node_ids in (ids[:, 0], ids[:, :2]):
        w = np.asarray(jp.score_edges(jqs, jnp.asarray(node_ids)))
        np.testing.assert_allclose(tp.score_edges(tqs, _t(node_ids)).numpy(), w, **TOL)
    np.testing.assert_allclose(tp.decode(_t(ids)).numpy(), np.asarray(jp.decode(jnp.asarray(ids))), **TOL)
    np.testing.assert_allclose(
        tp.pairwise(_t(ids), _t(ids)).numpy(),
        np.asarray(jp.pairwise(jnp.asarray(ids), jnp.asarray(ids))),
        **TOL,
    )


def test_sq4_score_edges_packed_layout_matches():
    """The build's layout: fused codes as [N, T, 128] uint8, constants as
    packed [N/8, 8, 128] int32 (float32 bits in lanes [0:R])."""
    import dataclasses

    n, r = 600, 64
    data, nbrs, jp, tp = _providers("euclidean", n=n, r=r)
    mp = 16
    f3 = np.asarray(jp.fused_packed).reshape(n, r * mp // 128, 128)
    w2 = np.zeros((n, 128), np.float32)
    w2[:, :r] = np.asarray(jp.fused_w2)
    w2p = w2.view(np.int32).reshape(n // 8, 8, 128)
    jpk = dataclasses.replace(jp, fused_packed=jnp.asarray(f3), fused_w2=jnp.asarray(w2p))
    tpk = dataclasses.replace(tp, fused_packed=_t(f3), fused_w2=_t(w2p))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, 32)).astype(np.float32)
    node_ids = rng.integers(0, n, (6, 2)).astype(np.int32)
    want = np.asarray(jpk.score_edges(jpk.prepare(jnp.asarray(q)), jnp.asarray(node_ids)))
    got = tpk.score_edges(tpk.prepare(_t(q)), _t(node_ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    flat = tp.score_edges(tp.prepare(_t(q)), _t(node_ids)).numpy()
    np.testing.assert_allclose(got, flat, **TOL)


@pytest.mark.parametrize("sim", SIMS)
def test_exact_provider_matches(sim):
    rng = np.random.default_rng(6)
    vecs = rng.normal(size=(300, 24)).astype(np.float32)
    q = rng.normal(size=(5, 24)).astype(np.float32)
    ids = rng.integers(0, 300, (5, 9)).astype(np.int32)
    jp = jscore.ExactScoreProvider(vectors=jnp.asarray(vecs), sim=jsim.SimilarityFunction(sim))
    tp = tscore.ExactScoreProvider(vectors=_t(vecs), sim=tsim.SimilarityFunction(sim))
    want = np.asarray(jp.score(jp.prepare(jnp.asarray(q)), jnp.asarray(ids)))
    np.testing.assert_allclose(tp.score(tp.prepare(_t(q)), _t(ids)).numpy(), want, **TOL)
    np.testing.assert_allclose(
        tp.pairwise(_t(ids), _t(ids)).numpy(),
        np.asarray(jp.pairwise(jnp.asarray(ids), jnp.asarray(ids))),
        **TOL,
    )
    va = vecs[ids]
    np.testing.assert_allclose(
        tscore.exact_score_rows(tp.prepare(_t(q)), _t(va), tp.sim).numpy(),
        np.asarray(jscore.exact_score_rows(jp.prepare(jnp.asarray(q)), jnp.asarray(va), jp.sim)),
        **TOL,
    )
    # bf16-rounded products are exact in float32 in both; only the order of
    # the float32 sums differs
    np.testing.assert_allclose(
        tscore.exact_pairwise_rows(_t(va), tp.sim).numpy(),
        np.asarray(jscore.exact_pairwise_rows(jnp.asarray(va), jp.sim)),
        **TOL,
    )


def test_tie_break_jitter_bit_identical():
    rng = np.random.default_rng(0)
    own = rng.integers(-5, 1 << 30, 256).astype(np.int32)
    cand = rng.integers(-1, 1 << 30, (256, 120)).astype(np.int32)
    sc = rng.random((256, 120)).astype(np.float32)
    sc[:, -3:] = -np.inf
    want = np.asarray(jax.jit(jdiv.tie_break_scores)(own, cand, sc))
    got = tdiv.tie_break_scores(_t(own), _t(cand), _t(sc)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    sim = rng.random((8, 120, 120)).astype(np.float32)
    want = np.asarray(jax.jit(jdiv.tie_break_pairs)(cand[:8], sim))
    got = tdiv.tie_break_pairs(_t(cand[:8]), _t(sim)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    x = rng.integers(0, 1 << 31, 4096).astype(np.uint32)
    np.testing.assert_array_equal(
        tdiv._mix32(torch.as_tensor(x.astype(np.int64))).numpy().astype(np.uint32),
        np.asarray(jdiv._mix32(jnp.asarray(x))),
    )


def test_dedup_sorted_desc_matches():
    rng = np.random.default_rng(3)
    ids = rng.integers(-1, 40, (64, 50)).astype(np.int32)  # duplicates + invalid
    sc = rng.integers(0, 8, (64, 50)).astype(np.float32) / 8  # many exact ties
    a_ids, a_sc = jdiv.dedup_sorted_desc(jnp.asarray(ids), jnp.asarray(sc))
    b_ids, b_sc = tdiv.dedup_sorted_desc(_t(ids), _t(sc))
    np.testing.assert_array_equal(b_ids.numpy(), np.asarray(a_ids))
    np.testing.assert_array_equal(b_sc.numpy(), np.asarray(a_sc))


def _prune_inputs(seed, b=48, c=60, tied=False):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(500)[:c] for _ in range(b)]).astype(np.int32)
    ids[:, -5:] = -1
    if tied:  # coarse levels: many exact ties in scores and in the matrix
        sc = rng.integers(1, 9, (b, c)).astype(np.float32) / 8
        sim = rng.integers(0, 10, (b, c, c)).astype(np.float32) / 8
    else:
        sc = rng.random((b, c)).astype(np.float32)
        sim = rng.random((b, c, c)).astype(np.float32)
    sc[ids < 0] = -np.inf
    sim = (sim + sim.transpose(0, 2, 1)) / 2
    ids, sc = (np.asarray(x) for x in jdiv.dedup_sorted_desc(jnp.asarray(ids), jnp.asarray(sc)))
    return ids, sc, sim


@pytest.mark.parametrize("algo", ["fixpoint", "greedy"])
@pytest.mark.parametrize("tied", [False, True])
def test_robust_prune_matches(algo, tied):
    ids, sc, sim = _prune_inputs(7, tied=tied)
    alphas = (1.0, 1.2)
    want = jdiv.robust_prune(jnp.asarray(ids), jnp.asarray(sc), jnp.asarray(sim), 16, alphas, algo=algo)
    got = tdiv.robust_prune(_t(ids), _t(sc), _t(sim), 16, alphas, algo=algo)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the fixpoint is greedy-equivalent in the port too
    other = tdiv.robust_prune(_t(ids), _t(sc), _t(sim), 16, alphas, algo="greedy")
    for a, b in zip(got, other):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize(
    "entry", ["synthetic_dataset", "exact_ground_truth", "build_graph", "sq4_compute", "pq_compute", "convert"]
)
def test_entry_points_default_to_the_card(entry):
    """Public entry points run on the card unless the caller asks for the
    CPU: without a CUDA device they raise instead of falling back."""
    from jvector_tpu_torch import convert
    from jvector_tpu_torch.graph import build_graph
    from jvector_tpu_torch.quantization import ProductQuantization

    x = np.random.default_rng(0).normal(size=(300, 16)).astype(np.float32)
    calls = {
        "synthetic_dataset": lambda: tds.synthetic_dataset(n=300, dim=16, n_queries=4, k=5),
        "exact_ground_truth": lambda: tds.exact_ground_truth(x, x[:4], 5),
        "build_graph": lambda: build_graph(x, "euclidean"),
        "sq4_compute": lambda: tsq.ScalarQuantization4.compute(x).scale,
        "pq_compute": lambda: ProductQuantization.compute(x, m=4, clusters=16).codebooks,
        "convert": lambda: convert.codes_from_numpy(np.zeros((3, 4), np.uint8)),
    }
    if torch.cuda.is_available():
        out = calls[entry]()
        if isinstance(out, torch.Tensor):
            assert out.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()
