"""Anisotropic PQ and SQ4 in the port against the JAX package: the
parallel-cost weight, anisotropic k-means (Lloyd rounds from the JAX
package's own k-means++ seeds), the coordinate-descent encode for PQ and
for SQ4's scalar levels, ``refine``, and the port's own anisotropic
training.

Both packages get the same numpy inputs.  Float32 sums run in another
order in torch, so an encode may take another centroid where two costs tie
within rounding: codes are held equal on >= 99.9% of entries and the
port's total anisotropic cost to no more than the JAX package's plus 1e-5
of it.  The port's k-means++ draws differ from jax.random's, so its own
training is held to the JAX package's anisotropic cost within 5%.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.quantization import ProductQuantization as JPQ
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu.quantization.pq import _pad_to as jpad
from jvector_tpu.quantization.pq import encode_anisotropic as j_encode_aniso
from jvector_tpu_torch import convert
from jvector_tpu_torch.quantization import ProductQuantization as TPQ
from jvector_tpu_torch.quantization.pq import encode_anisotropic as t_encode_aniso
from jvector_tpu_torch.util.datasets import recall_at_k

# the modules (each package exports the function ``kmeans`` under the same name)
jkm = importlib.import_module("jvector_tpu.quantization.kmeans")
tkm = importlib.import_module("jvector_tpu_torch.quantization.kmeans")
THR = 0.2


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


def _mips(n=2000, d=32, seed=12, clusters=30):
    """Clustered, L2-normalized vectors (a MIPS corpus)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, clusters, n)] + 0.35 * rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _aniso_cost(decoded: np.ndarray, data: np.ndarray, eta: float) -> float:
    """Total ``eta * ||r_par||^2 + ||r_perp||^2`` of the residuals, in float64."""
    x = data.astype(np.float64)
    r = decoded.astype(np.float64) - x
    par = np.sum(r * x, axis=1) ** 2 / np.sum(x * x, axis=1)
    return float(np.sum(eta * par + (np.sum(r * r, axis=1) - par)))


@pytest.mark.parametrize("thr,dim", [(0.2, 96), (0.3, 32), (0.2, 1), (0.999, 1536)])
def test_parallel_cost_multiplier_equal(thr, dim):
    assert tkm.compute_parallel_cost_multiplier(thr, dim) == jkm.compute_parallel_cost_multiplier(thr, dim)


@pytest.mark.parametrize("iters", [1, 6])
def test_anisotropic_lloyd_from_jax_seeds(iters):
    """Lloyd rounds from the JAX package's own k-means++ centroids: the same
    assignments and centroids within rtol=1e-4, atol=1e-5."""
    data = _mips(n=1500, d=4, seed=3)  # one subspace of S = 4
    eta = jkm.compute_parallel_cost_multiplier(THR, 32)
    key = jax.random.PRNGKey(5)
    seeds = np.asarray(jkm.kmeans_pp_init(jnp.asarray(data), 24, key))
    want = np.asarray(jkm.kmeans_anisotropic(jnp.asarray(data), 24, key, eta, iters))
    got = tkm.lloyd_anisotropic(_t(data)[None], _t(seeds)[None], eta, iters)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    a_j = np.asarray(jkm.assign_clusters_anisotropic(jnp.asarray(data), jnp.asarray(want), eta))
    np.testing.assert_array_equal(tkm.assign_clusters_anisotropic(_t(data)[None], _t(want)[None], eta)[0].numpy(), a_j)
    np.testing.assert_array_equal(tkm.assign_clusters_anisotropic(_t(data)[None], _t(got)[None], eta)[0].numpy(), a_j)


def test_anisotropic_lloyd_batched_and_blocked(monkeypatch):
    """Subspaces batched in one call equal one call each, and the outer-
    product blocks do not change the result."""
    rng = np.random.default_rng(7)
    data = rng.normal(size=(3, 400, 4)).astype(np.float32)
    seeds = data[:, :10].copy()
    eta = 1.7
    batched = tkm.lloyd_anisotropic(_t(data), _t(seeds), eta, 3)
    one = torch.stack([tkm.lloyd_anisotropic(_t(data[i : i + 1]), _t(seeds[i : i + 1]), eta, 3)[0] for i in range(3)])
    torch.testing.assert_close(batched, one, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(tkm, "OUTER_BLOCK", 3 * 16 * 7)  # 7 rows a block
    torch.testing.assert_close(tkm.lloyd_anisotropic(_t(data), _t(seeds), eta, 3), batched, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def aniso_pq():
    """The JAX package's anisotropic PQ (m = 8, K = 64, uncentred) on a
    normalized corpus, carried into the port."""
    data = _mips()
    jq = JPQ.compute(data, m=8, clusters=64, globally_center=False, anisotropic_threshold=THR)
    tq = convert.pq_from_numpy(np.asarray(jq.codebooks), None, jq.original_dim, device="cpu",
                               anisotropic_threshold=THR)
    return data, jq, tq


def test_encode_anisotropic_pq_matches(aniso_pq):
    data, jq, tq = aniso_pq
    eta = jkm.compute_parallel_cost_multiplier(THR, 32)
    jc = np.asarray(jq.encode(data))
    tc = tq.encode(data, block=700).numpy()  # blocks do not change codes
    assert tc.shape == jc.shape == (2000, 8) and tc.dtype == np.uint8
    assert (tc == jc).mean() >= 0.999, (tc != jc).sum()
    cost_t = _aniso_cost(tq.decode(_t(tc)).numpy(), data, eta)
    cost_j = _aniso_cost(np.asarray(jq.decode(jnp.asarray(jc))), data, eta)
    assert cost_t <= cost_j * (1 + 1e-5), (cost_t, cost_j)
    # the descent really moves codes off the plain L2 argmin
    plain = convert.pq_from_numpy(np.asarray(jq.codebooks), None, 32, device="cpu").encode(data).numpy()
    assert (plain != tc).mean() > 0.01
    # the function alone, on the same padded input
    x = np.asarray(jpad(jnp.asarray(data), jq.padded_dim))
    direct = t_encode_aniso(_t(x), tq.codebooks, eta).numpy()
    np.testing.assert_array_equal(direct, tc)
    assert (direct == np.asarray(j_encode_aniso(jnp.asarray(x), jq.codebooks, eta))).mean() >= 0.999


def test_encode_anisotropic_sq4_matches():
    data = _mips(n=1500, d=30, seed=4)  # odd padding: D_pad = 30, 15 bytes
    jsq = JSQ4.compute(data)
    tsq = convert.sq4_from_numpy(np.asarray(jsq.scale), np.asarray(jsq.offset), 30, device="cpu")
    np.testing.assert_array_equal(tsq.level_codebooks().numpy(), np.asarray(jsq.level_codebooks()))
    jc = np.asarray(jsq.encode_anisotropic(data, threshold=THR))
    tc = tsq.encode_anisotropic(data, threshold=THR, block=512).numpy()
    assert tc.shape == jc.shape == (1500, 15) and tc.dtype == np.uint8
    # packed bytes equal, and each nibble equal, on >= 99.9%
    assert (tc == jc).mean() >= 0.999
    lv_t = np.stack([tc & 15, tc >> 4], -1).reshape(1500, 30)
    lv_j = np.stack([jc & 15, jc >> 4], -1).reshape(1500, 30)
    assert (lv_t == lv_j).mean() >= 0.999
    eta = jkm.compute_parallel_cost_multiplier(THR, 30)
    cost_t = _aniso_cost(tsq.decode(_t(tc)).numpy(), data, eta)
    cost_j = _aniso_cost(np.asarray(jsq.decode(jnp.asarray(jc))), data, eta)
    assert cost_t <= cost_j * (1 + 1e-5), (cost_t, cost_j)
    assert (tc != tsq.encode(data).numpy()).mean() > 0.01
    assert tsq.compressed_size == jsq.compressed_size == 15


@pytest.mark.parametrize("center", [False, True])
def test_refine_matches(center):
    """Plain Lloyd rounds from carried codebooks on new data (the <= 128k
    sample drawn alike)."""
    data = _mips(n=1200, d=24, seed=6)
    new = _mips(n=900, d=24, seed=7)
    jq = JPQ.compute(data, m=6, clusters=32, globally_center=center, anisotropic_threshold=THR)
    tq = convert.pq_from_numpy(np.asarray(jq.codebooks), None if jq.center is None else np.asarray(jq.center), 24,
                               device="cpu", anisotropic_threshold=THR)
    jr, tr = jq.refine(new, iters=3), tq.refine(new, iters=3)
    assert tr.anisotropic_threshold == THR
    np.testing.assert_allclose(tr.codebooks.numpy(), np.asarray(jr.codebooks), rtol=1e-5, atol=1e-5)


def test_port_anisotropic_training_close_to_jax(aniso_pq):
    """The port's own training (k-means++ from a torch.Generator, six
    anisotropic rounds) reaches the JAX package's anisotropic cost within
    5%, with d = 32 padded from 30 in both."""
    data = _mips()[:, :30].copy()
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    eta = jkm.compute_parallel_cost_multiplier(THR, 30)
    jq = JPQ.compute(data, m=8, clusters=64, globally_center=False, anisotropic_threshold=THR)
    tq = TPQ.compute(data, m=8, clusters=64, globally_center=False, anisotropic_threshold=THR, device="cpu")
    assert tq.codebooks.shape == (8, 64, 4) and tq.anisotropic_threshold == THR
    cost_t = _aniso_cost(tq.decode(tq.encode(data)).numpy(), data, eta)
    cost_j = _aniso_cost(np.asarray(jq.decode(jq.encode(data))), data, eta)
    assert cost_t <= 1.05 * cost_j, (cost_t, cost_j)
    assert abs(tq.reconstruction_error(data) - jq.reconstruction_error(data)) <= 0.05 * jq.reconstruction_error(data)


def test_anisotropic_beats_plain_pq_recall_on_dot_product():
    """The reference's reason for anisotropic PQ (SCANN): better recall on
    MIPS corpora at equal code size (the port's copy of the JAX package's
    ``tests/test_quantization.py`` test of the same name)."""
    rng = np.random.default_rng(12)
    n, d, nq, k = 6000, 32, 200, 10
    centers = rng.normal(size=(30, d)).astype(np.float32)
    base = centers[rng.integers(0, 30, n)] + 0.35 * rng.normal(size=(n, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    queries = centers[rng.integers(0, 30, nq)] + 0.35 * rng.normal(size=(nq, d)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    gt = np.argsort(-queries @ base.T, axis=1, kind="stable")[:, :k]

    def pq_recall(thr, m, clusters):
        pq = TPQ.compute(base, m=m, clusters=clusters, globally_center=False, anisotropic_threshold=thr,
                         device="cpu")
        prov = pq.provider(pq.encode(base), "dot_product")
        sc = prov.score(prov.prepare(_t(queries)), torch.arange(n, dtype=torch.int32)[None].expand(nq, n))
        ids = torch.argsort(-sc, dim=1, stable=True)[:, :k]
        return recall_at_k(ids.numpy(), gt, k)

    # both the 8-bit (K = 256) and LUT16 (K = 16) code shapes must benefit
    for m, clusters in ((8, 256), (16, 16)):
        plain = pq_recall(-1.0, m, clusters)
        aniso = pq_recall(0.3, m, clusters)
        assert aniso > plain + 0.01, f"m={m} K={clusters}: anisotropic {aniso} <= plain {plain}"
