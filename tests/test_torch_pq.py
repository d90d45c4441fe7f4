"""PQ in the port against the JAX package: LUTs, K5's twin, the ADC and
fused ADC providers, encode / decode and codebook training.

Both packages get the same numpy inputs.  The JAX package's trained
quantizer goes into the port through ``convert.pq_from_numpy``, so the port
encodes and scores with the same codebooks.  Float results agree to
rtol=atol=1e-5 (only the order of float32 sums differs); codes and fused
code tables are equal.  The port's own k-means draws from a
``torch.Generator`` (jax.random's bits cannot be reproduced), so its
codebooks are held to the JAX package's reconstruction error within 5%.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import score as jscore
from jvector_tpu.ops import adc as jadc
from jvector_tpu.ops.pallas.adc_kernel import adc_score_pallas
from jvector_tpu.quantization.kmeans import _sq_dists as j_sq_dists
from jvector_tpu.quantization.kmeans import assign_clusters as j_assign_clusters
from jvector_tpu.quantization.pq import ProductQuantization as JPQ
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import score as tscore
from jvector_tpu_torch.ops import adc as tadc
from jvector_tpu_torch.ops.kernels.adc import adc_score_kernel
from jvector_tpu_torch.quantization.pq import ProductQuantization as TPQ

# the module (the package exports the function ``kmeans`` under the same name)
tkm = importlib.import_module("jvector_tpu_torch.quantization.kmeans")

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


def _data(n=1500, d=32, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def trained():
    """The JAX package's PQ (M=4, K=256, centered) on a 1500 x 32 corpus,
    carried into the port."""
    data = _data()
    jq = JPQ.compute(data, m=4, clusters=256, globally_center=True)
    tq = convert.pq_from_numpy(np.asarray(jq.codebooks), np.asarray(jq.center), jq.original_dim, device="cpu")
    return data, jq, tq


@pytest.mark.parametrize("sim", SIMS)
def test_build_partial_sums_match(sim):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(9, 24)).astype(np.float32)
    cb = rng.normal(size=(6, 32, 4)).astype(np.float32)
    want = np.asarray(jadc.build_partial_sums(jnp.asarray(q), jnp.asarray(cb), sim))
    np.testing.assert_allclose(tadc.build_partial_sums(_t(q), _t(cb), sim).numpy(), want, **TOL)
    np.testing.assert_allclose(
        tadc.partial_squared_magnitudes(_t(cb)).numpy(), np.asarray(jadc.partial_squared_magnitudes(jnp.asarray(cb))), **TOL
    )


@pytest.mark.parametrize("q, c, m, k", [(12, 18, 4, 32), (5, 40, 16, 256)])
def test_k5_twin_matches_jax_and_pallas(q, c, m, k):
    """K5's plain twin against the JAX package's ``adc_score`` and the
    Pallas kernel in interpret mode; on CPU tensors the kernel's wrapper
    runs the twin and counts no launch."""
    rng = np.random.default_rng(q * c)
    luts = rng.normal(size=(q, m, k)).astype(np.float32)
    codes = rng.integers(0, k, (q, c, m)).astype(np.uint8)
    got = tadc.adc_score(_t(luts), _t(codes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jadc.adc_score(jnp.asarray(luts), jnp.asarray(codes))), **TOL)
    pallas = adc_score_pallas(jnp.asarray(luts), jnp.asarray(codes), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    before = adc_score_kernel.launches
    np.testing.assert_array_equal(adc_score_kernel(_t(luts), _t(codes)).numpy(), got)
    assert adc_score_kernel.launches == before
    shared = np.asarray(jadc.adc_score_shared(jnp.asarray(luts), jnp.asarray(codes[0])))
    np.testing.assert_allclose(tadc.adc_score_shared(_t(luts), _t(codes[0])).numpy(), shared, **TOL)


def test_kmeans_distances_and_assignment_match():
    rng = np.random.default_rng(2)
    data = np.round(rng.normal(size=(3, 300, 8)) * 4).astype(np.float32)  # a grid: exact distances
    cent = data[:, :40].copy()
    for b in range(3):
        np.testing.assert_array_equal(
            tkm._sq_dists(_t(data[b : b + 1]), _t(cent[b : b + 1])).numpy()[0],
            np.asarray(j_sq_dists(jnp.asarray(data[b]), jnp.asarray(cent[b]))),
        )
        np.testing.assert_array_equal(
            tkm.assign_clusters(_t(data[b : b + 1]), _t(cent[b : b + 1])).numpy()[0],
            np.asarray(j_assign_clusters(jnp.asarray(data[b]), jnp.asarray(cent[b]))),
        )


def test_encode_decode_match(trained):
    data, jq, tq = trained
    jc = np.asarray(jq.encode(data))
    tc = tq.encode(data, block=500)  # blocks do not change the codes
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(tq.decode(tc).numpy(), np.asarray(jq.decode(jnp.asarray(jc))), **TOL)
    np.testing.assert_allclose(tq.reconstruction_error(data), jq.reconstruction_error(data), rtol=1e-5)
    assert (tq.m, tq.clusters, tq.subspace_dim, tq.padded_dim) == (jq.m, jq.clusters, jq.subspace_dim, jq.padded_dim)


@pytest.mark.parametrize("center", [False, True], ids=["uncentered", "centered"])
def test_port_compute_reconstruction_close_to_jax(center):
    """The port's own training (k-means++ from a torch.Generator, 6 Lloyd
    rounds) reaches the JAX package's reconstruction error within 5%; the
    uneven split (d=30, M=4) pads to 32 dims in both."""
    data = _data(n=2000, d=30, seed=3)
    jq = JPQ.compute(data, m=4, clusters=64, globally_center=center)
    tq = TPQ.compute(data, m=4, clusters=64, globally_center=center, device="cpu")
    assert tuple(tq.codebooks.shape) == tuple(jq.codebooks.shape) == (4, 64, 8)
    if center:
        np.testing.assert_allclose(tq.center.numpy(), np.asarray(jq.center), **TOL)
    je, te = jq.reconstruction_error(data), tq.reconstruction_error(data)
    assert te <= 1.05 * je, (te, je)


@pytest.mark.parametrize("sim", SIMS)
def test_adc_provider_matches(trained, sim):
    data, jq, tq = trained
    codes = np.asarray(jq.encode(data))
    jp = jq.provider(jnp.asarray(codes), sim)
    tp = tq.provider(_t(codes), sim)
    rng = np.random.default_rng(4)
    queries = rng.normal(size=(7, 32)).astype(np.float32)
    ids = rng.integers(0, data.shape[0], (7, 25)).astype(np.int32)
    jl, tl = jp.prepare(jnp.asarray(queries)), tp.prepare(_t(queries))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tp.score(tl, _t(ids)).numpy(), np.asarray(jp.score(jl, jnp.asarray(ids))), **TOL)
    nodes = ids[:, 0]
    np.testing.assert_allclose(
        tp.score_nodes(_t(nodes), _t(ids)).numpy(), np.asarray(jp.score_nodes(jnp.asarray(nodes), jnp.asarray(ids))), **TOL
    )
    np.testing.assert_allclose(
        tp.pairwise(_t(ids), _t(ids)).numpy(), np.asarray(jp.pairwise(jnp.asarray(ids), jnp.asarray(ids))), **TOL
    )
    np.testing.assert_allclose(
        tp.decode_centered(_t(ids)).numpy(), np.asarray(jp.decode_centered(jnp.asarray(ids))), **TOL
    )


@pytest.mark.parametrize("sim", SIMS)
def test_fused_adc_provider_matches(trained, sim):
    data, jq, tq = trained
    n = data.shape[0]
    codes = np.asarray(jq.encode(data))
    rng = np.random.default_rng(5)
    nbrs = rng.integers(0, n, (n, 12)).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.2] = -1
    jf = jscore.build_fused_codes(jnp.asarray(nbrs), jnp.asarray(codes), chunk=700)
    tf = tscore.build_fused_codes(_t(nbrs), _t(codes), chunk=400)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    jp = jscore.FusedADCScoreProvider(codes=jnp.asarray(codes), fused_codes=jf, codebooks=jq.codebooks,
                                      center=jq.center, sim=sim)
    tp = tscore.FusedADCScoreProvider(codes=_t(codes), fused_codes=tf, codebooks=tq.codebooks,
                                      center=tq.center, sim=sim)
    queries = rng.normal(size=(6, 32)).astype(np.float32)
    jl, tl = jp.prepare(jnp.asarray(queries)), tp.prepare(_t(queries))
    for node_ids in (rng.integers(0, n, (6,)), rng.integers(0, n, (6, 2))):
        node_ids = node_ids.astype(np.int32)
        np.testing.assert_allclose(
            tp.score_edges(tl, _t(node_ids)).numpy(), np.asarray(jp.score_edges(jl, jnp.asarray(node_ids))), **TOL
        )
    ids = rng.integers(0, n, (6, 9)).astype(np.int32)
    np.testing.assert_allclose(tp.score(tl, _t(ids)).numpy(), np.asarray(jp.score(jl, jnp.asarray(ids))), **TOL)
