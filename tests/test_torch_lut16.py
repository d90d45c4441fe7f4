"""LUT16 (4-bit PQ) scoring in the port against the JAX package: the
nibble helpers, K6's twin, the LUT16 provider and serving a JAX-built
graph with a LUT16 first pass.

Both packages get the same numpy inputs, and the JAX package's trained
codebooks go into the port through ``convert.lut16_from_numpy``.  Float
results agree to rtol=atol=1e-5 (only the order of float32 sums differs);
codes and fused tables are equal.  Served on an integer grid (codebooks
and queries integer, no centering) every LUT entry and sum is exact in
float32, so result ids must be equal; with real-valued codebooks the
port's recall must be within 0.01 of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import score as jscore
from jvector_tpu.graph import search as jsearch
from jvector_tpu.ops.pallas import adc16_kernel as jk6
from jvector_tpu.quantization.pq import ProductQuantization as JPQ
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider, search
from jvector_tpu_torch.graph import score as tscore
from jvector_tpu_torch.ops import adc16 as tk6
from jvector_tpu_torch.ops.adc import adc_score
from jvector_tpu_torch.ops.kernels.adc16 import adc16_score_kernel
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

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


def test_pack_unpack_match_jax():
    codes = np.random.default_rng(0).integers(0, 16, size=(37, 24), dtype=np.uint8)
    packed = tk6.pack_nibbles(_t(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jk6.pack_nibbles(jnp.asarray(codes))))
    assert packed.shape == (37, 12) and packed.dtype == torch.uint8
    unpacked = tk6.unpack_nibbles(packed)
    np.testing.assert_array_equal(unpacked.numpy(), codes)
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(jk6.unpack_nibbles(jnp.asarray(packed.numpy()))))
    luts = np.random.default_rng(1).normal(size=(3, 24, 16)).astype(np.float32)
    np.testing.assert_array_equal(tk6.lut_pairs(_t(luts)).numpy(), np.asarray(jk6.lut_pairs(jnp.asarray(luts))))
    with pytest.raises(ValueError):
        tk6.pack_nibbles(_t(codes[:, :23]))


@pytest.mark.parametrize("mp", [16, 13])
def test_k6_twin_matches_jax_and_pallas(mp):
    """K6's twin against the JAX ``adc16_ref`` and the Pallas kernel in
    interpret mode (MP = 13 exercises its pad to 8 sublanes); on CPU
    tensors the wrapper runs the twin and counts no launch."""
    rng = np.random.default_rng(mp)
    q, c = 12, 70
    luts = rng.normal(size=(q, mp, 32)).astype(np.float32)
    codes = rng.integers(0, 256, size=(q, mp, c), dtype=np.uint8)
    got = tk6.adc16_ref(_t(luts), _t(codes)).numpy()
    np.testing.assert_allclose(got, np.asarray(jk6.adc16_ref(jnp.asarray(luts), jnp.asarray(codes))), **TOL)
    pallas = jk6.adc16_pallas(jnp.asarray(luts), jnp.asarray(codes), query_block=8, cand_block=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    before = adc16_score_kernel.launches
    np.testing.assert_array_equal(adc16_score_kernel(_t(luts), _t(codes)).numpy(), got)
    assert adc16_score_kernel.launches == before
    shared = tk6.adc16_ref(_t(luts[:1]).expand(q, -1, -1), _t(codes)).numpy()  # one table, query stride 0
    np.testing.assert_allclose(shared, np.asarray(jk6.adc16_ref(jnp.broadcast_to(luts[:1], luts.shape),
                                                                jnp.asarray(codes))), **TOL)


def test_k6_twin_matches_k5_twin_on_unpacked_codes():
    """LUT16 on packed codes equals 8-bit ADC on the unpacked ones."""
    rng = np.random.default_rng(1)
    q, c, m = 5, 9, 16
    luts = _t(rng.normal(size=(q, m, 16)).astype(np.float32))
    codes = _t(rng.integers(0, 16, size=(q, c, m), dtype=np.uint8))
    packed = tk6.pack_nibbles(codes.reshape(q * c, m)).reshape(q, c, m // 2).transpose(1, 2).contiguous()
    got = tk6.adc16_ref(tk6.lut_pairs(luts), packed)
    torch.testing.assert_close(got, adc_score(luts, codes), **TOL)


@pytest.fixture(scope="module")
def trained():
    """The JAX package's LUT16 PQ (M=16, K=16, centered) on a 600 x 32
    corpus, and a neighbor table with -1 padding."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(600, 32)).astype(np.float32)
    jq = JPQ.compute(data, m=16, clusters=16)
    packed = np.asarray(jk6.pack_nibbles(jq.encode(data)))
    nbrs = rng.integers(0, data.shape[0], (data.shape[0], 12)).astype(np.int32)
    nbrs[rng.random(nbrs.shape) < 0.2] = -1
    return data, jq, packed, nbrs


def test_build_fused_codes_lut16_equal(trained):
    _, _, packed, nbrs = trained
    jf = np.asarray(jscore.build_fused_codes_lut16(jnp.asarray(nbrs), jnp.asarray(packed), chunk=250))
    tf = tscore.build_fused_codes_lut16(_t(nbrs), _t(packed), chunk=400)
    assert tf.dtype == torch.uint8 and tuple(tf.shape) == (600, 8, 12)
    np.testing.assert_array_equal(tf.numpy(), jf)


@pytest.mark.parametrize("sim", SIMS)
def test_lut16_provider_matches(trained, sim):
    data, jq, packed, nbrs = trained
    n = data.shape[0]
    jf = jscore.build_fused_codes_lut16(jnp.asarray(nbrs), jnp.asarray(packed))
    jp = jscore.LUT16ScoreProvider(codes_packed=jnp.asarray(packed), fused_packed=jf, codebooks=jq.codebooks,
                                   center=jq.center, sim=sim)
    tp = convert.lut16_from_numpy(packed, np.asarray(jf), np.asarray(jq.codebooks), np.asarray(jq.center), sim,
                                  device="cpu")
    assert (tp.exact, tp.supports_fused, tp.padded_dim) == (jp.exact, jp.supports_fused, jp.padded_dim)
    rng = np.random.default_rng(5)
    queries = rng.normal(size=(6, 30)).astype(np.float32)  # padded to 32 by prepare
    jl, tl = jp.prepare(jnp.asarray(queries)), tp.prepare(_t(queries))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    ids = rng.integers(0, n, (6, 9)).astype(np.int32)
    np.testing.assert_allclose(tp.score(tl, _t(ids)).numpy(), np.asarray(jp.score(jl, jnp.asarray(ids))), **TOL)
    for node_ids in (rng.integers(0, n, (6,)), rng.integers(0, n, (6, 1)), rng.integers(0, n, (6, 4))):
        node_ids = node_ids.astype(np.int32)  # [Q], E = 1 and E = 4
        np.testing.assert_allclose(
            tp.score_edges(tl, _t(node_ids)).numpy(), np.asarray(jp.score_edges(jl, jnp.asarray(node_ids))), **TOL
        )
    nodes = ids[:, 0]
    np.testing.assert_allclose(
        tp.score_nodes(_t(nodes), _t(ids)).numpy(), np.asarray(jp.score_nodes(jnp.asarray(nodes), jnp.asarray(ids))),
        **TOL,
    )
    np.testing.assert_allclose(
        tp.pairwise(_t(ids[:3]), _t(ids[3:, :5])).numpy(),
        np.asarray(jp.pairwise(jnp.asarray(ids[:3]), jnp.asarray(ids[3:, :5]))), **TOL,
    )
    np.testing.assert_allclose(
        tp.decode_centered(_t(ids)).numpy(), np.asarray(jp.decode_centered(jnp.asarray(ids))), **TOL
    )


N, D, Q, SCALE = 2000, 32, 128, 16.0


@pytest.fixture(scope="module")
def served():
    """A JAX-built graph (n=2000, d=32, base scaled x16, the default
    config) carried into the port with its exact reranker."""
    ds = synthetic_dataset(n=N, dim=D, n_queries=Q, k=10, seed=3, device="cpu")
    base = (ds.base * SCALE).astype(np.float32)
    jg, jex = jbuild(base, "euclidean", JConfig())
    tg = convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
    )
    tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)))
    return ds, base, (jg, jex), (tg, tex)


def _providers(base, jg, jq):
    codes = np.asarray(jk6.pack_nibbles(jq.encode(base)))
    packed = np.zeros((jg.capacity, codes.shape[1]), np.uint8)
    packed[:N] = codes
    jf = jscore.build_fused_codes_lut16(jg.base.neighbors, jnp.asarray(packed))
    jp = jscore.LUT16ScoreProvider(codes_packed=jnp.asarray(packed), fused_packed=jf, codebooks=jq.codebooks,
                                   center=jq.center, sim="euclidean")
    center = None if jq.center is None else np.asarray(jq.center)
    tp = convert.lut16_from_numpy(packed, np.asarray(jf), np.asarray(jq.codebooks), center, "euclidean", device="cpu")
    return jp, tp


def _serve(served, jp, tp, queries, expand):
    _, _, (jg, jex), (tg, tex) = served
    kw = dict(top_k=10, beam_width=40, rerank_k=40, expand_per_iter=expand)
    a = jsearch(jg, jp, jnp.asarray(queries), reranker=jex, **kw)
    b = search(tg, tp, torch.as_tensor(queries), reranker=tex, **kw)
    return a, b


@pytest.mark.parametrize("expand", [1, 4])
def test_serve_jax_built_graph_ids_equal_on_integer_grid(served, expand):
    """Integer codebooks and queries, no centering: the LUT16 first pass is
    exact in float32 in both packages, so ids and counts are equal."""
    ds, base, (jg, _), _ = served
    trained = JPQ.compute(base, m=D // 2, clusters=16, globally_center=False)
    jq = JPQ(codebooks=jnp.round(trained.codebooks), center=None, original_dim=D)
    jp, tp = _providers(base, jg, jq)
    queries = np.round(ds.queries * SCALE).astype(np.float32)
    a, b = _serve(served, jp, tp, queries, expand)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_allclose(b.scores.numpy(), np.asarray(a.scores), **TOL)
    np.testing.assert_array_equal(b.approx_scores.numpy(), np.asarray(a.approx_scores))
    np.testing.assert_array_equal(b.visited_count.numpy(), np.asarray(a.visited_count))
    np.testing.assert_array_equal(b.expanded_count.numpy(), np.asarray(a.expanded_count))


def test_serve_real_valued_recall_matches_jax(served):
    """Real-valued, centered codebooks: recall@10 within 0.01 of the JAX
    package's on the same graph, at E = 1 and E = 4."""
    ds, base, (jg, _), _ = served
    jq = JPQ.compute(base, m=D // 2, clusters=16)
    jp, tp = _providers(base, jg, jq)
    queries = (ds.queries * SCALE).astype(np.float32)  # the same neighbours as ds.ground_truth
    for expand in (1, 4):
        a, b = _serve(served, jp, tp, queries, expand)
        ra = recall_at_k(np.asarray(a.ids), ds.ground_truth, 10)
        rb = recall_at_k(b.ids.numpy(), ds.ground_truth, 10)
        assert ra >= 0.9 and abs(rb - ra) <= 0.01, (expand, ra, rb)
