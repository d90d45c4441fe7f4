"""BQ and NVQ in the port against the JAX package: bit packing, hamming
similarity, the BQ provider, the NVQ encode (its growth-rate sweep), the
NVQ reranker, and a BQ first pass with NVQ rerank on a JAX-built graph.

Both packages get the same numpy inputs; the JAX package's quantizers go
into the port through ``convert``.  BQ codes are the JAX package's uint32
words read as int32 and must be equal bit for bit, bit 31 included, as
must BQ scores (the same integer counts over the same divisor, rounded as
the JAX package's search rounds them: its provider calls run under
``jax.jit`` here, as inside the search).  NVQ's
encode differs only in float32 rounding (the order of sums, and torch's
``exp`` against XLA's), so its per-vector fit is held to rtol=1e-6, its
growth rates to equality on >= 99% of (vector, sub-vector) pairs and its
codes to equality wherever the growth rate is equal, but for a code whose
unrounded value ``255 * w`` lies within 1e-3 of a rounding boundary in the
JAX package's own computation: one ulp of ``exp`` can round that one the
other way, so it may differ by one level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import search as jsearch
from jvector_tpu.ops import hamming as jham
from jvector_tpu.quantization import BinaryQuantization as JBQ
from jvector_tpu.quantization import NVQuantization as JNVQ
from jvector_tpu.quantization.nvq import _warp as jwarp
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import BQScoreProvider, search
from jvector_tpu_torch.ops import hamming as tham
from jvector_tpu_torch.quantization import BinaryQuantization, NVQuantization
from jvector_tpu_torch.quantization import nvq as tnvq
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

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


def _words(jcodes) -> np.ndarray:
    """The JAX package's uint32 words as the port's int32, bit for bit."""
    return np.asarray(jcodes).view(np.int32)


@pytest.mark.parametrize("d", [32, 70, 1536])
def test_pack_bits_hamming_and_similarity_match(d):
    rng = np.random.default_rng(d)
    a = rng.normal(size=(40, d)).astype(np.float32)
    b = rng.normal(size=(25, d)).astype(np.float32)
    a[:, 31] = np.abs(a[:, 31]) + 0.5  # bit 31 of the first word set in every row
    ja, jb = jham.pack_bits(jnp.asarray(a)), jham.pack_bits(jnp.asarray(b))
    ta, tb = tham.pack_bits(_t(a)), tham.pack_bits(_t(b))
    assert ta.dtype == torch.int32 and ta.shape == (40, tham.packed_words(d))
    np.testing.assert_array_equal(ta.numpy(), _words(ja))
    np.testing.assert_array_equal(tb.numpy(), _words(jb))
    assert (ta[:, 0] < 0).all()  # the sign bit is bit 31
    np.testing.assert_array_equal(
        tham.hamming_distance(ta[:, None, :], tb[None, :, :]).numpy(),
        np.asarray(jham.hamming_distance(ja[:, None, :], jb[None, :, :])),
    )
    for dim in (None, d):
        np.testing.assert_array_equal(tham.bq_similarity(ta, tb, dim=dim).numpy(),
                                      np.asarray(jham.bq_similarity(ja, jb, dim=dim)))


def test_popcount_every_bit_pattern_edge():
    """Words with the sign bit, all ones, single bits and alternations."""
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555, 0xAAAAAAAA, 0x80000001, 0xF0F0F0F0],
                     np.uint64).astype(np.uint32)
    want = np.array([bin(int(w)).count("1") for w in words], np.int32)
    np.testing.assert_array_equal(tham.popcount32(_t(words.view(np.int32))).numpy(), want)


@pytest.fixture(scope="module")
def bq_pair():
    ds = synthetic_dataset(n=600, dim=70, n_queries=32, k=10, seed=5, device="cpu")
    jbq = JBQ.compute(ds.base)
    tbq = convert.bq_from_numpy(np.asarray(jbq.center), jbq.original_dim, device="cpu")
    jcodes = jbq.encode(ds.base)
    tcodes = tbq.encode(ds.base)
    return ds, jbq, tbq, jcodes, tcodes


def test_bq_encode_and_provider_match(bq_pair):
    ds, jbq, tbq, jcodes, tcodes = bq_pair
    np.testing.assert_array_equal(tcodes.numpy(), _words(jcodes))
    np.testing.assert_array_equal(convert.bq_codes_from_numpy(np.asarray(jcodes), device="cpu").numpy(), tcodes.numpy())
    assert tbq.compressed_size == jbq.compressed_size == 12
    jp, tp = jbq.provider(jcodes), tbq.provider(tcodes)
    assert isinstance(tp, BQScoreProvider) and tp.exact is False and tp.dim == 70
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 600, (32, 48)).astype(np.int32)
    jq, tq = jax.jit(jp.prepare)(jnp.asarray(ds.queries)), tp.prepare(_t(ds.queries))
    np.testing.assert_array_equal(tq.numpy(), _words(jq))
    assert torch.equal(tp.score(tq, _t(ids)), _t(jax.jit(jp.score)(jq, jnp.asarray(ids))))
    nodes = rng.integers(0, 600, 32).astype(np.int32)
    assert torch.equal(tp.score_nodes(_t(nodes), _t(ids)),
                       _t(jax.jit(jp.score_nodes)(jnp.asarray(nodes), jnp.asarray(ids))))
    ia, ib = ids[:4, :12], ids[4:8, :20]
    assert torch.equal(tp.pairwise(_t(ia), _t(ib)), _t(jax.jit(jp.pairwise)(jnp.asarray(ia), jnp.asarray(ib))))
    # dim 0 falls back to W * 32, as in the JAX package
    p0 = BQScoreProvider(codes=tcodes, center=tbq.center)
    jp0 = jp.__class__(jcodes, jbq.center)
    assert torch.equal(p0.score(tq, _t(ids)), _t(jax.jit(jp0.score)(jq, jnp.asarray(ids))))


def test_bq_compute_centroid_close():
    data = np.random.default_rng(1).normal(size=(500, 40)).astype(np.float32)
    tbq = BinaryQuantization.compute(data, device="cpu")
    np.testing.assert_allclose(tbq.center.numpy(), np.asarray(JBQ.compute(data).center), rtol=1e-5, atol=1e-6)


def test_fine_offsets_are_jax_float32_values():
    want = np.asarray(jnp.arange(-0.9, 0.91, 0.1))
    assert want.dtype == np.float32 and tnvq.FINE_OFFSETS.dtype == np.float32
    np.testing.assert_array_equal(tnvq.FINE_OFFSETS, want)
    np.testing.assert_array_equal(tnvq.COARSE_RATES, np.asarray(jnp.concatenate([jnp.zeros((1,)), jnp.arange(1.0, 21.0)])))


@pytest.fixture(scope="module")
def nvq_pair():
    ds = synthetic_dataset(n=700, dim=61, n_queries=24, k=10, seed=9, device="cpu")  # odd d: a padded sub-vector
    jq = JNVQ.compute(ds.base)
    jv = jq.encode(ds.base)
    tq = convert.nvq_from_numpy(np.asarray(jq.mean), jq.original_dim, jq.num_subvectors, jq.bits, device="cpu")
    return ds, jq, jv, tq


def test_nvq_encode_matches(nvq_pair):
    ds, jq, jv, tq = nvq_pair
    tv = tq.encode(ds.base)
    jp, tp = np.asarray(jv.params), tv.params.numpy()
    jc, tc = np.asarray(jv.codes), tv.codes.numpy()
    assert tc.shape == jc.shape == (700, 2, 31) and tc.dtype == np.uint8
    for j, name in ((0, "lo"), (1, "scale"), (3, "midpoint")):
        np.testing.assert_allclose(tp[..., j], jp[..., j], rtol=1e-6, atol=1e-7, err_msg=name)
    same = tp[..., 2] == jp[..., 2]
    assert same.mean() >= 0.99, f"growth equal on {same.mean():.4f} of pairs"
    # where the growth rates agree, codes differ only at a rounding boundary
    x = np.asarray(ds.base) - np.asarray(jq.mean)
    xs = np.pad(x, ((0, 0), (0, jq.padded_dim - x.shape[1]))).reshape(700, 2, 31)
    t = (xs - jp[..., 0:1]) / jp[..., 1:2]
    unrounded = np.asarray(jwarp(jnp.asarray(t), jnp.asarray(jp[..., 2:3]), jnp.asarray(jp[..., 3:4]))) * 255.0
    off = (tc != jc) & same[..., None]
    assert off.sum() <= 3, f"{off.sum()} codes differ where the growth rate agrees"
    np.testing.assert_array_equal(np.abs(tc[off].astype(int) - jc[off].astype(int)), 1)
    assert (np.abs(unrounded[off] - np.floor(unrounded[off]) - 0.5) < 1e-3).all(), unrounded[off]
    assert len(np.unique(jp[..., 2])) > 3  # the sweep really chose among rates
    # dequantize: the same codes and params give the same vectors; each
    # package's own encoding reconstructs the corpus equally well
    ids = np.arange(700, dtype=np.int32)
    want = np.asarray(jv.dequantize(jnp.asarray(ids)))
    carried = convert.nvq_vectors_from_numpy(jc, jp, tq)
    np.testing.assert_allclose(carried.dequantize(_t(ids)).numpy(), want, atol=1e-4)
    err_t = np.mean(np.sum((tv.dequantize(_t(ids)).numpy() - ds.base) ** 2, axis=1))
    err_j = np.mean(np.sum((want - ds.base) ** 2, axis=1))
    assert abs(err_t - err_j) <= 0.01 * err_j, (err_t, err_j)
    assert tv.compressed_size == jv.compressed_size


def test_nvq_encode_blocks_do_not_change_codes(nvq_pair, monkeypatch):
    ds, _, _, tq = nvq_pair
    whole = tq.encode(ds.base)
    monkeypatch.setattr(tnvq, "_ENCODE_BLOCK", 128)
    blocked = tq.encode(ds.base)
    assert torch.equal(whole.codes, blocked.codes) and torch.equal(whole.params, blocked.params)


@pytest.mark.parametrize("sim", SIMS)
def test_nvq_provider_matches(nvq_pair, sim):
    ds, jq, jv, tq = nvq_pair
    tv = convert.nvq_vectors_from_numpy(np.asarray(jv.codes), np.asarray(jv.params), tq)
    jp, tp = jv.provider(sim), tv.provider(sim)
    assert tp.exact is True
    ids = np.random.default_rng(2).integers(0, 700, (24, 30)).astype(np.int32)
    got = tp.score(tp.prepare(_t(ds.queries)), _t(ids)).numpy()
    want = np.asarray(jp.score(jp.prepare(jnp.asarray(ds.queries)), jnp.asarray(ids)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_nvq_compute_mean_close():
    data = np.random.default_rng(4).normal(size=(300, 48)).astype(np.float32)
    tq = NVQuantization.compute(data, num_subvectors=3, device="cpu")
    jq = JNVQ.compute(data, num_subvectors=3)
    assert (tq.sub_dim, tq.padded_dim) == (jq.sub_dim, jq.padded_dim)
    np.testing.assert_allclose(tq.mean.numpy(), np.asarray(jq.mean), rtol=1e-5, atol=1e-6)


def test_bq_first_pass_nvq_rerank_on_jax_graph():
    """BASELINE config 4's serve at n = 1200 on one JAX-built graph: BQ
    first pass, NVQ rerank at rerank_k = beam, equal ids or recall within
    0.01 of the JAX package's."""
    n, d = 1200, 96
    ds = synthetic_dataset(n=n, dim=d, n_queries=64, k=10, sim="cosine", seed=8, device="cpu")
    jg, _ = jbuild(ds.base, "dot_product", JConfig(max_degree=16, ef_construction=40))
    jbq = JBQ.compute(ds.base)
    jcodes = jnp.asarray(np.concatenate([np.asarray(jbq.encode(ds.base)),
                                         np.zeros((jg.capacity - n, 3), np.uint32)]))
    jnvq = JNVQ.compute(ds.base)
    jv = jnvq.encode(ds.base)
    res_j = jsearch(jg, jbq.provider(jcodes), jnp.asarray(ds.queries), top_k=10, beam_width=40, rerank_k=40,
                    reranker=jv.provider("dot_product"))

    tg = convert.graph_from_numpy(np.asarray(jg.base.neighbors), np.asarray(jg.base.scores),
                                  np.asarray(jg.base.counts), int(jg.entry_node), int(jg.num_nodes), device="cpu")
    tbq = convert.bq_from_numpy(np.asarray(jbq.center), d, device="cpu")
    tnv = convert.nvq_from_numpy(np.asarray(jnvq.mean), d, device="cpu")
    tv = convert.nvq_vectors_from_numpy(np.asarray(jv.codes), np.asarray(jv.params), tnv)
    res_t = search(tg, tbq.provider(convert.bq_codes_from_numpy(np.asarray(jcodes), device="cpu")),
                   _t(ds.queries), top_k=10, beam_width=40, rerank_k=40, reranker=tv.provider("dot_product"))
    ids_j, ids_t = np.asarray(res_j.ids), res_t.ids.numpy()
    r_j, r_t = recall_at_k(ids_j, ds.ground_truth, 10), recall_at_k(ids_t, ds.ground_truth, 10)
    assert np.array_equal(ids_t, ids_j) or abs(r_t - r_j) <= 0.01, (r_t, r_j)
    assert r_j > 0.8
