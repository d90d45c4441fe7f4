"""The port's default-configuration path against the JAX package: the
PQ-scored wave build, the fused SQ4 wave loop that builds the hierarchy's
small levels, the cleanup, the hierarchy and its descent.

Wave-by-wave tests run on an integer-grid corpus whose codebooks (PQ) or
quantizer (SQ4, scale 1 and offset 0) are integers too, so every score is
computed without rounding in both frameworks and the tables must be equal
after every wave.  On real-valued data the port serves a JAX-built
hierarchical graph with equal ids, and a graph the port builds itself with
the JAX package's PQ carried over has the same levels and reaches the JAX
package's recall@10 within 0.01 at each overquery of the default config.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import builder as jb
from jvector_tpu.graph import hierarchy as jh
from jvector_tpu.graph import index as jidx
from jvector_tpu.graph import score as jscore
from jvector_tpu.graph import search as jsearch
from jvector_tpu.quantization import ProductQuantization as JPQ
from jvector_tpu.quantization import sq as jsq
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider, FusedADCScoreProvider, GraphConfig, build_fused_codes, build_graph
from jvector_tpu_torch.graph import builder as tb
from jvector_tpu_torch.graph import hierarchy as th
from jvector_tpu_torch.graph import index as tidx
from jvector_tpu_torch.graph import score as tscore
from jvector_tpu_torch.graph import search
from jvector_tpu_torch.util.datasets import recall_at_k


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


def _grid_corpus(n: int, d: int, seed: int) -> np.ndarray:
    x = synthetic_dataset(n=n, dim=d, n_queries=1, k=1, n_clusters=12, seed=seed).base
    lo, hi = x.min(axis=0), x.max(axis=0)
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


def _layer_np(layer, n_cap):
    return [np.array(a)[:n_cap] for a in layer]


def _assert_layers_equal(tlayer, jlayer, n_cap, what):
    for name, a, b in zip(("neighbors", "scores", "counts"), _layer_np(jlayer, n_cap), _layer_np(tlayer, n_cap)):
        if name == "scores":
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("n, degree, seed", [(1, 32, 0), (5000, 32, 0), (4000, 16, 7)])
def test_assign_levels_match(n, degree, seed):
    np.testing.assert_array_equal(th.assign_levels(n, degree, seed), jh.assign_levels(n, degree, seed))


def test_slots_for_and_level_provider_match():
    ids = np.array([3, 9, 10, 40, 77], np.int32)
    base = np.array([77, 3, 10], np.int32)
    np.testing.assert_array_equal(th.slots_for(_t(ids), _t(base)).numpy(), np.asarray(jh.slots_for(jnp.asarray(ids), jnp.asarray(base))))
    vecs = np.random.default_rng(0).normal(size=(80, 8)).astype(np.float32)
    q = vecs[:2] + 0.1
    jp = jh.LevelProvider(inner=jscore.ExactScoreProvider(vectors=jnp.asarray(vecs)), node_ids=jnp.asarray(ids))
    tp = th.LevelProvider(inner=tscore.ExactScoreProvider(vectors=_t(vecs)), node_ids=_t(ids))
    slots = np.array([[0, 4, 2], [1, 1, 3]], np.int32)
    np.testing.assert_allclose(
        tp.score(tp.prepare(_t(q)), _t(slots)).numpy(),
        np.asarray(jp.score(jp.prepare(jnp.asarray(q)), jnp.asarray(slots))), rtol=1e-6,
    )


@pytest.fixture(scope="module")
def pq_build():
    """Both packages' PQ-scored wave loops side by side (3 waves of 512, the
    last one ragged), then the cleanup; the tables after every wave."""
    n, d, m, k = 1100, 32, 8, 16
    data = _grid_corpus(n, d, seed=21)
    rng = np.random.default_rng(5)
    s = d // m
    codebooks = np.stack([data[rng.choice(n, k, replace=False), i * s : (i + 1) * s] for i in range(m)])
    n_cap = jidx.bucket_capacity(n)
    codes = np.zeros((n_cap, m), np.uint8)
    jq = JPQ(codebooks=jnp.asarray(codebooks), center=None, original_dim=d)
    codes[:n] = np.asarray(jq.encode(data))
    tq = convert.pq_from_numpy(codebooks, None, d, device="cpu")
    np.testing.assert_array_equal(tq.encode(data).numpy(), codes[:n])
    jprov, tprov = jq.provider(jnp.asarray(codes), "euclidean"), tq.provider(_t(codes), "euclidean")
    cfg_j, cfg_t = JConfig(), GraphConfig()
    w = cfg_j.wave_size
    jg, tg = jidx.empty_graph(n_cap, cfg_j), tb._sink_graph(n_cap, cfg_t, "cpu")
    seeds = jb._EntrySeedSampler(n, w, cfg_j.build_entry_seeds)
    waves = []
    for start in jb._shuffled_wave_starts(n, w):
        ids = np.arange(start, start + w, dtype=np.int32)
        ids = np.where(ids < n, ids, -1)
        wv = data[np.minimum(np.arange(start, start + w), n - 1)]
        seed = seeds.sample()
        jg = jb._insert_wave(jg, jprov, jnp.asarray(ids), jnp.asarray(wv), cfg_j, seed_ids=seed)
        tg = tb._insert_wave(tg, tprov, _t(ids), _t(wv), cfg_t, seed_ids=_t(seed))
        seeds.record(ids)
        waves.append((_layer_np(jg.base, n_cap), _layer_np(tg.base, n_cap),
                      (int(jg.entry_node), int(jg.num_nodes)), (int(tg.entry_node), int(tg.num_nodes))))
    jc = jb.GraphIndexBuilder(cfg_j).cleanup(jg, jprov, jnp.asarray(data))
    tc = tb.GraphIndexBuilder(cfg_t).cleanup(tb._drop_sink(tg), tprov, _t(data))
    return dict(n_cap=n_cap, waves=waves, jc=jc, tc=tc)


@pytest.mark.parametrize("wave", [0, 1, 2])
def test_pq_insert_wave_matches(pq_build, wave):
    jl, tl, jbk, tbk = pq_build["waves"][wave]
    for name, a, b in zip(("neighbors", "scores", "counts"), jl, tl):
        np.testing.assert_array_equal(b.view(np.int32) if name == "scores" else b,
                                      a.view(np.int32) if name == "scores" else a, err_msg=name)
    assert tbk == jbk


def test_pq_cleanup_matches(pq_build):
    jc, tc, n_cap = pq_build["jc"], pq_build["tc"], pq_build["n_cap"]
    _assert_layers_equal(tc.base, jc.base, n_cap, "cleanup")
    assert tc.capacity == jc.capacity == n_cap
    assert int(tc.entry_node) == int(jc.entry_node)
    assert int(tc.base.counts.max()) <= 32


@pytest.mark.parametrize("d", [32, 30, 96], ids=["slot_patch", "full_rows", "whole_tile_full_rows"])
def test_fused_wave_loop_matches(d):
    """The unpacked SQ4 loop (the hierarchy's small levels): 64-node waves
    are not packed-eligible.  d=32 keeps a whole-tile ``[N, T, 128]`` fused
    table updated by K2's slot patches; d=30 (15-byte codes) a 2-D table
    rewritten row by row; d=96 (48-byte codes, which do not tile 128
    lanes) a whole-tile ``[N, 24, 128]`` table rewritten row by row through
    K4a's twin.  Graph and fused tables equal after every wave."""
    n = 400
    data = _grid_corpus(n, d, seed=3)
    n_cap = jidx.bucket_capacity(n)
    mp = (d + 1) // 2
    cfg_j = jb._fused_aligned_config(JConfig(wave_size=64), mp)
    cfg_t = tb._fused_aligned_config(GraphConfig(wave_size=64), mp)
    assert cfg_j.row_cap == cfg_t.row_cap
    assert not tb._packed_build_eligible(cfg_t, mp, n_cap) and not jb._packed_build_eligible(cfg_j, mp, n_cap)
    k_row = cfg_t.row_cap * mp
    assert (k_row % 1024 == 0) == (d != 30)
    assert tb._slot_patch_supported(2 if d == 30 else 3, mp) == (d == 32)
    one, zero = np.ones(d, np.float32), np.zeros(d, np.float32)
    jq = jsq.ScalarQuantization4(scale=jnp.asarray(one), offset=jnp.asarray(zero), original_dim=d)
    codes = np.zeros((n_cap, mp), np.uint8)
    codes[:n] = np.asarray(jq.encode(data))
    jw2, jn2 = jq.node_constants(jnp.asarray(codes))
    jbp = jscore.SQ4ScoreProvider(
        codes_packed=jnp.asarray(codes), node_w2=jw2, node_norm2=jn2,
        fused_packed=jnp.zeros((n_cap, 0), jnp.uint8), fused_w2=jnp.zeros((n_cap, 0)),
        scale=jq.scale, offset=jq.offset, codes_aug=jscore.sq4_aug_rows(jnp.asarray(codes), jw2),
    )
    tw2 = _t(jw2)
    tbp = tscore.SQ4ScoreProvider(
        codes_packed=_t(codes), node_w2=tw2, node_norm2=_t(jn2),
        fused_packed=torch.zeros((n_cap, 0), dtype=torch.uint8), fused_w2=torch.zeros((n_cap, 0)),
        scale=_t(one), offset=_t(zero), codes_aug=tscore.sq4_aug_rows(_t(codes), tw2),
    )
    pv = np.zeros((n_cap, d), np.float32)
    pv[:n] = data
    jprov, tprov = jscore.ExactScoreProvider(vectors=jnp.asarray(pv)), tscore.ExactScoreProvider(vectors=_t(pv))
    shape = (n_cap, k_row // 128, 128) if k_row % 1024 == 0 else (n_cap, k_row)
    jf, jw = jnp.zeros(shape, jnp.uint8), jnp.zeros((n_cap, cfg_j.row_cap), jnp.float32)
    tf = torch.zeros((n_cap + 1,) + shape[1:], dtype=torch.uint8)
    tw = torch.zeros((n_cap + 1, cfg_t.row_cap))
    jg, tg = jidx.empty_graph(n_cap, cfg_j), tb._sink_graph(n_cap, cfg_t, "cpu")
    w = cfg_j.wave_size
    seeds = jb._EntrySeedSampler(n, w, cfg_j.build_entry_seeds)
    for i, start in enumerate(jb._shuffled_wave_starts(n, w)):
        ids = np.arange(start, start + w, dtype=np.int32)
        ids = np.where(ids < n, ids, -1)
        wv = pv[start : start + w]
        seed = seeds.sample()
        jbeam = jb._wave_search(jg.base.neighbors, dataclasses.replace(jbp, fused_packed=jf, fused_w2=jw),
                                jg.entry_node, jnp.asarray(ids), jnp.asarray(wv), cfg_j, seed)
        tbeam = tb._wave_search(tg.base.neighbors, dataclasses.replace(tbp, fused_packed=tf, fused_w2=tw),
                                tg.entry_node, _t(ids), _t(wv), cfg_t, _t(seed))
        seeds.record(ids)
        np.testing.assert_array_equal(tbeam[0].numpy(), np.asarray(jbeam[0]), err_msg=f"wave {i} beam ids")
        jg, jf, jw = jb._wave_update_fused(jg, jf, jw, jprov, jbp.codes_packed, jbp.node_w2,
                                           jnp.asarray(ids), jnp.asarray(wv), *jbeam, cfg_j)
        tg = tb._wave_update_fused(tg, tf, tw, tprov, tbp.codes_packed, tbp.node_w2,
                                   _t(ids), _t(wv), *tbeam, cfg_t)
        _assert_layers_equal(tg.base, jg.base, n_cap, f"wave {i}")
        np.testing.assert_array_equal(tf[:n_cap].numpy(), np.asarray(jf), err_msg=f"wave {i} fused codes")
        np.testing.assert_array_equal(tw[:n_cap].numpy().view(np.int32), np.asarray(jw).view(np.int32))
        assert (int(tg.entry_node), int(tg.num_nodes)) == (int(jg.entry_node), int(jg.num_nodes))


# -- the default configuration on real-valued data --------------------------

N, D, M, Q = 3000, 32, 4, 200
OVERQUERY = (1, 2, 5, 10)


@pytest.fixture(scope="module")
def default_config():
    """The JAX package's default configuration (PQ M=d/8, K=256, uncentered,
    hierarchy) and the port's, built from the same JAX-trained PQ."""
    ds = synthetic_dataset(n=N, dim=D, n_queries=Q, k=10, seed=0)
    jpq = JPQ.compute(ds.base, m=M, clusters=256, globally_center=False)
    n_cap = jidx.bucket_capacity(N)
    codes = np.zeros((n_cap, M), np.uint8)
    codes[:N] = np.asarray(jpq.encode(ds.base))
    cfg = dict(max_degree=32, ef_construction=100, neighbor_overflow=1.2, add_hierarchy=True)
    jg, _ = jbuild(ds.base, "euclidean", JConfig(**cfg), provider=jpq.provider(jnp.asarray(codes), "euclidean"))
    tpq = convert.pq_from_numpy(np.asarray(jpq.codebooks), None, D, device="cpu")
    tg, tprov = build_graph(ds.base, "euclidean", GraphConfig(**cfg), provider=tpq.provider(_t(codes), "euclidean"),
                            device="cpu")
    pv = np.zeros((n_cap, D), np.float32)
    pv[:N] = ds.base
    return dict(ds=ds, codes=codes, jpq=jpq, tpq=tpq, jg=jg, tg=tg, tprov=tprov, pv=pv)


def test_default_config_build_levels_match(default_config):
    jg, tg = default_config["jg"], default_config["tg"]
    assert tg.num_levels == jg.num_levels >= 2
    for a, b in zip(jg.level_node_ids, tg.level_node_ids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert [lay.neighbors.shape for lay in tg.layers] == [tuple(lay.neighbors.shape) for lay in jg.layers]
    assert int(tg.num_nodes) == N and int(tg.base.counts.max()) <= 32
    assert default_config["tprov"].codes.shape[0] == tg.capacity  # the explicit provider is returned


def test_default_config_recall_matches(default_config):
    """ADC first pass + FP32 rerank at beam = rerank_k = 10 x overquery."""
    c = default_config
    ds, n_cap = c["ds"], c["jg"].capacity
    jex = jscore.ExactScoreProvider(vectors=jnp.asarray(c["pv"]))
    tex = ExactScoreProvider(vectors=_t(c["pv"]))
    jfirst = c["jpq"].provider(jnp.asarray(c["codes"][:N]), "euclidean")
    tfirst = c["tpq"].provider(_t(c["codes"][:N]), "euclidean")
    for oq in OVERQUERY:
        beam = 10 * oq
        a = jsearch(c["jg"], jfirst, jnp.asarray(ds.queries), top_k=10, beam_width=beam, rerank_k=beam, reranker=jex)
        b = search(c["tg"], tfirst, _t(ds.queries), top_k=10, beam_width=beam, rerank_k=beam, reranker=tex)
        ra = recall_at_k(np.asarray(a.ids), ds.ground_truth, 10)
        rb = recall_at_k(b.ids.numpy(), ds.ground_truth, 10)
        assert abs(rb - ra) <= 0.01, (beam, ra, rb)
    assert n_cap == c["tg"].capacity


@pytest.mark.parametrize("first", ["exact", "pq", "fused_pq"])
def test_serve_jax_built_hierarchy_ids_equal(default_config, first):
    """A JAX-built hierarchical graph, carried over with its upper layers,
    serves equal ids through the descent and the base-layer beam."""
    c = default_config
    jg, ds = c["jg"], c["ds"]
    tg = convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
        upper_layers=[tuple(np.asarray(a) for a in lay) for lay in jg.layers[1:]],
        level_node_ids=[np.asarray(i) for i in jg.level_node_ids],
    )
    jex = jscore.ExactScoreProvider(vectors=jnp.asarray(c["pv"]))
    tex = ExactScoreProvider(vectors=_t(c["pv"]))
    codes = c["codes"]
    if first == "exact":
        jp, tp, rer = jex, tex, {}
    elif first == "pq":
        jp, tp = c["jpq"].provider(jnp.asarray(codes), "euclidean"), c["tpq"].provider(_t(codes), "euclidean")
    else:
        jf = jscore.build_fused_codes(jg.base.neighbors, jnp.asarray(codes))
        jp = jscore.FusedADCScoreProvider(codes=jnp.asarray(codes), fused_codes=jf, codebooks=c["jpq"].codebooks,
                                          center=None, sim="euclidean")
        tp = FusedADCScoreProvider(codes=_t(codes), fused_codes=build_fused_codes(tg.base.neighbors, _t(codes)),
                                   codebooks=c["tpq"].codebooks, center=None)
    kw = dict(top_k=10, beam_width=30)
    if first != "exact":
        kw.update(rerank_k=30)
    a = jsearch(jg, jp, jnp.asarray(ds.queries), **kw, **({} if first == "exact" else dict(reranker=jex)))
    b = search(tg, tp, _t(ds.queries), **kw, **({} if first == "exact" else dict(reranker=tex)))
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_allclose(b.scores.numpy(), np.asarray(a.scores), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(b.visited_count.numpy(), np.asarray(a.visited_count))
