"""The rest of the search API and the graph refine in the port, against the
JAX package: threshold search, resume with and without the beam state,
``exclude_ids``, ``hierarchy_beam``, ``score_nodes`` of the exact and SQ4
providers, ``refine_graph`` and ``rescore_graph``.

A hierarchical JAX-built graph (n=1500, d=24, the corpus of
``tests/test_search_api.py``) is carried into the port through
``jvector_tpu_torch.convert``; both packages search the same numpy queries
with exact scoring, so ids, counters and states must be equal and scores
agree to rtol=atol=1e-5.  Refine and rescore with the exact provider give
the JAX package's adjacency bit for bit on an integer-grid corpus (the one
of ``tests/test_torch_build.py``, where every score is exact), and on the
float corpus the refined graph's recall stays within 0.01 of the JAX
package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jvector_tpu.graph.searcher as jsearcher
import jvector_tpu_torch.graph.searcher as tsearcher
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import score as jscore
from jvector_tpu.graph.builder import refine_graph as jrefine
from jvector_tpu.graph.builder import rescore_graph as jrescore
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu.quantization.pq import ProductQuantization as JPQ
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig
from jvector_tpu_torch.graph.builder import refine_graph, rescore_graph
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(max_degree=16, ef_construction=40, wave_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_graph(jg):
    upper = [(np.asarray(l.neighbors), np.asarray(l.scores), np.asarray(l.counts)) for l in jg.layers[1:]]
    return convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
        upper_layers=upper, level_node_ids=[np.asarray(i) for i in jg.level_node_ids],
    )


@pytest.fixture(scope="module")
def built():
    ds = synthetic_dataset(n=1500, dim=24, n_queries=25, k=50, seed=101, device="cpu")
    jg, jex = jbuild(ds.base, ds.similarity.value, JConfig(add_hierarchy=True, **CFG))
    assert jg.num_levels > 1
    tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)), sim=ds.similarity)
    return ds, (jg, jex), (_port_graph(jg), tex)


def _same(a, b, counts=True):
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    ok = np.asarray(a.ids) >= 0
    np.testing.assert_allclose(b.scores.numpy()[ok], np.asarray(a.scores)[ok], **TOL)
    if counts:
        for name in ("visited_count", "expanded_count", "reranked_count"):
            np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)), err_msg=name)


def _both(built, fn_j, fn_t):
    ds, (jg, jex), (tg, tex) = built
    return fn_j(jg, jex, jnp.asarray(ds.queries)), fn_t(tg, tex, torch.as_tensor(ds.queries))


def test_threshold_search_matches_jax(built):
    """Results below the threshold are dropped and stale queries retire
    (the stale counter): equal ids and expansion counts."""
    ds, (jg, jex), (tg, tex) = built
    free = jsearcher.search(jg, jex, jnp.asarray(ds.queries), top_k=20, beam_width=60)
    thr = float(np.median(np.asarray(free.scores)))
    a, b = _both(built, lambda g, p, q: jsearcher.search(g, p, q, top_k=20, beam_width=60, threshold=thr),
                 lambda g, p, q: tsearcher.search(g, p, q, top_k=20, beam_width=60, threshold=thr))
    _same(a, b)
    ids = b.ids.numpy()
    assert (b.scores.numpy()[ids >= 0] >= thr).all() and (ids < 0).any()
    assert b.expanded_count.sum() < torch.as_tensor(np.asarray(free.expanded_count)).sum()


@pytest.mark.parametrize("beam", [40, 12])
def test_resume_with_state_matches_jax(built, beam):
    """``return_state`` gives the JAX package's state (beam, history ring,
    step count), and ``resume`` from it the same next page; at beam 12 the
    page runs past the original beam (the re-opened quiescent frontier)."""
    ds, (jg, jex), (tg, tex) = built
    first_j, st_j = jsearcher.search(jg, jex, jnp.asarray(ds.queries), top_k=10, beam_width=beam, return_state=True)
    first_t, st_t = tsearcher.search(tg, tex, torch.as_tensor(ds.queries), top_k=10, beam_width=beam,
                                     return_state=True)
    _same(first_j, first_t)
    for name in ("ids", "expanded", "history"):
        np.testing.assert_array_equal(getattr(st_t, name).numpy(), np.asarray(getattr(st_j, name)), err_msg=name)
    assert st_t.iters == int(st_j.iters)
    a = jsearcher.resume(jg, jex, jnp.asarray(ds.queries), first_j, top_k=10, state=st_j)
    b = tsearcher.resume(tg, tex, torch.as_tensor(ds.queries), first_t, top_k=10, state=st_t)
    _same(a, b)
    ids = b.ids.numpy()
    assert (ids >= 0).all()
    assert not (first_t.ids.numpy()[:, :, None] == ids[:, None, :]).any()
    combined = np.concatenate([first_t.ids.numpy(), ids], axis=1)
    assert recall_at_k(combined, ds.ground_truth[:, :20], 20) >= (0.9 if beam == 40 else 0.8)


def test_resume_without_state_and_exclude_ids_match_jax(built):
    """The stateless resume (a wider re-search excluding page 1) and an
    explicit ``exclude_ids``."""
    ds, (jg, jex), (tg, tex) = built
    first_j = jsearcher.search(jg, jex, jnp.asarray(ds.queries), top_k=10, beam_width=40)
    first_t = tsearcher.search(tg, tex, torch.as_tensor(ds.queries), top_k=10, beam_width=40)
    a = jsearcher.resume(jg, jex, jnp.asarray(ds.queries), first_j, top_k=10)
    b = tsearcher.resume(tg, tex, torch.as_tensor(ds.queries), first_t, top_k=10)
    _same(a, b)
    assert not (first_t.ids.numpy()[:, :, None] == b.ids.numpy()[:, None, :]).any()
    excl = np.asarray(first_j.ids)[:, ::3]
    a, b = _both(built, lambda g, p, q: jsearcher.search(g, p, q, top_k=10, beam_width=30,
                                                         exclude_ids=jnp.asarray(excl)),
                 lambda g, p, q: tsearcher.search(g, p, q, top_k=10, beam_width=30, exclude_ids=excl))
    _same(a, b)


@pytest.mark.parametrize("hierarchy_beam", [1, 4])
def test_hierarchy_beam_matches_jax(built, hierarchy_beam):
    a, b = _both(built,
                 lambda g, p, q: jsearcher.search(g, p, q, top_k=10, beam_width=20, hierarchy_beam=hierarchy_beam),
                 lambda g, p, q: tsearcher.search(g, p, q, top_k=10, beam_width=20, hierarchy_beam=hierarchy_beam))
    _same(a, b)


@pytest.mark.parametrize("sim", ["euclidean", "dot_product", "cosine"])
def test_score_nodes_match_jax(sim):
    """``score_nodes`` of the exact and SQ4 providers (the rescore's scorer)."""
    rng = np.random.default_rng(9)
    data = rng.normal(size=(300, 24)).astype(np.float32)
    nodes = rng.integers(0, 300, 40).astype(np.int32)
    ids = rng.integers(0, 300, (40, 12)).astype(np.int32)
    jex = jscore.ExactScoreProvider(vectors=jnp.asarray(data), sim=sim)
    tex = ExactScoreProvider(vectors=torch.as_tensor(data), sim=sim)
    want = np.asarray(jex.score_nodes(jnp.asarray(nodes), jnp.asarray(ids)))
    np.testing.assert_allclose(tex.score_nodes(torch.as_tensor(nodes), torch.as_tensor(ids)).numpy(), want, **TOL)
    jsq = JSQ4.compute(data)
    codes = np.asarray(jsq.encode(data))
    jp = jsq.provider_for_graph(jnp.asarray(codes), jnp.asarray(ids), sim)
    tsq = convert.sq4_from_numpy(np.asarray(jsq.scale), np.asarray(jsq.offset), jsq.original_dim, device="cpu")
    tp = tsq.provider_for_graph(torch.as_tensor(codes), torch.as_tensor(ids), sim)
    np.testing.assert_allclose(
        tp.score_nodes(torch.as_tensor(nodes), torch.as_tensor(ids)).numpy(),
        np.asarray(jp.score_nodes(jnp.asarray(nodes), jnp.asarray(ids))), **TOL,
    )


def _grid_corpus(n: int, d: int) -> np.ndarray:
    """``tests/test_torch_build.py``'s integer grid (levels 0..15)."""
    x = synthetic_dataset(n=n, dim=d, n_queries=1, k=1, n_clusters=12, seed=21, device="cpu").base
    lo, hi = x.min(axis=0), x.max(axis=0)
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


def test_refine_and_rescore_bit_equal_on_integer_grid():
    """Every score on the grid is exact in both packages, so the refined
    and the rescored adjacency must equal the JAX package's bit for bit
    (ties included); the input graph is left as it was."""
    base = _grid_corpus(1024, 32)
    kw = dict(max_degree=16, ef_construction=32, wave_size=256)
    jg, jex = jbuild(base, "euclidean", JConfig(**kw))
    tg = _port_graph(jg)
    tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)))
    before = tg.base.neighbors.clone()
    jr = jrefine(jg, jex, base, JConfig(**kw), chunk=512)
    tr = refine_graph(tg, tex, base, GraphConfig(**kw), chunk=512)
    assert torch.equal(tg.base.neighbors, before)
    assert not np.array_equal(np.asarray(jr.base.neighbors), np.asarray(jg.base.neighbors))
    for name in ("neighbors", "scores", "counts"):
        np.testing.assert_array_equal(getattr(tr.base, name).numpy(), np.asarray(getattr(jr.base, name)), err_msg=name)
    assert int(tr.base.counts.max()) <= kw["max_degree"]
    js, ts = jrescore(jr, jex, chunk=384), rescore_graph(tr, tex, chunk=384)
    for name in ("neighbors", "scores", "counts"):
        np.testing.assert_array_equal(getattr(ts.base, name).numpy(), np.asarray(getattr(js.base, name)), err_msg=name)


def test_refine_recall_and_pq_rescore_on_float_corpus(built):
    """On the float corpus: the refined graph's recall is within 0.01 of the
    JAX package's refined graph (and no worse than the graph before, by
    0.01, as ``tests/test_search_api.py`` holds); a rescore through the PQ
    provider (``score_nodes`` through K5's twin here) keeps every row's id
    set, sorts it, and gives the JAX package's scores."""
    ds, (jg, jex), (tg, tex) = built
    cfg = dict(CFG)
    q = ds.queries

    def recall(ids):
        return recall_at_k(np.asarray(ids), ds.ground_truth, 10)

    before = recall(tsearcher.search(tg, tex, torch.as_tensor(q), top_k=10, beam_width=20).ids)
    jr = jrefine(jg, jex, jnp.asarray(ds.base), JConfig(**cfg), chunk=512)
    tr = refine_graph(tg, tex, ds.base, GraphConfig(**cfg), chunk=512)
    rj = recall(jsearcher.search(jr, jex, jnp.asarray(q), top_k=10, beam_width=20).ids)
    rt = recall(tsearcher.search(tr, tex, torch.as_tensor(q), top_k=10, beam_width=20).ids)
    assert abs(rt - rj) <= 0.01 and rt >= before - 0.01, (before, rj, rt)
    assert int(tr.base.counts[:1500].max()) <= cfg["max_degree"]

    jpq = JPQ.compute(ds.base, m=6, clusters=32)
    codes = np.zeros((jg.capacity, 6), np.uint8)
    codes[:1500] = np.asarray(jpq.encode(ds.base))
    jp = jpq.provider(jnp.asarray(codes), ds.similarity.value)
    center = None if jpq.center is None else np.asarray(jpq.center)
    tpq = convert.pq_from_numpy(np.asarray(jpq.codebooks), center, 24, device="cpu")
    tp = tpq.provider(torch.as_tensor(codes), ds.similarity)
    js, ts = jrescore(jr, jp, chunk=512), rescore_graph(tr, tp, chunk=512)
    counts = tr.base.counts.numpy()[:1500]
    old, new = tr.base.neighbors.numpy()[:1500], ts.base.neighbors.numpy()[:1500]
    sc = ts.base.scores.numpy()[:1500]
    for i in range(1500):
        c = counts[i]
        assert set(old[i, :c]) == set(new[i, :c])
        assert (np.diff(sc[i, :c]) <= 0).all()
    np.testing.assert_allclose(sc, np.asarray(js.base.scores)[:1500], **TOL)
