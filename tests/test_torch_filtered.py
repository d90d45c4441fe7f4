"""Filtered (acceptOrds) search in the port against the JAX package.

One JAX-built graph (n=4000, d=32, the corpus of
``tests/test_filtered_search.py``) is carried into the port through
``jvector_tpu_torch.convert``, and both packages search the same numpy
queries with the same accept masks: the in-loop accepted channel (exact
and SQ4 + exact rerank), the low-cardinality brute path, beam escalation
stopping when widening finds nothing more, tombstones, and host-served
filtered and threshold search off one index file.  Ids must be equal,
scores within rtol=atol=1e-5, counters equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jvector_tpu.graph.searcher as jsearcher
import jvector_tpu_torch.graph.searcher as tsearcher
from jvector_tpu.disk.host_graph import HostGraphIndex as JHostGraphIndex
from jvector_tpu.disk.host_graph import write_sq4_index
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph.mutation import mark_deleted
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu_torch import convert
from jvector_tpu_torch.disk import HostGraphIndex
from jvector_tpu_torch.graph import ExactScoreProvider
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

N, D, Q, K = 4000, 32, 32, 10
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_graph(jg):
    return convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
    )


@pytest.fixture(scope="module")
def served():
    ds = synthetic_dataset(n=N, dim=D, n_queries=Q, k=K, seed=7, device="cpu")
    jg, jex = jbuild(ds.base, "euclidean", JConfig(max_degree=16, ef_construction=40, wave_size=128))
    jsq = JSQ4.compute(ds.base)
    codes = np.zeros((jg.capacity, D // 2), np.uint8)
    codes[:N] = np.asarray(jsq.encode(ds.base))
    jprov = jsq.provider_for_graph(jnp.asarray(codes), jg.base.neighbors, "euclidean")
    tg = _port_graph(jg)
    tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)))
    tsq = convert.sq4_from_numpy(np.asarray(jsq.scale), np.asarray(jsq.offset), jsq.original_dim, device="cpu")
    tprov = tsq.provider_for_graph(convert.codes_from_numpy(codes, device="cpu"), tg.base.neighbors, "euclidean")
    return ds, (jg, jex, jprov, jsq, codes), (tg, tex, tprov)


def _mask(selectivity: float, seed: int = 13, n: int = N) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, max(int(n * selectivity), 20), replace=False)] = True
    return mask


def _filtered_gt(base, queries, mask, k):
    sub = np.where(mask)[0]
    d = np.sum(queries**2, axis=1)[:, None] - 2.0 * queries @ base[sub].T + np.sum(base[sub] ** 2, axis=1)[None, :]
    return sub[np.argsort(d, axis=1)[:, :k]]


def _same(a, b, counts=("visited_count", "expanded_count", "reranked_count")):
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    ok = np.asarray(a.ids) >= 0
    np.testing.assert_allclose(b.scores.numpy()[ok], np.asarray(a.scores)[ok], **TOL)
    for name in counts:
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)), err_msg=name)


CASES = {
    "exact_0.05": dict(first="exact", sel=0.05),
    "sq4_rerank_0.05": dict(first="sq4", sel=0.05),
    "exact_0.01_capped": dict(first="exact", sel=0.01, max_iters=64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_in_loop_filtered_matches_jax(served, case):
    """The in-loop accepted channel (``accept_brute_cutoff=0`` forces the
    graph path): equal ids, full result sets and recall >= 0.9 against the
    filtered ground truth; equal counters where both packages score
    exactly (SQ4's float32 sums differ in order, which can move a near tie
    at the beam's floor, and a long filtered search then pops a few more or
    fewer nodes on the way to the same results).  At 1% selectivity both stop at the
    same ``max_iters`` cap."""
    ds, (jg, jex, jprov, _, _), (tg, tex, tprov) = served
    c = CASES[case]
    mask = _mask(c["sel"])
    q = ds.queries[:12]
    kw = dict(top_k=K, beam_width=40, accept_brute_cutoff=0, max_iters=c.get("max_iters", 1000))
    if c["first"] == "sq4":
        a = jsearcher.search(jg, jprov, jnp.asarray(q), reranker=jex, rerank_k=40, accept=jnp.asarray(mask), **kw)
        b = tsearcher.search(tg, tprov, torch.as_tensor(q), reranker=tex, rerank_k=40, accept=torch.as_tensor(mask),
                             **kw)
    else:
        a = jsearcher.search(jg, jex, jnp.asarray(q), accept=jnp.asarray(mask), **kw)
        b = tsearcher.search(tg, tex, torch.as_tensor(q), accept=mask, **kw)
    _same(a, b, counts=() if c["first"] == "sq4" else ("visited_count", "expanded_count", "reranked_count"))
    ids = b.ids.numpy()
    assert mask[ids[ids >= 0]].all()
    if "max_iters" not in c:
        assert (ids >= 0).all()
        assert recall_at_k(ids, _filtered_gt(ds.base, q, mask, K), K) >= 0.9


def test_brute_path_matches_jax(served):
    """A small accepted set (200 <= the default cutoff of 512) is scored
    exactly, with no traversal, in both packages."""
    ds, (jg, jex, jprov, _, _), (tg, tex, tprov) = served
    mask = _mask(0.05, seed=29)
    excl = np.asarray(jsearcher.search(jg, jex, jnp.asarray(ds.queries), top_k=3, beam_width=40).ids)
    a = jsearcher.search(jg, jprov, jnp.asarray(ds.queries), top_k=K, beam_width=40, rerank_k=40, reranker=jex,
                         accept=jnp.asarray(mask), exclude_ids=jnp.asarray(excl))
    b = tsearcher.search(tg, tprov, torch.as_tensor(ds.queries), top_k=K, beam_width=40, rerank_k=40, reranker=tex,
                         accept=torch.as_tensor(mask), exclude_ids=torch.as_tensor(excl))
    _same(a, b)
    assert int(b.expanded_count.sum()) == 0
    assert mask[b.ids.numpy()].all() and not (b.ids.numpy()[:, :, None] == excl[:, None, :]).any()


def test_filtered_escalation_stops_when_results_cannot_improve(served, monkeypatch):
    """A threshold that drops every result: one search and two widenings
    that find nothing more, then stop, in both packages (the mask of 700 is
    over the cutoff, so the traversal path runs)."""
    ds, (jg, jex, _, _, _), (tg, tex, _) = served
    mask = _mask(700 / N, seed=0)
    calls = {"jax": [], "port": []}
    jorig, torig = jsearcher._search_jit, tsearcher._search_wave

    def jcount(*a, **k):
        calls["jax"].append(k.get("beam_width"))
        return jorig(*a, **k)

    def tcount(*a, **k):
        calls["port"].append(k.get("beam_width"))
        return torig(*a, **k)

    monkeypatch.setattr(jsearcher, "_search_jit", jcount)
    monkeypatch.setattr(tsearcher, "_search_wave", tcount)
    kw = dict(top_k=K, beam_width=16, threshold=0.9999)
    a = jsearcher.search(jg, jex, jnp.asarray(ds.queries), accept=jnp.asarray(mask), **kw)
    b = tsearcher.search(tg, tex, torch.as_tensor(ds.queries), accept=mask, **kw)
    assert calls["port"] == calls["jax"] == [16, 32, 64]
    assert (b.ids.numpy() == -1).all() and (np.asarray(a.ids) == -1).all()


def test_tombstones_excluded_from_filtered_results(served):
    """Deleted nodes stay traversable and never come back as results."""
    ds, (jg, jex, _, _, _), (tg, tex, _) = served
    q = jnp.asarray(ds.queries)
    victims = np.unique(np.asarray(jsearcher.search(jg, jex, q, top_k=5, beam_width=30).ids)[:, 0])
    jg2 = mark_deleted(jg, jnp.asarray(victims, jnp.int32))
    tg2 = tg._replace(deleted=torch.as_tensor(np.asarray(jg2.deleted)))
    mask = np.ones(jg.capacity, bool)
    for cutoff in (0, None):  # in-loop, then the brute path (all accepted > 512: in-loop again)
        a = jsearcher.search(jg2, jex, q, top_k=5, beam_width=30, accept=jnp.asarray(mask),
                             accept_brute_cutoff=cutoff)
        b = tsearcher.search(tg2, tex, torch.as_tensor(ds.queries), top_k=5, beam_width=30, accept=mask,
                             accept_brute_cutoff=cutoff)
        _same(a, b)
        assert not np.isin(b.ids.numpy(), victims).any()
    small = _mask(0.02, seed=3, n=jg.capacity) | np.isin(np.arange(jg.capacity), victims)
    a = jsearcher.search(jg2, jex, q, top_k=5, beam_width=30, accept=jnp.asarray(small))
    b = tsearcher.search(tg2, tex, torch.as_tensor(ds.queries), top_k=5, beam_width=30, accept=small)
    _same(a, b)
    assert not np.isin(b.ids.numpy(), victims).any()


@pytest.fixture(scope="module")
def host_file(served, tmp_path_factory):
    ds, (jg, jex, jprov, jsq, codes), _ = served
    path = tmp_path_factory.mktemp("hgf") / "host.jvtpu"
    write_sq4_index(path, jg, jsq, jnp.asarray(codes), jprov, "euclidean", inline_vectors={"vectors": ds.base})
    return path


def _threshold(base, queries, mask, rank):
    """The median over the queries of the exact score (``1 / (1 + d^2)``)
    of the accepted neighbor at ``rank``: a threshold that keeps about half
    of the results at that rank."""
    gt = _filtered_gt(base, queries, mask, rank + 1)[:, rank]
    d2 = np.sum((base[gt] - queries) ** 2, axis=1)
    return float(np.median(1.0 / (1.0 + d2)))


HOST_CASES = {
    "in_loop_0.05": dict(sel=0.05, accept_brute_cutoff=0),
    "brute_0.05_threshold": dict(sel=0.05, threshold=True),
    "threshold": dict(sel=None, threshold=True),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_served_filtered_matches_jax(served, host_file, case):
    """``HostGraphIndex.search(accept=..., threshold=...)`` off one file: the
    streamed in-loop path (12 queries), the brute path and the threshold
    contract give the JAX package's ids (and counters, but for the in-loop
    path's SQ4 traversal)."""
    ds = served[0]
    kw = dict(HOST_CASES[case])
    sel = kw.pop("sel")
    q = ds.queries[:12] if "in_loop" in case else ds.queries
    mask = np.ones(N, bool) if sel is None else _mask(sel, seed=17)
    kw.update(top_k=K, beam_width=40, expand=4, max_iters=400)
    if sel is not None:
        kw["accept"] = mask
    if kw.get("threshold"):
        kw["threshold"] = _threshold(ds.base, q, mask, K // 2)
    a = JHostGraphIndex.load(host_file).search(jnp.asarray(q), **kw)
    b = HostGraphIndex.load(host_file, device="cpu").search(q, **kw)
    _same(a, b, counts=() if "in_loop" in case else ("visited_count", "expanded_count"))
    ids = b.ids.numpy()
    assert mask[ids[ids >= 0]].all()
    if kw.get("threshold"):
        assert (b.scores.numpy()[ids >= 0] >= kw["threshold"]).all() and (ids == -1).any() and (ids >= 0).any()
    else:
        assert (ids >= 0).all()
        assert recall_at_k(ids, _filtered_gt(ds.base, q, mask, K), K) >= 0.9
