"""Multi-index search in the port against the JAX package: the stacked path
(the port's one wave of S x Q lanes over the segments' tables laid end to
end, against the JAX package's vmapped search), the sequential path with
and without ``rerank_floor``, and the stacked path's per-segment loop for a
provider that cannot be laid end to end (PQ under cosine).

Three JAX-built segments of 640 nodes (d=24, one shape, so they stack) are
carried into the port through ``jvector_tpu_torch.convert``; both packages
search the same numpy queries.  Ids and counters must be equal and scores
agree to rtol=atol=1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import multi as jmulti
from jvector_tpu.graph import score as jscore
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu.quantization.pq import ProductQuantization as JPQ
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider
from jvector_tpu_torch.graph import multi as tmulti
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

TOL = dict(rtol=1e-5, atol=1e-5)
SEG, S, D = 640, 3, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def segments():
    ds = synthetic_dataset(n=S * SEG, dim=D, n_queries=24, k=10, seed=91, device="cpu")
    segs = []
    for s in range(S):
        part = ds.base[s * SEG : (s + 1) * SEG]
        jg, jex = jbuild(part, "euclidean", JConfig(max_degree=16, ef_construction=40, wave_size=128))
        tg = convert.graph_from_numpy(
            np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
            int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
        )
        tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)))
        segs.append(dict(part=part, jg=jg, jex=jex, tg=tg, tex=tex, offset=s * SEG))
    return ds, segs


def _sq4(seg, sim="euclidean"):
    jsq = JSQ4.compute(seg["part"])
    codes = np.zeros((seg["jg"].capacity, D // 2), np.uint8)
    codes[:SEG] = np.asarray(jsq.encode(seg["part"]))
    jp = jsq.provider_for_graph(jnp.asarray(codes), seg["jg"].base.neighbors, sim)
    tsq = convert.sq4_from_numpy(np.asarray(jsq.scale), np.asarray(jsq.offset), jsq.original_dim, device="cpu")
    return jp, tsq.provider_for_graph(torch.as_tensor(codes), seg["tg"].base.neighbors, sim)


def _pq(seg, sim="euclidean"):
    jpq = JPQ.compute(seg["part"], m=6, clusters=64)
    codes = np.zeros((seg["jg"].capacity, 6), np.uint8)
    codes[:SEG] = np.asarray(jpq.encode(seg["part"]))
    center = None if jpq.center is None else np.asarray(jpq.center)
    tpq = convert.pq_from_numpy(np.asarray(jpq.codebooks), center, D, device="cpu")
    return jpq.provider(jnp.asarray(codes), sim), tpq.provider(torch.as_tensor(codes), sim)


def _shards(segs, first):
    """(JAX shards, port shards) with ``first`` = exact, sq4, pq or pq_cosine
    first passes (the compressed ones reranked exactly)."""
    js, ts = [], []
    for seg in segs:
        if first == "exact":
            jp, tp, jr, tr = seg["jex"], seg["tex"], None, None
        else:
            make = _sq4 if first == "sq4" else _pq
            jp, tp = make(seg, "cosine" if first == "pq_cosine" else "euclidean")
            jr, tr = seg["jex"], seg["tex"]
        js.append(jmulti.IndexShard(graph=seg["jg"], provider=jp, reranker=jr, id_offset=seg["offset"]))
        ts.append(tmulti.IndexShard(graph=seg["tg"], provider=tp, reranker=tr, id_offset=seg["offset"]))
    return js, ts


def _same(a, b):
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_allclose(b.scores.numpy(), np.asarray(a.scores), **TOL)
    for name in ("visited_count", "expanded_count", "reranked_count"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)), err_msg=name)


@pytest.mark.parametrize("first", ["exact", "sq4", "pq_cosine"])
def test_stacked_matches_jax(segments, first):
    """The stacked path against the JAX package's vmapped one: one global
    top-k over every segment, no floor.  Exact and SQ4 segments run as one
    wave over the tables laid end to end; PQ under cosine as a loop."""
    ds, segs = segments
    js, ts = _shards(segs, first)
    assert jmulti._can_stack(js) and tmulti._can_stack(ts)
    assert (tmulti._stack_provider([t.provider for t in ts]) is None) == (first == "pq_cosine")
    kw = dict(top_k=10, beam_width=40, stacked=True)
    a = jmulti.multi_search(js, jnp.asarray(ds.queries), **kw)
    b = tmulti.multi_search(ts, torch.as_tensor(ds.queries), **kw)
    _same(a, b)
    if first != "pq_cosine":
        assert recall_at_k(b.ids.numpy(), ds.ground_truth, 10) >= 0.9


def test_sequential_rerank_floor_matches_jax(segments):
    """The sequential path with PQ first passes: the floor skips exact
    reranks (the same ones as in the JAX package) at no cost in recall."""
    ds, segs = segments
    js, ts = _shards(segs, "pq")
    out = {}
    for floor in (True, False):
        kw = dict(top_k=10, beam_width=40, stacked=False, use_rerank_floor=floor)
        a = jmulti.multi_search(js, jnp.asarray(ds.queries), **kw)
        b = tmulti.multi_search(ts, torch.as_tensor(ds.queries), **kw)
        _same(a, b)
        np.testing.assert_allclose(b.approx_scores.numpy(), np.asarray(a.approx_scores), **TOL)
        out[floor] = b
    assert int(out[True].reranked_count.sum()) < int(out[False].reranked_count.sum())
    r_f, r_n = (recall_at_k(out[f].ids.numpy(), ds.ground_truth, 10) for f in (True, False))
    assert r_f >= r_n - 0.02


def test_can_stack_needs_one_shape(segments):
    ds, segs = segments
    _, ts = _shards(segs, "exact")
    small = tmulti.IndexShard(graph=ts[0].graph, provider=ExactScoreProvider(vectors=ts[0].provider.vectors[:512]))
    assert not tmulti._can_stack(ts[:1]) and not tmulti._can_stack([ts[0], small])
    assert not jmulti._can_stack([jmulti.IndexShard(graph=segs[0]["jg"], provider=segs[0]["jex"]),
                                  jmulti.IndexShard(graph=segs[0]["jg"], provider=jscore.ExactScoreProvider(
                                      vectors=segs[0]["jex"].vectors[:512]))])
