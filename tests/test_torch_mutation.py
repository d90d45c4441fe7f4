"""The port's index mutation (``jvector_tpu_torch.graph.mutation``) against
the JAX package: tombstone deletes, the FreshDiskANN splice and inserts.

One hierarchical graph is built by the JAX package on an integer-grid
corpus (levels 0..15, the corpus of ``tests/test_torch_build.py``), where
every exact score is computed without rounding in both frameworks, and is
carried into the port through ``jvector_tpu_torch.convert``.  Both packages
then tombstone the same victims, splice them out and insert new nodes past
the capacity (1000 nodes in 1024 slots, 300 more: the capacity grows to
1536 and the hierarchy is rebuilt), with exact providers on the CPU.  Every
table (ids, counts, the float32 edge scores bit for bit, the upper levels,
the entry point) must equal the JAX package's; the caller's graph must be
left as it was by every call.  Mirrors ``tests/test_mutation.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import mutation as jmut
from jvector_tpu.graph import search as jsearch
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, search
from jvector_tpu_torch.graph import mutation as tmut

N0, K_NEW, D = 1000, 300, 32
CFG = dict(max_degree=16, ef_construction=40, wave_size=128, add_hierarchy=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid_corpus(n: int, d: int) -> np.ndarray:
    x = synthetic_dataset(n=n, dim=d, n_queries=1, k=1, n_clusters=12, seed=21).base
    lo, hi = x.min(axis=0), x.max(axis=0)
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


def _port_graph(jg):
    upper = [(np.asarray(l.neighbors), np.asarray(l.scores), np.asarray(l.counts)) for l in jg.layers[1:]]
    return convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
        upper_layers=upper, level_node_ids=[np.asarray(i) for i in jg.level_node_ids],
    )


def _assert_graphs_equal(tg, jg):
    assert tg.num_levels == jg.num_levels and tg.capacity == jg.capacity
    for lv, (tl, jl) in enumerate(zip(tg.layers, jg.layers)):
        for name in ("neighbors", "counts"):
            np.testing.assert_array_equal(getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
                                          err_msg=f"L{lv} {name}")
        np.testing.assert_array_equal(tl.scores.numpy().view(np.int32), np.asarray(jl.scores).view(np.int32),
                                      err_msg=f"L{lv} scores")
    for tids, jids in zip(tg.level_node_ids, jg.level_node_ids):
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tg.deleted.numpy(), np.asarray(jg.deleted))
    assert int(tg.entry_node) == int(jg.entry_node) and int(tg.num_nodes) == int(jg.num_nodes)


def _checksum(g) -> list:
    return [t.clone() for layer in g.layers for t in layer] + [g.deleted.clone(), g.entry_node.clone()]


def _unchanged(g, before) -> bool:
    return all(torch.equal(a, b) for a, b in zip(_checksum(g), before))


@pytest.fixture(scope="module")
def lifecycle():
    """Both packages through mark -> splice -> insert on one JAX-built graph."""
    data = _grid_corpus(N0 + K_NEW, D)
    jg, jex = jbuild(data[:N0], "euclidean", JConfig(**CFG))
    assert jg.num_levels > 1 and jg.capacity == 1024
    tg = _port_graph(jg)
    tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)))
    victims = np.random.default_rng(0).choice(N0, 100, replace=False)
    out = dict(data=data, victims=victims, jg=jg, tg=tg, jex=jex, tex=tex)

    before = _checksum(tg)
    out["jm"], out["tm"] = jmut.mark_deleted(jg, victims), tmut.mark_deleted(tg, victims)
    out["tg_after_mark"] = _unchanged(tg, before)

    cfg_j, cfg_t = JConfig(**CFG), GraphConfig(**CFG)
    out["js"] = jmut.remove_deleted(out["jm"], jex, cfg_j, chunk=256)
    before = _checksum(out["tm"])
    out["ts"] = tmut.remove_deleted(out["tm"], tex, cfg_t, chunk=256)
    out["tm_after_splice"] = _unchanged(out["tm"], before)

    out["ja"], out["jp"] = jmut.add_nodes(out["js"], jex, data[N0:], cfg_j)
    before = _checksum(out["ts"])
    out["ta"], out["tp"] = tmut.add_nodes(out["ts"], tex, data[N0:], cfg_t)
    out["ts_after_insert"] = _unchanged(out["ts"], before)
    return out


def test_mark_deleted_filters_results_and_keeps_the_callers_graph(lifecycle):
    lc = lifecycle
    assert lc["tg_after_mark"]
    assert not lc["tg"].deleted.any()
    np.testing.assert_array_equal(lc["tm"].deleted.numpy(), np.asarray(lc["jm"].deleted))
    q = lc["data"][N0 : N0 + 40] + 0.25
    res = search(lc["tm"], lc["tex"], torch.as_tensor(q), top_k=10, beam_width=40)
    assert not np.isin(res.ids.numpy(), lc["victims"]).any()
    jres = jsearch(lc["jm"], lc["jex"], jnp.asarray(q), top_k=10, beam_width=40)
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres.ids))


def test_remove_deleted_matches_jax(lifecycle):
    """The spliced tables equal the JAX package's bit for bit; no live row
    keeps an edge into a deleted node, deleted rows are empty, the
    tombstones stay, the entry is live, the tombstoned input is unchanged."""
    lc = lifecycle
    ts, victims = lc["ts"], lc["victims"]
    _assert_graphs_equal(ts, lc["js"])
    nbrs = ts.base.neighbors.numpy()
    assert not np.isin(nbrs[nbrs >= 0], victims).any()
    assert (ts.base.counts.numpy()[victims] == 0).all()
    assert ts.deleted.numpy()[victims].all()
    assert int(ts.entry_node) not in set(victims.tolist())
    assert lc["tm_after_splice"]


def test_add_nodes_matches_jax_across_a_capacity_bump(lifecycle):
    """300 inserts past the 1024-slot capacity: the grown tables, the
    rebuilt hierarchy and the provider equal the JAX package's, and the
    spliced graph passed in is unchanged.  Both packages serve the grown
    graph alike; a query whose hierarchy descent lands on a spliced hole
    (the rebuilt upper levels still hold deleted ordinals, a fault of the
    reference listed in ROADMAP.md) finds nothing in either, every other
    query finds its own vector."""
    lc = lifecycle
    ta, ja = lc["ta"], lc["ja"]
    assert ta.capacity == 1536 and int(ta.num_nodes) == N0 + K_NEW
    _assert_graphs_equal(ta, ja)
    np.testing.assert_array_equal(lc["tp"].vectors.numpy(), np.asarray(lc["jp"].vectors))
    assert lc["ts_after_insert"]
    q = lc["data"][N0:]
    res = search(ta, lc["tp"], torch.as_tensor(q), top_k=1, beam_width=40)
    jres = jsearch(ja, lc["jp"], jnp.asarray(q), top_k=1, beam_width=40)
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres.ids))
    found = res.ids.numpy()[:, 0] >= 0
    assert found.mean() >= 0.9 and (res.scores.numpy()[found, 0] == 1.0).all()


# tests/test_stress_lifecycle.py's randomized interleaving, cut for CPU time
# only: 3,000 nodes (1,000 built, inserts of 150-350) and 16 steps where the
# JAX test grows 6,000 to 24,000 nodes over 32 steps; the port alone, with
# the invariants checked after every step
N_TOTAL, N_INITIAL, N_STEPS = 3_000, 1_000, 16


def test_randomized_lifecycle():
    from jvector_tpu_torch.graph import build_graph
    from jvector_tpu_torch.util.datasets import exact_ground_truth

    rng = np.random.default_rng(1234)
    ds = synthetic_dataset(n=N_TOTAL, dim=16, n_queries=20, k=20, seed=51)
    cfg = GraphConfig(max_degree=12, ef_construction=32, wave_size=256)
    queries = torch.as_tensor(ds.queries)
    graph, provider = build_graph(ds.base[:N_INITIAL], "euclidean", cfg, device="cpu")
    inserted, deleted = N_INITIAL, set()
    counts = {"insert": 0, "delete": 0, "splice": 0}
    for step in range(N_STEPS):
        op = rng.choice(["insert", "delete", "splice"], p=[0.45, 0.30, 0.25])
        if op == "insert" and inserted >= N_TOTAL:
            op = "delete"
        if op == "insert":
            k = min(int(rng.integers(150, 350)), N_TOTAL - inserted)
            graph, provider = tmut.add_nodes(graph, provider, ds.base[inserted : inserted + k], cfg)
            inserted += k
        elif op == "delete":
            live = np.asarray([i for i in range(inserted) if i not in deleted], np.int32)
            victims = rng.choice(live, size=min(100, len(live) // 10), replace=False)
            graph = tmut.mark_deleted(graph, victims)
            deleted.update(int(v) for v in victims)
        else:
            graph = tmut.remove_deleted(graph, provider, cfg, chunk=512)
        counts[op] += 1

        ids = search(graph, provider, queries, top_k=10, beam_width=32).ids.numpy()
        assert ids.max() < inserted
        if deleted:
            assert not np.isin(ids, np.asarray(sorted(deleted))).any(), f"step {step} ({op}): deleted node in results"
        nbrs = graph.base.neighbors.numpy()[:inserted]
        assert (nbrs < inserted).all(), f"step {step}: edge to an unborn node"
        rows_sorted = np.sort(np.where(nbrs < 0, 2**31 - 1, nbrs), axis=1)
        dup = (rows_sorted[:, 1:] == rows_sorted[:, :-1]) & (rows_sorted[:, 1:] < 2**31 - 1)
        assert not dup.any(), f"step {step}: duplicate neighbor ids"
        assert not (nbrs == np.arange(inserted)[:, None]).any(), f"step {step}: self-loop edge"
        assert ((nbrs >= 0).sum(axis=1) == graph.base.counts.numpy()[:inserted]).all(), f"step {step}: counts"

    assert min(counts.values()) >= 3, counts
    live_mask = np.zeros(N_TOTAL, bool)
    live_mask[:inserted] = True
    live_mask[np.asarray(sorted(deleted), np.int64)] = False
    gt = np.where(live_mask)[0][exact_ground_truth(ds.base[live_mask], ds.queries, 10, device="cpu")]
    ids = search(graph, provider, queries, top_k=10, beam_width=48).ids.numpy()
    recall = sum(len(set(ids[q]) & set(gt[q])) for q in range(len(ids))) / (len(ids) * 10)
    assert recall >= 0.85, f"post-stress recall {recall}"
