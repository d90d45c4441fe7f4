"""The port's N:1 compaction (``jvector_tpu_torch.disk.compaction``) against
the JAX package: ``compact_indexes`` exact and through a PQ sidecar, and
the streamed ``compact_on_disk``.

Three segments (500 / 400 / 300 nodes: ``tests/test_compaction.py``'s
uneven split at half its size, for CPU time) are built once by the JAX
package on an integer-grid corpus (levels 0..15, as in
``tests/test_torch_build.py``, each dimension clipped at its 2nd and 98th
percentiles so that the SQ4 fit's 0.1% quantiles land on 0 and 15) and
carried into the port through ``jvector_tpu_torch.convert`` or saved with
the JAX package's ``write_index`` (one of them in the v3 paired layout).
On the grid every exact score, every SQ4 score (the quantizer fits scale 1
and offset 0) and every PQ score with grid-valued codebooks is computed
without rounding in both frameworks, so the mappers, the merged tables
(float32 edge scores bit for bit) and every array of ``compact_on_disk``'s
output file must equal the JAX package's.  Mirrors
``tests/test_compaction.py`` and ``tests/test_streamed_compaction.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.disk import CompactionSource as JSource
from jvector_tpu.disk import FeatureId, compact_indexes as jcompact, compact_on_disk as jcompact_disk, write_index
from jvector_tpu.disk.format import IndexFileReader
from jvector_tpu.disk.host_graph import HostGraphIndex as JHost
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph.mutation import mark_deleted as jmark
from jvector_tpu.quantization.pq import ProductQuantization as JPQ
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import convert
from jvector_tpu_torch.disk import CompactionSource, HostGraphIndex, compact_indexes, compact_on_disk
from jvector_tpu_torch.disk import format as tformat
from jvector_tpu_torch.graph import GraphConfig
from jvector_tpu_torch.graph.mutation import mark_deleted
from jvector_tpu_torch.graph.score import ADCScoreProvider

D, N = 16, 1200
SPLITS = [(0, 500), (500, 900), (900, 1200)]
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
    return convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
    )


@pytest.fixture(scope="module")
def segments(tmp_path_factory):
    ds = synthetic_dataset(n=N, dim=D, n_queries=40, k=1, n_clusters=12, seed=83)
    lo, hi = np.percentile(ds.base, 2, axis=0), np.percentile(ds.base, 98, axis=0)
    data = np.clip(np.round((ds.base - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)
    queries = (np.round(np.clip((ds.queries - lo) / (hi - lo) * 15, 0, 15) * 4) / 4).astype(np.float32)
    tmp = tmp_path_factory.mktemp("segs")
    jgraphs, paths = [], []
    for i, (a, b) in enumerate(SPLITS):
        jg, _ = jbuild(data[a:b], "euclidean", JConfig(**CFG))
        jgraphs.append(jg)
        p = str(tmp / f"seg{i}.jvtpu")
        write_index(p, jg, features={FeatureId.INLINE_VECTORS: {"vectors": data[a:b]}}, paired_adjacency=i == 1,
                    similarity="euclidean")
        paths.append(p)
    return dict(data=data, queries=queries, jgraphs=jgraphs, paths=paths, tmp=tmp)


def _sources(seg, deleted0=None):
    data = seg["data"]
    js, ts = [], []
    for i, ((a, b), jg) in enumerate(zip(SPLITS, seg["jgraphs"])):
        tg = _port_graph(jg)
        if i == 0 and deleted0 is not None:
            jg, tg = jmark(jg, deleted0), mark_deleted(tg, deleted0)
        js.append(JSource(graph=jg, vectors=data[a:b]))
        ts.append(CompactionSource(graph=tg, vectors=data[a:b]))
    return js, ts


def _assert_merged_equal(tg, jg, tmap, jmap):
    for a, b in zip(tmap, jmap):
        np.testing.assert_array_equal(a, b)
    for name in ("neighbors", "counts"):
        np.testing.assert_array_equal(getattr(tg.base, name).numpy(), np.asarray(getattr(jg.base, name)), err_msg=name)
    np.testing.assert_array_equal(tg.base.scores.numpy().view(np.int32), np.asarray(jg.base.scores).view(np.int32))
    assert int(tg.num_nodes) == int(jg.num_nodes) and tg.capacity == jg.capacity


def test_compact_indexes_exact_matches_jax_and_drops_tombstones(segments):
    js, ts = _sources(segments, np.arange(100, dtype=np.int32))
    jm, _, jmaps = jcompact(js, JConfig(**CFG), "euclidean")
    tm, tp, tmaps = compact_indexes(ts, GraphConfig(**CFG), "euclidean")
    _assert_merged_equal(tm, jm, tmaps, jmaps)
    assert int(tm.num_nodes) == N - 100 and (tmaps[0][:100] == -1).all()
    assert (tm.base.neighbors.numpy() < N - 100).all()
    assert tp.vectors.shape[0] == tm.capacity


def test_compact_indexes_pq_sidecar_carried_codebooks_matches_jax(segments):
    """retrain=False with grid-valued codebooks (rows of the corpus) and no
    centering, host-array sources, and the refine post-pass: every score is
    an exact ADC sum (through K5's plain twin here) in both packages."""
    data = segments["data"]
    rng = np.random.default_rng(5)
    m, k = 4, 32
    s = D // m
    books = np.stack([data[rng.choice(len(data), k, replace=False), i * s : (i + 1) * s] for i in range(m)])
    jpq = JPQ(codebooks=jnp.asarray(books), center=None, original_dim=D)
    tpq = convert.pq_from_numpy(books, None, D, device="cpu")
    js, ts = _sources(segments)
    jm, jp, jmaps = jcompact(js, JConfig(**CFG), "euclidean", pq=jpq, retrain=False, refine_merged=True)
    tm, tp, tmaps = compact_indexes(ts, GraphConfig(**CFG), "euclidean", pq=tpq, retrain=False, refine_merged=True)
    assert isinstance(tp, ADCScoreProvider)
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
    _assert_merged_equal(tm, jm, tmaps, jmaps)
    assert int(tm.entry_node) == int(jm.entry_node)


def test_pq_sidecar_retrain_draws_the_jax_sample(segments):
    """With retrain=True the port trains on the JAX package's proportional
    sample (numpy draws from one seed; here every row) with its own
    k-means draws: the codebooks differ from the base PQ's and the merged
    graph holds every node."""
    from jvector_tpu_torch.quantization.pq import ProductQuantization

    data = segments["data"]
    base_pq = ProductQuantization.compute(data[:500], m=4, clusters=32, device="cpu")
    _, ts = _sources(segments)
    tm, tp, _ = compact_indexes(ts, GraphConfig(**CFG), "euclidean", pq=base_pq)
    assert int(tm.num_nodes) == N and not torch.allclose(tp.codebooks, base_pq.codebooks)


def _arrays(path) -> dict:
    r = IndexFileReader(path)
    return {name: np.asarray(r.read(name)) for name in r.array_names()}, r.meta


def _assert_files_equal(tpath, jpath):
    (ta, tmeta), (ja, jmeta) = _arrays(tpath), _arrays(jpath)
    assert sorted(ta) == sorted(ja)
    for name in ja:
        np.testing.assert_array_equal(ta[name], ja[name], err_msg=name)
    assert tmeta == jmeta


@pytest.mark.parametrize("variant", ["save_fused", "dropped_and_hierarchy"])
def test_compact_on_disk_file_matches_jax(segments, variant):
    """Every array and the metadata of the output file equal the JAX
    package's: with ``save_fused=True`` (the fused layout built on the
    host from the written rows; no kernel), or with 100 nodes of source 0
    dropped through ``live``, the hierarchy added and a device budget under
    what the merged graph alone would take (``N * row_cap * 8`` bytes of
    neighbors and scores; the codes are ~0.05 MB here)."""
    paths, tmp = segments["paths"], segments["tmp"]
    kw = dict(wave=256)
    if variant == "save_fused":
        kw.update(save_fused=True)
    else:
        live0 = np.ones(500, bool)
        live0[:100] = False
        budget = N * GraphConfig(**CFG).row_cap * 8 - 1 + 300_000
        kw.update(live=[live0, None, None], add_hierarchy=True, device_budget_bytes=budget)
    jout, tout = str(tmp / f"j_{variant}.jvtpu"), str(tmp / f"t_{variant}.jvtpu")
    jmaps, jstats = jcompact_disk(paths, jout, JConfig(**CFG), **kw)
    tmaps, tstats = compact_on_disk(paths, tout, GraphConfig(**CFG), device="cpu", **kw)
    for a, b in zip(tmaps, jmaps):
        np.testing.assert_array_equal(a, b)
    assert tstats["total"] == jstats["total"] == (N if variant == "save_fused" else N - 100)
    # the ledgers peak with a source resident; the JAX package's holds its
    # adjacency as pairs padded to 64 slots a node, the port's plain [N, R]
    pads = {tformat.pack_adjacency_pairs_host(nb, 64).nbytes - nb.nbytes
            for nb in (tformat._read_l0_neighbors(tformat.IndexFileReader(p)) for p in paths)}
    assert len(pads) == 1  # the three segments share one capacity and R = 40
    assert tstats["peak_device_bytes"] == jstats["peak_device_bytes"] - pads.pop()
    assert tstats["allocated_peak_bytes"] is None  # the allocator cross-check is the card's
    _assert_files_equal(tout, jout)
    if variant == "save_fused":
        # the port's host tier serves the port's file with the JAX host tier's ids
        q = segments["queries"]
        tres = HostGraphIndex.load(tout, device="cpu").search(torch.as_tensor(q), top_k=10, beam_width=40)
        jres = JHost.load(tout).search(jnp.asarray(q), top_k=10, beam_width=40)
        np.testing.assert_array_equal(tres.ids.numpy(), np.asarray(jres.ids))
        assert (tres.ids.numpy() >= 0).all()
    else:
        assert (tmaps[0][:100] == -1).all() and IndexFileReader(tout).meta["num_levels"] > 1
        assert tstats["peak_device_bytes"] <= budget


def test_compact_on_disk_budget_and_mixed_similarities(segments):
    """A budget below the merged codes raises MemoryError (the ledger's
    count, not the allocator's, is what is checked); sources of two
    similarities raise ValueError where the JAX package asserts."""
    paths, tmp = segments["paths"], segments["tmp"]
    cfg = GraphConfig(**CFG)
    with pytest.raises(MemoryError, match="device budget"):
        compact_on_disk(paths, str(tmp / "toosmall.jvtpu"), cfg, device="cpu", device_budget_bytes=1000)
    other = str(tmp / "dot.jvtpu")
    jg = segments["jgraphs"][2]
    write_index(other, jg, features={FeatureId.INLINE_VECTORS: {"vectors": segments["data"][900:]}},
                similarity="dot_product")
    with pytest.raises(ValueError, match="similarit"):
        compact_on_disk([paths[0], other], str(tmp / "mixed.jvtpu"), cfg, device="cpu")
