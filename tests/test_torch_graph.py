"""The port serves a JAX-built graph like the JAX package, and builds a
graph of the same quality.

At n=2048, d=32 and the default ``GraphConfig``: the JAX package builds the
graph and fits SQ4 on the host (numpy quantiles); ``jvector_tpu_torch.convert``
loads the graph, the quantizer and the codes into the port.  Both packages
then search the same queries: exact single-pass, and the flagship two-pass
SQ4 first pass with exact rerank, plain and repacked.  Result ids must be
equal and scores agree to rtol=atol=1e-5.  A graph the port builds itself
must reach the JAX-built graph's recall@10 at the same beam within 0.01.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import search as jsearch
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider, GraphConfig, GraphIndexBuilder, build_graph, search
from jvector_tpu_torch.util.datasets import recall_at_k, synthetic_dataset

N, D, Q = 2048, 32, 256
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def served():
    ds = synthetic_dataset(n=N, dim=D, n_queries=Q, k=10, seed=3, device="cpu")
    sim = ds.similarity.value
    jg, jex = jbuild(ds.base, sim, JConfig())
    jsq = JSQ4.compute(ds.base)  # host array: numpy quantiles
    codes = np.zeros((jg.capacity, D // 2), np.uint8)
    codes[:N] = np.asarray(jsq.encode(ds.base))
    jprov = jsq.provider_for_graph(jnp.asarray(codes), jg.base.neighbors, sim)

    tg = convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts),
        int(jg.entry_node), int(jg.num_nodes), np.asarray(jg.deleted), device="cpu",
    )
    tex = ExactScoreProvider(vectors=torch.as_tensor(np.array(jex.vectors)), sim=ds.similarity)
    tsq = convert.sq4_from_numpy(np.asarray(jsq.scale), np.asarray(jsq.offset), jsq.original_dim, device="cpu")
    tprov = tsq.provider_for_graph(convert.codes_from_numpy(codes, device="cpu"), tg.base.neighbors, ds.similarity)
    return ds, (jg, jex, jprov), (tg, tex, tprov)


def _both(served, **kw):
    ds, (jg, jex, jprov), (tg, tex, tprov) = served
    first = kw.pop("first")
    jp, tp = (jprov, tprov) if first == "sq4" else (jex, tex)
    rer = dict(reranker=jex) if first == "sq4" else {}
    trer = dict(reranker=tex) if first == "sq4" else {}
    a = jsearch(jg, jp, jnp.asarray(ds.queries), top_k=10, **kw, **rer)
    b = search(tg, tp, torch.as_tensor(ds.queries), top_k=10, **kw, **trer)
    return a, b


CASES = {
    "exact": dict(first="exact", beam_width=24),
    "exact_seeds": dict(first="exact", beam_width=24, entry_seeds=4, expand_per_iter=2),
    "sq4_rerank": dict(first="sq4", beam_width=20, rerank_k=20),
    "sq4_rerank_repack": dict(first="sq4", beam_width=40, rerank_k=40, repack_after=64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_serve_jax_built_graph_ids_equal(served, case):
    a, b = _both(served, **CASES[case])
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_allclose(b.scores.numpy(), np.asarray(a.scores), **TOL)
    np.testing.assert_array_equal(b.visited_count.numpy(), np.asarray(a.visited_count))
    np.testing.assert_array_equal(b.expanded_count.numpy(), np.asarray(a.expanded_count))
    np.testing.assert_array_equal(b.reranked_count.numpy(), np.asarray(a.reranked_count))


def _safe_cut(expanded_count: np.ndarray, w2: int) -> int:
    """Smallest iteration cut where the active tail fits the sub-wave."""
    for cut in range(1, int(expanded_count.max()) + 1):
        if int((expanded_count > cut).sum()) <= w2 - 4:
            return cut
    return int(expanded_count.max())


def test_repack_identical_when_tail_fits(served):
    """The ``tests/test_repack.py`` contract, in the port."""
    ds, _, (tg, tex, tprov) = served
    q = torch.as_tensor(ds.queries)
    plain = search(tg, tprov, q, top_k=10, beam_width=20, rerank_k=20, reranker=tex)
    cut = _safe_cut(plain.expanded_count.numpy(), w2=Q // 4)
    rep = search(tg, tprov, q, top_k=10, beam_width=20, rerank_k=20, reranker=tex, repack_after=cut)
    for name in ("ids", "scores", "visited_count", "expanded_count"):
        assert torch.equal(getattr(plain, name), getattr(rep, name)), name


def test_port_build_recall_matches_jax_build(served):
    ds, (jg, jex, _), _ = served
    tg, tex = build_graph(ds.base, ds.similarity, GraphConfig(), device="cpu")
    assert tg.capacity == jg.capacity and tg.row_cap == jg.row_cap
    assert int(tg.num_nodes) == N and int(tg.base.counts.max()) <= 32
    for beam in (10, 16):
        a = jsearch(jg, jex, jnp.asarray(ds.queries), top_k=10, beam_width=beam)
        b = search(tg, tex, torch.as_tensor(ds.queries), top_k=10, beam_width=beam)
        ra = recall_at_k(np.asarray(a.ids), ds.ground_truth, 10)
        rb = recall_at_k(b.ids.numpy(), ds.ground_truth, 10)
        assert rb >= ra - 0.01, (beam, ra, rb)


@pytest.mark.parametrize("dim, cfg", [(96, GraphConfig(wave_size=64))], ids=["k4a_full_image_fallback"])
def test_unported_build_paths_raise(dim, cfg):
    """The one build path still unported raises instead of falling back:
    the fused loop's full-image rewrite of whole-tile rows whose codes do
    not tile 128 lanes (d=96: 48-byte codes), which the JAX package runs on
    the TPU kernel K4a."""
    x = np.random.default_rng(0).normal(size=(600, dim)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="K4a"):
        build_graph(x, "euclidean", cfg, device="cpu")


@pytest.mark.parametrize(
    "dim, cfg",
    [(32, GraphConfig(build_compression=None)), (32, GraphConfig(add_hierarchy=True)), (30, GraphConfig())],
    ids=["exact_build", "hierarchy", "unaligned_rows"],
)
def test_other_build_paths_reach_jax_recall(dim, cfg):
    """The build paths beside the packed SQ4 loop: the exact build (plain
    wave loop), the hierarchy, and d=30 (15-byte codes do not tile the
    fused rows: the unpacked fused loop with a 2-D table).  Each reaches the
    JAX package's recall@10 on the same corpus within 0.01."""
    ds = synthetic_dataset(n=800, dim=dim, n_queries=100, k=10, seed=4, device="cpu")
    jcfg = JConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    jg, jex = jbuild(ds.base, "euclidean", jcfg)
    tg, tex = build_graph(ds.base, "euclidean", cfg, device="cpu")
    assert tg.num_levels == jg.num_levels and tg.row_cap == jg.row_cap
    for beam in (10, 16):
        a = jsearch(jg, jex, jnp.asarray(ds.queries), top_k=10, beam_width=beam)
        b = search(tg, tex, torch.as_tensor(ds.queries), top_k=10, beam_width=beam)
        ra = recall_at_k(np.asarray(a.ids), ds.ground_truth, 10)
        rb = recall_at_k(b.ids.numpy(), ds.ground_truth, 10)
        assert abs(rb - ra) <= 0.01, (beam, ra, rb)


@pytest.mark.parametrize("compression", [None, "sq4"], ids=["exact_build", "sq4_build"])
def test_build_reports_only_its_own_phases(compression):
    """``on_phase`` hears each phase of the build it was given to once, in
    order; the hierarchy's sub-builds report nothing."""
    x = np.random.default_rng(1).normal(size=(200, 8)).astype(np.float32)
    phases = []
    cfg = GraphConfig(max_degree=8, ef_construction=16, wave_size=64, build_compression=compression, add_hierarchy=True)
    builder = GraphIndexBuilder(cfg,
                                on_phase=lambda name, s: phases.append((name, s)))
    graph, _ = builder.build(x, "euclidean", device="cpu")
    assert graph.num_levels >= 2
    assert [name for name, _ in phases] == ["provider prep", "wave loop", "cleanup", "hierarchy"]
    assert all(s >= 0 for _, s in phases)
