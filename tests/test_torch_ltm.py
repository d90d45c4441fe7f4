"""The port's larger-than-memory build and host serving against the JAX
package.

On an integer-grid corpus (values 0..15, saturated at both ends so the SQ4
quantizer fitted on it has scale 1 and offset 0) every score is computed
without rounding in both frameworks, so the SQ4 stream build in the packed
regime (the K3 path: both packages' ``_FUSED_BUILD_BUDGET`` set to 0) and in
the fused regime, and the PQ stream build with codebooks carried over from
the JAX package, must write files equal array by array.  A port build
resumed from its checkpoint equals an uninterrupted one, and
``HostGraphIndex`` serves one file with equal ids in both packages, plain
and filtered.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.disk import format as jfmt
from jvector_tpu.disk import host_graph as jhg
from jvector_tpu.disk import ltm as jltm
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.quantization import ProductQuantization as JPQ
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import convert
from jvector_tpu_torch.disk import format as tfmt
from jvector_tpu_torch.disk import host_graph as thg
from jvector_tpu_torch.disk import ltm as tltm
from jvector_tpu_torch.graph import GraphConfig

N, D = 2000, 32
CFG = dict(max_degree=16, ef_construction=40, wave_size=256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid_corpus(n: int, d: int, seed: int) -> np.ndarray:
    """Levels 0..15 with four 0s and four 15s in every column, so the
    quantizer's clipped quantiles land exactly on 0 and 15."""
    x = synthetic_dataset(n=n, dim=d, n_queries=1, k=1, n_clusters=12, seed=seed).base
    lo, hi = x.min(axis=0), x.max(axis=0)
    g = np.clip(np.round((x - lo) / (hi - lo) * 17) - 1, 0, 15).astype(np.float32)
    rng = np.random.default_rng(seed)
    for j in range(d):
        rows = rng.choice(n, 8, replace=False)
        g[rows[:4], j], g[rows[4:], j] = 0, 15
    return g


@pytest.fixture(scope="module")
def corpus():
    return _grid_corpus(N, D, seed=3)


def _assert_files_equal(a_path, b_path):
    a, b = jfmt.IndexFileReader(a_path), tfmt.IndexFileReader(b_path)
    assert b.version == a.version and b.meta == a.meta
    assert sorted(b.array_names()) == sorted(a.array_names())
    for name in a.array_names():
        x, y = np.asarray(a.read(name)), np.asarray(b.read(name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8), err_msg=name)


_BUILDS = {}


def _both_builds(regime, corpus, tmp_path_factory, monkeypatch):
    """Build one regime with each package (once per module)."""
    if regime not in _BUILDS:
        d = tmp_path_factory.mktemp(regime)
        if regime == "packed":
            monkeypatch.setattr(jltm, "_FUSED_BUILD_BUDGET", 0)
            monkeypatch.setattr(tltm, "_FUSED_BUILD_BUDGET", 0)
        if regime == "pq":
            # 16-centroid codebooks trained by the JAX package, rounded to
            # the grid so every ADC sum is exact
            jpq = JPQ.compute(corpus, m=8, clusters=16, globally_center=False)
            cb = np.round(np.asarray(jpq.codebooks))
            kw_j = dict(compression="pq", pq=JPQ(codebooks=jnp.asarray(cb), center=None, original_dim=D))
            kw_t = dict(compression="pq", pq=convert.pq_from_numpy(cb, None, D, device="cpu"))
        else:
            kw_j = kw_t = dict(compression="sq4")
        cfg = dict(CFG, add_hierarchy=regime != "pq")
        jltm.build_on_disk_ltm(str(d / "jax.jvtpu"), corpus, N, D, config=JConfig(**cfg), **kw_j)
        phases = []
        tg, _ = tltm.build_on_disk_ltm(str(d / "torch.jvtpu"), corpus, N, D, config=GraphConfig(**cfg), device="cpu",
                                       on_phase=lambda name, s: phases.append(name), **kw_t)
        _BUILDS[regime] = dict(jax=d / "jax.jvtpu", torch=d / "torch.jvtpu", phases=phases, graph=tg, kw=kw_t,
                               cfg=cfg)
    return _BUILDS[regime]


@pytest.mark.parametrize("regime", ["packed", "fused", "pq"])
def test_ltm_file_equals_jax(regime, corpus, tmp_path_factory, monkeypatch):
    b = _both_builds(regime, corpus, tmp_path_factory, monkeypatch)
    assert f"waves/{regime}" in b["phases"]
    _assert_files_equal(b["jax"], b["torch"])
    r = tfmt.IndexFileReader(b["torch"])
    np.testing.assert_array_equal(r.read("feature/inline_vectors/vectors"), corpus)
    assert r.meta["num_levels"] == (1 if regime == "pq" else b["graph"].num_levels) and r.meta["ltm"] is True
    if regime != "pq":
        assert r.meta["num_levels"] > 1  # the hierarchy over the sampled subset
        # the grid fixes the fitted quantizer, so no score is rounded
        assert (r.read("feature/fused_sq4/scale") == 1).all() and (r.read("feature/fused_sq4/offset") == 0).all()


class _FailingLoader:
    """Chunk loader that dies after ``fail_after`` calls (a simulated crash)."""

    def __init__(self, base, fail_after):
        self.base, self.calls, self.fail_after = base, 0, fail_after

    def __call__(self, a, b):
        self.calls += 1
        if self.calls > self.fail_after:
            raise RuntimeError("simulated crash")
        return self.base[a:b]


@pytest.mark.parametrize("regime", ["packed", "pq"])
def test_ltm_resume_bit_identical(regime, corpus, tmp_path_factory, tmp_path, monkeypatch):
    """Crash after four waves (checkpoints every two), call again: the
    resumed build's file equals the uninterrupted build's (the packed
    regime restores its packed table, the PQ build its [N, R] graph).  The
    packed builds also save through the larger-than-memory branch
    (``_FUSED_SERVE_BUDGET`` = 0: L0 and the fused layout streamed from the
    host, a provider without fused tables), which must write the same file
    as the uninterrupted build's on-device save."""
    b = _both_builds(regime, corpus, tmp_path_factory, monkeypatch)
    clean = b["torch"]
    if regime == "packed":
        monkeypatch.setattr(tltm, "_FUSED_BUILD_BUDGET", 0)
        monkeypatch.setattr(tltm, "_FUSED_SERVE_BUDGET", 0)
    p = tmp_path / "crashy.jvtpu"

    def build(vectors):
        return tltm.build_on_disk_ltm(str(p), vectors, N, D, config=GraphConfig(**b["cfg"]), checkpoint_every=2,
                                      device="cpu", **b["kw"])

    with pytest.raises(RuntimeError, match="simulated crash"):
        # each wave reads once; the SQ4 fit reads once more (PQ is given)
        build(_FailingLoader(corpus, fail_after=5 if regime == "packed" else 4))
    ck = tfmt.IndexFileReader(str(p) + ".ckpt")
    assert ck.meta["waves_done"] == 4 and ck.meta.get("packed", False) is (regime == "packed")
    _, provider = build(corpus)
    if regime == "packed":
        assert not provider.supports_fused  # the host-streamed save ran
    assert not (tmp_path / "crashy.jvtpu.ckpt").exists()
    a, b = tfmt.IndexFileReader(clean), tfmt.IndexFileReader(p)
    assert a.meta == b.meta and a.array_names() == b.array_names()
    for name in a.array_names():
        np.testing.assert_array_equal(np.asarray(b.read(name)), np.asarray(a.read(name)), err_msg=name)


@pytest.mark.parametrize("pipeline", [1, 2])
def test_host_graph_search_ids_equal(pipeline, corpus, tmp_path_factory, monkeypatch):
    """A JAX-written packed-regime file served by both packages' host tier
    (hierarchy descent, streamed base layer, default two-pass rerank from
    the inline vectors): equal ids, scores and counters."""
    path = _both_builds("packed", corpus, tmp_path_factory, monkeypatch)["jax"]
    rng = np.random.default_rng(9)
    queries = np.clip(corpus[rng.choice(N, 40, replace=False)] + rng.integers(-2, 3, (40, D)), 0, 15)
    queries = queries.astype(np.float32)
    a = jhg.HostGraphIndex.load(path).search(jnp.asarray(queries), top_k=10, beam_width=32, expand=4,
                                             pipeline=pipeline)
    hg = thg.HostGraphIndex.load(path, device="cpu")
    assert hg.upper_node_ids and hg.rerank_store is not None
    b = hg.search(queries, top_k=10, beam_width=32, expand=4, pipeline=pipeline)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_array_equal(b.scores.numpy(), np.asarray(a.scores))
    np.testing.assert_array_equal(b.visited_count.numpy(), np.asarray(a.visited_count))
    np.testing.assert_array_equal(b.expanded_count.numpy(), np.asarray(a.expanded_count))
    single = hg.search(queries, top_k=10, beam_width=32, expand=4, rerank=False)
    assert single.ids.shape == (40, 10) and (single.reranked_count == 0).all()
    # filtered host search (the streamed in-loop path) on the same file
    mask = np.zeros(N, bool)
    mask[::7] = True
    kw = dict(top_k=10, beam_width=32, expand=4, pipeline=pipeline, accept=mask, accept_brute_cutoff=0)
    fa = jhg.HostGraphIndex.load(path).search(jnp.asarray(queries), **kw)
    fb = hg.search(queries, **kw)
    np.testing.assert_array_equal(fb.ids.numpy(), np.asarray(fa.ids))
    np.testing.assert_array_equal(fb.expanded_count.numpy(), np.asarray(fa.expanded_count))
    assert mask[fb.ids.numpy()].all()
