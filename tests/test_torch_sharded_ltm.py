"""The port's sharded larger-than-memory pipeline against the JAX package:
per-shard stream builds on disk, merged bounded-memory host serving
(``ShardedHostIndex``), per-shard quantizers restacked onto a mesh, and the
multi-device dry run.

The corpus lies on an integer grid (levels 0..15, saturated at both ends in
every shard, so each shard's SQ4 fit has scale 1 and offset 0), which makes
every score exact in both frameworks: the shard files must be equal array
for array, and the host serve's ids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu import parallel as jp
from jvector_tpu.disk import host_graph as jhg
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import entry
from jvector_tpu_torch import parallel as tp
from jvector_tpu_torch.disk import format as tfmt
from jvector_tpu_torch.disk import host_graph as thg
from jvector_tpu_torch.graph import GraphConfig

N, D, SHARDS = 2000, 32, 2
CFG = dict(max_degree=16, ef_construction=40, wave_size=256)
_SQ4_FIELDS = ("codes_packed", "node_w2", "node_norm2", "fused_packed", "fused_w2", "codes_aug", "scale", "offset")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid(n: int, d: int, seed: int) -> np.ndarray:
    """Levels 0..15 with four 0s and four 15s in every column of every
    shard's half, so each shard's clipped quantiles land on 0 and 15."""
    x = synthetic_dataset(n=n, dim=d, n_queries=1, k=1, n_clusters=12, seed=seed).base
    lo, hi = x.min(axis=0), x.max(axis=0)
    g = np.clip(np.round((x - lo) / (hi - lo) * 17) - 1, 0, 15).astype(np.float32)
    rng = np.random.default_rng(seed)
    half = n // SHARDS
    for s in range(SHARDS):
        for j in range(d):
            rows = s * half + rng.choice(half, 8, replace=False)
            g[rows[:4], j], g[rows[4:], j] = 0, 15
    return g


@pytest.fixture(scope="module")
def corpus():
    return _grid(N, D, seed=3)


@pytest.fixture(scope="module")
def built(corpus, tmp_path_factory):
    d = tmp_path_factory.mktemp("shltm")
    jm = jp.sharded_build_on_disk(d / "jax", corpus, n=N, dim=D, shards=SHARDS, config=JConfig(**CFG))
    tm = tp.sharded_build_on_disk(d / "torch", corpus, n=N, dim=D, shards=SHARDS, config=GraphConfig(**CFG),
                                  device="cpu")
    return d, jm, tm


def _assert_file_equal(a_path, b_path) -> None:
    a, b = tfmt.IndexFileReader(a_path), tfmt.IndexFileReader(b_path)
    assert a.meta == b.meta and a.array_names() == b.array_names()
    for name in a.array_names():
        np.testing.assert_array_equal(np.asarray(b.read(name)).view(np.uint8), np.asarray(a.read(name)).view(np.uint8),
                                      err_msg=name)


def _queries(corpus: np.ndarray, q: int = 40) -> np.ndarray:
    rng = np.random.default_rng(9)
    noise = rng.integers(-2, 3, (q, corpus.shape[1]))
    return np.clip(corpus[rng.choice(corpus.shape[0], q, replace=False)] + noise, 0, 15).astype(np.float32)


def test_shard_files_equal_jax(built):
    d, jm, tm = built
    assert tm == jm and tm["ltm"] and tm["n_total"] == N
    assert (d / "jax" / "manifest.json").read_text() == (d / "torch" / "manifest.json").read_text()
    for fname in tm["shards"]:
        _assert_file_equal(d / "jax" / fname, d / "torch" / fname)
        r = tfmt.IndexFileReader(d / "torch" / fname)
        assert (r.read("feature/fused_sq4/scale") == 1).all() and (r.read("feature/fused_sq4/offset") == 0).all()


def test_rerun_skips_committed_shards(built, corpus, tmp_path):
    """A re-run rebuilds only the missing shard: the committed shard's range
    is never read again, and the rebuilt file equals the first build's."""
    d, _, tm = built
    work = tmp_path / "rerun"
    work.mkdir()
    for fname in tm["shards"]:
        (work / fname).write_bytes((d / "torch" / fname).read_bytes())
    first = (work / tm["shards"][0]).read_bytes()
    (work / tm["shards"][1]).unlink()
    touched = []

    def loader(a, b):
        touched.append((a, b))
        return corpus[a:b]

    tp.sharded_build_on_disk(work, loader, n=N, dim=D, shards=SHARDS, config=GraphConfig(**CFG), device="cpu")
    n_local = -(-N // SHARDS)
    assert touched and all(a >= n_local for a, _ in touched)
    assert (work / tm["shards"][0]).read_bytes() == first
    _assert_file_equal(d / "torch" / tm["shards"][1], work / tm["shards"][1])


def _host_pair(d):
    return jhg.ShardedHostIndex.load(d / "jax"), thg.ShardedHostIndex.load(d / "jax", device="cpu")


def _assert_same(a, b) -> None:
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_array_equal(b.scores.numpy(), np.asarray(a.scores))
    np.testing.assert_array_equal(b.approx_scores.numpy(), np.asarray(a.approx_scores))
    for f in ("visited_count", "expanded_count", "reranked_count"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), err_msg=f)


def _accept(name: str) -> np.ndarray | None:
    if name == "none":
        return None
    mask = np.zeros(N, bool)
    if name == "every7":
        mask[::7] = True
    elif name == "boundary":
        # only shard 1's first nodes: a capacity-wide slice (1024 > 1000
        # nodes a shard) would lay them on shard 0's padding ordinals
        mask[N // SHARDS : N // SHARDS + 48] = True
    return mask


@pytest.mark.parametrize("accept", ["none", "every7", "boundary", "empty"])
def test_sharded_host_search_equals_jax(built, corpus, accept):
    d, _, _ = built
    js, ts = _host_pair(d)
    assert ts.offsets == js.offsets and ts.n_total == js.n_total == N and len(ts.shards) == SHARDS
    q = _queries(corpus)
    mask = _accept(accept)
    kw = dict(top_k=10, beam_width=32, expand=2, accept=mask)
    a, b = js.search(jnp.asarray(q), **kw), ts.search(q, **kw)
    _assert_same(a, b)
    ids = b.ids.numpy()
    if accept == "empty":
        assert (ids == -1).all() and np.isneginf(b.scores.numpy()).all()
    elif mask is not None:
        assert (ids >= 0).all() and mask[ids].all()
    else:
        n_local = N // SHARDS
        assert (ids < n_local).any() and (ids >= n_local).any()  # both shards contribute


def test_sharded_host_non_uniform_offsets(built, corpus):
    """Publicly built with non-uniform offsets (one shard a host): each
    shard's accept slice ends at the next offset."""
    d, _, _ = built
    js, ts = _host_pair(d)
    n_total = N - 100
    jx = jhg.ShardedHostIndex(shards=js.shards, offsets=[0, 900], n_total=n_total)
    tx = thg.ShardedHostIndex(shards=ts.shards, offsets=[0, 900], n_total=n_total)
    mask = np.zeros(n_total, bool)
    mask[850:960] = True
    kw = dict(top_k=10, beam_width=32, expand=2, accept=mask)
    q = _queries(corpus)
    _assert_same(jx.search(jnp.asarray(q), **kw), tx.search(q, **kw))


def test_per_shard_quantizers_restack_equal_jax(tmp_path):
    """Shard 1's range is shard 0's grid doubled, so the shards fit
    different affines (scale 1 and 2); ``load_sharded`` re-encodes both
    with the union affine (scale 2, offset 0) and rebuilds the fused
    tables, every product and sum exact: equal to the JAX package's bit for
    bit, and the mesh serve returns its ids."""
    x = _grid(N, D, seed=5)
    x[N // SHARDS :] *= 2.0
    cfg = dict(CFG, add_hierarchy=False)
    jp.sharded_build_on_disk(tmp_path, x, n=N, dim=D, shards=SHARDS, config=JConfig(**cfg))
    r0 = tfmt.IndexFileReader(tmp_path / "shard0000.jvtpu")
    r1 = tfmt.IndexFileReader(tmp_path / "shard0001.jvtpu")
    assert (r0.read("feature/fused_sq4/scale") == 1).all() and (r1.read("feature/fused_sq4/scale") == 2).all()
    jl = jp.load_sharded(tmp_path, jp.make_mesh(SHARDS, "shard"))
    mesh = tp.make_mesh(SHARDS, "shard", devices=["cpu"] * SHARDS)
    tl = tp.load_sharded(tmp_path, mesh)
    assert (tl.search_providers[0].scale == 2).all() and (tl.search_providers[0].offset == 0).all()
    for s in range(SHARDS):
        for f in _SQ4_FIELDS:
            a = np.asarray(getattr(jl.search_providers, f))
            a = a if f in ("scale", "offset") else a[s]
            b = getattr(tl.search_providers[s], f).numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(b.view(np.uint8), a.view(np.uint8), err_msg=f"shard {s}: {f}")
    q = _queries(x[: N // SHARDS])
    jg, _ = jp.sharded_graph_search(jl, jnp.asarray(q), jp.make_mesh(SHARDS, "shard"), top_k=10, beam_width=32)
    tg, _ = tp.sharded_graph_search(tl, q, mesh, top_k=10, beam_width=32)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def test_dryrun_multichip_on_cpu_mesh(capsys):
    entry.dryrun_multichip(2, devices=["cpu"] * 2)
    assert "dryrun_multichip(2): OK" in capsys.readouterr().out
    fn, args = entry.entry("cpu")
    assert tuple(fn(*args).ids.shape) == (32, 10)
