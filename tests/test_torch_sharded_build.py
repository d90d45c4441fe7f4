"""The port's sharded in-memory build, sharded serving and sharded
persistence against the JAX package on virtual CPU meshes.

The corpora lie on an integer grid (levels 0..15, saturated at both ends,
so the global SQ4 fit has scale 1 and offset 0): every score of every
regime is then computed without rounding in both frameworks, and each
shard's tables must be equal bit for bit — the packed regime (K1 and K2's
twins on the CPU), the exact regime and the unpacked SQ4 regime, the last
two on a ragged corpus that leaves two tail shards short (one of them
empty).  Exact score ties are common on a grid, so the serve also holds
the port's tie order (per-shard rerank and the merge) to the JAX
package's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu import parallel as jp
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph.builder import _fused_aligned_config as j_aligned
from jvector_tpu.graph.builder import _packed_build_eligible as j_packed_eligible
from jvector_tpu.graph.score import ExactScoreProvider as JExact
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import convert
from jvector_tpu_torch import parallel as tp
from jvector_tpu_torch.disk import format as tfmt
from jvector_tpu_torch.graph import GraphConfig
from jvector_tpu_torch.util.datasets import recall_at_k

_SQ4_FIELDS = ("codes_packed", "node_w2", "node_norm2", "fused_packed", "fused_w2", "codes_aug", "scale", "offset")
# (shards, n, dim, config, build_compression): the packed regime at d = 32
# (M = 8, waves of 256 align the fused rows), and a ragged corpus of 260
# over 8 shards of capacity 40 (counts 40 x 6, 20, 0) in the other two
CASES = {
    "packed": (4, 2000, 32, dict(max_degree=8, ef_construction=32, wave_size=256), "sq4"),
    "exact": (8, 260, 16, dict(max_degree=8, ef_construction=24, wave_size=32), None),
    "unpacked": (8, 260, 24, dict(max_degree=12, ef_construction=24, wave_size=32), "sq4"),
}


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


def _grid_queries(corpus: np.ndarray, q: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    noise = rng.integers(-2, 3, (q, corpus.shape[1]))
    return np.clip(corpus[rng.choice(corpus.shape[0], q, replace=False)] + noise, 0, 15).astype(np.float32)


def _cpu_mesh(s: int) -> tp.Mesh:
    return tp.make_mesh(s, "shard", devices=["cpu"] * s)


_BUILDS = {}


def _both(case: str) -> dict:
    """Each package's sharded build of one case (once per module)."""
    if case not in _BUILDS:
        s, n, d, cfg, comp = CASES[case]
        x = _grid_corpus(n, d, seed=3)
        ji = jp.sharded_build(x, jp.make_mesh(s, "shard"), JConfig(**cfg), build_compression=comp)
        ti = tp.sharded_build(x, _cpu_mesh(s), GraphConfig(**cfg), build_compression=comp)
        _BUILDS[case] = dict(x=x, jax=ji, torch=ti, shards=s)
    return _BUILDS[case]


def _jax_shard(ji, s: int) -> dict:
    """Shard ``s`` of a JAX ShardedIndex as numpy."""
    g, lay = ji.graphs, ji.graphs.layers[0]
    out = {f: np.asarray(getattr(lay, f))[s] for f in ("neighbors", "scores", "counts")}
    out.update(entry=int(np.asarray(g.entry_node)[s]), num=int(np.asarray(g.num_nodes)[s]),
               deleted=np.asarray(g.deleted)[s], vectors=np.asarray(ji.providers.vectors)[s])
    if ji.search_providers is not None:
        sp = ji.search_providers
        out.update({f: np.asarray(getattr(sp, f)) if f in ("scale", "offset") else np.asarray(getattr(sp, f))[s]
                    for f in _SQ4_FIELDS})
    return out


def _torch_shard(ti, s: int) -> dict:
    g = ti.graphs[s]
    out = {f: getattr(g.base, f).numpy() for f in ("neighbors", "scores", "counts")}
    out.update(entry=int(g.entry_node), num=int(g.num_nodes), deleted=g.deleted.numpy(),
               vectors=ti.providers[s].vectors.numpy())
    if ti.search_providers is not None:
        out.update({f: getattr(ti.search_providers[s], f).numpy() for f in _SQ4_FIELDS})
    return out


def _assert_shards_equal(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), what
    for k, x in a.items():
        if isinstance(x, np.ndarray):
            y = b[k]
            assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: {k} {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
            np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8), err_msg=f"{what}: {k}")
        else:
            assert x == b[k], f"{what}: {k} {x} vs {b[k]}"


def _to_port(ji, mesh: tp.Mesh):
    """A JAX-built index as the port's, through ``convert``."""
    lay, g = ji.graphs.layers[0], ji.graphs
    graphs = {f: np.asarray(getattr(lay, f)) for f in ("neighbors", "scores", "counts")}
    graphs.update(entry_node=np.asarray(g.entry_node), num_nodes=np.asarray(g.num_nodes),
                  deleted=np.asarray(g.deleted))
    sp = None
    if ji.search_providers is not None:
        sp = {f: np.asarray(getattr(ji.search_providers, f)) for f in _SQ4_FIELDS}
    return convert.sharded_index_from_numpy(graphs, np.asarray(ji.providers.vectors), ji.n_local, ji.n_total,
                                            ji.sim, mesh, sp)


@pytest.mark.parametrize("case", list(CASES))
def test_shard_tables_equal_jax(case):
    b = _both(case)
    ji, ti = b["jax"], b["torch"]
    assert (ti.n_shards, ti.n_local, ti.n_total, ti.sim) == (ji.n_shards, ji.n_local, ji.n_total, ji.sim)
    assert (ti.search_providers is None) == (ji.search_providers is None)
    for s in range(b["shards"]):
        _assert_shards_equal(_jax_shard(ji, s), _torch_shard(ti, s), f"{case} shard {s}")
    if case == "packed":
        s, n, d, cfg, _ = CASES[case]
        assert j_packed_eligible(j_aligned(JConfig(**cfg), d // 2), d // 2, ti.n_local)
        # the packed regime's signature: w2 rides the packed int32 table, fused rows rank-3
        assert ti.search_providers[0].fused_w2.dtype == torch.int32
        assert ti.search_providers[0].fused_packed.dim() == 3
    else:
        counts = np.array([int(g.num_nodes) for g in ti.graphs])
        assert (counts < ti.n_local).sum() == 2 and counts[-1] == 0 and int(ti.graphs[-1].entry_node) == -1
        assert ti.search_providers is None or ti.search_providers[0].fused_packed.dim() == 2


@pytest.mark.parametrize("case", ["packed", "unpacked", "exact"])
@pytest.mark.parametrize("floor_slack", [None, 0.0])
def test_serve_jax_built_index_equal_ids(case, floor_slack):
    b = _both(case)
    s = b["shards"]
    q = _grid_queries(b["x"], 40, seed=9)
    kw = dict(top_k=10, beam_width=32, rerank_k=32, floor_slack=floor_slack)
    jg, js = jp.sharded_graph_search(b["jax"], jnp.asarray(q), jp.make_mesh(s, "shard"), **kw)
    mesh = _cpu_mesh(s)
    tg, ts = tp.sharded_graph_search(_to_port(b["jax"], mesh), q, mesh, **kw)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tg.numpy() < b["x"].shape[0]).all()


@pytest.mark.parametrize("floor_slack", [None, 0.0])
def test_floor_slack_gates_the_rerank_as_jax(floor_slack):
    """On the grid the SQ4 first pass is exact, so the floor never bites;
    with rerank vectors moved off the grid (the same in both packages) the
    approximate and exact scores differ, a zero-slack floor skips reranking
    candidates the exact scores would keep, and the port's ids still equal
    the JAX package's (scores within float32 sum order)."""
    b = _both("packed")
    s = b["shards"]
    v = np.asarray(b["jax"].providers.vectors)
    moved = (v + np.random.default_rng(5).normal(0.0, 0.4, v.shape)).astype(np.float32)
    ji = dataclasses.replace(b["jax"], providers=JExact(vectors=jnp.asarray(moved), sim=b["jax"].sim))
    q = _grid_queries(b["x"], 40, seed=9)
    mesh = _cpu_mesh(s)
    kw = dict(top_k=10, beam_width=32, rerank_k=32)
    jg, js = jp.sharded_graph_search(ji, jnp.asarray(q), jp.make_mesh(s, "shard"), floor_slack=floor_slack, **kw)
    ti = _to_port(ji, mesh)
    tg, ts = tp.sharded_graph_search(ti, q, mesh, floor_slack=floor_slack, **kw)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    if floor_slack is not None:  # the gate bites: some ids differ from the ungated serve
        ungated, _ = tp.sharded_graph_search(ti, q, mesh, **kw)
        assert (ungated.numpy() != tg.numpy()).any()


def test_port_build_recall_matches_jax():
    """The port's own packed sharded build against the JAX package's, by
    recall@10 at equal beams (its tables are equal, so the recall is too)."""
    b = _both("packed")
    s = b["shards"]
    q = _grid_queries(b["x"], 40, seed=9)
    d2 = ((q[:, None, :] - b["x"][None, :, :]) ** 2).sum(-1)
    gt = np.argsort(d2, axis=1, kind="stable")[:, :10]
    mesh = _cpu_mesh(s)
    for beam in (16, 48):
        jg, _ = jp.sharded_graph_search(b["jax"], jnp.asarray(q), jp.make_mesh(s, "shard"), top_k=10,
                                        beam_width=beam)
        tg, _ = tp.sharded_graph_search(b["torch"], q, mesh, top_k=10, beam_width=beam)
        rj, rt = recall_at_k(np.asarray(jg), gt, 10), recall_at_k(tg.numpy(), gt, 10)
        assert abs(rt - rj) <= 0.02, (beam, rt, rj)
    assert rt >= 0.9, rt


def _files_equal(a_dir, b_dir, name: str) -> None:
    a, b = tfmt.IndexFileReader(a_dir / name), tfmt.IndexFileReader(b_dir / name)
    assert a.meta == b.meta and a.array_names() == b.array_names(), name
    for k in a.array_names():
        np.testing.assert_array_equal(np.asarray(b.read(k)).view(np.uint8), np.asarray(a.read(k)).view(np.uint8),
                                      err_msg=f"{name}: {k}")


@pytest.mark.parametrize("case", ["packed", "unpacked"])
def test_save_load_cross_packages(case, tmp_path):
    """Each package saves its own build; the files are equal array for
    array, and each package's ``load_sharded`` of the other's directory
    gives equal tables."""
    b = _both(case)
    s = b["shards"]
    jp.save_sharded(b["jax"], tmp_path / "jax")
    tp.save_sharded(b["torch"], tmp_path / "torch")
    assert (tmp_path / "jax" / "manifest.json").read_text() == (tmp_path / "torch" / "manifest.json").read_text()
    for s_ in range(s):
        _files_equal(tmp_path / "jax", tmp_path / "torch", f"shard{s_:04d}.jvtpu")
    jl = jp.load_sharded(tmp_path / "torch", jp.make_mesh(s, "shard"))
    tl = tp.load_sharded(tmp_path / "jax", _cpu_mesh(s))
    for s_ in range(s):
        _assert_shards_equal(_jax_shard(jl, s_), _torch_shard(tl, s_), f"{case} reloaded shard {s_}")
    # the reloaded index serves the built one's ids (the saved scores are dropped)
    q = _grid_queries(b["x"], 40, seed=9)
    mesh = _cpu_mesh(s)
    before, _ = tp.sharded_graph_search(b["torch"], q, mesh, top_k=10, beam_width=32)
    after, _ = tp.sharded_graph_search(tl, q, mesh, top_k=10, beam_width=32)
    np.testing.assert_array_equal(after.numpy(), before.numpy())


def test_v3_paired_shard_loads(tmp_path):
    """A shard rewritten in the v3 paired L0 layout loads in the port (its
    L0 read goes through the version dispatch) with the same tables."""
    b = _both("packed")
    tp.save_sharded(b["torch"], tmp_path)
    ref = tp.load_sharded(tmp_path, _cpu_mesh(b["shards"]))
    r = tfmt.IndexFileReader(tmp_path / "shard0001.jvtpu")
    feats = {}
    for k in r.array_names():
        if k.startswith("feature/"):
            _, fid, name = k.split("/", 2)
            feats.setdefault(fid, {})[name] = np.array(r.read(k))
    meta = {k: v for k, v in r.meta.items() if k not in ("num_levels", "entry_node", "num_nodes", "features")}
    tfmt.write_index(tmp_path / "shard0001.jvtpu", ref.graphs[1], features=feats, renumber=False,
                     paired_adjacency=True, **meta)
    assert tfmt.IndexFileReader(tmp_path / "shard0001.jvtpu").meta["l0_layout"] == "paired"
    got = tp.load_sharded(tmp_path, _cpu_mesh(b["shards"]))
    for s in range(b["shards"]):
        _assert_shards_equal(_torch_shard(ref, s), _torch_shard(got, s), f"paired shard {s}")


def test_load_refuses_mesh_size(tmp_path):
    b = _both("exact")
    tp.save_sharded(b["torch"], tmp_path)
    with pytest.raises(ValueError, match="manifest has 8 shards, mesh has 4"):
        tp.load_sharded(tmp_path, _cpu_mesh(4))
    assert b["torch"].global_ids(3, np.array([0, 5])).tolist() == [3 * b["torch"].n_local, 3 * b["torch"].n_local + 5]
