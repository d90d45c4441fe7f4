"""The port's mesh, node-sharded brute force and query-parallel search
against the JAX package on the 8-device virtual CPU mesh.

The port's mesh is a list of torch devices named by the caller
(``["cpu"] * 8`` here, the counterpart of the JAX package's virtual
devices); one process runs every shard.  Inputs come from numpy with a
seed and go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.parallel import make_mesh as jmesh
from jvector_tpu.parallel import sharded_brute_force as jbrute
from jvector_tpu.parallel import sharded_search as jsearch
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch import convert
from jvector_tpu_torch.graph import ExactScoreProvider, search
from jvector_tpu_torch.parallel import Mesh, make_mesh, replicate, shard_queries, sharded_brute_force, sharded_search

S = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one torch thread each."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(n=1200, dim=16, n_queries=64, k=10, seed=5)


def _cpu_mesh(axis: str) -> Mesh:
    return make_mesh(S, axis, devices=["cpu"] * S)


def test_make_mesh_devices_and_refusals(monkeypatch):
    mesh = _cpu_mesh("nodes")
    assert mesh.size == S and mesh.axis_name == "nodes" and all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(2, devices=["cpu"] * 3).size == 2
    with pytest.raises(ValueError, match="needs as many"):
        make_mesh(4, devices=["cpu"] * 2)
    # no card and no devices named: a mesh is refused, never laid on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 2)
    # too few cards visible
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 visible"):
        make_mesh(4)


def test_replicate_and_shard_queries():
    mesh = _cpu_mesh("dp")
    p = ExactScoreProvider(vectors=torch.zeros(4, 3))
    copies = replicate(p, mesh)
    assert len(copies) == S and all(c.vectors is p.vectors for c in copies)  # one device: shared, not copied
    q = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    blocks = shard_queries(q, mesh)
    assert [b.shape[0] for b in blocks] == [2] * S
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), q)
    with pytest.raises(ValueError, match="do not split"):
        shard_queries(q[:15], mesh)


def _brute_case(name):
    rng = np.random.default_rng(11)
    if name == "ragged":  # 1003 rows over 8 shards: the last shard short, its pad rows masked
        base = rng.normal(size=(1003, 16)).astype(np.float32)
        return base, rng.normal(size=(24, 16)).astype(np.float32), "euclidean"
    # dot product with every real score below a zero row's 0.5: an unmasked
    # pad row would win every query
    base = -np.abs(rng.normal(size=(1001, 16))).astype(np.float32)
    return base, np.abs(rng.normal(size=(24, 16))).astype(np.float32), "dot_product"


@pytest.mark.parametrize("case", ["ragged", "dot_pad"])
@pytest.mark.parametrize("k", [1, 10])
def test_sharded_brute_force_matches_jax(case, k):
    base, q, sim = _brute_case(case)
    js, ji = jbrute(jnp.asarray(q), jnp.asarray(base), jmesh(S, "nodes"), k=k, sim=sim)
    ts, ti = sharded_brute_force(q, base, _cpu_mesh("nodes"), k=k, sim=sim)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    assert (ti.numpy() >= 0).all() and (ti.numpy() < base.shape[0]).all()


def test_sharded_brute_force_k_beyond_n():
    """k > n: the slots past n report id -1 and score -inf; the first n are
    the exact order (the JAX package's top_k refuses k above a shard's
    rows, so this is held to numpy)."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(10, 8)).astype(np.float32)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    ts, ti = sharded_brute_force(q, base, _cpu_mesh("nodes"), k=16)
    d2 = ((q[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(ti.numpy()[:, :10], np.argsort(d2, axis=1, kind="stable"))
    assert (ti.numpy()[:, 10:] == -1).all() and np.isneginf(ts.numpy()[:, 10:]).all()


def test_sharded_search_matches_single_device_and_jax(ds):
    jgraph, jprov = jbuild(ds.base, ds.similarity, JConfig(max_degree=12, ef_construction=32, wave_size=128))
    jmulti = jsearch(jgraph, jprov, jnp.asarray(ds.queries), jmesh(S, "dp"), top_k=10, beam_width=32)
    base = jgraph.layers[0]
    graph = convert.graph_from_numpy(
        np.asarray(base.neighbors), np.asarray(base.scores), np.asarray(base.counts), int(jgraph.entry_node),
        int(jgraph.num_nodes), np.asarray(jgraph.deleted), device="cpu",
    )
    prov = ExactScoreProvider(vectors=torch.as_tensor(np.array(jprov.vectors)), sim=ds.similarity)
    single = search(graph, prov, torch.as_tensor(ds.queries), top_k=10, beam_width=32)
    multi = sharded_search(graph, prov, ds.queries, _cpu_mesh("dp"), top_k=10, beam_width=32)
    np.testing.assert_array_equal(multi.ids.numpy(), single.ids.numpy())
    np.testing.assert_array_equal(multi.ids.numpy(), np.asarray(jmulti.ids))
    np.testing.assert_allclose(multi.scores.numpy(), np.asarray(jmulti.scores), rtol=1e-5, atol=1e-5)
    assert multi.visited_count.shape == (64,)
    with pytest.raises(ValueError, match="do not split"):
        sharded_search(graph, prov, ds.queries[:63], _cpu_mesh("dp"), top_k=10)
