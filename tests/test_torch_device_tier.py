"""The port's device-resident serving tier (``jvector_tpu_torch.disk.device_tier``)
against the JAX package.

One hierarchical graph is built by the JAX package on an integer-grid
corpus (levels 0..15, as in ``tests/test_torch_build.py``) with queries on
a quarter grid, so the SQ4 codes (scale 1, offset 0), the SQ4 scores, the
bfloat16 rerank rows (small integers are exact in bfloat16) and every
float32 sum are exact in both frameworks.  The JAX package writes it in the
three L0 layouts (plain, renumbered after a splice, v3 paired), and the
port's ``DeviceTierIndex`` must load each and return the JAX tier's ids,
all of them (exact equality, not a share), at a bfloat16 and a float32
rerank, with and without the hierarchy.  The JAX tier holds the base
layer as paired rows of at least 64 slots a node (a TPU lane layout);
the port holds the file's plain ``[N, R]`` table, which must be the JAX
tier's slots with any padding cut off.  Mirrors ``tests/test_device_tier.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.disk import DeviceTierIndex as JTier
from jvector_tpu.disk import FeatureId, write_index
from jvector_tpu.disk.device_tier import sq4_aug_rows_host as j_aug_host
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import mutation as jmut
from jvector_tpu.graph import searcher as jsearcher
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch.disk import DeviceTierIndex
from jvector_tpu_torch.disk import device_tier as tdt
from jvector_tpu_torch.disk.format import pack_adjacency_pairs_host
from jvector_tpu_torch.graph import score as tscore
from jvector_tpu_torch.graph import searcher as tsearcher

N, D = 1500, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _grid(x: np.ndarray, lo, hi) -> np.ndarray:
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    ds = synthetic_dataset(n=N, dim=D, n_queries=64, k=1, n_clusters=12, seed=21)
    lo, hi = ds.base.min(axis=0), ds.base.max(axis=0)
    base = _grid(ds.base, lo, hi)
    queries = np.round(np.clip((ds.queries - lo) / (hi - lo) * 15, 0, 15) * 4) / 4
    return base, queries.astype(np.float32)


@pytest.fixture(scope="module")
def containers(corpus, tmp_path_factory):
    """The JAX package's graph saved in the three L0 layouts, with the
    ``fused_sq4`` sidecar and inline vectors; and a container without SQ4."""
    base, _ = corpus
    tmp = tmp_path_factory.mktemp("tier")
    cfg = JConfig(max_degree=16, ef_construction=40, wave_size=256, add_hierarchy=True)
    jg, jex = jbuild(base, "euclidean", cfg)
    sq = JSQ4(scale=jnp.ones(D), offset=jnp.zeros(D), original_dim=D)
    codes = np.zeros((jg.capacity, D // 2), np.uint8)
    codes[:N] = np.asarray(sq.encode(base))
    w2, _ = sq.node_constants(jnp.asarray(codes))

    def feats(vectors):
        return {FeatureId.INLINE_VECTORS: {"vectors": vectors},
                FeatureId.FUSED_SQ4: {"codes_packed": codes, "node_const": np.asarray(w2),
                                      "scale": np.ones(D, np.float32), "offset": np.zeros(D, np.float32)}}

    paths = {k: str(tmp / f"{k}.jvtpu") for k in ("plain", "renumbered", "paired", "no_sq4")}
    write_index(paths["plain"], jg, features=feats(base), renumber=False)
    write_index(paths["paired"], jg, features=feats(base), paired_adjacency=True)
    victims = np.random.default_rng(2).choice(N, 150, replace=False)
    spliced = jmut.remove_deleted(jmut.mark_deleted(jg, victims), jex, cfg)
    write_index(paths["renumbered"], spliced, features=feats(base))
    write_index(paths["no_sq4"], jg, features={FeatureId.INLINE_VECTORS: {"vectors": base}})
    return paths


@pytest.mark.parametrize("layout", ["plain", "renumbered", "paired"])
@pytest.mark.parametrize("rerank", ["bf16", "f32"])
def test_port_tier_serves_jax_containers_with_equal_ids(containers, corpus, layout, rerank):
    _, queries = corpus
    path = containers[layout]
    jdt, tdt_ = jnp.bfloat16 if rerank == "bf16" else jnp.float32, torch.bfloat16 if rerank == "bf16" else torch.float32
    for hier in (True, False):
        j = JTier.load(path, use_hierarchy=hier, rerank_dtype=jdt)
        t = DeviceTierIndex.load(path, use_hierarchy=hier, rerank_dtype=tdt_, device="cpu")
        assert t.capacity == j.capacity
        j_slots = np.asarray(j.adj_pairs).reshape(j.capacity, j.row_cap)
        np.testing.assert_array_equal(t.neighbors.numpy(), j_slots[:, : t.row_cap])
        assert t.row_cap <= j.row_cap and (j_slots[:, t.row_cap :] == -1).all()
        assert (t.upper is None) == (j.upper is None) and 0 < t.hbm_bytes() <= j.hbm_bytes()
        kw = dict(top_k=10, beam_width=48, entry_seeds=4)
        jr = j.search(jnp.asarray(queries), **kw)
        tr = t.search(torch.as_tensor(queries), **kw)
        np.testing.assert_array_equal(tr.ids.numpy(), np.asarray(jr.ids), err_msg=f"{layout} hierarchy={hier}")
        np.testing.assert_array_equal(tr.scores.numpy(), np.asarray(jr.scores))
        for name in ("visited_count", "expanded_count", "reranked_count"):
            np.testing.assert_array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name)), err_msg=name)
        assert (tr.ids.numpy() >= 0).all()


def test_repacked_tail_serves_alike(containers, corpus):
    _, queries = corpus
    q = np.concatenate([queries, queries[::-1]])  # 128 queries: the repack needs >= 64
    j = JTier.load(containers["paired"], use_hierarchy=False)
    t = DeviceTierIndex.load(containers["paired"], use_hierarchy=False, device="cpu")
    kw = dict(top_k=10, beam_width=40, repack_after=12)
    np.testing.assert_array_equal(t.search(torch.as_tensor(q), **kw).ids.numpy(),
                                  np.asarray(j.search(jnp.asarray(q), **kw).ids))


def test_paired_search_layer_equals_plain(containers, corpus):
    """The JAX package's ``search_layer(packed_pairs=R)`` on its tier's
    paired rows returns the ids and scores of the port's ``search_layer`` on
    the plain ``[N, R]`` table that the port's tier reads from the v3
    paired container (the port has no paired mode: row-major the pairs are
    the plain table)."""
    _, queries = corpus
    t = DeviceTierIndex.load(containers["paired"], use_hierarchy=False, device="cpu")
    j = JTier.load(containers["paired"], use_hierarchy=False)
    entries = t.entry_node.expand(len(queries))
    plain = tsearcher.search_layer(t.neighbors, t.provider, t.provider.prepare(torch.as_tensor(queries)), entries,
                                   beam_width=32)
    jbeam = jsearcher.search_layer(j.adj_pairs, j.provider, j.provider.prepare(jnp.asarray(queries)),
                                   jnp.broadcast_to(j.entry_node, (len(queries),)), beam_width=32,
                                   packed_pairs=j.row_cap)
    np.testing.assert_array_equal(plain.ids.numpy(), np.asarray(jbeam.ids))
    np.testing.assert_array_equal(plain.scores.numpy(), np.asarray(jbeam.scores))


def test_refusals_and_helpers(containers):
    with pytest.raises(ValueError, match="fused_sq4"):
        DeviceTierIndex.load(containers["no_sq4"], device="cpu")
    nbrs = np.random.default_rng(3).integers(-1, 100, size=(10, 40)).astype(np.int32)
    with pytest.raises(ValueError, match="r_pad"):  # the JAX package asserts here
        pack_adjacency_pairs_host(nbrs, 48)
    with pytest.raises(ValueError, match="r_pad"):
        pack_adjacency_pairs_host(nbrs, 32)
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, size=(32, 16)).astype(np.uint8)
    const = rng.normal(size=32).astype(np.float32)
    host = tdt.sq4_aug_rows_host(codes, const)
    np.testing.assert_array_equal(host, j_aug_host(codes, const))
    np.testing.assert_array_equal(host, tscore.sq4_aug_rows(torch.as_tensor(codes), torch.as_tensor(const)).numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):  # the card by default, never the CPU
        DeviceTierIndex.load(containers["plain"])
