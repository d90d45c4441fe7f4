"""The port's NN-descent bulk builder (``jvector_tpu_torch.graph.nndescent``)
against the JAX package.

``_reverse_sample`` must draw and fill exactly as the JAX package's from the
same ``np.random.default_rng``.  On an integer-grid corpus (levels 0..15,
as in ``tests/test_torch_build.py``), where every exact score is computed
without rounding in both frameworks, ``nn_descent_build`` must give the JAX
package's adjacency, counts, edge scores (bit for bit) and entry point.  On
a float corpus (``tests/test_nndescent.py``'s, n = 4000, d = 24) the port's
recall@10 at beam 48 must reach that test's 0.85 floor and lie within 0.02
of the JAX package's (the float32 sums may round apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import nndescent as jnn
from jvector_tpu.graph import search as jsearch
from jvector_tpu.util.datasets import recall_at_k, synthetic_dataset
from jvector_tpu_torch.graph import GraphConfig, search
from jvector_tpu_torch.graph import nndescent as tnn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n_valid,r", [(300, 16), (257, 5)])
def test_reverse_sample_equal_draw_for_draw(n_valid, r):
    rng = np.random.default_rng(3)
    fwd = rng.integers(-1, n_valid, size=(320, 24)).astype(np.int32)
    a = jnn._reverse_sample(fwd, n_valid, r, np.random.default_rng(9))
    b = tnn._reverse_sample(fwd, n_valid, r, np.random.default_rng(9))
    np.testing.assert_array_equal(b, a)
    assert (b >= 0).any()


def _grid_corpus(n: int, d: int) -> np.ndarray:
    x = synthetic_dataset(n=n, dim=d, n_queries=1, k=1, n_clusters=12, seed=21).base
    lo, hi = x.min(axis=0), x.max(axis=0)
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


def test_nn_descent_build_matches_jax_on_integer_grid():
    """n = 1500 in a 1536-slot capacity (36 padded rows), chunks of 1024
    (a ragged last chunk), five rounds: every table equal, and the rows
    valid as ``tests/test_nndescent.py`` holds them."""
    data = _grid_corpus(1500, 16)
    kw = dict(max_degree=12, ef_construction=32)
    jg, _ = jnn.nn_descent_build(data, "euclidean", JConfig(**kw), rounds=5, chunk=1024)
    tg, tp = tnn.nn_descent_build(data, "euclidean", GraphConfig(**kw), rounds=5, chunk=1024, device="cpu")
    for name in ("neighbors", "counts"):
        np.testing.assert_array_equal(getattr(tg.base, name).numpy(), np.asarray(getattr(jg.base, name)), err_msg=name)
    np.testing.assert_array_equal(tg.base.scores.numpy().view(np.int32), np.asarray(jg.base.scores).view(np.int32))
    assert int(tg.entry_node) == int(jg.entry_node) and int(tg.num_nodes) == 1500
    assert tp.vectors.shape[0] == tg.capacity == 1536
    nbrs, counts = tg.base.neighbors.numpy()[:1500], tg.base.counts.numpy()[:1500]
    assert counts.max() <= kw["max_degree"] and (counts > 0).all()
    for i in range(0, 1500, 113):
        row = nbrs[i][: counts[i]]
        assert (row >= 0).all() and (row < 1500).all() and i not in row
        assert len(set(row.tolist())) == len(row)


def test_nn_descent_recall_matches_jax():
    ds = synthetic_dataset(n=4000, dim=24, n_queries=40, k=10, seed=77)
    kw = dict(max_degree=16, ef_construction=48)
    jg, jp = jnn.nn_descent_build(ds.base, "euclidean", JConfig(**kw), rounds=6, chunk=2048)
    tg, tp = tnn.nn_descent_build(ds.base, "euclidean", GraphConfig(**kw), rounds=6, chunk=2048, device="cpu")
    rj = recall_at_k(np.asarray(jsearch(jg, jp, jnp.asarray(ds.queries), top_k=10, beam_width=48).ids),
                     ds.ground_truth, 10)
    rt = recall_at_k(search(tg, tp, torch.as_tensor(ds.queries), top_k=10, beam_width=48).ids.numpy(),
                     ds.ground_truth, 10)
    assert rt >= 0.85 and abs(rt - rj) <= 0.02, (rt, rj)
