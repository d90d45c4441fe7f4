"""Wave-by-wave parity of the port's packed SQ4 build with the JAX package.

Both packages run the packed-adjacency wave loop on the same corpus with the
same SQ4 quantizer and the same entry seeds.  The corpus lies on an integer
grid (levels 0..15, the quantizer's scale 1 and offset 0), so every score in
the build, exact and SQ4 alike, is computed without rounding in both
frameworks and the comparisons below can demand equality: the beam search
ids and scores, every write stream of ``_wave_update_compute`` given the
same search result, the tables after ``_wave_apply_packed``, the packed
cleanup, the unpacked graph and its entry point.  Exact score ties are
common on such a grid, so this also holds the port's tie order to the JAX
package's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import builder as jb
from jvector_tpu.graph import index as jidx
from jvector_tpu.graph import score as jscore
from jvector_tpu.quantization import sq as jsq
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch.graph import builder as tb
from jvector_tpu_torch.graph import index as tidx
from jvector_tpu_torch.graph import score as tscore
from jvector_tpu_torch.quantization import sq as tsq

N, D = 1536, 32  # capacity 1536: three 512-node waves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x):
    return torch.as_tensor(np.array(x))


def _grid_corpus() -> np.ndarray:
    ds = synthetic_dataset(n=N, dim=D, n_queries=1, k=1, n_clusters=12, seed=21)
    x = ds.base
    lo, hi = x.min(axis=0), x.max(axis=0)
    return np.clip(np.round((x - lo) / (hi - lo) * 15), 0, 15).astype(np.float32)


def _build_providers(data: np.ndarray, n_cap: int):
    scale, offset = np.ones(D, np.float32), np.zeros(D, np.float32)
    jq = jsq.ScalarQuantization4(scale=jnp.asarray(scale), offset=jnp.asarray(offset), original_dim=D)
    tq = tsq.ScalarQuantization4(scale=_t(scale), offset=_t(offset), original_dim=D)
    codes = np.zeros((n_cap, D // 2), np.uint8)
    codes[:N] = np.asarray(jq.encode(data))
    np.testing.assert_array_equal(tq.encode(data).numpy(), codes[:N])
    jw2, jn2 = jq.node_constants(jnp.asarray(codes))
    tw2, tn2 = tq.node_constants(_t(codes))
    np.testing.assert_array_equal(tw2.numpy(), np.asarray(jw2))
    jbp = jscore.SQ4ScoreProvider(
        codes_packed=jnp.asarray(codes), node_w2=jw2, node_norm2=jn2,
        fused_packed=jnp.zeros((n_cap, 0), jnp.uint8), fused_w2=jnp.zeros((n_cap, 0)),
        scale=jq.scale, offset=jq.offset, codes_aug=jscore.sq4_aug_rows(jnp.asarray(codes), jw2),
    )
    tbp = tscore.SQ4ScoreProvider(
        codes_packed=_t(codes), node_w2=tw2, node_norm2=tn2,
        fused_packed=torch.zeros((n_cap, 0), dtype=torch.uint8), fused_w2=torch.zeros((n_cap, 0)),
        scale=tq.scale, offset=tq.offset, codes_aug=tscore.sq4_aug_rows(_t(codes), tw2),
    )
    np.testing.assert_array_equal(tbp.codes_aug.numpy(), np.asarray(jbp.codes_aug))
    return jbp, tbp


def _snapshot(out):
    """numpy copies of a wave's outputs (later steps update tables in place)."""
    counts, entry, num, adj_stream, fused_stream = out
    as_np = lambda x: np.array(x.numpy() if isinstance(x, torch.Tensor) else x)  # noqa: E731
    return (
        as_np(counts), int(entry), int(num),
        [as_np(x) for x in adj_stream], [as_np(x) for x in fused_stream],
    )


@pytest.fixture(scope="module", params=[0, 24], ids=["plain", "repack24"])
def run(request):
    """Run both wave loops side by side; record what each wave produced.

    ``build_repack_after=24`` cuts each wave search after 24 steps and
    finishes the active lanes in a quarter-width sub-wave (lanes past its
    width stay truncated), which both packages must do alike."""
    data = _grid_corpus()
    n_cap = jidx.bucket_capacity(N)
    assert n_cap == tidx.bucket_capacity(N) == N
    cut = request.param
    jcfg = jb._fused_aligned_config(jidx.GraphConfig(build_repack_after=cut), D // 2)
    tcfg = tb._fused_aligned_config(tidx.GraphConfig(build_repack_after=cut), D // 2)
    assert jcfg.row_cap == tcfg.row_cap == 64
    assert jb._packed_build_eligible(jcfg, D // 2, n_cap) and tb._packed_build_eligible(tcfg, D // 2, n_cap)
    jbp, tbp = _build_providers(data, n_cap)
    mp, w = D // 2, jcfg.wave_size
    jprov = jscore.ExactScoreProvider(vectors=jnp.asarray(data))
    tprov = tscore.ExactScoreProvider(vectors=_t(data))
    j = dict(
        adj=jb._empty_packed_adjacency(n_cap, jcfg.row_cap),
        w2t=jnp.zeros((n_cap // 8, 8, 128), jnp.int32),
        fused=jnp.zeros((n_cap, jcfg.row_cap * mp // 128, 128), jnp.uint8),
        counts=jnp.zeros((n_cap,), jnp.int32), entry=jnp.int32(-1), num=jnp.int32(0),
    )
    t = dict(
        adj=tb._empty_packed_adjacency(n_cap, tcfg.row_cap, "cpu"),
        w2t=torch.zeros((n_cap // 8, 8, 128), dtype=torch.int32),
        fused=torch.zeros((n_cap, tcfg.row_cap * mp // 128, 128), dtype=torch.uint8),
        counts=torch.zeros((n_cap,), dtype=torch.int32),
        entry=torch.tensor(-1, dtype=torch.int32), num=torch.tensor(0, dtype=torch.int32),
    )
    np.testing.assert_array_equal(t["adj"].numpy(), np.asarray(j["adj"]))
    seeds = jb._EntrySeedSampler(N, w, jcfg.build_entry_seeds)
    waves = []
    starts = jb._shuffled_wave_starts(N, w)
    assert starts == tb._shuffled_wave_starts(N, w)
    for start in starts:
        ids = np.arange(start, start + w, dtype=np.int32)
        seed = seeds.sample()
        wv = data[start : start + w]
        jbeam = jb._wave_search(
            j["adj"], dataclasses.replace(jbp, fused_packed=j["fused"], fused_w2=j["w2t"]),
            j["entry"], jnp.asarray(ids), jnp.asarray(wv), jcfg, seed,
        )
        tbeam = tb._wave_search(
            t["adj"], dataclasses.replace(tbp, fused_packed=t["fused"], fused_w2=t["w2t"]),
            t["entry"], _t(ids), _t(wv), tcfg, _t(seed),
        )
        seeds.record(ids)
        jout = jb._wave_update_compute(
            j["adj"], j["counts"], j["entry"], j["num"], jprov, jbp.codes_packed, jbp.node_w2,
            jnp.asarray(ids), jnp.asarray(wv), *jbeam, jcfg,
        )
        # the port's update gets the JAX search result: streams must agree
        # given the same beams
        tout = tb._wave_update_compute(
            t["adj"], t["counts"], t["entry"], t["num"], tprov, tbp.codes_packed, tbp.node_w2,
            _t(ids), _t(wv), _t(jbeam[0]), _t(jbeam[1]), tcfg,
        )
        j["counts"], j["entry"], j["num"] = jout[:3]
        t["counts"], t["entry"], t["num"] = tout[:3]
        j["adj"], j["w2t"], j["fused"] = jb._wave_apply_packed(
            j["adj"], j["w2t"], j["fused"], jout[3], jout[4], mp
        )
        tb._wave_apply_packed(t["adj"], t["w2t"], t["fused"], tout[3], tout[4])
        waves.append(dict(
            jbeam=[np.array(x) for x in jbeam], tbeam=[x.numpy() for x in tbeam],
            jout=_snapshot(jout), tout=_snapshot(tout),
            jtables=[np.array(j[k]) for k in ("adj", "w2t", "fused", "counts")],
            ttables=[t[k].numpy().copy() for k in ("adj", "w2t", "fused", "counts")],
        ))
    jadj, jcnt = jb.packed_cleanup(j["adj"], j["counts"], jprov, jcfg, j["num"])
    tb.packed_cleanup(t["adj"], t["counts"], tprov, tcfg, t["num"])
    jg = jidx.GraphIndex(
        layers=(jb._unpack_adjacency(jadj, jcnt, jcfg.row_cap),), level_node_ids=(),
        entry_node=j["entry"], num_nodes=j["num"], deleted=jnp.zeros((n_cap,), bool),
    )
    jg = jb.GraphIndexBuilder(jcfg).cleanup(jg, jprov, jnp.asarray(data), enforce=False)
    tg = tidx.GraphIndex(
        layers=(tb._unpack_adjacency(t["adj"], t["counts"], tcfg.row_cap),), level_node_ids=(),
        entry_node=t["entry"], num_nodes=t["num"], deleted=torch.zeros((n_cap,), dtype=torch.bool),
    )
    tg = tb.GraphIndexBuilder(tcfg).cleanup(tg, tprov, _t(data), enforce=False)
    return dict(waves=waves, jg=jg, tg=tg)


@pytest.mark.parametrize("wave", [0, 1, 2])
def test_wave_search_matches(run, wave):
    w = run["waves"][wave]
    np.testing.assert_array_equal(w["tbeam"][0], w["jbeam"][0])
    np.testing.assert_array_equal(w["tbeam"][1], w["jbeam"][1])


STREAMS = ["a_rows", "a_adj", "a_w2", "m_key", "m_slot", "m_id", "m_sc", "m_w2", "m_img", "e_adj", "e_w2"]
FUSED = ["f_rows_a", "f_codes", "f_p_rows", "f_slots", "f_src_codes", "er", "pf_codes"]


@pytest.mark.parametrize("wave", [0, 1, 2])
def test_wave_update_streams_match(run, wave):
    jout, tout = run["waves"][wave]["jout"], run["waves"][wave]["tout"]
    np.testing.assert_array_equal(tout[0], jout[0])  # counts
    assert tout[1:3] == jout[1:3]  # entry node, node count
    for name, a, b in zip(STREAMS, jout[3], tout[3]):
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name, a, b in zip(FUSED, jout[4], tout[4]):
        if name == "f_p_rows":
            # the port marks the invalid tail with the drop key _BIG, the JAX
            # package with -1 (both drop; K2's row owners need drops >= N
            # last): every in-range row and every drop position agree
            tail = b == tb._BIG
            assert (np.diff(tail.astype(np.int8)) >= 0).all(), "_BIG only as a tail"
            b = np.where(tail, -1, b)
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("wave", [0, 1, 2])
def test_wave_apply_tables_match(run, wave):
    w = run["waves"][wave]
    for name, a, b in zip(("adj", "w2t", "fused", "counts"), w["jtables"], w["ttables"]):
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_cleanup_and_unpacked_graph_match(run):
    jg, tg = run["jg"], run["tg"]
    np.testing.assert_array_equal(tg.base.neighbors.numpy(), np.asarray(jg.base.neighbors))
    np.testing.assert_array_equal(
        tg.base.scores.numpy().view(np.int32), np.asarray(jg.base.scores).view(np.int32)
    )
    np.testing.assert_array_equal(tg.base.counts.numpy(), np.asarray(jg.base.counts))
    assert int(tg.entry_node) == int(jg.entry_node)
    assert int(tg.num_nodes) == int(jg.num_nodes) == N
    assert int(tg.base.counts.max()) <= 32
