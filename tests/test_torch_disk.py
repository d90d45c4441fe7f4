"""The index container is the shared interface of the two packages: a file
either one writes loads in the other with equal arrays and meta.

Covers the frozen v1/v2 fixtures, the plain layout with features and edge
scores, the renumbered layout of a graph with deleted holes, the v3 paired
layout, the refusals (corrupt, truncated and wrong-magic files; paired with
``save_scores``), the port's ``graph_to_device`` round trip and its host IO
helpers.
"""

import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.disk import format as jfmt
from jvector_tpu.disk import host_graph as jhg
from jvector_tpu.graph import index as jidx
from jvector_tpu_torch import convert
from jvector_tpu_torch.disk import format as tfmt
from jvector_tpu_torch.disk import host_graph as thg
from jvector_tpu_torch.quantization import ScalarQuantization4
from jvector_tpu_torch.util import native

FIX = pathlib.Path(__file__).parent / "fixtures"


def _random_graph(seed: int, n_cap: int = 96, r: int = 12, n: int = 90, levels: int = 2, holes: int = 0):
    """A graph as numpy: random -1 padded rows with scores, an upper level
    in slot space, optional deleted holes."""
    rng = np.random.default_rng(seed)

    def layer(rows, ids_range):
        counts = rng.integers(0, r + 1, rows).astype(np.int32)
        nb = np.full((rows, r), -1, np.int32)
        sc = np.full((rows, r), -np.inf, np.float32)
        for i, c in enumerate(counts):
            nb[i, :c] = rng.choice(ids_range, c, replace=False)
            sc[i, :c] = np.sort(rng.random(c).astype(np.float32))[::-1]
        return nb, sc, counts

    base = layer(n_cap, n)
    upper, ids = [], []
    for lv in range(1, levels):
        nl = max(2, n // (6 * lv))
        ids.append(np.sort(rng.choice(n, nl, replace=False)).astype(np.int32))
        upper.append(layer(nl, nl))
    deleted = np.zeros(n_cap, bool)
    deleted[rng.choice(n, holes, replace=False)] = True
    return dict(base=base, upper=upper, ids=ids, deleted=deleted, entry=int(np.flatnonzero(~deleted[:n])[0]), n=n)


def _jax_graph(g):
    layers = tuple(jidx.GraphLayer(*(jnp.asarray(a) for a in lay)) for lay in [g["base"], *g["upper"]])
    return jidx.GraphIndex(
        layers=layers, level_node_ids=tuple(jnp.asarray(i) for i in g["ids"]),
        entry_node=jnp.int32(g["entry"]), num_nodes=jnp.int32(g["n"]), deleted=jnp.asarray(g["deleted"]),
    )


def _torch_graph(g):
    return convert.graph_from_numpy(*g["base"], g["entry"], g["n"], g["deleted"], device="cpu",
                                    upper_layers=g["upper"], level_node_ids=g["ids"])


def _assert_files_equal(a_path, b_path):
    """Both readers on both files: equal names, meta, versions and arrays."""
    readers = [mod.IndexFileReader(p) for p in (a_path, b_path) for mod in (jfmt, tfmt)]
    first = readers[0]
    for r in readers[1:]:
        assert r.version == first.version
        assert r.meta == first.meta
        assert r.array_names() == first.array_names()
        for name in first.array_names():
            x, y = np.asarray(first.read(name)), np.asarray(r.read(name, verify=True))
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(y.view(np.uint8), x.view(np.uint8), err_msg=name)


FEATURES = {"inline_vectors": {"vectors": np.arange(96 * 6, dtype=np.float32).reshape(96, 6) / 7},
            "pq_codes": {"codes": np.arange(96 * 4, dtype=np.uint8).reshape(96, 4)}}


@pytest.mark.parametrize(
    "layout, holes, kw",
    [
        ("plain", 0, dict(save_scores=True)),
        ("renumbered", 7, dict(save_scores=True)),
        ("tombstones", 5, dict(renumber=False)),
        ("paired", 0, dict(paired_adjacency=True)),
    ],
)
def test_files_cross_both_ways(tmp_path, layout, holes, kw):
    """The same graph written by each package: each file reads equal in both
    packages (arrays byte for byte, meta, version)."""
    g = _random_graph(3, holes=holes)
    jp, tp = tmp_path / "jax.jvtpu", tmp_path / "torch.jvtpu"
    jfmt.write_index(jp, _jax_graph(g), features=FEATURES, similarity="euclidean", **kw)
    tfmt.write_index(tp, _torch_graph(g), features=FEATURES, similarity="euclidean", **kw)
    _assert_files_equal(jp, tp)
    r = tfmt.IndexFileReader(tp)
    assert r.version == (3 if layout == "paired" else 2)
    assert r.meta.get("renumbered", False) == (layout == "renumbered")
    # the JAX package loads the port's file into an equal graph
    jg, feats = jfmt.load_index(tp).to_device()
    tg, tfeats = tfmt.load_index(jp).to_device("cpu")
    assert jg.num_levels == tg.num_levels and int(jg.entry_node) == int(tg.entry_node)
    for a, b in zip(jg.layers, tg.layers):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    for a, b in zip(jg.level_node_ids, tg.level_node_ids):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(tg.deleted.numpy(), np.asarray(jg.deleted))
    for fname, arrays in feats.items():
        for aname, arr in arrays.items():
            np.testing.assert_array_equal(tfeats[fname][aname].numpy(), np.asarray(arr))


@pytest.mark.parametrize("fixture", ["v1", "v2"])
def test_frozen_fixtures_read(fixture):
    idx = tfmt.load_index(FIX / f"{fixture}_frozen.jvtpu")
    expect = np.load(FIX / f"{fixture}_frozen_expect.npz")
    graph, feats = idx.to_device("cpu")
    np.testing.assert_array_equal(graph.base.neighbors.numpy(), expect["neighbors"])
    np.testing.assert_array_equal(feats["inline_vectors"]["vectors"].numpy(), expect["vectors"])
    if fixture == "v1":
        assert (int(graph.entry_node), int(graph.num_nodes)) == (3, 32)
        np.testing.assert_allclose(graph.base.scores.numpy(), expect["scores"], rtol=1e-7)
    else:
        assert idx.reader.version == 2
        assert graph.num_levels == int(expect["num_levels"])
        assert int(graph.entry_node) == int(expect["entry"])
        np.testing.assert_array_equal(graph.layers[1].neighbors.numpy(), expect["l1_neighbors"])
        np.testing.assert_array_equal(graph.level_node_ids[0].numpy(), expect["l1_node_ids"])
    jg, _ = jfmt.load_index(FIX / f"{fixture}_frozen.jvtpu").to_device()
    np.testing.assert_array_equal(graph.base.counts.numpy(), np.asarray(jg.base.counts))
    np.testing.assert_array_equal(graph.base.scores.numpy(), np.asarray(jg.base.scores))


def test_refusals(tmp_path):
    """Corrupt, truncated and wrong-magic files raise; so does a paired save
    asked to keep scores (the JAX package drops them silently), and a paired
    save of a graph with holes."""
    p = tmp_path / "y.jvtpu"
    with tfmt.IndexFileWriter(p) as w:
        w.add_array("a", np.arange(64, dtype=np.float32))
    raw = p.read_bytes()
    (tmp_path / "t.jvtpu").write_bytes(raw[:-3])
    with pytest.raises(ValueError, match="footer"):
        tfmt.IndexFileReader(tmp_path / "t.jvtpu")
    (tmp_path / "m.jvtpu").write_bytes(b"NOTJV\x00" + raw[6:])
    with pytest.raises(ValueError, match="magic"):
        tfmt.IndexFileReader(tmp_path / "m.jvtpu")
    bad = bytearray(raw)
    bad[64 + 10] ^= 0xFF  # one flipped byte inside the blob
    (tmp_path / "c.jvtpu").write_bytes(bytes(bad))
    r = tfmt.IndexFileReader(tmp_path / "c.jvtpu")
    with pytest.raises(ValueError, match="CRC"):
        r.read("a", verify=True)
    (tmp_path / "v.jvtpu").write_bytes(raw[:6] + (9).to_bytes(2, "little") + raw[8:])
    with pytest.raises(ValueError, match="version"):
        tfmt.IndexFileReader(tmp_path / "v.jvtpu")
    g = _random_graph(4)
    with pytest.raises(ValueError, match="save_scores"):
        tfmt.write_index(tmp_path / "p.jvtpu", _torch_graph(g), save_scores=True, paired_adjacency=True)
    with pytest.raises(ValueError, match="holes"):
        tfmt.write_index(tmp_path / "h.jvtpu", _torch_graph(_random_graph(4, holes=3)), paired_adjacency=True)


def test_writer_resume_and_graph_round_trip(tmp_path):
    """A reserved extent filled across a writer snapshot and resume, and a
    saved graph back through ``graph_to_device`` unchanged."""
    p = tmp_path / "r.jvtpu"
    w = tfmt.IndexFileWriter(p)
    w.reserve_array("v", (6, 3), np.float32)
    w.write_rows("v", 4, np.full((2, 3), 4, np.float32))
    state = w.state_dict()
    w._f.write(b"torn tail")  # bytes after the snapshot are cut on resume
    w._f.close()
    w = tfmt.IndexFileWriter.resume(p, state)
    w.write_rows("v", 0, np.ones((2, 3), np.float32))
    w.add_array("after", np.arange(5, dtype=np.int32))
    w.close()
    j = jfmt.IndexFileReader(p)
    np.testing.assert_array_equal(np.asarray(j.read("v"))[[0, 1, 4, 5]], np.repeat([1, 1, 4, 4], 3).reshape(4, 3))
    np.testing.assert_array_equal(j.read("after", verify=True), np.arange(5))
    with pytest.raises(ValueError, match="shorter"):
        tfmt.IndexFileWriter.resume(p, {**state, "file_size": p.stat().st_size + 1})

    g = _random_graph(5)
    tg = _torch_graph(g)
    tfmt.write_index(tmp_path / "g.jvtpu", tg, save_scores=True)
    back = tfmt.load_index(tmp_path / "g.jvtpu").graph_to_device("cpu")
    for a, b in zip(tg.layers, back.layers):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert int(back.entry_node) == int(tg.entry_node) and int(back.num_nodes) == int(tg.num_nodes)
    # without saved scores, live slots read back as 0 and padding as -inf
    tfmt.write_index(tmp_path / "n.jvtpu", tg)
    noscore = tfmt.load_index(tmp_path / "n.jvtpu").graph_to_device("cpu")
    nb = noscore.base.neighbors
    assert torch.equal(noscore.base.scores, torch.where(nb >= 0, 0.0, float("-inf")))


def test_native_io_helpers(tmp_path):
    """``crc32_file`` equals zlib's; ``gather_rows`` gives zero rows for
    out-of-range ids, fills ``out`` when given, and reads memmaps."""
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
    p = tmp_path / "blob"
    p.write_bytes(data)
    assert native.crc32_file(str(p), 1000, len(data) - 5000) == zlib.crc32(data[1000:-4000]) & 0xFFFFFFFF
    assert native.backend() in ("native", "numpy")
    src = rng.normal(size=(50, 7)).astype(np.float32)
    np.save(tmp_path / "src.npy", src)
    mm = np.load(tmp_path / "src.npy", mmap_mode="r")
    idx = np.array([3, -1, 49, 50, 0, 3], np.int32)
    want = src[np.clip(idx, 0, 49)]
    want[[1, 3]] = 0
    np.testing.assert_array_equal(native.gather_rows(mm, idx), want)
    out = np.empty((6, 7), np.float32)
    assert native.gather_rows(src, idx, out=out) is out
    np.testing.assert_array_equal(out, want)


def test_write_sq4_index_serves_equal_in_both(tmp_path):
    """A flat port graph saved with ``write_sq4_index`` (no inline vectors:
    one SQ4 pass) is served by both packages' ``HostGraphIndex`` with equal
    ids and scores.  Grid vectors with 0 and 15 in every column give the
    quantizer scale 1 and offset 0, so no score is rounded."""
    g = _random_graph(6, levels=1)
    rng = np.random.default_rng(6)
    vec = rng.integers(0, 16, (96, 16)).astype(np.float32)
    vec[:2], vec[2:4] = 0, 15
    sq = ScalarQuantization4.compute(vec[: g["n"]], device="cpu")
    assert (sq.scale == 1).all() and (sq.offset == 0).all()
    codes = sq.encode(vec)
    tg = _torch_graph(g)
    thg.write_sq4_index(tmp_path / "s.jvtpu", tg, sq, codes, sq.provider_for_graph(codes, tg.base.neighbors,
                                                                                      "euclidean"), "euclidean")
    q = rng.integers(0, 16, (12, 16)).astype(np.float32)
    kw = dict(top_k=5, beam_width=16, expand=2)
    a = jhg.HostGraphIndex.load(str(tmp_path / "s.jvtpu")).search(jnp.asarray(q), **kw)
    hg = thg.HostGraphIndex.load(tmp_path / "s.jvtpu", device="cpu")
    assert hg.rerank_store is None and not hg.upper_node_ids
    b = hg.search(q, **kw)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(a.ids))
    np.testing.assert_array_equal(b.scores.numpy(), np.asarray(a.scores))
    assert (b.ids.numpy() >= 0).all()
