"""Compressor files, the compressor cache and the NVQ / BQ index features
across the two packages.

A compressor file (PQ with its anisotropic threshold, SQ4, BQ, NVQ) or an
index with the ``NVQ_VECTORS`` and ``BQ_CODES`` features written by either
package loads in the other with every array bit-equal; BQ codes are
``uint32`` on disk and the port's int32 words in memory.  One key names the
same cache file in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.disk.format import FeatureId as JFeatureId
from jvector_tpu.disk.format import load_index as jload_index
from jvector_tpu.disk.format import write_index as jwrite_index
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.quantization import BinaryQuantization as JBQ
from jvector_tpu.quantization import CompressorCache as JCache
from jvector_tpu.quantization import NVQuantization as JNVQ
from jvector_tpu.quantization import NVQVectors as JNVQVectors
from jvector_tpu.quantization import ProductQuantization as JPQ
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu.quantization import load_compressor as jload
from jvector_tpu.quantization import save_compressor as jsave
from jvector_tpu_torch import convert
from jvector_tpu_torch.disk import FeatureId, load_index, write_index
from jvector_tpu_torch.quantization import (
    BinaryQuantization,
    CompressorCache,
    NVQuantization,
    NVQVectors,
    ProductQuantization,
    ScalarQuantization4,
    load_compressor,
    save_compressor,
)
from jvector_tpu_torch.quantization.bq import codes_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(n=600, d=30, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _arrays(comp) -> dict:
    """A compressor's arrays and settings as numpy / Python values."""
    out = {}
    for f in ("codebooks", "center", "scale", "offset", "mean"):
        v = getattr(comp, f, None)
        if v is not None:
            out[f] = np.array(v.cpu() if isinstance(v, torch.Tensor) else v)
    for f in ("original_dim", "anisotropic_threshold", "num_subvectors", "bits"):
        if hasattr(comp, f):
            out[f] = getattr(comp, f)
    return out


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == b[k].dtype and v.tobytes() == b[k].tobytes(), k
        else:
            assert v == b[k], k


def _jax_compressors(data):
    return {
        "pq_aniso": JPQ.compute(data, m=6, clusters=32, globally_center=True, anisotropic_threshold=0.2),
        "pq_plain_uncentred": JPQ.compute(data, m=6, clusters=32, globally_center=False),
        "sq4": JSQ4.compute(data),
        "bq": JBQ.compute(data),
        "nvq": JNVQ.compute(data, num_subvectors=3),
    }


def _port_compressors(data):
    return {
        "pq_aniso": ProductQuantization.compute(data, m=6, clusters=32, globally_center=True,
                                                anisotropic_threshold=0.2, iters=1, device="cpu"),
        "pq_plain_uncentred": ProductQuantization.compute(data, m=6, clusters=32, globally_center=False, iters=1,
                                                          device="cpu"),
        "sq4": ScalarQuantization4.compute(data, device="cpu"),
        "bq": BinaryQuantization.compute(data, device="cpu"),
        "nvq": NVQuantization.compute(data, num_subvectors=3, device="cpu"),
    }


def test_jax_compressor_files_load_in_port(tmp_path):
    data = _data()
    types = {"pq_aniso": ProductQuantization, "pq_plain_uncentred": ProductQuantization,
             "sq4": ScalarQuantization4, "bq": BinaryQuantization, "nvq": NVQuantization}
    for name, comp in _jax_compressors(data).items():
        p = tmp_path / f"{name}.jvtpu"
        jsave(p, comp)
        got = load_compressor(p, device="cpu")
        assert type(got) is types[name], name
        _same(_arrays(got), _arrays(comp))
    # the loaded anisotropic PQ encodes as the JAX package's does
    got = load_compressor(tmp_path / "pq_aniso.jvtpu", device="cpu")
    want = np.asarray(_jax_compressors(data)["pq_aniso"].encode(data))
    assert (got.encode(data).numpy() == want).mean() >= 0.999


def test_port_compressor_files_load_in_jax(tmp_path):
    data = _data()
    types = {"pq_aniso": JPQ, "pq_plain_uncentred": JPQ, "sq4": JSQ4, "bq": JBQ, "nvq": JNVQ}
    for name, comp in _port_compressors(data).items():
        p = tmp_path / f"{name}.jvtpu"
        save_compressor(p, comp)
        got = jload(p)
        assert type(got) is types[name], name
        _same(_arrays(got), _arrays(comp))
        _same(_arrays(load_compressor(p, device="cpu")), _arrays(comp))  # and back in the port


def test_not_a_compressor_raises(tmp_path):
    data = _data(n=200)
    with pytest.raises(TypeError):
        save_compressor(tmp_path / "x.jvtpu", object())
    graph, _ = jbuild(data, "euclidean", JConfig(max_degree=8, ef_construction=16, wave_size=128))
    p = tmp_path / "index.jvtpu"
    jwrite_index(p, graph)
    with pytest.raises(ValueError, match="not a compressor"):
        load_compressor(p, device="cpu")
    junk = tmp_path / "junk.jvtpu"
    junk.write_bytes(b"not a container at all, just bytes" * 4)
    with pytest.raises(ValueError):
        load_compressor(junk, device="cpu")


def test_cache_names_the_same_file_in_both_packages(tmp_path):
    keys = [
        {"dataset": "synth", "n": 20000, "dim": 96, "kind": "pq", "m": 24, "k": 256, "center": False, "aniso": 0.2},
        {"dataset": "synth", "n": 20000, "dim": 96, "kind": "bq"},
        {"dataset": "x", "n": 5, "dim": 1536, "kind": "nvq", "extra": np.float32(1.5)},  # default=str
    ]
    jc, tc = JCache(tmp_path / "j"), CompressorCache(tmp_path / "t", device="cpu")
    for key in keys:
        assert jc._path(key).rsplit("/", 1)[1] == tc._path(key).rsplit("/", 1)[1]


def test_cache_shared_between_packages(tmp_path):
    """A compressor the JAX package's cache trained loads through the
    port's cache without training, and the reverse."""
    data = _data(n=300)
    key = {"dataset": "d", "n": 300, "dim": 30, "kind": "bq"}
    jcomp = JCache(tmp_path).get_or_train(key, lambda: JBQ.compute(data))
    calls = []
    got = CompressorCache(tmp_path, device="cpu").get_or_train(key, lambda: calls.append(1))
    assert not calls and np.array_equal(got.center.numpy(), np.asarray(jcomp.center))
    key2 = {**key, "kind": "nvq"}
    tcomp = CompressorCache(tmp_path, device="cpu").get_or_train(key2, lambda: NVQuantization.compute(data, device="cpu"))
    jgot = JCache(tmp_path).get_or_train(key2, lambda: calls.append(1))
    assert not calls and np.asarray(jgot.mean).tobytes() == tcomp.mean.numpy().tobytes()


@pytest.fixture(scope="module")
def small_graph():
    data = _data(n=400, d=40, seed=3)
    jg, _ = jbuild(data, "euclidean", JConfig(max_degree=8, ef_construction=16, wave_size=128))
    tg = convert.graph_from_numpy(np.asarray(jg.base.neighbors), np.asarray(jg.base.scores),
                                  np.asarray(jg.base.counts), int(jg.entry_node), int(jg.num_nodes), device="cpu")
    return data, jg, tg


def test_nvq_and_bq_features_jax_to_port(small_graph, tmp_path):
    data, jg, _ = small_graph
    jv = JNVQ.compute(data).encode(data)
    jbq = JBQ.compute(data)
    jcodes = np.asarray(jbq.encode(data))
    p = tmp_path / "jax_index.jvtpu"
    jwrite_index(p, jg, features={JFeatureId.NVQ_VECTORS: jv.feature_arrays(),
                                  JFeatureId.BQ_CODES: {"codes": jcodes, "center": np.asarray(jbq.center)}})
    idx = load_index(p)
    assert set(idx.features) == {FeatureId.NVQ_VECTORS, FeatureId.BQ_CODES}
    _, feats = idx.to_device("cpu")
    tv = NVQVectors.from_feature_arrays(feats[FeatureId.NVQ_VECTORS])
    assert tv.codes.numpy().tobytes() == np.asarray(jv.codes).tobytes()
    assert tv.params.numpy().tobytes() == np.asarray(jv.params).tobytes()
    assert tv.nvq.mean.numpy().tobytes() == np.asarray(jv.nvq.mean).tobytes()
    assert (tv.nvq.original_dim, tv.nvq.num_subvectors, tv.nvq.bits) == (40, 2, 8)
    codes = convert.bq_codes_from_numpy(idx.reader.read(f"feature/{FeatureId.BQ_CODES}/codes"), device="cpu")
    assert np.array_equal(codes_to_numpy(codes), jcodes)
    tbq = convert.bq_from_numpy(np.asarray(feats[FeatureId.BQ_CODES]["center"]), 40, device="cpu")
    assert torch.equal(tbq.encode(data), codes)
    # the numpy dict rebuilds the same vectors
    tv2 = NVQVectors.from_feature_arrays(jv.feature_arrays(), device="cpu")
    assert torch.equal(tv2.codes, tv.codes) and torch.equal(tv2.params, tv.params)


def test_nvq_and_bq_features_port_to_jax(small_graph, tmp_path):
    data, _, tg = small_graph
    tv = NVQuantization.compute(data, device="cpu").encode(data)
    tbq = BinaryQuantization.compute(data, device="cpu")
    tcodes = tbq.encode(data)
    p = tmp_path / "port_index.jvtpu"
    write_index(p, tg, features={FeatureId.NVQ_VECTORS: tv.feature_arrays(),
                                 FeatureId.BQ_CODES: {"codes": codes_to_numpy(tcodes), "center": tbq.center}})
    _, feats = jload_index(p).to_device()
    jv = JNVQVectors.from_feature_arrays(feats[JFeatureId.NVQ_VECTORS])
    assert np.asarray(jv.codes).tobytes() == tv.codes.numpy().tobytes()
    assert np.asarray(jv.params).tobytes() == tv.params.numpy().tobytes()
    assert np.asarray(jv.nvq.mean).tobytes() == tv.nvq.mean.numpy().tobytes()
    jcodes = feats[JFeatureId.BQ_CODES]["codes"]
    assert jcodes.dtype == jnp.uint32
    assert np.asarray(jcodes).view(np.int32).tobytes() == tcodes.numpy().tobytes()
    # the JAX package scores the port's codes as the port does
    jbq = JBQ(center=jnp.asarray(tbq.center.numpy()), original_dim=40)
    assert np.array_equal(np.asarray(jbq.encode(data)), np.asarray(jcodes))
