"""The port's dataset IO, YAML reader and dataset catalogs against the JAX
package's (``jvector_tpu_torch.util.io`` / ``.yaml_subset`` / ``.catalog``
/ ``.datasets`` loaders).

fvecs / ivecs / bvecs files cross between the packages bit for bit; the
native fvecs parser equals the numpy path; malformed files raise
``ValueError`` (a truncated ivecs or bvecs too, which the JAX package reads
short).  The YAML reader gives what ``yaml.safe_load`` gives on every file
under ``yaml-configs/`` and on the test suites' YAML strings, and refuses
what it does not read.  ``tests/test_catalog.py`` runs against the port's
catalog; a synthetic entry draws the JAX package's corpus bit for bit; a
failing fetch leaves no file behind; ``load_hdf5`` reads what the JAX
loader reads.
"""

import glob
import math
import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from jvector_tpu.util import catalog as jcatalog
from jvector_tpu.util import datasets as jdatasets
from jvector_tpu.util import io as jio
from jvector_tpu_torch.ops.similarity import SimilarityFunction
from jvector_tpu_torch.util import catalog as tcatalog
from jvector_tpu_torch.util import datasets as tdatasets
from jvector_tpu_torch.util import io as tio
from jvector_tpu_torch.util import native, yaml_subset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# -- fvecs / ivecs / bvecs ---------------------------------------------------


def _bvecs_bytes(v: np.ndarray) -> bytes:
    n, d = v.shape
    out = np.empty((n, 4 + d), np.uint8)
    out[:, :4] = np.frombuffer(np.int32(d).tobytes(), np.uint8)
    out[:, 4:] = v
    return out.tobytes()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_vecs_files_cross_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    f = rng.normal(size=(37, 24)).astype(np.float32)
    f[0, :3] = [np.inf, -0.0, np.nan]
    i = rng.integers(-5, 1 << 30, (37, 10)).astype(np.int32)
    wio, rio = (jio, tio) if writer == "jax" else (tio, jio)
    wio.write_fvecs(tmp_path / "a.fvecs", f)
    wio.write_ivecs(tmp_path / "a.ivecs", i)
    assert rio.read_fvecs(tmp_path / "a.fvecs").tobytes() == f.tobytes()
    np.testing.assert_array_equal(rio.read_ivecs(tmp_path / "a.ivecs"), i)
    for r in (jio, tio):
        assert r.read_fvecs(tmp_path / "a.fvecs", max_vectors=5).tobytes() == f[:5].tobytes()
        np.testing.assert_array_equal(r.read_ivecs(tmp_path / "a.ivecs", max_vectors=5), i[:5])
    b = rng.integers(0, 256, (11, 20)).astype(np.uint8)
    (tmp_path / "a.bvecs").write_bytes(_bvecs_bytes(b))
    np.testing.assert_array_equal(tio.read_bvecs(tmp_path / "a.bvecs"), jio.read_bvecs(tmp_path / "a.bvecs"))
    np.testing.assert_array_equal(tio.read_bvecs(tmp_path / "a.bvecs", max_vectors=3), b[:3])
    (tmp_path / "empty.fvecs").write_bytes(b"")
    assert tio.read_fvecs(tmp_path / "empty.fvecs").shape == jio.read_fvecs(tmp_path / "empty.fvecs").shape == (0, 0)


def test_native_fvecs_and_pwrite_match_numpy(tmp_path):
    rng = np.random.default_rng(1)
    v = rng.normal(size=(1000, 33)).astype(np.float32)
    tio.write_fvecs(tmp_path / "v.fvecs", v)
    ref = tio.read_fvecs_numpy(tmp_path / "v.fvecs")
    assert ref.tobytes() == v.tobytes()
    out = native.read_fvecs_native(str(tmp_path / "v.fvecs"))
    if native.backend() == "native":
        assert out is not None and out.tobytes() == ref.tobytes()
        assert native.read_fvecs_native(str(tmp_path / "v.fvecs"), 7).tobytes() == ref[:7].tobytes()
        path = tmp_path / "rows.bin"
        path.write_bytes(b"\xff" * (16 + 1000 * 33 * 4))
        assert native.pwrite_rows(str(path), 16, v[100:400], 100) and native.pwrite_rows(str(path), 16, v[:100], 0)
        got = np.frombuffer(path.read_bytes()[16:], np.float32).reshape(1000, 33)
        assert got[:400].tobytes() == v[:400].tobytes() and (got[400:].view(np.uint32) == 0xFFFFFFFF).all()
    else:
        assert out is None and not native.pwrite_rows(str(tmp_path / "x"), 0, v, 0)


def _truncated(kind: str) -> bytes:
    if kind == "bvecs":
        return _bvecs_bytes(np.ones((3, 8), np.uint8))[:-3]
    rows = np.concatenate([np.full((3, 1), 8, np.int32), np.ones((3, 8), np.int32)], axis=1)
    return rows.tobytes()[:-4]


MALFORMED = {
    "fvecs_truncated": ("fvecs", lambda: _truncated("fvecs")),
    "fvecs_negative_dim": ("fvecs", lambda: np.array([-3, 1, 2, 3], np.int32).tobytes()),
    "fvecs_mixed_dims": ("fvecs", lambda: np.array([2, 1, 1, 1, 5, 5], np.int32).tobytes()),
    "ivecs_truncated": ("ivecs", lambda: _truncated("ivecs")),
    "ivecs_zero_dim": ("ivecs", lambda: np.array([0, 0], np.int32).tobytes()),
    "ivecs_mixed_dims": ("ivecs", lambda: np.array([2, 1, 1, 1, 5, 5], np.int32).tobytes()),
    "bvecs_truncated": ("bvecs", lambda: _truncated("bvecs")),
    "bvecs_short_header": ("bvecs", lambda: b"\x08\x00"),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_files_raise(tmp_path, case):
    kind, make = MALFORMED[case]
    path = tmp_path / f"bad.{kind}"
    path.write_bytes(make())
    readers = {"fvecs": [tio.read_fvecs, tio.read_fvecs_numpy], "ivecs": [tio.read_ivecs],
               "bvecs": [tio.read_bvecs]}[kind]
    for read in readers:
        with pytest.raises(ValueError):
            read(path)


def test_reference_reads_truncated_ivecs_short(tmp_path):
    """The fault the port repairs: the JAX reader drops the partial row."""
    path = tmp_path / "t.ivecs"
    path.write_bytes(_truncated("ivecs"))
    assert jio.read_ivecs(path).shape == (2, 8)


# -- the YAML reader ---------------------------------------------------------

# tests/test_bench_harness.py's and tests/test_catalog.py's YAML strings
HARNESS_SCHEMA = """
yamlSchemaVersion: 1
construction:
  outDegree: [8]
  efConstruction: [24]
  neighborOverflow: [1.2f]
  addHierarchy: [No]
  compression:
    - type: PQ
      mFactor: 4
      k: 32
  reranking: [FP32]
search:
  compression:
    - none
    - type: SQ4
  topKOverquery:
    10: [2.0]
"""
HARNESS_CATALOG = (
    "datasets:\n  tiny-synth:\n    format: synthetic\n    n: 800\n    dim: 16\n    n_queries: 20\n"
    "    k: 10\n    similarity: euclidean\n    seed: 0\n"
)
HARNESS_CONFIG = (
    "yamlSchemaVersion: 1\nconstruction:\n  outDegree: [8]\n  efConstruction: [24]\n  addHierarchy: [No]\n"
    "  compression: [none]\nsearch:\n  topKOverquery:\n    5: [2.0]\n"
)
CATALOG_TEMPLATE = """
datasets:
  toy:
    format: fvecs
    prefix: /data/toy
    similarity: cosine
  tiny-synth:
    format: synthetic
    n: 300
    dim: 16
    n_queries: 8
    k: 5
"""
SCALARS = """
# every scalar form the reader resolves
a: 1   # trailing comment
b:
- x
- y: 2
  z: [1, 2.5, .5, -1.0, 1.0e+5, 1e5, 1_000, +3, 0, -0, yes, Off, ~, null, '', "q", 'it''s', [a, []], 1.2f, none]
c: ${DATA}/a/b
d: http://x/y#frag
10: ten
Yes: t
e:
  - - 1
    - 2
  -
  - k:
      deep: 1
f: "a # b"
g: .inf
h: -.Inf
i: 1.
j:
"""
STRINGS = {"harness_schema": HARNESS_SCHEMA, "harness_catalog": HARNESS_CATALOG, "harness_config": HARNESS_CONFIG,
           "catalog_template": CATALOG_TEMPLATE, "scalars": SCALARS, "document_start": "---\nfoo: bar\n",
           "comments_only": "# nothing\n\n", "safe_dump": yaml.safe_dump(
               {"construction": {"outDegree": [8], "addHierarchy": [False], "compression": ["none"]},
                "search": {"compression": [{"type": "SQ4"}], "topKOverquery": {5: [2.0]}}})}
FILES = sorted(os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "yaml-configs", "**", "*.yml"),
                                                            recursive=True))


def _same(a, b) -> bool:
    """Equal values of equal types (``True == 1`` does not pass)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(x, y) and _same(a[x], b[y]) for x, y in zip(a, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


@pytest.mark.parametrize("name", FILES + sorted(STRINGS))
def test_yaml_reader_equals_safe_load(name):
    if name in STRINGS:
        text = STRINGS[name]
    else:
        with open(os.path.join(ROOT, name)) as f:
            text = f.read()
    got, want = yaml_subset.load(text), yaml.safe_load(text)
    assert _same(got, want), (got, want)
    if name not in STRINGS:
        assert _same(yaml_subset.load_file(os.path.join(ROOT, name)), want)


REFUSED = {
    "anchor_alias": ("a: &x 1\nb: *x\n", 1),
    "block_scalar": ("a: 1\nb: |\n  text\n", 2),
    "folded_scalar": ("a: >\n  text\n", 1),
    "flow_mapping": ("a: {b: 1}\n", 1),
    "second_document": ("a: 1\n---\nb: 2\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "complex_key": ("? a\n: b\n", 1),
    "octal": ("a: 010\n", 1),
    "hex": ("a: 0x1f\n", 1),
    "timestamp": ("a: 2001-12-14\n", 1),
    "multi_line_flow": ("a: [1,\n 2]\n", 1),
    "multi_line_scalar": ("a: b\n  c\n", 2),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "nested_mapping_value": ("a: b: c\n", 1),
    "merge_key": ("<<: 1\n", 1),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_yaml_reader_refuses_what_it_does_not_read(case):
    text, line = REFUSED[case]
    with pytest.raises(ValueError, match=f"<string>:{line}:"):
        yaml_subset.load(text)


# -- catalogs ------------------------------------------------------------------


@pytest.fixture()
def catalog_dir(tmp_path):
    rng = np.random.default_rng(0)
    tio.write_fvecs(tmp_path / "toy_base.fvecs", rng.normal(size=(50, 8)).astype(np.float32))
    tio.write_fvecs(tmp_path / "toy_query.fvecs", rng.normal(size=(5, 8)).astype(np.float32))
    tio.write_ivecs(tmp_path / "toy_groundtruth.ivecs", rng.integers(0, 50, (5, 10)).astype(np.int32))
    (tmp_path / "cat.yaml").write_text(CATALOG_TEMPLATE.replace("/data/toy", f"{tmp_path}/toy"))
    return tmp_path


def test_catalog_select_and_open(catalog_dir):
    c = tcatalog.Catalog.load(catalog_dir / "cat.yaml")
    assert c.names() == ["tiny-synth", "toy"]
    assert c.select("^toy$") == ["toy"]
    assert c.select("synth|toy") == ["tiny-synth", "toy"]
    ds = c.open("toy", device="cpu")
    assert ds.base.shape == (50, 8)
    assert ds.similarity == SimilarityFunction.COSINE
    ds2 = c.open("tiny-synth", device="cpu")
    assert ds2.base.shape == (300, 16)
    assert ds2.ground_truth.shape == (8, 5)
    with pytest.raises(KeyError):
        c.open("nope", device="cpu")


def test_discover_finds_fvecs_triples(catalog_dir):
    found = tcatalog.discover(catalog_dir)
    assert found == jcatalog.discover(catalog_dir) and "toy" in found
    assert tcatalog.Catalog(entries=found).open("toy", device="cpu").queries.shape == (5, 8)


def test_catalog_auto_fetch_file_urls(tmp_path):
    rng = np.random.default_rng(9)
    src = tmp_path / "remote"
    src.mkdir()
    base = rng.normal(size=(60, 8)).astype(np.float32)
    q = rng.normal(size=(6, 8)).astype(np.float32)
    gt = np.argsort(((q[:, None] - base[None]) ** 2).sum(-1), axis=1)[:, :5]
    tio.write_fvecs(src / "ds_base.fvecs", base)
    tio.write_fvecs(src / "ds_query.fvecs", q)
    tio.write_ivecs(src / "ds_groundtruth.ivecs", gt.astype(np.int32))
    local = tmp_path / "cache" / "ds"
    cat = tcatalog.Catalog(entries={"ds": {
        "format": "fvecs", "prefix": str(local), "similarity": "euclidean",
        "urls": {"base": f"file://{src}/ds_base.fvecs", "query": f"file://{src}/ds_query.fvecs",
                 "groundtruth": f"file://{src}/ds_groundtruth.ivecs"}}})
    ds = cat.open("ds")
    assert ds.base.tobytes() == base.tobytes()
    np.testing.assert_array_equal(ds.ground_truth[:, :5], gt)

    def boom(url, tmp):
        raise AssertionError("re-fetched a cached file")

    assert cat.open("ds", fetcher=boom).base.shape == (60, 8)
    assert sorted(os.listdir(local.parent)) == ["ds_base.fvecs", "ds_groundtruth.ivecs", "ds_query.fvecs"]


def test_catalog_fetch_injectable_and_url_rewrite(tmp_path):
    assert tcatalog.resolve_url("s3://my-bucket/dir/f.fvecs") == "https://my-bucket.s3.amazonaws.com/dir/f.fvecs"
    assert tcatalog.resolve_url("gs://b/k.hdf5") == "https://storage.googleapis.com/b/k.hdf5"
    assert tcatalog.resolve_url("http://x/y") == "http://x/y"
    calls = []

    def fake(url, tmp):
        calls.append(url)
        with open(tmp, "wb") as f:
            f.write(b"payload")

    dest = tmp_path / "sub" / "f.bin"
    assert tcatalog.fetch("s3://bkt/f.bin", str(dest), fetcher=fake) == str(dest)
    assert dest.read_bytes() == b"payload" and calls == ["https://bkt.s3.amazonaws.com/f.bin"]
    tcatalog.fetch("s3://bkt/f.bin", str(dest), fetcher=fake)
    assert len(calls) == 1


def test_failed_fetch_leaves_no_file(tmp_path):
    """A raising transport leaves neither the destination nor its temporary
    file; two fetches of one destination write to different temporaries."""
    temps = []

    def bad(url, tmp):
        temps.append(tmp)
        with open(tmp, "wb") as f:
            f.write(b"half")
        raise OSError("network down")

    for _ in range(2):
        with pytest.raises(OSError, match="network down"):
            tcatalog.fetch("s3://bkt/g.bin", str(tmp_path / "g.bin"), fetcher=bad)
    assert os.listdir(tmp_path) == []
    assert len(set(temps)) == 2 and all(os.path.dirname(t) == str(tmp_path) for t in temps)


def _gt_equal(port_gt, jax_gt, base, queries, sim):
    """Equal ids, or equal as sets where the k-th score ties."""
    same = (port_gt == jax_gt).all(axis=1)
    from jvector_tpu_torch.ops.similarity import pairwise_scores

    scores = pairwise_scores(torch.as_tensor(queries), torch.as_tensor(base), sim).numpy()
    for q in np.nonzero(~same)[0]:
        kth = np.sort(scores[q])[::-1][port_gt.shape[1] - 1]
        assert set(port_gt[q]) ^ set(jax_gt[q]) <= set(np.nonzero(scores[q] == kth)[0]), q


@pytest.mark.parametrize("sim", ["euclidean", "dot_product"])
def test_synthetic_entry_matches_the_jax_catalog(sim):
    entries = {"s": {"format": "synthetic", "n": 800, "dim": 16, "n_queries": 40, "k": 10, "similarity": sim,
                     "seed": 5}}
    t = tcatalog.Catalog(entries=entries).open("s", device="cpu")
    j = jcatalog.Catalog(entries=entries).open("s")
    assert t.name == j.name == "s" and t.similarity.value == j.similarity.value == sim
    assert t.base.tobytes() == j.base.tobytes() and t.queries.tobytes() == j.queries.tobytes()
    _gt_equal(t.ground_truth, np.asarray(j.ground_truth), t.base, t.queries, sim)


def test_load_hdf5_matches_the_jax_loader(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "ann.hdf5"
    with h5py.File(path, "w") as f:
        f["train"] = rng.normal(size=(40, 12)).astype(np.float32)
        f["test"] = rng.normal(size=(4, 12)).astype(np.float32)
        f["neighbors"] = rng.integers(0, 40, (4, 10)).astype(np.int32)
        f.attrs["distance"] = "angular"
    t, j = tdatasets.load_hdf5(path), jdatasets.load_hdf5(path)
    assert t.name == j.name == "ann" and t.similarity.value == j.similarity.value == "cosine"
    for a in ("base", "queries", "ground_truth"):
        assert getattr(t, a).tobytes() == np.asarray(getattr(j, a)).tobytes() and getattr(t, a).dtype == \
            np.asarray(getattr(j, a)).dtype
    assert tdatasets.load_dataset(str(path)).base.tobytes() == t.base.tobytes()
    cat = tcatalog.Catalog(entries={"ann": {"format": "hdf5", "path": str(path), "similarity": "cosine"}})
    assert cat.open("ann").queries.tobytes() == t.queries.tobytes()
    assert tdatasets.load_dataset(str(tmp_path / "missing")) is None
    assert tdatasets.load_siftsmall(str(tmp_path)) is None
