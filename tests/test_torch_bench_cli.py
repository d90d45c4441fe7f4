"""The port's bench CLI (``python -m jvector_tpu_torch.bench``), its report
names, memory accounting and public names, against the JAX package's.

``tests/test_bench_harness.py``'s CLI test runs against the port with
``--device cpu``; on one tiny catalog and two YAML configs (that test's and
an SQ4 build + serve like ``yaml-configs/sq4.yml``'s) the port's rows carry the JAX CLI's keys
(``torch_version`` where it writes ``jax_version``), as many rows, and
recall within 0.03.  Two runs inside one second keep two report pairs.
``bytes_used`` / ``graph_ram_report`` of a JAX-built graph carried across
by ``convert.py``, with its exact and SQ4 providers, equal the JAX
figures (every port structure here holds the JAX pytree's leaves, shape for
shape).  Importing the harness modules loads no JAX and no PyYAML, and
the port's catalog and YAML reader run with PyYAML blocked.  Every module of
the JAX package has a counterpart and every name of a JAX ``__all__`` is in
the port's; the four similarity helpers this adds to ``ops`` give the JAX
package's values.
"""

import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.bench.__main__ import main as jmain
from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.quantization import ScalarQuantization4 as JSQ4
from jvector_tpu.util import accounting as jacct
from jvector_tpu_torch import convert
from jvector_tpu_torch.bench import grid as tgrid
from jvector_tpu_torch.bench.__main__ import main as tmain
from jvector_tpu_torch.graph import ExactScoreProvider
from jvector_tpu_torch.util import accounting as tacct
from jvector_tpu_torch.util.datasets import synthetic_dataset
from test_torch_io_catalog import HARNESS_CATALOG as CATALOG  # tests/test_bench_harness.py's
from test_torch_io_catalog import HARNESS_CONFIG as CONFIG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def inputs(tmp_path):
    (tmp_path / "cat.yml").write_text(CATALOG)
    (tmp_path / "cfg.yml").write_text(CONFIG)
    return tmp_path


def _reports(out) -> dict[str, list[dict]]:
    rows = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(".jsonl"):
            with open(os.path.join(out, name)) as f:
                rows[name] = [json.loads(line) for line in f]
    return rows


def test_bench_cli_main(inputs):
    out = inputs / "reports"
    rc = tmain(["tiny.*", "--config", str(inputs / "cfg.yml"), "--catalog", str(inputs / "cat.yml"),
                "--output", str(out), "--device", "cpu"])
    assert rc == 0
    files = os.listdir(out)
    assert any(f.endswith(".csv") for f in files) and any(f.endswith(".jsonl") for f in files)
    assert tmain(["nomatch.*", "--catalog", str(inputs / "cat.yml"), "--device", "cpu"]) == 2


# sq4.yml's construction and serve (SQ4 build, SQ4 first pass, FP32 rerank)
# at the tiny config's degree, so both packages build in seconds
CONFIG_SQ4 = (
    "yamlSchemaVersion: 1\nconstruction:\n  outDegree: [8]\n  efConstruction: [24]\n  neighborOverflow: [1.2f]\n"
    "  addHierarchy: [No]\n  compression:\n    - type: SQ4\n  reranking: [FP32]\nsearch:\n  topKOverquery:\n"
    "    5: [2.0, 4.0]\n"
)


def test_rows_match_the_jax_cli(inputs):
    (inputs / "sq4.yml").write_text(CONFIG_SQ4)
    args = ["tiny-synth", "--config", str(inputs / "cfg.yml"), "--config", str(inputs / "sq4.yml"),
            "--catalog", str(inputs / "cat.yml")]
    assert jmain(args + ["--output", str(inputs / "jax")]) == 0
    assert tmain(args + ["--output", str(inputs / "torch"), "--device", "cpu"]) == 0
    jrep, trep = _reports(inputs / "jax"), _reports(inputs / "torch")
    assert len(jrep) == len(trep) == 2  # one pair per dataset x config
    jrows = sorted((r for rows in jrep.values() for r in rows), key=lambda r: (r["compression"], r["overquery"]))
    trows = sorted((r for rows in trep.values() for r in rows), key=lambda r: (r["compression"], r["overquery"]))
    assert len(trows) == len(jrows) == 3  # cfg.yml: one row; sq4.yml: overquery 2 and 4
    for t, j in zip(trows, jrows):
        assert set(t) - {"torch_version"} == set(j) - {"jax_version"} and "torch_version" in t
        for key in ("dataset", "outDegree", "efConstruction", "addHierarchy", "buildCompression", "compression",
                    "reranking", "topK", "overquery"):
            assert t[key] == j[key], key
        assert abs(t["recall"] - j["recall"]) <= 0.03, (t["overquery"], t["recall"], j["recall"])
        assert t["device"] == "cpu"


def test_two_runs_in_one_second_keep_two_report_pairs(inputs, monkeypatch):
    monkeypatch.setattr(tgrid.time, "strftime", lambda fmt, *a: "20260101T000000")
    ds = synthetic_dataset(name="tiny", n=300, dim=16, n_queries=20, k=5, seed=2, device="cpu")
    out = inputs / "out"
    for _ in range(2):
        assert len(tgrid.run_yaml(str(inputs / "cfg.yml"), ds, out_dir=str(out), device="cpu")) == 1
    assert sorted(os.listdir(out)) == ["experiments-20260101T000000-1.csv", "experiments-20260101T000000-1.jsonl",
                                       "experiments-20260101T000000.csv", "experiments-20260101T000000.jsonl"]
    assert all(len(rows) == 1 for rows in _reports(out).values())


def test_accounting_matches_the_jax_package():
    ds = synthetic_dataset(n=700, dim=16, n_queries=4, k=5, seed=1, device="cpu")
    jg, jp = jbuild(ds.base, "euclidean", JConfig(max_degree=8, ef_construction=24, add_hierarchy=True))
    assert jg.num_levels > 1
    upper = [(np.asarray(l.neighbors), np.asarray(l.scores), np.asarray(l.counts)) for l in jg.layers[1:]]
    tg = convert.graph_from_numpy(
        np.asarray(jg.base.neighbors), np.asarray(jg.base.scores), np.asarray(jg.base.counts), int(jg.entry_node),
        int(jg.num_nodes), np.asarray(jg.deleted), device="cpu", upper_layers=upper,
        level_node_ids=[np.asarray(i) for i in jg.level_node_ids])
    tp = ExactScoreProvider(vectors=torch.as_tensor(np.array(jp.vectors)), sim="euclidean")
    jsq = JSQ4.compute(ds.base)
    codes = np.zeros((jg.capacity, 8), np.uint8)
    codes[:700] = np.asarray(jsq.encode(ds.base))
    jsq4 = jsq.provider_for_graph(jnp.asarray(codes), jg.base.neighbors, "euclidean")
    tsq = convert.sq4_from_numpy(np.asarray(jsq.scale), np.asarray(jsq.offset), jsq.original_dim, device="cpu")
    tsq4 = tsq.provider_for_graph(torch.as_tensor(codes), tg.base.neighbors, "euclidean")
    assert tacct.bytes_used(tg) == jacct.bytes_used(jg)
    assert tacct.bytes_used(tsq4) == jacct.bytes_used(jsq4) and tacct.bytes_used(tsq) == jacct.bytes_used(jsq)
    assert tacct.graph_ram_report(tg, {"exact": tp, "sq4": tsq4}) == jacct.graph_ram_report(
        jg, {"exact": jp, "sq4": jsq4})
    assert tacct.bytes_used({"a": [np.zeros(3, np.float64)], "b": (torch.zeros(2, 5, dtype=torch.int16), "x")}) \
        == 3 * 8 + 2 * 5 * 2
    for n in (0, 1023, 1024, 5 << 20, 3 << 40, 7 << 50):
        assert tacct.format_bytes(n) == jacct.format_bytes(n)


HARNESS_MODULES = ("jvector_tpu_torch.bench.ipc", "jvector_tpu_torch.bench.__main__", "jvector_tpu_torch.util.catalog",
                   "jvector_tpu_torch.util.io", "jvector_tpu_torch.util.accounting")


def test_harness_imports_no_jax_and_reads_yaml_without_pyyaml():
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"  # any import of PyYAML now raises
        f"for m in {HARNESS_MODULES!r}:\n"
        "    __import__(m)\n"
        "from jvector_tpu_torch.util.catalog import Catalog\n"
        "from jvector_tpu_torch.util import yaml_subset\n"
        "cat = Catalog.load('yaml-configs/dataset-catalogs/local.yml')\n"
        "assert 'synth-100k' in cat.names(), cat.names()\n"
        "assert yaml_subset.load_file('yaml-configs/sq4.yml')['search']['topKOverquery'] == {10: [2.0, 4.0, 6.0]}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'jvector_tpu')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _modules(pkg_dir: str) -> set[str]:
    found = set()
    for root, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith(".py"):
                found.add(os.path.relpath(os.path.join(root, f), pkg_dir))
    return found


def _counterpart(rel: str) -> str:
    """The port's module for a JAX module: the Pallas kernels
    (``ops/pallas/<name>[_kernel].py``) are the CUDA kernels' wrappers
    (``ops/kernels/<name>.py``); everything else keeps its path."""
    if rel.startswith(os.path.join("ops", "pallas")):
        return os.path.join("ops", "kernels", os.path.basename(rel).replace("_kernel.py", ".py"))
    return rel


def test_every_jax_module_and_public_name_has_a_counterpart():
    jroot, troot = os.path.join(ROOT, "jvector_tpu"), os.path.join(ROOT, "jvector_tpu_torch")
    tmods = _modules(troot)
    assert {rel for rel in _modules(jroot) if _counterpart(rel) not in tmods} == set()
    for rel in sorted(_modules(jroot)):
        if not rel.endswith("__init__.py") or rel.startswith(os.path.join("ops", "pallas")):
            continue
        pkg = os.path.dirname(rel).replace(os.sep, ".")
        jmod = importlib.import_module("jvector_tpu" + ("." + pkg if pkg else ""))
        tmod = importlib.import_module("jvector_tpu_torch" + ("." + pkg if pkg else ""))
        missing = [n for n in getattr(jmod, "__all__", []) if n not in getattr(tmod, "__all__", [])
                   or not hasattr(tmod, n)]
        assert missing == [], (pkg, missing)


def test_public_similarity_helpers_match_the_jax_ops():
    from jvector_tpu import ops as jops
    from jvector_tpu_torch import ops as tops

    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(5, 3, 24)).astype(np.float32), rng.normal(size=(3, 24)).astype(np.float32)
    a[0, 0] = 0.0  # a zero vector: cosine and l2_normalize take their floor
    for name in ("dot_product", "squared_l2", "cosine"):
        got = getattr(tops, name)(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(jops, name)(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for axis in (-1, 1):
        np.testing.assert_allclose(tops.l2_normalize(torch.as_tensor(a), axis=axis).numpy(),
                                   np.asarray(jops.l2_normalize(jnp.asarray(a), axis=axis)), rtol=1e-6, atol=1e-7)
