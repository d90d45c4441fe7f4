"""The port's bench script (``jvector_tpu_torch.bench.headline``) against
the repository's ``bench.py``: the same robustness corpus, the same JSON
keys, and on the mips-96d shape (d = 96, dot product: the fused build's
whole-row fallback on ``[N, 24, 128]`` tables, K4a's twin on the CPU) a
graph whose recall@10 is the JAX package's within 0.01.

``bench.py`` is loaded by path: it imports JAX only inside ``main``.
"""

import ast
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jvector_tpu.graph import GraphConfig as JConfig
from jvector_tpu.graph import build_graph as jbuild
from jvector_tpu.graph import search as jsearch
from jvector_tpu.util.datasets import synthetic_dataset
from jvector_tpu_torch.bench import headline
from jvector_tpu_torch.graph import GraphConfig, search
from jvector_tpu_torch.util.datasets import recall_at_k

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench_under_test", BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n, dim, n_queries, seed", [(5000, 128, 300, 7), (4321, 96, 17, 3)])
def test_clustered_adversarial_equals_bench(bench, n, dim, n_queries, seed):
    want = bench.clustered_adversarial(n, dim, n_queries, seed)
    got = headline.clustered_adversarial(n, dim, n_queries, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_constants_match_bench(bench):
    for name in ("REFERENCE_QPS", "BASELINE_SOURCE", "RECALL_FLOOR", "HEADLINE_MARGIN", "BEAMS", "MIN_TIMED_QUERIES"):
        assert getattr(headline, name) == getattr(bench, name), name


def _bench_json_keys() -> tuple[set, set]:
    """The keys of ``bench.py``'s JSON line and of one corpus row, read from
    its source."""
    tree = ast.parse(open(BENCH).read())
    dicts = [node for node in ast.walk(tree) if isinstance(node, ast.Dict) and node.keys]
    keysets = [{k.value for k in d.keys if isinstance(k, ast.Constant)} for d in dicts]
    top = next(k for k in keysets if "metric" in k)
    row = next(k for k in keysets if "qps_serial" in k and "beam_width" in k and "metric" not in k)
    return top, row


def test_headline_main_emits_bench_keys(monkeypatch, capsys):
    """A tiny run on the CPU (the headline corpus; the robustness rows are
    driven in :func:`test_mips_96d_build_reaches_jax_recall`) prints one
    JSON line with ``bench.py``'s keys."""
    monkeypatch.setattr(headline, "MIN_TIMED_QUERIES", 64)
    monkeypatch.setattr(headline, "SMALL_BATCH_ITERS", {1: 2, 16: 2, 64: 2, 256: 2})
    out = headline.main(["--n", "300", "--dim", "16", "--queries", "64", "--gt-queries", "32", "--wave", "32",
                         "--device", "cpu", "--skip-robustness"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == out
    top, row = _bench_json_keys()
    assert set(out) == top
    assert set(out["corpora"]) == {"synth-sift-1m"}
    r = out["corpora"]["synth-sift-1m"]
    assert set(r) == row
    assert 0.0 <= r["recall"] <= 1.0 and r["beam_width"] in headline.BEAMS
    assert set(out["small_batch_latency"]) == {"Q1", "Q16", "Q64", "Q256"}
    assert all(set(v) == {"p50_ms", "p999_ms"} for v in out["small_batch_latency"].values())
    assert out["device"] == "cpu" and out["mode"] in ("exact_f32", "sq4+f32_rerank")


def test_headline_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        headline.main(["--n", "100"])


def test_mips_96d_build_reaches_jax_recall(monkeypatch):
    """bench.py's mips-96d shape at n = 512 through the bench's own
    ``robustness_row``: both packages build at
    ``GraphConfig(max_degree=32, ef_construction=100)`` with SQ4 build
    scoring, in waves of 256 so the small corpus takes two; the port's
    fused loop rewrites whole ``[N, 24, 128]`` rows through K4a's twin.
    Exact search recall@10 within 0.01 of the JAX package's at beams 10
    and 16, and the row has ``bench.py``'s keys."""
    monkeypatch.setattr(headline, "MIN_TIMED_QUERIES", 64)
    ds = synthetic_dataset(n=512, dim=96, n_queries=64, k=10, sim="dot_product", n_clusters=64, seed=4)
    cfg = dict(max_degree=32, ef_construction=100, wave_size=256)
    jg, jex = jbuild(ds.base, "dot_product", JConfig(**cfg))
    recalls = {}

    def after_build(built):
        tg, tex = built[:2]
        assert tg.row_cap == jg.row_cap == 64 and int(tg.num_nodes) == 512
        for beam in (10, 16):
            a = jsearch(jg, jex, jnp.asarray(ds.queries), top_k=10, beam_width=beam)
            b = search(tg, tex, torch.as_tensor(ds.queries), top_k=10, beam_width=beam)
            recalls[beam] = (recall_at_k(np.asarray(a.ids), ds.ground_truth, 10),
                             recall_at_k(b.ids.numpy(), ds.ground_truth, 10))

    pt, build_s = headline.robustness_row(ds.base, ds.queries, "dot_product", torch.device("cpu"), wave=32,
                                          timed_queries=64, gt_queries=32, config=GraphConfig(**cfg),
                                          after_build=after_build)
    for beam, (ra, rb) in recalls.items():
        assert abs(rb - ra) <= 0.01, (beam, ra, rb)
    assert sorted(recalls) == [10, 16]
    r = headline._corpus_row(pt, build_s)
    assert set(r) == _bench_json_keys()[1]
    assert r["recall"] >= headline.RECALL_FLOOR and r["beam_width"] in headline.BEAMS
