"""The port's grid runner (``jvector_tpu_torch.bench.grid``) and its metrics
against the JAX package's.

``GridConfig.from_yaml_dict`` reads the repository's YAML configs field for
field as the JAX package does; the metrics copy gives the same numbers; a
tiny grid (n = 512, d = 32, search waves of 128) with PQ and BQ search
compression and NVQ rerank emits rows with the JAX package's keys (bar
``jax_version`` / ``torch_version``) and recall within 0.02 (BQ + NVQ) or
0.05 (PQ, whose k-means draws differ) of the JAX package's on the same
corpus.  The second run of a grid with a compressor cache trains nothing.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import yaml

from jvector_tpu.bench import metrics as jmetrics
from jvector_tpu.bench.grid import Grid as JGrid
from jvector_tpu.bench.grid import GridConfig as JGridConfig
from jvector_tpu.util.datasets import synthetic_dataset as jsynthetic
from jvector_tpu_torch.bench import metrics as tmetrics
from jvector_tpu_torch.bench.grid import Grid, GridConfig, run_yaml
from jvector_tpu_torch.util.datasets import synthetic_dataset

YAML_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "yaml-configs")
PQ = {"type": "PQ", "mFactor": 4, "k": 64, "centerData": False, "anisotropicThreshold": 0.2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["default", "exact", "sq4"])
def test_grid_config_from_yaml_matches(name):
    with open(os.path.join(YAML_DIR, f"{name}.yml")) as f:
        y = yaml.safe_load(f)
    assert dataclasses.asdict(GridConfig.from_yaml_dict(y)) == dataclasses.asdict(JGridConfig.from_yaml_dict(y))


def test_metrics_match():
    rng = np.random.default_rng(0)
    gt = np.stack([rng.permutation(500)[:20] for _ in range(64)]).astype(np.int32)
    ids = np.where(rng.random((64, 20)) < 0.6, gt, rng.integers(0, 500, (64, 20))).astype(np.int32)
    ids[3, 5] = -1
    for k in (1, 10, 20):
        assert tmetrics.recall_at_k(ids, gt, k) == jmetrics.recall_at_k(ids, gt, k)
        assert tmetrics.mean_average_precision(ids, gt, k) == jmetrics.mean_average_precision(ids, gt, k)
    assert tmetrics.AccuracyMetrics.compute(ids, gt, 10) == tmetrics.AccuracyMetrics(
        **dataclasses.asdict(jmetrics.AccuracyMetrics.compute(ids, gt, 10)))
    secs, sizes = list(rng.random(9) + 0.1), [128] * 9
    assert dataclasses.asdict(tmetrics.LatencyStats.compute(secs, sizes)) == dataclasses.asdict(
        jmetrics.LatencyStats.compute(secs, sizes))


def _config():
    return dict(compression=[None], search_compression=[PQ, {"type": "BQ"}], reranking=["NVQ"],
                top_k_overquery={10: [2.0, 4.0]}, wave_size=128)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    kw = dict(name="tiny", n=512, dim=32, n_queries=256, k=10, sim="dot_product", n_clusters=16, seed=11)
    jrows = JGrid(jsynthetic(**kw), JGridConfig(**_config())).run(verbose=False)
    cache = str(tmp_path_factory.mktemp("cache"))
    ds = synthetic_dataset(**kw, device="cpu")
    trows = Grid(ds, GridConfig(**_config()), compressor_cache_dir=cache, device="cpu").run(verbose=False)
    return ds, cache, jrows, trows


def test_tiny_grid_rows_match_jax(grids):
    _, _, jrows, trows = grids
    assert len(trows) == len(jrows) == 4
    for t, j in zip(trows, jrows):
        assert set(t) - {"torch_version"} == set(j) - {"jax_version"}
        assert t["device"] == "cpu" and "torch_version" in t
        for key in ("dataset", "outDegree", "efConstruction", "buildCompression", "compression", "reranking",
                    "topK", "overquery"):
            assert t[key] == j[key], key
        slack = 0.02 if t["compression"] == "BQ" else 0.05
        assert abs(t["recall"] - j["recall"]) <= slack, (t["compression"], t["overquery"], t["recall"], j["recall"])
        assert t["recall"] > 0.5 and t["qps_avg"] > 0


def test_second_run_loads_from_the_cache(grids, monkeypatch):
    """Every compressor of the second run comes from the cache: no
    ``compute`` runs, and the rows' recall is the first run's."""
    ds, cache, _, trows = grids
    assert len(os.listdir(cache)) == 3  # PQ, BQ, NVQ

    def refuse(*a, **k):
        raise AssertionError("trained instead of loading")

    from jvector_tpu_torch.quantization import BinaryQuantization, NVQuantization, ProductQuantization

    for cls in (BinaryQuantization, NVQuantization, ProductQuantization):
        monkeypatch.setattr(cls, "compute", staticmethod(refuse))
    again = Grid(ds, GridConfig(**_config()), compressor_cache_dir=cache, device="cpu").run(verbose=False)
    assert [r["recall"] for r in again] == [r["recall"] for r in trows]


def test_run_yaml_writes_rows(tmp_path):
    y = {"construction": {"outDegree": [8], "efConstruction": [16], "addHierarchy": [False],
                          "compression": ["none"]},
         "search": {"compression": [{"type": "SQ4"}], "topKOverquery": {5: [2.0]}}}
    path = tmp_path / "g.yml"
    path.write_text(yaml.safe_dump(y))
    ds = synthetic_dataset(name="yaml", n=300, dim=16, n_queries=128, k=5, seed=2, device="cpu")
    rows = run_yaml(str(path), ds, out_dir=str(tmp_path / "out"), device="cpu")
    assert len(rows) == 1 and rows[0]["compression"] == "SQ4" and rows[0]["recall"] > 0.5
    assert sorted(f.rsplit(".", 1)[1] for f in os.listdir(tmp_path / "out")) == ["csv", "jsonl"]
