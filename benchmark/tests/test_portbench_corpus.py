"""The dataset is ann-benchmarks' own: the replay of scikit-learn's
``make_blobs`` and ``train_test_split`` gives the values scikit-learn gave
for ``random-s-100-*`` (recorded here, so no scikit-learn is needed)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import corpus, harness

BENCH = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))


def test_replay_equals_scikit_learn():
    x = corpus.make_blobs(100_000, 100, 1000, 1.0, [-10.0, 10.0], 1)
    train, test = corpus.split(100_000, 10_000, 1)
    assert x[test][0, :3].tolist() == [0.25182217375167326, 3.6551947066062236, -1.1909522482111778]
    assert x[train][-1, -2:].tolist() == [-0.6464665199146824, 6.4583838436344205]
    assert float(x[train].sum()) == pytest.approx(-141215.46310300883, rel=1e-12)
    assert float(x[test].sum()) == pytest.approx(-15833.083075906594, rel=1e-12)
    assert len(np.intersect1d(train, test)) == 0 and len(train) + len(test) == 100_000


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_makes_its_stated_sizes(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.load(open(os.path.join(harness.ROOT, entry["file"])))
    data = corpus.make(cfg, torch.device("cpu"))
    assert data.base.shape == (cfg["n"], cfg["dim"]) and data.queries.shape == (cfg["queries"], cfg["dim"])
    assert data.base.dtype == torch.float32
    if cfg["dataset"]["normalize"]:
        assert torch.allclose(torch.linalg.vector_norm(data.queries, dim=1), torch.ones(cfg["queries"]))
