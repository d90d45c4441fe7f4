"""The port's two sharded examples (``examples/torch_sharded_ltm_pipeline.py``,
``examples/torch_sharded_vs_global.py``) at a reduced size on the CPU, on
meshes of CPU devices named: 256 vectors at the scripts' dimension, which
still builds four and eight shards.  The other six examples are in
``tests/test_torch_examples.py``.
"""

import pytest
import torch

from test_torch_examples import finite, load_example


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_sharded_ltm_pipeline_runs_on_the_cpu(capsys):
    out = load_example("sharded_ltm_pipeline").main(n=256, device="cpu")
    assert finite(out) and out["n_shards"] == 4
    assert "merged recall@10 over 4 shards" in capsys.readouterr().out
    assert out["recall"] >= 0.8


def test_sharded_vs_global_runs_on_the_cpu(capsys):
    out = load_example("sharded_vs_global").main(n=256, nq=32, device="cpu")
    assert finite(out)
    assert "devices=8 n=256 d=64" in capsys.readouterr().out
    assert [r["budget"] for r in out["rows"]] == [16, 32, 64, 128]
    assert [r["shard_beam"] for r in out["rows"]] == [10, 10, 10, 16]
    assert all(0.0 <= r["r_global"] <= 1.0 and 0.0 <= r["r_sharded"] <= 1.0 for r in out["rows"])
