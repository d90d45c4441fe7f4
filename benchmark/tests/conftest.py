"""The benchmark's own tests: the repository root on ``sys.path`` (so
``benchmark`` and ``jvector_tpu_torch`` import), the ``cuda`` marker, a
toy copy of the benchmark shared by a test run, and the ``cuda_device``
fixture that decides inside a test whether there is a card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one (run on the GPU host)")
    if os.environ.get("PYTEST_XDIST_WORKER"):
        import torch

        torch.set_num_threads(1)  # one thread a worker: the CPU twins oversubscribe the cores otherwise


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory):
    from benchmark.tests import toy

    return toy.make(str(tmp_path_factory.mktemp("portbench")))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
