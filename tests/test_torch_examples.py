"""The port's examples (``examples/torch_*.py``) at a reduced size on the CPU;
the two sharded ones are in ``tests/test_torch_examples_sharded.py`` (every
build costs a few seconds on one CPU thread, so the eight are split in two
files of under a minute each).

Each script's ``main`` runs with 128 or 256 vectors (256 where PQ trains
256 centroids) at the script's own
dimension and ``device="cpu"``, and must return finite figures; the
recalls are held to loose floors that only a broken path misses (the
scripts' figures at their own sizes are recorded from the card in
``PERF.md``).  ``hello_vector_world`` must find vector 42 first.
"""

import importlib.util
import math
import os

import pytest
import torch

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", os.path.join(EXAMPLES, f"torch_{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def finite(x) -> bool:
    if isinstance(x, dict):
        return all(finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(finite(v) for v in x)
    if isinstance(x, (int, float)):
        return math.isfinite(x)
    return True


# (example, reduced-size keyword arguments, {figure: floor})
CASES = [
    ("hello_vector_world", {"n": 128}, {}),
    ("vector_intro", {"n": 128}, {"recall": 0.9}),
    ("disk_intro", {"n": 256}, {"recall": 0.5}),
    ("larger_than_memory", {"n": 256}, {"recall": 0.5}),
    ("nvq_example", {"n": 128}, {"recall": 0.5}),
    ("sq4_serving", {"n": 128}, {"recall_tier1": 0.9, "recall_tier2": 0.9, "recall_tier3": 0.9}),
]


@pytest.mark.parametrize("name,kwargs,floors", CASES, ids=[c[0] for c in CASES])
def test_example_runs_on_the_cpu(name, kwargs, floors, capsys):
    out = load_example(name).main(**kwargs, device="cpu")
    assert isinstance(out, dict) and out and finite(out), out
    assert capsys.readouterr().out.strip(), "the example printed nothing"
    for key, floor in floors.items():
        assert out[key] >= floor, (key, out[key])
    if name == "hello_vector_world":
        assert out["ids"][0] == 42
