"""The beam loop's readers of the port's own spans and counters
(``layer_metrics/beam_steps_per_wave.py``, ``step_issue_us.py``,
``stop_wait_pct.py``, ``lane_use_pct.py``): known spans and counters in a
hand-made record give known values, read from the record each reader
names (counts from the traced window, host times from the last
unprofiled request), and a record with no ``search`` span, or a program
without ``jvector_tpu_torch.tracing`` or the record, gives None."""

import os
import sys

import pytest

from benchmark import harness
from jvector_tpu_torch import tracing
from jvector_tpu_torch.tracing import Span, Window

QUANTITIES = ["beam_steps_per_wave", "step_issue_us", "stop_wait_pct", "lane_use_pct"]
US = 1_000


def _reader(quantity):
    return harness.load_module(harness.reader_path(harness.BENCH_DIR, f"{quantity}.bq"), quantity)


def _window():
    """Two search calls of 10 ms each (waves 0 and 10); the first takes
    three steps of 1, 2 and 3 ms and one stop read of 2 ms, the second one
    step of 2 ms and two stop reads of 1 ms; a build's step outside any
    search (wave 20) is left out."""
    spans = [
        Span("beam.stop_test", 0, 2_000 * US, 1, 0, 0),
        Span("beam.step", 2_000 * US, 3_000 * US, 2, 0, 0),
        Span("beam.step", 3_000 * US, 5_000 * US, 3, 0, 0),
        Span("beam.step", 5_000 * US, 8_000 * US, 4, 0, 0),
        Span("search", 0, 10_000 * US, 0, None, 0),
        Span("beam.stop_test", 20_000 * US, 21_000 * US, 11, 10, 10),
        Span("beam.step", 21_000 * US, 23_000 * US, 12, 10, 10),
        Span("beam.stop_test", 23_000 * US, 24_000 * US, 13, 10, 10),
        Span("search", 20_000 * US, 30_000 * US, 10, None, 10),
        Span("beam.step", 40_000 * US, 49_000 * US, 20, None, 20),
    ]
    return Window(spans=spans, counters={"beam.lane_slots": 40_000, "beam.pops": 30_000})


EMPTY = Window(spans=[], counters={})
RECORD = {  # the record each quantity reads
    "beam_steps_per_wave": "last_window",
    "step_issue_us": "last_request",
    "stop_wait_pct": "last_request",
    "lane_use_pct": "last_window",
}


@pytest.mark.parametrize("quantity, value", [
    ("beam_steps_per_wave", 2.0),  # 4 steps over 2 search calls
    ("step_issue_us", 2_000.0),  # (1 + 2 + 3 + 2) ms over 4 steps
    ("stop_wait_pct", 20.0),  # (2 + 1 + 1) ms of 20 ms
    ("lane_use_pct", 75.0),
])
def test_reader_reads_a_known_window(quantity, value, monkeypatch):
    for record in ("last_window", "last_request"):
        monkeypatch.setattr(tracing, record, _window if record == RECORD[quantity] else lambda: EMPTY)
    assert _reader(quantity).read(None) == pytest.approx(value)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_reader_finds_nothing_in_a_window_without_search(quantity, monkeypatch):
    monkeypatch.setattr(tracing, RECORD[quantity], lambda: EMPTY)
    assert _reader(quantity).read(None) is None
    build_only = Window(spans=[s for s in _window().spans if s.wave == 20], counters={"beam.lane_slots": 8})
    monkeypatch.setattr(tracing, RECORD[quantity], lambda: build_only)
    assert _reader(quantity).read(None) is None


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_reader_finds_nothing_in_a_program_without_its_record(quantity, monkeypatch):
    monkeypatch.setattr(tracing, "last_window" if RECORD[quantity] == "last_request" else "last_request", _window)
    monkeypatch.delattr(tracing, RECORD[quantity])
    assert _reader(quantity).read(None) is None


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_reader_finds_nothing_in_a_program_without_tracing(quantity, monkeypatch):
    import jvector_tpu_torch

    monkeypatch.delattr(jvector_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "jvector_tpu_torch.tracing", None)  # its import fails
    assert _reader(quantity).read(None) is None


def test_every_quantity_has_its_reader_and_both_cells():
    import json

    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    for q in QUANTITIES:
        entries = {m["name"]: m for m in bench["per_layer"] if m["name"].split(".")[0] == q}
        assert {n: (m["workloads"], m["moves"], m["layer"]) for n, m in entries.items()} == {
            f"{q}.bq": (["angular-bq-batch"], "qps.bq", "beam loop"),
            f"{q}.sq4": (["euclidean-sq4-batch"], "qps.sq4", "beam loop"),
        }
        assert os.path.isfile(os.path.join(harness.BENCH_DIR, "layer_metrics", f"{q}.py"))
