"""The port's in-program spans and counters (``jvector_tpu_torch/tracing.py``)
around the beam loop, on the CPU.

One graph of 1,024 nodes (d = 32) is built once; a BQ search (beam 40, no
repack) and an SQ4 search with a repacked tail (beam 24, repack after 6)
run over 128 queries with the profiler off and on.  Off, no
``record_function`` is opened and the last window stays as it was, while
the last request holds the search's host stamps: one ``search`` span, one
``beam.step`` per ``_step`` call and one ``beam.stop_test`` per read of
the stop test, each under the ``search``.  On, the window holds the same
spans, with each call's wave id, and the last request stays as it was;
the profiler's ``jv:`` ranges lie inside the spans' stamps (one clock);
the counters add up to the steps' widths and to ``expanded_count``; and
the results are the same bits either way.
"""

import statistics

import pytest
import torch

import jvector_tpu_torch.graph.searcher as searcher
from jvector_tpu_torch import BinaryQuantization, GraphConfig, ScalarQuantization4, build_graph, tracing
from jvector_tpu_torch.graph.searcher import search

N, DIM, Q = 1024, 32, 128
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tests run several workers per machine: one torch thread each keeps
    them from oversubscribing the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def index():
    g = torch.Generator().manual_seed(18)
    centers = torch.randn(16, DIM, generator=g) * 4
    pick = torch.randint(0, 16, (N + Q,), generator=g)
    data = centers[pick] + torch.randn(N + Q, DIM, generator=g)
    base, queries = data[:N].contiguous(), data[N:].contiguous()
    graph, exact = build_graph(base, "euclidean", GraphConfig(max_degree=16, ef_construction=32, wave_size=256),
                               device="cpu")
    bq = BinaryQuantization.compute(base)
    bq_first = bq.provider(bq.encode(base))
    sq = ScalarQuantization4.compute(base)
    codes = torch.nn.functional.pad(sq.encode(base), (0, 0, 0, graph.capacity - N))
    sq_first = sq.provider_for_graph(codes, graph.base.neighbors, "euclidean")
    searches = {
        "bq": lambda: search(graph, bq_first, queries, top_k=10, beam_width=40, rerank_k=40, reranker=exact),
        "sq4": lambda: search(graph, sq_first, queries, top_k=10, beam_width=24, rerank_k=24, reranker=exact,
                              repack_after=6),
    }
    return searches


def _profiled(fn):
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, prof


class _Counting:
    """Wraps a function of the searcher and counts its calls."""

    def __init__(self, monkeypatch, name):
        self.fn, self.calls = getattr(searcher, name), 0
        monkeypatch.setattr(searcher, name, self)

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_off_opens_no_range_and_keeps_the_window(index, kind, monkeypatch):
    _profiled(index[kind])
    before = tracing.last_window()
    assert before.spans
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: opened.append(a) or real(*a, **k))
    index[kind]()
    assert opened == []
    assert tracing.last_window() == before


def _check_searches(spans, steps, stop_reads):
    """One ``search`` root per call; ``steps`` steps and ``stop_reads``
    stop reads, each directly under its call and inside its stamps."""
    root = {s.id: s for s in spans if s.name == "search"}
    assert all(s.parent is None and s.wave == s.id for s in root.values())
    by_name = {n: [s for s in spans if s.name == n] for n in ("beam.step", "beam.stop_test")}
    assert len(by_name["beam.step"]) == steps
    assert len(by_name["beam.stop_test"]) == stop_reads
    for s in by_name["beam.step"] + by_name["beam.stop_test"]:
        assert s.parent == s.wave and s.wave in root
        assert root[s.wave].start_ns <= s.start_ns <= s.end_ns <= root[s.wave].end_ns
    assert {s.wave for s in by_name["beam.step"]} == set(root)
    return root


@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_off_stamps_the_last_request(index, kind, monkeypatch):
    steps = _Counting(monkeypatch, "_step")
    lives = _Counting(monkeypatch, "_live")
    tails = _Counting(monkeypatch, "_repack_tail")
    index[kind]()
    assert (tails.calls > 0) == (kind == "sq4")
    req = tracing.last_request()
    assert req.counters == {}
    # _repack_tail reads _live once to pick its lanes, outside the stop test
    first = _check_searches(req.spans, steps.calls, lives.calls - tails.calls)
    assert len(first) == 1
    _profiled(index[kind])
    assert tracing.last_request() == req  # a profiled search keeps the unprofiled one
    steps.calls = lives.calls = tails.calls = 0
    index[kind]()
    again = _check_searches(tracing.last_request().spans, steps.calls, lives.calls - tails.calls)
    assert len(again) == 1 and set(again).isdisjoint(first)


@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_on_records_each_search_step_and_stop_read(index, kind, monkeypatch):
    steps = _Counting(monkeypatch, "_step")
    lives = _Counting(monkeypatch, "_live")
    tails = _Counting(monkeypatch, "_repack_tail")
    index[kind]()  # unprofiled: the next profiled search starts a window
    steps.calls = lives.calls = tails.calls = 0
    with torch.profiler.profile(activities=CPU):
        index[kind]()
        index[kind]()
    assert (tails.calls > 0) == (kind == "sq4")
    w = tracing.last_window()
    # _repack_tail reads _live once to pick its lanes, outside the stop test
    assert len(_check_searches(w.spans, steps.calls, lives.calls - tails.calls)) == 2


@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_profiler_ranges_lie_inside_the_spans(index, kind):
    index[kind]()
    _, prof = _profiled(index[kind])
    spans = tracing.last_window().spans
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("jv:")]
    gaps = []
    for name in ("search", "beam.step", "beam.stop_test"):
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.start_ns)
        theirs = sorted((e for e in events if e.name() == f"jv:{name}"), key=lambda e: e.start_ns())
        assert len(mine) == len(theirs) > 0
        for s, e in zip(mine, theirs):
            start = e.start_ns()
            end = e.end_ns() if hasattr(e, "end_ns") else start + e.duration_ns()
            assert s.start_ns <= start <= end <= s.end_ns, name
            gaps += [start - s.start_ns, s.end_ns - end]
    assert statistics.median(gaps) < 50_000


@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_counters_add_up(index, kind, monkeypatch):
    widths = []
    step = searcher._step

    def counted(s, *a, **k):
        widths.append(s.ids.shape[0])
        return step(s, *a, **k)

    monkeypatch.setattr(searcher, "_step", counted)
    index[kind]()
    widths.clear()
    res, _ = _profiled(index[kind])
    c = tracing.last_window().counters
    assert c["beam.lane_slots"] == sum(widths)  # E = 1
    assert (kind == "sq4") == (min(widths) < Q)  # the tail's own width
    assert c["beam.pops"] == int(res.expanded_count.sum())
    # running totals, one a device: a long profiled stretch holds no more
    totals = [v for t in tracing._rec.counters.values() for v in t.values()]
    assert len(totals) == 2 and all(not isinstance(v, torch.Tensor) or v.dim() == 0 for v in totals)


def test_windows_follow_the_profiler(index):
    index["sq4"]()
    _profiled(index["bq"])
    first = tracing.last_window()
    assert sum(s.name == "search" for s in first.spans) == 1
    index["sq4"]()  # unprofiled: the window it leaves stays readable
    assert tracing.last_window() == first
    _profiled(index["bq"])
    _profiled(index["bq"])  # no unprofiled search between: one window
    second = tracing.last_window()
    assert sum(s.name == "search" for s in second.spans) == 2
    assert {s.id for s in second.spans}.isdisjoint(s.id for s in first.spans)
    assert second.counters["beam.pops"] == 2 * first.counters["beam.pops"]


@pytest.mark.parametrize("kind", ["bq", "sq4"])
def test_results_bit_equal_on_and_off(index, kind):
    off = index[kind]()
    on, _ = _profiled(index[kind])
    for name in off._fields:
        a, b = getattr(off, name), getattr(on, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
