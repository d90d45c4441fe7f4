"""Spans and counters inside the port: host stamps of every request, and a
window of spans and counters while a PyTorch profiler collects.

Every span site stamps its start and end on ``time.time_ns()`` (the
profiler's clock) and knows its parent span and the request it belongs to
(the outermost span, e.g. one ``search()`` call).  What else it does
depends on whether a profiler is collecting, read once at the site:

- with no profiler, the stamps are all: the spans of the most recent
  request to finish without a profiler are kept, and that request alone
  (``last_request()``), so memory stays bounded and the request's host
  times are those of a process that nobody profiles.  A counter records
  nothing.  No ``record_function`` is opened;
- under a profiler (``torch.profiler``, or
  ``jvector_tpu_torch.bench.diagnostics.profile_trace()``), each span also
  opens a ``record_function`` range named ``jv:<name>``, which sits in the
  profiler's own timeline beside the device's kernels (the trace that
  ``profile_trace`` writes, or ``prof.profiler.kineto_results.events()``),
  and goes into the window (``last_window()``) with the counters' totals.
  The profiler slows the host, so spans in a window time the host as
  profiled; ``last_request()`` times it as served.

A window is the most recent stretch of time in which a profiler was
collecting: the first span or counter recorded after a span site or a
counter found the profiler off starts a new window, which replaces the old
one.  So a profiled search that follows an unprofiled one starts afresh,
while two profiled blocks with no span site reached between them (no
search in between) form one window.

No span synchronises the device.  A counter keeps a running total, which
may be a device scalar; it is read as a number only when ``last_window()``
is read.  Nothing here writes a file or reads the environment.

The spans and counters of the beam loop (``graph/searcher.py``):

- ``search``: one per ``search()`` call, the root span of a request;
- ``beam.step``: each step of ``search_layer`` (a repacked tail's too);
- ``beam.stop_test``: the host's read of the stop test, where it waits
  for the device;
- ``beam.lane_slots``: the pop slots (queries x expand width) of each
  ``search_layer`` call's steps;
- ``beam.pops``: the pops of those steps (the slots that popped a node),
  from the growth of the beam's ``expanded_count``;
- ``beam.frontier_kernel``: the steps of those calls whose frontier filter
  went through the K8 kernel (``ops/kernels/frontier.py``: one launch a
  step on the card, none on the CPU, where its plain twin runs), from the
  growth of the wrapper's launch count (a host int).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    name: str
    start_ns: int  # time.time_ns(), stamped before the profiler's range opens
    end_ns: int  # stamped after it closes
    id: int
    parent: int | None  # the enclosing span's id
    wave: int  # the root span's id: shared by every span of one request


class Window(NamedTuple):
    spans: list  # Span, in the order they closed
    counters: dict  # name -> total (a number)


_ids = itertools.count()
_local = threading.local()  # .stack: this thread's open spans; .request: the spans of its open unprofiled request


class _Recorder:
    """The current window; ``fresh`` once a site found the profiler off.
    ``request`` is the last unprofiled request's spans."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, dict] = {}  # name -> device (None: host) -> running total
        self.fresh = True
        self.request: list[tuple] = []  # Span's fields

    def window(self) -> _Recorder:
        if self.fresh:
            self.spans, self.counters, self.fresh = [], {}, False
        return self


_rec = _Recorder()


class _Span:
    __slots__ = ("name", "id", "parent", "wave", "start", "range")

    def __init__(self, name: str, range_):
        self.name, self.range = name, range_

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
            _local.request = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.wave = up.wave if up is not None else self.id
        stack.append(self)
        self.start = time.time_ns()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        stack = _local.stack
        stack.pop()
        if self.range is not None:
            _rec.spans.append(Span(self.name, self.start, end, self.id, self.parent, self.wave))
            if not stack:  # a profiled request leaves no unprofiled one to keep
                _local.request = []
        else:
            _local.request.append((self.name, self.start, end, self.id, self.parent, self.wave))
            if not stack:
                _rec.request, _local.request = _local.request, []
        return False


def span(name: str):
    """A context that stamps span ``name``, and also records it in the
    window and the profiler's timeline while a profiler collects."""
    if not _profiler._is_profiler_enabled:
        _rec.fresh = True
        return _Span(name, None)
    _rec.window()
    return _Span(name, torch.profiler.record_function(f"jv:{name}"))


def add(name: str, n) -> None:
    """Add ``n`` to counter ``name`` while a profiler collects: an int, a
    tensor (its sum, taken on its device), or a function that returns one,
    called only then."""
    if not _profiler._is_profiler_enabled:
        _rec.fresh = True
        return
    if callable(n):
        n = n()
    totals = _rec.window().counters.setdefault(name, {})  # one running total a device
    dev = n.device if isinstance(n, torch.Tensor) else None
    totals[dev] = totals.get(dev, 0) + (n if dev is None else n.sum())


def _number(v) -> int | float:
    return v.item() if isinstance(v, torch.Tensor) else v


def last_window() -> Window:
    """The spans and counter totals of the most recent window (empty before
    any profiler collected a span or a counter)."""
    return Window(spans=list(_rec.spans),
                  counters={k: sum(_number(v) for v in t.values()) for k, t in _rec.counters.items()})


def last_request() -> Window:
    """The spans of the most recent request (outermost span) that ran with
    no profiler collecting, and no counters (empty before one finished)."""
    return Window(spans=[Span._make(t) for t in _rec.request], counters={})
