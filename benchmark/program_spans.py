"""The port's own spans and counters (``jvector_tpu_torch.tracing``), for
the beam loop's per-layer readers.

Two records of the port: ``last_window()``, the spans and counters of the
last traced window (the benchmark's traced waves run under
``torch.profiler``), and ``last_request()``, the host stamps of the last
search that ran with no profiler (in a traced run, the window's last wave,
after the profiled ones).  Counts (steps, pops, slots) read the traced
window; host times read the unprofiled request, since the profiler slows
the host it times.  A program without ``jvector_tpu_torch.tracing`` or
without the record, or a record with no ``search`` span (the control,
which runs no search), gives None.
"""

from __future__ import annotations

import collections
import dataclasses


@dataclasses.dataclass
class Searches:
    waves: int  # search spans: one per search() call
    seconds: dict  # span name -> the durations (s) of its spans inside those calls
    counters: dict  # counter name -> total over the record


def _searches(record: str) -> Searches | None:
    try:
        from jvector_tpu_torch import tracing

        w = getattr(tracing, record)()
    except (ImportError, AttributeError):
        return None
    roots = {s.id for s in w.spans if s.name == "search"}
    if not roots:
        return None
    seconds = collections.defaultdict(list)
    for s in w.spans:
        if s.wave in roots:
            seconds[s.name].append((s.end_ns - s.start_ns) / 1e9)
    return Searches(waves=len(roots), seconds=dict(seconds), counters=dict(w.counters))


def searches() -> Searches | None:
    """The traced window's ``search`` calls, the spans under them and the
    window's counters, or None."""
    return _searches("last_window")


def unprofiled_search() -> Searches | None:
    """The last unprofiled ``search`` call and the spans under it, or None."""
    return _searches("last_request")
