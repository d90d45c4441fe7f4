"""The share of a search call's host time spent blocked on the device at
the beam loop's stop test: 100 x the sum of ``beam.stop_test`` spans over
the ``search`` span, in the last search that ran with no profiler (the
port's own spans)."""

from benchmark.program_spans import unprofiled_search


def read(rec):
    s = unprofiled_search()
    if s is None:
        return None
    total = sum(s.seconds["search"])
    return 100.0 * sum(s.seconds.get("beam.stop_test", [])) / total if total > 0 else None
