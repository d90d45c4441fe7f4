"""The share of the beam loop's issued pop slots that popped a node:
100 x ``beam.pops`` over ``beam.lane_slots`` (the port's own counters,
each step adding its queries x expand width and its pops) in the traced
window."""

from benchmark.program_spans import searches


def read(rec):
    s = searches()
    slots = s.counters.get("beam.lane_slots") if s is not None else None
    return 100.0 * s.counters.get("beam.pops", 0) / slots if slots else None
