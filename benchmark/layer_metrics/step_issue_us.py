"""Host microseconds to issue one beam step: the mean ``beam.step`` span
of the last search that ran with no profiler (the port's own spans; a
step reads nothing from the device, so this is the host's time, not the
device's, and no profiler's)."""

from benchmark.program_spans import unprofiled_search


def read(rec):
    s = unprofiled_search()
    steps = s.seconds.get("beam.step") if s is not None else None
    return 1e6 * sum(steps) / len(steps) if steps else None
