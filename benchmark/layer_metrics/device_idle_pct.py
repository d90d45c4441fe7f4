"""Device idle share of the traced window (the search waves): 100 x (1 - busy / window),
busy being the union of the device's activity intervals in the profiled
sub-window (NVML's sampled utilization where the profiler recorded no
device activity)."""

from benchmark.trace import busy_seconds


def read(rec):
    s = rec.traces.get("serve")
    busy = busy_seconds(s) if s is not None else None
    return None if busy is None else 100.0 * (1.0 - busy / s.window_s)
