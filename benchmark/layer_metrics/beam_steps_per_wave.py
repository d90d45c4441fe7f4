"""Beam steps a search call: ``beam.step`` spans (the repacked tail's
included) over ``search`` spans in the traced window (the port's own
spans, ``jvector_tpu_torch.tracing``)."""

from benchmark.program_spans import searches


def read(rec):
    s = searches()
    return None if s is None else len(s.seconds.get("beam.step", [])) / s.waves
