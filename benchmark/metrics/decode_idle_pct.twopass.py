"""The device's idle share of the decode loop, in %: over the union of the
device extents of the traced slice's ``decode_step`` spans, the share in
which no kernel, copy or set ran (the union of their intervals, as
``device_idle_pct``). Nothing where the slice holds no such span."""

from benchmark import program_trace

LAYER = "decode loop"
MOVES = "samples_per_s"


def read(r):
    t = program_trace.for_reading(r)
    return t.idle_pct("decode_step") if t else None
