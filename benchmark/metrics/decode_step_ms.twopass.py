"""One decode step on the device, in ms: the median over the traced slice's
``decode_step`` spans of each span's device extent, from the start of the
first device operation launched inside it to the end of the last
(``program_trace.py``). Nothing where the slice holds no such span."""

from benchmark import program_trace

LAYER = "decode loop"
MOVES = "samples_per_s"


def read(r):
    t = program_trace.for_reading(r)
    return t.median_ms("decode_step") if t else None
