"""One prompt prefill on the device, in ms: the mean over the traced
slice's ``prefill`` spans (both passes of a batch) of each span's device
extent, from the start of the first device operation launched inside it to
the end of the last (``program_trace.py``). Nothing where the slice holds
no such span."""

from benchmark import program_trace

LAYER = "prefill"
MOVES = "samples_per_s"


def read(r):
    t = program_trace.for_reading(r)
    return t.mean_ms("prefill") if t else None
