"""The expert layers of one prompt prefill on the device, in ms: the device
extents of the ``moe`` spans inside each ``prefill`` span of the traced
slice, summed a prefill, as a mean over the prefills that hold one
(``program_trace.py``). A decode step's expert layers run inside replayed
graphs, with no span of their own (``decode_step_ms.twopass`` holds them).
Nothing where the slice holds no such span."""

from benchmark import program_trace

LAYER = "MoE FFN"
MOVES = "samples_per_s"


def read(r):
    t = program_trace.for_reading(r)
    if not t:
        return None
    per_prefill = {}
    for sp in t.spans:
        if sp.name != "moe" or not sp.has_device:
            continue
        p = sp.parent
        while p is not None and t.spans[p].name != "prefill":
            p = t.spans[p].parent
        if p is not None:
            per_prefill[p] = per_prefill.get(p, 0.0) + sp.dev_end - sp.dev_start
    return sum(per_prefill.values()) / len(per_prefill) / 1e3 if per_prefill else None
