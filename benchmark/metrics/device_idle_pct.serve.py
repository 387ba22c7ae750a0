"""The share of the traced slice in which no kernel, copy or set ran on the
card (the union of their intervals, so overlapping kernels count once), in
%."""

LAYER = "device"
MOVES = "served_tok_per_s"


def read(r):
    if not r.trace or r.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
