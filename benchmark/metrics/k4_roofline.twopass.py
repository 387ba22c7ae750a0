"""Kernel K4's share of its roofline in the traced slice, in %: the summed
least time of its calls (``counts/roofline.py``'s bound of the work that
``kernels/k4.py`` gives at the shapes recorded at the kernel's Python
entry) over the device time of its kernels in the trace, the union of
their intervals. Nothing where the slice ran no K4."""

LAYER = "kernels"
MOVES = "samples_per_s"


def read(r):
    t = r.trace["kernel_s"].get("k4") if r.trace else None
    least = r.kernel_least_s.get("k4")
    return 100.0 * least / t if t and least else None
