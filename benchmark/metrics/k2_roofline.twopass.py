"""Kernel K2's share of its roofline in the traced slice, in %: the summed
least time of its calls (``counts/roofline.py`` at the shapes recorded at
the kernel's Python entry) over the device time of its kernels in the
trace, the union of their intervals. Nothing where the slice ran no K2."""

LAYER = "kernels"
MOVES = "samples_per_s"


def read(r):
    t = r.trace["kernel_s"].get("k2") if r.trace else None
    least = r.kernel_least_s.get("k2")
    return 100.0 * least / t if t and least else None
