"""K1, the separable bilinear warp resample (``kernels/warp_resample.py``,
``csrc/warp_resample.cu``): a call's record is its shapes; its work is
``counts/roofline.py::k1_work``."""

from benchmark.counts import roofline

ENTRIES = [("attwarp_tpu_torch.warp.warp", "warp_resample")]
TRACE_NAMES = ("warp_resample_kernel",)


def record(args, kwargs, count):
    images, map_x, map_y = args[:3]
    B, H, W, C = images.shape
    return (B, H, W, C, map_y.shape[1], map_x.shape[1])


def work(rec):
    return roofline.k1_work(*rec)
