"""K2, the causal flash prefill with left padding (``kernels/flash_prefill.py``,
``csrc/flash_prefill.cu``): a call's record is its shapes and the valid
positions of each row, reduced on the device; its work is
``counts/roofline.py::k2_work`` over the pairs that padding allows."""

from benchmark.counts import roofline

ENTRIES = [("attwarp_tpu_torch.models.llama", "flash_prefill")]
TRACE_NAMES = ("flash_prefill_kernel",)


def record(args, kwargs, count):
    q, k, _v, mask = args[:4]
    B, T, H, _hd = q.shape
    return (B, T, H, k.shape[2], count(mask, 1))


def work(rec):
    B, T, H, kvH, valid = rec
    return roofline.k2_work(B, T, H, kvH, [T - int(v) for v in valid.tolist()])
