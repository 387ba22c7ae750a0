"""K4, the scaled row softmax between a vision tower's two attention
products (``kernels/attn_softmax.py``, ``csrc/attn_softmax.cu``), looked up
by both towers' modules: a call's record is its rows, row length and value
size; its work is each value read once and written once, and 5 operations
a value (scale, max, exponent, sum, quotient). A checkout without the
kernel's module has no entry to record."""

import importlib.util

_TOWERS = ("attwarp_tpu_torch.models.qwen2vl", "attwarp_tpu_torch.models.clip_vit")

ENTRIES = ([(m, "scaled_softmax_") for m in _TOWERS]
           if importlib.util.find_spec("attwarp_tpu_torch.kernels.attn_softmax") else [])
TRACE_NAMES = ("attn_softmax_rows",)


def record(args, kwargs, count):
    logits = args[0]
    L = logits.shape[-1]
    return (logits.numel() // L, L, logits.element_size())


def work(rec):
    rows, L, elem = rec
    return 2 * elem * rows * L, 5 * rows * L
