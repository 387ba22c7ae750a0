"""K3, the int8-cache decode attention (``kernels/decode_attn.py``,
``csrc/decode_attn_int8.cu``): a split kernel (MHA or GQA) and the merge
kernel it launches as a programmatic dependent. A call's record is its
shapes and the positions its mask keeps, reduced on the device; its work is
``counts/roofline.py::k3_work``."""

from benchmark.counts import roofline

ENTRIES = [("attwarp_tpu_torch.models.llama", "decode_attn_int8")]
TRACE_NAMES = ("decode_attn_mha", "decode_attn_gqa", "decode_merge_kernel")


def record(args, kwargs, count):
    q, k_q, _ks, _vq, _vs, mask = args[:6]
    _L, B, S, kvH, _hd = k_q.shape
    return (B, S, q.shape[1], kvH, count(mask))


def work(rec):
    B, S, H, kvH, n_valid = rec
    return roofline.k3_work(B, S, H, kvH, int(n_valid))
