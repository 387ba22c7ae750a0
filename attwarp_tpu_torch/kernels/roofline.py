"""The least time one NVIDIA H100 (SXM) could take for a kernel's work.

Pure Python, from shapes alone: each input byte is counted read once and
each output byte written once, whatever a kernel reads again, and the work
counts only what these inputs need (the key pairs a mask allows, the cache
rows a mask keeps). The bound is the larger of bytes over the HBM rate and
operations over the peak rate of their type, against NVIDIA's published
peaks for the H100 SXM at its 700 W limit; a card set to a lower power
limit runs below them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # HBM3, 80 GB part
BF16_FLOPS = 989e12           # dense tensor-core bf16
F32_FLOPS = 67e12             # f32 outside the tensor cores


def bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> dict:
    """``{"bound_ms", "bound_by", "bound_peak"}`` for ``nbytes`` moved and
    ``flops`` done at ``peak_flops``: ``bound_by`` is "bytes" or
    "operations", whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes * 1e3, "bound_by": "bytes",
                "bound_peak": f"hbm {HBM_BYTES_PER_S / 1e12:g} TB/s"}
    kind = "bf16" if peak_flops == BF16_FLOPS else "f32"
    return {"bound_ms": t_ops * 1e3, "bound_by": "operations",
            "bound_peak": f"{kind} {peak_flops / 1e12:g} TFLOP/s"}


def causal_segment_pairs(T: int, pads) -> int:
    """(query, key) pairs that K2 computes over a batch whose row ``b`` has
    ``pads[b]`` left-padding positions: causal, and within the segment
    (padding with padding, valid with valid)."""
    total = 0
    for p in pads:
        n = T - p
        total += p * (p + 1) // 2 + n * (n + 1) // 2
    return total


def k2_work(B: int, T: int, H: int, kvH: int, pads, hd: int = 128,
            elem: int = 2) -> tuple[int, int]:
    """Bytes and flops of K2 (flash prefill): q (B, T, H, hd), k and v (B,
    T, kvH, hd) and the (B, T) bool mask read, out (B, T, H, hd) written;
    q.k and p.v at 2 * hd flops each per allowed pair and head."""
    nbytes = (2 * B * T * H * hd + 2 * B * T * kvH * hd) * elem + B * T
    flops = 4 * hd * H * causal_segment_pairs(T, pads)
    return nbytes, flops


def k3_work(B: int, S: int, H: int, kvH: int, n_valid: int,
            hd: int = 128) -> tuple[int, int]:
    """Bytes and flops of K3 (int8-cache decode attention) with ``n_valid``
    (row, position) pairs allowed by the (B, S) mask: the int8 K and V rows
    and their f32 scales of those positions for every kv head, q and out in
    bf16 (B, H, hd), and the mask; q.k and p.v at 2 * hd flops each per
    allowed position and query head."""
    nbytes = n_valid * kvH * (2 * hd + 2 * 4) + 2 * (2 * B * H * hd) + B * S
    flops = 4 * hd * H * n_valid
    return nbytes, flops


def k1_work(B: int, H: int, W: int, C: int, H_out: int,
            W_out: int) -> tuple[int, int]:
    """Bytes and flops of K1 (separable bilinear resample), all f32: the
    image and the two coordinate maps read, the warped image written; per
    output value three lerps of 3 flops each (two along x, one along y)."""
    nbytes = 4 * (B * H * W * C + B * (H_out + W_out) + B * H_out * W_out * C)
    flops = 9 * B * H_out * W_out * C
    return nbytes, flops
