"""The least time one NVIDIA H100 (SXM) could take for a kernel's work.

The benchmark's own copy of ``attwarp_tpu_torch/kernels/roofline.py``, so
that a change to the program cannot move the yardstick;
``benchmark/tests/test_counts.py`` holds the two equal at the shapes of the
kernel table in ``PERF.md``.

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
INT8_OPS = 1979e12            # dense tensor-core int8
F32_FLOPS = 67e12             # f32 outside the tensor cores
_PEAK_NAMES = {BF16_FLOPS: "bf16 989 TFLOP/s", INT8_OPS: "int8 1979 TOP/s",
               F32_FLOPS: "f32 67 TFLOP/s"}


def bound(nbytes: float, flops: float, peak_flops: float = BF16_FLOPS) -> dict:
    """``{"bound_ms", "bound_by", "bound_peak"}`` for ``nbytes`` moved and
    ``flops`` done at ``peak_flops``: ``bound_by`` is "bytes" or
    "operations", whichever takes longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes * 1e3, "bound_by": "bytes",
                "bound_peak": f"hbm {HBM_BYTES_PER_S / 1e12:g} TB/s"}
    return {"bound_ms": t_ops * 1e3, "bound_by": "operations",
            "bound_peak": _PEAK_NAMES[peak_flops]}


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


def k1_backward_work(B: int, H: int, W: int, C: int, H_out: int, W_out: int,
                     need_image: bool, need_maps: bool) -> tuple[int, int]:
    """Bytes and flops of K1's backward, all f32: ``g`` (B, H_out, W_out, C)
    read, the image read if the maps need a gradient, its gradient written
    if the image needs one, both maps read and their gradients written if
    asked for. Per value of ``g``: the image gradient's two transposed
    lerps (8 flops), the maps' two x lerps, their difference and the taps'
    differences (16 flops)."""
    n_g = B * H_out * W_out * C
    n_img = B * H * W * C
    n_maps = B * (H_out + W_out)
    nbytes = 4 * (n_g + n_maps + (n_img + n_maps if need_maps else 0)
                  + (n_img if need_image else 0))
    flops = n_g * ((8 if need_image else 0) + (16 if need_maps else 0))
    return nbytes, flops


def w8a8_work(M: int, K: int, N: int, bias: bool = False, in_elem: int = 2,
              out_elem: int = 2) -> tuple[int, int]:
    """Bytes and int8 operations of one w8a8 linear (``numerics/quant.py::
    apply_linear`` on an int8 weight): the activations (M, K) read in their
    dtype, the int8 weight (N, K), its f32 scales and bias read, the output
    (M, N) written; 2 * M * N * K int8 operations."""
    nbytes = M * K * in_elem + N * K + 4 * N * (2 if bias else 1) + M * N * out_elem
    return nbytes, 2 * M * N * K
