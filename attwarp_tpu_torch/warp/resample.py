"""Separable bilinear resampling with ``cv2.remap(INTER_LINEAR,
BORDER_REPLICATE)`` semantics — the plain PyTorch version of kernel K1.

Counterpart of ``attwarp_tpu/warp/resample.py::remap_bilinear_separable``,
batched: ``kernels/warp_resample.py`` runs this function for CPU tensors and
compares its CUDA kernel (``csrc/warp_resample.cu``) against it on the card.
The TPU matmul forms (``_mm``, ``_mm_int8`` and the int8-pair core) are TPU
workarounds and are not ported.
"""

from __future__ import annotations

import torch


def _axis_lerp(img: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation of ``img (B, ...)`` along ``axis`` at per-sample
    float ``coords (B, n_out)``, clamping both neighbour indices from the
    unclipped floor (border replicate: a coordinate in [-1, 0) replicates
    index 0 on both sides, as cv2 does)."""
    n = img.shape[axis]
    i0f = torch.floor(coords)
    frac = coords - i0f
    i0 = torch.clamp(i0f.to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0f.to(torch.int64) + 1, 0, n - 1)
    shape = [1] * img.ndim
    shape[0] = coords.shape[0]
    shape[axis] = coords.shape[1]
    expand = list(img.shape)
    expand[axis] = coords.shape[1]
    g0 = torch.gather(img, axis, i0.reshape(shape).expand(expand))
    g1 = torch.gather(img, axis, i1.reshape(shape).expand(expand))
    frac = frac.reshape(shape)
    return g0 * (1.0 - frac) + g1 * frac


def remap_bilinear_separable(
    images: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor
) -> torch.Tensor:
    """Warp ``images (B, H, W, C)`` with per-sample source-coordinate
    vectors ``map_x (B, W_out)`` and ``map_y (B, H_out)`` -> ``(B, H_out,
    W_out, C)`` f32: a pass along x, then a pass along y."""
    img = images.to(torch.float32)
    out = _axis_lerp(img, map_x.to(torch.float32), axis=2)
    return _axis_lerp(out, map_y.to(torch.float32), axis=1)
