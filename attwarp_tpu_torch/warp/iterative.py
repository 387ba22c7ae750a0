"""Iterative warping and attention-map conditioning (counterpart of
``attwarp_tpu/warp/iterative.py``; the SD-warp ablation's warp math,
reference ``Ablations/Stable_diffusion_based_warp.py``).

- ``condition_attention_map``: a low-resolution map -> cv2's cubic upsample
  to image size -> 5x5 Gaussian blur (sigma 1.0) -> min-max normalize
  (:407-413, :399-402).
- ``iterative_warp``: the warp applied N times with ``exp_scale / N`` each,
  so that the compounded distortion matches one full-strength warp
  (:446-455). Each iteration is one ``warp_image_by_attention``: one launch
  of kernel K1 on a CUDA tensor.

The blur and the resize are constant matrices built in numpy (cv2's
``getGaussianKernel`` with a replicate border, through
``warp/blend.py::replicate_fir_matrix``) and applied as f32 matmuls on the
input's device. Every function takes a leading batch dimension or none.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.resize import resize_linear
from attwarp_tpu_torch.warp.blend import _const, replicate_fir_matrix, resize_cubic
from attwarp_tpu_torch.warp.transforms import Transform, WarpParams
from attwarp_tpu_torch.warp.warp import warp_image_by_attention


@lru_cache(maxsize=8)
def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics."""
    r = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


@lru_cache(maxsize=64)
def _gaussian_matrix_np(n: int, ksize: int, sigma: float) -> np.ndarray:
    """1-D Gaussian filter with replicate border as an (n, n) matrix."""
    return replicate_fir_matrix(n, _gaussian_kernel1d(ksize, sigma))


def gaussian_blur(x: torch.Tensor, ksize: int = 5, sigma: float = 1.0) -> torch.Tensor:
    """Separable Gaussian blur (replicate border) over the last two dims,
    as two f32 matmuls."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.to(torch.float32)
    Gy = _const(_gaussian_matrix_np(h, ksize, sigma), x)
    Gx = _const(_gaussian_matrix_np(w, ksize, sigma), x)
    return torch.matmul(torch.matmul(Gy, x), Gx.T)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    """``(x - min) / (max - min + 1e-9)`` per map over the last two dims."""
    x = x - torch.amin(x, dim=(-2, -1), keepdim=True)
    return x / (torch.amax(x, dim=(-2, -1), keepdim=True) + 1e-9)


def condition_attention_map(att_lr: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Low-resolution attention ``(..., h, w)`` -> the conditioned map
    ``(..., *target_hw)`` in [0, 1], on ``att_lr``'s device."""
    full = resize_cubic(_minmax(att_lr.to(torch.float32)), target_hw)
    return _minmax(gaussian_blur(full, 5, 1.0))


def iterative_warp(
    image: torch.Tensor,
    att_map: torch.Tensor,
    width: int,
    height: int,
    iterations: int = 1,
    transform: Transform = Transform.IDENTITY,
    exp_scale: float = 1.0,
    exp_divisor: float = 1.0,
    apply_inverse: bool = False,
) -> List[torch.Tensor]:
    """Warp ``image (H, W[, C])`` by ``att_map (H, W)`` ``iterations`` times
    with ``exp_scale / iterations`` each; returns every iterate (the last is
    the final image), each ``(height, width[, C])`` f32 on the image's
    device. The map stays fixed, as in the reference, so successive warps
    compound the magnification: after the first iteration it is resized to
    the iterate's size once, by ``jax.image.resize``'s antialiased linear
    rule (``extract/resize.py::resize_linear``)."""
    params = WarpParams(
        transform=transform,
        exp_scale=exp_scale / max(1, iterations),
        exp_divisor=exp_divisor,
        apply_inverse_to_marginals=apply_inverse,
    )
    outs: List[torch.Tensor] = []
    cur, att = image, att_map
    for _ in range(iterations):
        if tuple(att.shape[:2]) != tuple(cur.shape[:2]):
            att = resize_linear(att.to(torch.float32)[None, :, :, None], cur.shape[:2])[0, :, :, 0]
        cur = warp_image_by_attention(cur, att, width, height, params)
        outs.append(cur)
    return outs
