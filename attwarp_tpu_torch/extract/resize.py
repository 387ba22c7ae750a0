"""Bilinear resizes on the device (counterpart of ``resize_images_batch``,
``resize_scale_device``, ``_resize_for_backend`` and ``_to_uint8_rgb`` in
``attwarp_tpu/extract/extraction.py``), and the host cubic resize with which
the layer sweep upscales its maps (``jax.image.resize(..., "cubic")``).

They equal ``jax.image.resize(..., "linear")``, which antialiases when it
downsamples (the triangle kernel is widened by the inverse scale) and
leaves axes whose size does not change untouched; ``F.interpolate``'s
bilinear mode does neither. Each resized axis is a weight matrix built in
numpy float32 by JAX's rule (``scale_and_translate``) and applied as an f32
matmul.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.models.clip_vit import CLIP_MEAN, CLIP_STD


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add: the
    float64 product of two float32 values is exact. XLA contracts the
    multiply-adds of JAX's weight rule into FMAs."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.float64(c)).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel, a = -0.5 (JAX's
    ``_fill_keys_cubic_kernel``), its Horner steps as FMAs."""
    inner = _fma(_fma(_fma(1.5, x, -2.5), x, 0.0), x, 1.0)
    outer = _fma(_fma(_fma(-0.5, x, 2.5), x, -4.0), x, 2.0)
    out = np.where(x >= np.float32(1.0), outer, inner)
    return np.where(x >= np.float32(2.0), np.float32(0.0), out).astype(np.float32)


def _weight_matrix(in_len: int, out_len: int, kernel, fused: bool) -> np.ndarray:
    """(in_len, out_len) float32 weights of ``jax.image.resize`` along one
    axis (``jax._src.image.scale.compute_weight_mat``, antialias on, no
    translation): the kernel widened by the inverse scale when it
    downsamples, each column normalised over its taps inside the input,
    columns whose sample falls outside ``[-0.5, in_len - 0.5]`` zeroed.
    ``fused`` places the samples with an FMA, as XLA does."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_len / in_len))
    kernel_scale = max(inv_scale, f32(1.0))
    steps = np.arange(out_len, dtype=f32) + f32(0.5)
    sample_f = _fma(inv_scale, steps, -0.5) if fused else steps * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_len, dtype=f32)[:, None]) / kernel_scale
    w = kernel(x)
    total = np.sum(w, axis=0, keepdims=True)
    safe = np.where(total != 0, total, f32(1.0))
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, w / safe, f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_len - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@lru_cache(maxsize=64)
def linear_weight_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) float32 weights of ``jax.image.resize`` "linear"
    along one axis (the triangle kernel). The samples are placed unfused:
    the port's image paths were built and held to their bars with these
    weights, within ~1e-6 of XLA's."""
    return _weight_matrix(in_len, out_len, _triangle, fused=False)


@lru_cache(maxsize=64)
def cubic_weight_matrix(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) float32 weights of ``jax.image.resize`` "cubic"
    along one axis (Keys' kernel, a = -0.5). Not ``warp/blend.py``'s
    cv2-style cubic of the JAX package, which clamps its taps at the
    border. Fused like XLA's, to hold the weights within 1e-6 of JAX's."""
    return _weight_matrix(in_len, out_len, _keys_cubic, fused=True)


def resize_cubic(att: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """A 2-D float32 map resized like ``jax.image.resize(att, out_hw,
    "cubic")``, on the host: only the axes whose size changes. Not
    ``warp/blend.py::resize_cubic``, which is cv2's cubic (a = -0.75)."""
    x = np.asarray(att, np.float32)
    if x.shape[0] != out_hw[0]:
        x = cubic_weight_matrix(x.shape[0], out_hw[0]).T @ x
    if x.shape[1] != out_hw[1]:
        x = x @ cubic_weight_matrix(x.shape[1], out_hw[1])
    return x


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """``x (B, H, W, C)`` float32 -> ``(B, *out_hw, C)``, resizing only the
    axes whose size changes."""
    H, W = x.shape[1], x.shape[2]
    out_h, out_w = out_hw
    if H != out_h:
        wy = torch.as_tensor(linear_weight_matrix(H, out_h)).to(x.device)
        x = torch.einsum("bhwc,hy->bywc", x, wy)
    if W != out_w:
        wx = torch.as_tensor(linear_weight_matrix(W, out_w)).to(x.device)
        x = torch.einsum("bhwc,wx->bhxc", x, wx)
    return x


def resize_scale_device(batch: torch.Tensor, scale: float,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
    """``batch (B, H, W, C)`` of any dtype -> float32 times ``scale``,
    resized to ``out_hw``, on the batch's device."""
    x = batch.to(torch.float32) * scale
    if tuple(x.shape[1:3]) == tuple(out_hw):
        return x
    return resize_linear(x, out_hw)


def to01_scale(arr: np.ndarray) -> float:
    """The multiplier that takes an image to [0, 1] by its dtype: integer
    images are 0-255; float images are [0, 1] unless their max says 0-255."""
    if np.issubdtype(arr.dtype, np.integer):
        return 1.0 / 255.0
    return 1.0 / 255.0 if float(arr.max()) > 1.5 else 1.0


def to_uint8_rgb(im: np.ndarray) -> np.ndarray:
    """An image -> uint8: integer images are clipped to 0-255, float images
    are [0, 1] and rounded from ``x * 255``."""
    im = np.asarray(im)
    if im.dtype == np.uint8:
        return im
    if np.issubdtype(im.dtype, np.integer):
        return np.clip(im, 0, 255).astype(np.uint8)
    return np.clip(np.rint(im * 255.0), 0, 255).astype(np.uint8)


def resize_for_backend(im: np.ndarray, size: int) -> np.ndarray:
    """One host image -> (size, size, C) float32 in [0, 1] on the host: to
    [0, 1] by its dtype (a float image whose max is above 1.5 is 0-255),
    then resized like ``jax.image.resize`` "linear"."""
    arr = np.asarray(im)
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
        if arr.max() > 1.5:
            arr = arr / 255.0
    if arr.shape[0] == size and arr.shape[1] == size:
        return arr
    return resize_linear(torch.as_tensor(arr)[None], (size, size))[0].numpy()


def resize_images_batch(images: Sequence[np.ndarray], size: int,
                        device: torch.device) -> torch.Tensor:
    """Host images -> ``(B, size, size, C)`` float32 in [0, 1] on ``device``,
    in input order: one upload and one resize per (shape, scale) group."""
    arrs = [np.asarray(im) for im in images]
    groups: dict = {}
    for i, a in enumerate(arrs):
        groups.setdefault((a.shape, to01_scale(a)), []).append(i)
    pieces, order = [], []
    for (_shape, scale), idxs in groups.items():
        batch = torch.as_tensor(np.stack([arrs[i] for i in idxs])).to(device)
        pieces.append(resize_scale_device(batch, scale, (size, size)))
        order.extend(idxs)
    if len(pieces) == 1:
        return pieces[0]
    inv = torch.as_tensor(np.argsort(order), device=device)
    return torch.cat(pieces, dim=0)[inv]


def clip_pixels(images, size: int, device: torch.device, mean=CLIP_MEAN,
                std=CLIP_STD) -> torch.Tensor:
    """Images -> CLIP-normalized (B, size, size, 3) f32 on ``device`` (or
    by another tower's ``mean`` and ``std``): a (B, size, size, C) tensor
    is taken as it is, anything else is resized on the device first."""
    if not (isinstance(images, torch.Tensor) and images.ndim == 4
            and tuple(images.shape[1:3]) == (size, size)):
        images = resize_images_batch(list(images), size, device)
    x = images.to(device)
    x = x.to(torch.float32) / 255.0 if not x.is_floating_point() else x.to(torch.float32)
    mean = torch.as_tensor(mean, device=x.device)
    std = torch.as_tensor(std, device=x.device)
    return (x - mean) / std
