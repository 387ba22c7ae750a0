"""The MOTA mask (counterpart of ``attwarp_tpu/warp/blend.py``; reference
``attention_extraction/llava.py:195-270``).

A low-resolution attention map is min-normalized, z-score-enhanced through
a sigmoid, box-filtered with replicate padding, quantized to uint8 as
torchvision's ``ToPILImage`` does (truncation), and resized to the image
with PIL's LANCZOS, which quantizes to uint8 between its two passes. Every
linear stage is a constant matrix built in numpy (``replicate_fir_matrix``,
``_lanczos_matrix_np`` and cv2's cubic, ``_cubic_matrix_np``, are copies:
``attwarp_tpu.warp.blend`` imports JAX) and applied as f32 matmuls, except
the box filter (``_box_pass``). On the card those matmuls need
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default):
TF32 would cost the 1-LSB mask parity.

The box filter is rounded as the CPU's f32 matmul rounds it, on every
device: the truncation after it puts cells that ``enhance`` saturates
(near 1.0) on the 254/255 boundary, where the card's matmul, summing in
another order, moved whole patches of the mask a level from the CPU's
(and from JAX's, which rounds as the CPU does).

Functions take a leading batch dimension: ``mota_mask`` maps ``(B, h, w)``
to ``(B, H, W)``. ``blend_mask`` (one image's mask and JET overlay, the
dataset driver's) and ``merge_gray`` work on one host image.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def normalize_minmax(mat: torch.Tensor, method: str = "min") -> torch.Tensor:
    """Per map over the last two dims. 'min': (x-min)/(max-min); 'max':
    (max-x)/(max-min). A constant map gives zeros (the reference's 0/0)."""
    if method not in ("min", "max"):
        raise NotImplementedError(method)
    lo = torch.amin(mat, dim=(-2, -1), keepdim=True)
    hi = torch.amax(mat, dim=(-2, -1), keepdim=True)
    rng = hi - lo
    num = (mat - lo) if method == "min" else (hi - mat)
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    return torch.where(rng > 0, num / safe, torch.zeros_like(num))


def enhance(mat: torch.Tensor, coe: float = 10.0) -> torch.Tensor:
    """Z-score with the unbiased std -> scale -> sigmoid -> clamp, per map
    (llava.py:215-221). A constant map gives sigmoid(0)."""
    mat = mat - torch.mean(mat, dim=(-2, -1), keepdim=True)
    n = mat.shape[-2] * mat.shape[-1]
    std = torch.sqrt(torch.sum(mat * mat, dim=(-2, -1), keepdim=True)
                     / max(n - 1, 1))
    safe = torch.where(std > 0, std, torch.ones_like(std))
    mat = torch.where(std > 0, mat / safe, torch.zeros_like(mat)) * coe
    return torch.clamp(torch.sigmoid(mat), 0.0, 1.0)


def replicate_fir_matrix(n: int, kernel: np.ndarray) -> np.ndarray:
    """An odd-length 1-D FIR kernel with replicate padding as an (n, n)
    matrix."""
    k = np.asarray(kernel, np.float64)
    if k.size % 2 != 1:
        raise ValueError(f"FIR kernel length must be odd, got {k.size}")
    r = k.size // 2
    M = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for dj in range(-r, r + 1):
            M[i, min(max(i + dj, 0), n - 1)] += k[dj + r]
    return M


@lru_cache(maxsize=64)
def _box_matrix_np(n: int, kernel_size: int) -> np.ndarray:
    """1-D replicate-padded box filter as an (n, n) matrix."""
    return replicate_fir_matrix(
        n, np.full(kernel_size, 1.0 / kernel_size, np.float64))


def _const(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32).to(like.device)


@lru_cache(maxsize=64)
def _box_bands_np(n: int, kernel_size: int) -> np.ndarray:
    """The box matrix's f32 weights by offset: row ``d + r`` holds
    ``B[i, i + d]`` for d = -r..r (0 where ``i + d`` falls outside)."""
    B = _box_matrix_np(n, kernel_size).astype(np.float32)
    r = kernel_size // 2
    bands = np.zeros((2 * r + 1, n), np.float32)
    for d in range(-r, r + 1):
        for i in range(max(0, -d), min(n, n - d)):
            bands[d + r, i] = B[i, i + d]
    return bands


def _box_pass(x: torch.Tensor, kernel_size: int, dim: int) -> torch.Tensor:
    """The box matrix applied along ``dim`` of f32 ``x`` with the CPU f32
    matmul's rounding: each output one fused multiply-add a term, in
    ascending order of the terms, rounded to f32. Emulated in f64 (a
    product of two f32 values is exact there), so every device gives the
    same bits."""
    n, r = x.shape[dim], kernel_size // 2
    bands = torch.as_tensor(_box_bands_np(n, kernel_size), dtype=torch.float64,
                            device=x.device)
    shape = [1] * x.ndim
    shape[dim] = n
    acc = torch.zeros_like(x)
    for d in range(-r, r + 1):
        # out of range, the weight is 0 and the clamped index any value
        idx = torch.clamp(torch.arange(n, device=x.device) + d, 0, n - 1)
        term = bands[d + r].reshape(shape) * x.index_select(dim, idx).to(torch.float64)
        acc = (term + acc.to(torch.float64)).to(torch.float32)
    return acc


def revise_mask(patch_mask: torch.Tensor, kernel_size: int = 3,
                enhance_coe: float = 10.0) -> torch.Tensor:
    """Min-normalize -> enhance -> replicate-padded box filter
    (llava.py:223-238): ``By @ m @ Bx.T`` as the CPU rounds it."""
    m = enhance(normalize_minmax(patch_mask, "min"), coe=enhance_coe)
    return _box_pass(_box_pass(m, kernel_size, -2), kernel_size, -1)


def _lanczos(x: np.ndarray, a: float = 3.0) -> np.ndarray:
    """Lanczos-3 kernel (PIL's LANCZOS filter)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.sinc(x) * np.sinc(x / a)
    return np.where(np.abs(x) < a, out, 0.0)


@lru_cache(maxsize=128)
def _lanczos_matrix_np(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) PIL-compatible LANCZOS resampling matrix: per
    output pixel, center (i + 0.5) * scale, support widened by max(scale,
    1), weights at (j - center + 0.5) / filterscale normalized over the
    clipped window."""
    support = 3.0
    scale = in_len / out_len
    filterscale = max(scale, 1.0)
    support_scaled = support * filterscale
    M = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        center = (i + 0.5) * scale
        xmin = max(int(center - support_scaled + 0.5), 0)
        xmax = min(int(center + support_scaled + 0.5), in_len)
        js = np.arange(xmin, xmax)
        w = _lanczos((js - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        M[i, xmin:xmax] = w
    return M


def _clip8(x: torch.Tensor) -> torch.Tensor:
    """Pillow's clip8: round half up, clamp to [0, 255] (stays float32)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def resize_lanczos(x: torch.Tensor, out_hw: Tuple[int, int],
                   uint8_mode: bool = False) -> torch.Tensor:
    """Separable LANCZOS resize ``(..., H, W) -> (..., *out_hw)``.

    ``uint8_mode`` reproduces Pillow's 8-bit pipeline: the horizontal pass
    first, quantized to uint8 levels, then the vertical pass, quantized
    again."""
    out_h, out_w = out_hw
    H, W = x.shape[-2], x.shape[-1]
    x = x.to(torch.float32)
    Ly = _const(_lanczos_matrix_np(H, out_h), x)
    Lx = _const(_lanczos_matrix_np(W, out_w), x)
    if uint8_mode:
        tmp = _clip8(torch.matmul(x, Lx.T))
        return _clip8(torch.matmul(Ly, tmp))
    return torch.matmul(torch.matmul(Ly, x), Lx.T)


def _keys_cubic(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' bicubic kernel; a = -0.75 is cv2's INTER_CUBIC (a copy of the
    JAX package's ``warp/blend.py::_keys_cubic``)."""
    t = np.abs(np.asarray(t, np.float64))
    return np.where(
        t <= 1.0,
        (a + 2.0) * t**3 - (a + 3.0) * t**2 + 1.0,
        np.where(t < 2.0, a * t**3 - 5.0 * a * t**2 + 8.0 * a * t - 4.0 * a, 0.0),
    )


@lru_cache(maxsize=64)
def _cubic_matrix_np(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) cv2-INTER_CUBIC resampling matrix in float64:
    half-pixel centres, Keys a = -0.75, taps clamped at the border."""
    scale = in_len / out_len
    M = np.zeros((out_len, in_len), dtype=np.float64)
    for i in range(out_len):
        s = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(s))
        d = s - x0
        for j in (-1, 0, 1, 2):
            M[i, min(max(x0 + j, 0), in_len - 1)] += _keys_cubic(j - d)
    return M


def resize_cubic(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Separable bicubic resize ``(..., H, W) -> (..., *out_hw)`` with cv2's
    kernel, as two f32 matmuls on ``x``'s device. Not
    ``extract/resize.py::resize_cubic``, which is ``jax.image.resize``'s
    cubic (a = -0.5, no border clamp) for the layer sweep."""
    out_h, out_w = out_hw
    H, W = x.shape[-2], x.shape[-1]
    x = x.to(torch.float32)
    Cy = _const(_cubic_matrix_np(H, out_h), x)
    Cx = _const(_cubic_matrix_np(W, out_w), x)
    return torch.matmul(torch.matmul(Cy, x), Cx.T)


def quantize_uint8_trunc(x: torch.Tensor) -> torch.Tensor:
    """torchvision ToPILImage float -> uint8: truncate x*255."""
    return torch.clamp(torch.floor(x * 255.0), 0.0, 255.0).to(torch.uint8)


def mota_mask(att: torch.Tensor, out_hw: Tuple[int, int],
              enhance_coe: float = 10.0, kernel_size: int = 3,
              quantize_like_reference: bool = True) -> torch.Tensor:
    """Attention maps ``(B, h, w)`` -> image-size masks ``(B, *out_hw)``.

    With ``quantize_like_reference`` the masks are uint8, the reference's
    ``mota_mask.npy`` contract; otherwise float in [0, 255] with no
    intermediate quantization."""
    m = revise_mask(att.to(torch.float32), kernel_size=kernel_size,
                    enhance_coe=enhance_coe)
    if quantize_like_reference:
        m8 = quantize_uint8_trunc(m).to(torch.float32)
        return resize_lanczos(m8, out_hw, uint8_mode=True).to(torch.uint8)
    return torch.clamp(resize_lanczos(m * 255.0, out_hw), 0.0, 255.0)


def quantize_uint8_round(x: torch.Tensor) -> torch.Tensor:
    """PIL resample output clamp: round half to even, clip to [0, 255]."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def blend_mask(image_rgb: np.ndarray, att, enhance_coe: float = 10.0,
               kernel_size: int = 3, grayscale: float = 0.0,
               device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """One image's MOTA mask and JET overlay (reference llava.py:240-270).

    ``image_rgb (H, W, 3)`` uint8 on the host; ``att (h, w)`` an array or a
    tensor. The mask runs on ``device``, the card unless the caller asks for
    the CPU (without a card, ``cuda`` raises). Returns ``(overlay_rgb,
    mask)``, both uint8 on the host, the mask
    at image size, quantized like the reference. The overlay
    min-max stretches the mask to 0-255 (``cv2.normalize`` NORM_MINMAX),
    colormaps it and blends with ``alpha = grayscale if 0 < grayscale <= 1
    else 0.5``."""
    from attwarp_tpu_torch.utils.colormap import apply_jet
    from attwarp_tpu_torch.utils.device import require_device

    device = require_device(device, "blend_mask")
    H, W = image_rgb.shape[0], image_rgb.shape[1]
    if not isinstance(att, torch.Tensor):
        att = torch.as_tensor(np.asarray(att, np.float32))
    att = att.to(device=device, dtype=torch.float32)
    mask = mota_mask(att[None], (H, W), enhance_coe=enhance_coe,
                     kernel_size=kernel_size)[0].cpu().numpy()
    m = mask.astype(np.float64)
    lo, hi = m.min(), m.max()
    m = (m - lo) * (255.0 / (hi - lo)) if hi > lo else np.zeros_like(m)
    heat = apply_jet(np.clip(np.rint(m), 0, 255).astype(np.uint8))
    alpha = grayscale if isinstance(grayscale, (int, float)) and 0 < grayscale <= 1 else 0.5
    overlay = np.clip(np.rint(image_rgb.astype(np.float64) * (1 - alpha)
                              + heat.astype(np.float64) * alpha), 0, 255).astype(np.uint8)
    return overlay, mask


def merge_gray(mask: np.ndarray, image_rgb: np.ndarray,
               gray_scale: float = 200.0) -> np.ndarray:
    """Gray blend (llava.py:198-205): ``image * m + (1 - m) * gray`` with
    ``m = mask / 255``, truncated to uint8."""
    m = mask.astype(np.float32) / 255.0
    gray = np.full_like(image_rgb, gray_scale, dtype=np.float32)
    out = image_rgb.astype(np.float32) * m[..., None] + (1 - m[..., None]) * gray
    return out.astype(np.uint8)
