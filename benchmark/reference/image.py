"""Plain image stages of the two-pass pipeline and of the warp, for the
benchmark's check: the antialiased linear resize, the MOTA mask, the
attention warp's grid and its bilinear resample, each written from its
definition (reference ``new_method.py`` and ``llava.py``), imports nothing
of the program.

``dtype`` is ``torch.float64`` for the reference and ``torch.bfloat16`` for
the control, the step below the float32 the program computes these stages
in.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


# ── resize: jax.image.resize(..., "linear") ───────────────────────────


def linear_weights(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) float64 weights of an antialiased linear resize:
    the triangle kernel widened by the inverse scale when shrinking, each
    output normalised over its taps, outputs whose sample falls outside the
    input zeroed."""
    inv = in_len / out_len
    kscale = max(inv, 1.0)
    sample = (np.arange(out_len) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(in_len)[:, None]) / kscale
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000 * np.finfo(np.float32).eps, w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_len - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize(x: torch.Tensor, out_hw: Tuple[int, int], dtype=torch.float64) -> torch.Tensor:
    """(B, H, W, C) -> (B, *out_hw, C) in ``dtype``, resizing only the axes
    whose size changes."""
    x = x.to(dtype)
    H, W = x.shape[1], x.shape[2]
    if H != out_hw[0]:
        wy = torch.as_tensor(linear_weights(H, out_hw[0]), device=x.device).to(dtype)
        x = torch.einsum("bhwc,hy->bywc", x, wy)
    if W != out_hw[1]:
        wx = torch.as_tensor(linear_weights(W, out_hw[1]), device=x.device).to(dtype)
        x = torch.einsum("bhwc,wx->bhxc", x, wx)
    return x


# ── the MOTA mask ─────────────────────────────────────────────────────


def _lanczos_rows(in_len: int, out_len: int) -> np.ndarray:
    """(out_len, in_len) Pillow LANCZOS (a = 3) weights: support widened
    by the scale when shrinking, normalised over the clipped window."""
    scale = in_len / out_len
    fs = max(scale, 1.0)
    sup = 3.0 * fs
    M = np.zeros((out_len, in_len))
    for i in range(out_len):
        c = (i + 0.5) * scale
        lo, hi = max(int(c - sup + 0.5), 0), min(int(c + sup + 0.5), in_len)
        t = (np.arange(lo, hi) - c + 0.5) / fs
        w = np.where(np.abs(t) < 3.0, np.sinc(t) * np.sinc(t / 3.0), 0.0)
        M[i, lo:hi] = w / w.sum() if w.sum() != 0 else w
    return M


def mota_mask(att: torch.Tensor, out_hw: Tuple[int, int], coe: float = 10.0,
              ksize: int = 3, dtype=torch.float64) -> torch.Tensor:
    """One attention map (h, w) -> its MOTA mask (H, W), integer values
    0-255 held in ``dtype``: min-max normalise, z-score (unbiased std) times
    ``coe`` through a sigmoid, a ``ksize`` box filter with replicated
    edges, truncated to 8 bits, then Pillow's two-pass LANCZOS resize (rows
    first), rounded to 8 bits after each pass."""
    a = att.to(dtype)
    lo, hi = a.min(), a.max()
    a = (a - lo) / (hi - lo) if hi > lo else torch.zeros_like(a)
    a = a - a.mean()
    std = torch.sqrt((a * a).sum() / max(a.numel() - 1, 1))
    a = torch.sigmoid(a / std * coe) if std > 0 else torch.sigmoid(torch.zeros_like(a))
    r = ksize // 2
    pad = torch.nn.functional.pad(a[None, None].to(torch.float64), (r, r, r, r),
                                  mode="replicate")[0, 0].to(dtype)
    h, w = a.shape
    box = sum(pad[i:i + h, j:j + w] for i in range(ksize) for j in range(ksize)) / (ksize * ksize)
    m8 = torch.clamp(torch.floor(box * 255.0), 0, 255)
    Lx = torch.as_tensor(_lanczos_rows(w, out_hw[1]), device=a.device).to(dtype)
    Ly = torch.as_tensor(_lanczos_rows(h, out_hw[0]), device=a.device).to(dtype)
    t = torch.clamp(torch.floor(m8 @ Lx.t() + 0.5), 0, 255)
    return torch.clamp(torch.floor(Ly @ t + 0.5), 0, 255)


# ── the warp ──────────────────────────────────────────────────────────


def _inverse_map(profile: torch.Tensor, out_len: int) -> torch.Tensor:
    """Source coordinates (out_len,) of the warp along one axis: the forward
    knots ``[0, cumsum(profile) / total] * out_len`` (the last forced to
    ``out_len``) against cells ``0..n``, inverted at ``0..out_len-1`` by
    linear interpolation, clamped to ``[0, n]``."""
    n = profile.shape[0]
    cum = torch.cumsum(profile, dim=0) / profile.sum()
    knots = torch.cat([torch.zeros(1, dtype=cum.dtype, device=cum.device), cum]) * out_len
    knots[-1] = out_len
    t = torch.arange(out_len, dtype=torch.float64, device=cum.device)
    kf = knots.to(torch.float64)
    k = torch.clamp(torch.searchsorted(kf, t, right=True) - 1, 0, n - 1)
    k0, k1 = knots[k], knots[k + 1]
    res = k.to(knots.dtype) + (t.to(knots.dtype) - k0) / torch.where(k1 > k0, k1 - k0, torch.ones_like(k0))
    res = torch.where(t < kf[0], torch.zeros_like(res), res)
    return torch.where(t >= kf[-1], torch.full_like(res, float(n)), res)


def grid_maps(att: torch.Tensor, image_hw: Tuple[int, int], out_w: int, out_h: int,
              dtype=torch.float64):
    """An attention map or mask (h, w) -> source coordinates map_x (out_w,)
    and map_y (out_h,) in the pixels of an ``image_hw`` image (identity
    transform; 1e-9 added to every cell)."""
    a = torch.clamp(att.to(dtype), min=0) + 1e-9
    h, w = a.shape
    mx = _inverse_map(a.sum(dim=0), out_w) * (image_hw[1] / w)
    my = _inverse_map(a.sum(dim=1), out_h) * (image_hw[0] / h)
    return mx, my


def remap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          dtype=torch.float64) -> torch.Tensor:
    """Bilinear resample of ``img`` (H, W, C) at columns ``map_x`` and rows
    ``map_y``, neighbours clamped to the border (cv2 INTER_LINEAR,
    BORDER_REPLICATE), in ``dtype``."""
    img = img.to(dtype)
    H, W = img.shape[0], img.shape[1]

    def taps(coord, n):
        f0 = torch.floor(coord.to(torch.float64))
        frac = (coord.to(torch.float64) - f0).to(dtype)
        i0 = torch.clamp(f0.long(), 0, n - 1)
        i1 = torch.clamp(f0.long() + 1, 0, n - 1)
        return i0, i1, frac

    x0, x1, fx = taps(map_x, W)
    rows = img[:, x0] * (1 - fx)[None, :, None] + img[:, x1] * fx[None, :, None]
    y0, y1, fy = taps(map_y, H)
    return rows[y0] * (1 - fy)[:, None, None] + rows[y1] * fy[:, None, None]


def warp(img: torch.Tensor, att: torch.Tensor, out_w: int, out_h: int,
         dtype=torch.float64) -> torch.Tensor:
    """``img`` (H, W, C) warped by attention ``att`` (h, w) to (out_h,
    out_w, C)."""
    mx, my = grid_maps(att, img.shape[:2], out_w, out_h, dtype)
    return remap(img, mx, my, dtype)
