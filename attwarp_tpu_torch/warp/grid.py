"""Warp-grid construction: attention -> marginal profiles -> CDF -> inverse map.

Counterpart of ``attwarp_tpu/warp/grid.py`` (reference
``new_method.py:198-283``). Every function takes leading batch dimensions,
so a whole batch of maps is one call (JAX vmaps the single-map form).

``piecewise_linear_inverse`` is JAX's segment-membership form, batched: it
equals ``np.interp`` for monotone knots, ties included, and JAX's answer on
non-monotone knots, where ``np.interp`` is undefined.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from attwarp_tpu_torch.warp.transforms import (
    Transform,
    WarpParams,
    apply_inverse_transform,
    apply_transform,
)

# Constants from new_method.py:194-195.
EPSILON = 1e-9
BASE_ATTENTION = 1e-9


def _degenerate_fallback(profile_x, profile_y, total_x, total_y, mean_biased,
                         h: int, w: int):
    """Degenerate-attention fallback (new_method.py:231-239): profiles
    become ones and the totals the reference's approximations."""
    degenerate = (total_x < EPSILON) | (total_y < EPSILON)
    fb_total_x = torch.clamp(w * (mean_biased * h), min=EPSILON)
    fb_total_y = torch.clamp(h * (mean_biased * w), min=EPSILON)
    d = degenerate[..., None]
    profile_x = torch.where(d, torch.ones_like(profile_x), profile_x)
    profile_y = torch.where(d, torch.ones_like(profile_y), profile_y)
    total_x = torch.where(degenerate, fb_total_x, total_x)
    total_y = torch.where(degenerate, fb_total_y, total_y)
    return profile_x, profile_y, total_x, total_y


def attention_profiles(
    att_map: torch.Tensor, params: WarpParams
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention maps ``(..., h, w)`` -> ``(profile_x (..., w), profile_y
    (..., h), total_x (...), total_y (...))``, with the degenerate fallback.

    The EXP transform runs in the log domain, shifted by each map's max:
    ``exp(scale*x)`` overflows float32 where the reference's float64 does
    not, and the normalized cumulative profile is invariant to the shift.
    """
    h, w = att_map.shape[-2], att_map.shape[-1]
    a = torch.clamp(att_map.to(torch.float32), min=0.0)

    if params.transform is Transform.EXP:
        sx = params.exp_scale * a
        m = torch.amax(sx, dim=(-2, -1), keepdim=True)      # (..., 1, 1)
        es = torch.exp(sx - m)
        m1 = m[..., 0]                                       # (..., 1)
        if params.apply_inverse_to_marginals:
            ls_x = m1 + torch.log(torch.sum(es, dim=-2))     # (..., w)
            ls_y = m1 + torch.log(torch.sum(es, dim=-1))     # (..., h)
            floor = math.log(1e-9)
            profile_x = (torch.clamp(ls_x, min=floor) / params.exp_scale
                         + BASE_ATTENTION * h)
            profile_y = (torch.clamp(ls_y, min=floor) / params.exp_scale
                         + BASE_ATTENTION * w)
            total_x = torch.sum(profile_x, dim=-1)
            total_y = torch.sum(profile_y, dim=-1)
            # inverse-transformed profiles can go negative, so the
            # degenerate fallback is reachable here
            mean_biased = torch.exp(
                m1[..., 0] + torch.log(torch.sum(es, dim=(-2, -1)))
                - math.log(float(h * w))
            ) / params.exp_divisor + BASE_ATTENTION
            return _degenerate_fallback(profile_x, profile_y, total_x, total_y,
                                        mean_biased, h, w)
        # non-inverse: scaled profiles; normalization cancels the shift, and
        # the per-cell bias keeps the fallback unreachable
        scale = torch.exp(-m1)
        div = params.exp_divisor
        profile_x = torch.sum(es, dim=-2) / div + (BASE_ATTENTION * h) * scale
        profile_y = torch.sum(es, dim=-1) / div + (BASE_ATTENTION * w) * scale
        return (profile_x, profile_y, torch.sum(profile_x, dim=-1),
                torch.sum(profile_y, dim=-1))

    a_biased = apply_transform(a, params) + BASE_ATTENTION
    profile_x = torch.sum(a_biased, dim=-2)   # (..., w)
    profile_y = torch.sum(a_biased, dim=-1)   # (..., h)
    if params.apply_inverse_to_marginals:
        profile_x = apply_inverse_transform(profile_x - BASE_ATTENTION * h, params)
        profile_y = apply_inverse_transform(profile_y - BASE_ATTENTION * w, params)
        profile_x = profile_x + BASE_ATTENTION * h
        profile_y = profile_y + BASE_ATTENTION * w
    total_x = torch.sum(profile_x, dim=-1)
    total_y = torch.sum(profile_y, dim=-1)
    mean_biased = torch.mean(a_biased, dim=(-2, -1))
    return _degenerate_fallback(profile_x, profile_y, total_x, total_y,
                                mean_biased, h, w)


def piecewise_linear_inverse(knots: torch.Tensor, out_len: int) -> torch.Tensor:
    """Inverse of the forward map ``knots[k] -> k`` at integer targets
    ``0..out_len-1``, for knots ``(..., n+1)``. Returns ``(..., out_len)``
    f32.

    Each target takes the mean of ``k + (t - knots[k]) / (knots[k+1] -
    knots[k])`` over the segments ``[knots[k], knots[k+1])`` that contain
    it, and is clamped to 0 below the first knot and to n from the last.
    For monotone knots exactly one segment contains a target (a zero-width
    tie contains none), which is ``np.interp``; for non-monotone knots (a
    LOG transform whose marginals mix signs) it is JAX's answer. The
    (..., out_len, n) membership costs little at attention widths."""
    n = knots.shape[-1] - 1
    knots = knots.to(torch.float32)
    t = torch.arange(out_len, dtype=torch.float32, device=knots.device)[:, None]
    k0 = knots[..., None, :-1]                                  # (..., 1, n)
    k1 = knots[..., None, 1:]
    inseg = (t >= k0) & (t < k1)                                # (..., T, n)
    denom = torch.where(k1 > k0, k1 - k0, torch.ones_like(k0))
    vals = torch.arange(n, dtype=torch.float32, device=knots.device) + (t - k0) / denom
    res = torch.sum(torch.where(inseg, vals, torch.zeros_like(vals)), dim=-1)
    res = res / torch.clamp(torch.sum(inseg, dim=-1), min=1)
    # outside-range clamping, as np.interp
    t = t[:, 0]
    res = torch.where(t < knots[..., :1], torch.zeros_like(res), res)
    return torch.where(t >= knots[..., -1:], torch.full_like(res, float(n)), res)


def inverse_axis_map(
    profile: torch.Tensor, total: torch.Tensor, out_len: int
) -> torch.Tensor:
    """One axis of the C1 path: profile ``(..., N)`` -> source coordinates
    ``(..., out_len)``. Forward knots ``[0, cumsum(profile)/total] *
    out_len`` (last forced to ``out_len``) against ``[0, 1..N]``
    (new_method.py:241-261)."""
    cum = torch.cumsum(profile, dim=-1) / total[..., None]
    zero = torch.zeros_like(cum[..., :1])
    knots = torch.cat([zero, cum], dim=-1) * out_len
    knots[..., -1] = float(out_len)
    return piecewise_linear_inverse(knots, out_len)
