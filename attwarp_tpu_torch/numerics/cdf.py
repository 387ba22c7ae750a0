"""CDF/PDF primitives (counterpart of ``attwarp_tpu/numerics/cdf.py``).

Numerically matches the reference implementations in
``model/marginalnet_full_dataset/checkpoint_utils.py``:
- ``cdf_from_density``          (checkpoint_utils.py:30-41)
- ``gt_marginals``              (checkpoint_utils.py:43-51)
- ``make_strictly_increasing``  (checkpoint_utils.py:17-28)
- ``resample_cdf``              (checkpoint_utils.py:53-62)
- ``normalize_cdf_1d``          (checkpoint_utils.py:388-399)

Every function is batched over leading axes and differentiable where its
JAX original is.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _pin_last(F: torch.Tensor) -> torch.Tensor:
    """``F`` with its last entry set to exactly 1 (JAX's ``.at[..., -1].set``)."""
    return torch.cat([F[..., :-1], torch.ones_like(F[..., -1:])], dim=-1)


def cdf_from_density(p: torch.Tensor) -> torch.Tensor:
    """``p: (B, N)`` densities -> ``(B, N)`` non-decreasing CDF in [0, 1],
    last = 1: clamp to >= 0, scrub NaN/Inf, renormalize, cumsum, pin the
    last entry."""
    p = torch.nan_to_num(torch.clamp(p.to(torch.float32), min=0.0), nan=0.0, posinf=0.0,
                         neginf=0.0)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-6)
    return _pin_last(torch.cumsum(p, dim=-1))


def gt_marginals(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``A: (B, 1, H, W)`` or ``(B, H, W)`` -> normalized marginals
    ``(px: (B, W), py: (B, H))``."""
    if A.ndim == 4:
        A = A.squeeze(1)
    Apos = torch.clamp(A, min=0.0)
    mx = torch.sum(Apos, dim=-2)   # (B, W): sum over rows
    my = torch.sum(Apos, dim=-1)   # (B, H): sum over columns
    mx = mx / torch.clamp(torch.sum(mx, dim=-1, keepdim=True), min=1e-6)
    my = my / torch.clamp(torch.sum(my, dim=-1, keepdim=True), min=1e-6)
    return mx, my


def make_strictly_increasing(F: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Force a batch of CDFs ``(B, N)`` to be strictly increasing, in [0, 1],
    ending at exactly 1: scrub -> running max -> clamp consecutive steps to
    >= eps/N -> rebuild by cumsum -> renormalize by the (clamped) last value
    -> clip."""
    F = torch.nan_to_num(F, nan=0.0, posinf=1.0, neginf=0.0)
    F_nd = torch.cummax(F, dim=-1).values
    N = F.shape[-1]
    min_step = eps / max(N, 1)
    d = torch.clamp(F_nd[..., 1:] - F_nd[..., :-1], min=min_step)
    head = F_nd[..., :1]
    F_fix = torch.cat([head, head + torch.cumsum(d, dim=-1)], dim=-1)
    last = torch.clamp(F_fix[..., -1:], min=1e-6)
    return _pin_last(torch.clamp(F_fix / last, 0.0, 1.0))


def resample_cdf(F: torch.Tensor, target_len: int) -> torch.Tensor:
    """Resize a batch of CDFs ``(B, N) -> (B, target_len)`` by linear
    interpolation with the align_corners=True end points, enforcing strict
    monotonicity before and after."""
    F = make_strictly_increasing(F.to(torch.float32))
    N = F.shape[-1]
    if target_len == 1:
        pos = torch.zeros((1,), dtype=torch.float32, device=F.device)
    else:
        # align_corners=True: output i samples input at i * (N-1) / (T-1)
        pos = torch.arange(target_len, dtype=torch.float32, device=F.device) * (
            float(N - 1) / float(target_len - 1))
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, N - 1)
    hi = torch.clamp(lo + 1, 0, N - 1)
    frac = pos - lo.to(torch.float32)
    F_up = F[..., lo] * (1.0 - frac) + F[..., hi] * frac
    return make_strictly_increasing(F_up)


def normalize_cdf_1d(F: torch.Tensor) -> torch.Tensor:
    """Make a CDF ``(..., N)`` safe: non-decreasing, in [0, 1], last = 1;
    a degenerate one (last value <= 1e-12) becomes the uniform ramp."""
    F = torch.nan_to_num(F.to(torch.float32), nan=0.0, posinf=1.0, neginf=0.0)
    F = torch.cummax(F, dim=-1).values
    last = F[..., -1:]
    N = F.shape[-1]
    uniform = torch.linspace(0.0, 1.0, N, dtype=torch.float32, device=F.device).expand(F.shape)
    degenerate = last <= 1e-12
    F = torch.where(degenerate, uniform, F / torch.where(degenerate, torch.ones_like(last), last))
    return _pin_last(F)
