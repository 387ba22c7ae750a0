"""Loss library for MarginalNet training (counterpart of
``attwarp_tpu/numerics/losses.py``).

Mirrors ``model/marginalnet_full_dataset/losses.py``:
- ``l1_cdf_loss``                 (losses.py:11-12)
- ``sym_kl``                      (losses.py:15-22)
- ``separable_recon_loss``        (losses.py:25-33)
- ``recon_l1``                    (losses.py:36-45)
- ``build_axis_cdf_targets``      (losses.py:48-65)
- ``cdf_from_density_downsample`` (losses.py:68-77)

Only the image-resolution PDF L1 (assembled in ``train/train_step.py``) is
on the training path; the rest are library losses and logged metrics.
"""

from __future__ import annotations

from typing import Tuple

import torch

from attwarp_tpu_torch.numerics.cdf import _pin_last, cdf_from_density
from attwarp_tpu_torch.numerics.pooling import adaptive_avg_pool1d


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean absolute error."""
    return torch.mean(torch.abs(a - b))


def l1_cdf_loss(p_pred: torch.Tensor, p_gt: torch.Tensor) -> torch.Tensor:
    return l1_loss(cdf_from_density(p_pred), cdf_from_density(p_gt))


def sym_kl(p: torch.Tensor, q: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.clamp(p, min=eps)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    q = torch.clamp(q, min=eps)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    kl_pq = torch.mean(torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1))
    kl_qp = torch.mean(torch.sum(q * (torch.log(q) - torch.log(p)), dim=-1))
    return 0.5 * (kl_pq + kl_qp)


def _normalized_outer(px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """(B, W), (B, H) -> (B, H, W) separable map, normalized to sum 1 per
    sample."""
    P = py[:, :, None] * px[:, None, :]
    return P / torch.clamp(torch.sum(P, dim=(-2, -1), keepdim=True), min=1e-6)


def _normalized_attention(A: torch.Tensor) -> torch.Tensor:
    if A.ndim == 4:
        A = A.squeeze(1)
    Apos = torch.clamp(A, min=0.0)
    return Apos / torch.clamp(torch.sum(Apos, dim=(-2, -1), keepdim=True), min=1e-6)


def separable_recon_loss(px: torch.Tensor, py: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """MSE between the separable outer-product map and the normalized
    attention."""
    return torch.mean((_normalized_outer(px, py) - _normalized_attention(A)) ** 2)


def recon_l1(px: torch.Tensor, py: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """L1 between the separable outer-product map and the normalized
    attention."""
    return torch.mean(torch.abs(_normalized_outer(px, py) - _normalized_attention(A)))


def _cdf_of_pooled(p: torch.Tensor, L: int) -> torch.Tensor:
    F = torch.cumsum(adaptive_avg_pool1d(p, L), dim=-1)
    return _pin_last(F / torch.clamp(F[..., -1:], min=1e-6))


def build_axis_cdf_targets(A: torch.Tensor, L: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``A: (B, 1, H, W) -> (Fx, Fy)``, each ``(B, L)``, monotone, ending
    at 1."""
    A = torch.nan_to_num(torch.clamp(A.to(torch.float32), min=0.0), nan=0.0, posinf=0.0,
                         neginf=0.0)
    if A.ndim == 4:
        A = A.squeeze(1)
    mx = torch.sum(A, dim=-2)
    my = torch.sum(A, dim=-1)
    mx = mx / torch.clamp(torch.sum(mx, dim=-1, keepdim=True), min=1e-6)
    my = my / torch.clamp(torch.sum(my, dim=-1, keepdim=True), min=1e-6)
    return _cdf_of_pooled(mx, L), _cdf_of_pooled(my, L)


def cdf_from_density_downsample(p: torch.Tensor, L: int) -> torch.Tensor:
    """Densities ``(B, N) -> CDF (B, L)``: pool the PDF, cumsum,
    renormalize."""
    p = torch.nan_to_num(torch.clamp(p.to(torch.float32), min=0.0), nan=0.0, posinf=0.0,
                         neginf=0.0)
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-6)
    return _cdf_of_pooled(p, L)
