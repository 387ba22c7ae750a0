"""Numerically guarded probability helpers (counterpart of
``attwarp_tpu/numerics/safe.py``).

Matches the reference ``model/marginalnet_full_dataset/model.py``:
``safe_softmax`` (model.py:8-14), ``mix_with_uniform`` (model.py:98-101),
``entropy`` (model.py:104-106).
"""

from __future__ import annotations

import torch


def safe_softmax(logits: torch.Tensor, dim: int = -1, eps: float = 1e-6) -> torch.Tensor:
    """Softmax with NaN/Inf scrubbing and renormalization afterwards."""
    logits = torch.nan_to_num(logits, nan=0.0, posinf=0.0, neginf=0.0)
    logits = logits - torch.amax(logits, dim=dim, keepdim=True)
    p = torch.softmax(logits, dim=dim)
    p = torch.nan_to_num(p, nan=0.0, posinf=0.0, neginf=0.0)
    return p / torch.clamp(torch.sum(p, dim=dim, keepdim=True), min=eps)


def mix_with_uniform(p: torch.Tensor, alpha) -> torch.Tensor:
    """Convexly mix a batch of PDFs ``(B, N)`` with the uniform
    distribution. ``alpha`` may be a tensor (the training schedule anneals
    it), so nothing branches on its value."""
    n = p.shape[-1]
    alpha = torch.clamp(torch.as_tensor(alpha, dtype=p.dtype, device=p.device), 0.0, 1.0)
    return (1.0 - alpha) * p + alpha / n


def entropy(p: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean Shannon entropy over the batch of PDFs ``(B, N)``."""
    q = torch.clamp(p, min=eps)
    return torch.mean(-torch.sum(q * torch.log(q), dim=-1))


def normalize_pdf(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Clamp to >= 0 and renormalize along the last axis."""
    p = torch.clamp(p, min=0.0)
    return p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=eps)
