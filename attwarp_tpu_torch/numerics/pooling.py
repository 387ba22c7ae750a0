"""Adaptive average pooling and its minimum-norm right inverse (counterpart
of ``attwarp_tpu/numerics/pooling.py``).

Both are constant matrices built in numpy float64, cached per ``(L_out,
L_in)``, and applied as f32 matmuls on the input's device. PyTorch's
AdaptiveAvgPool1d window rule:

    start_i = floor(i * L_in / L_out)
    end_i   = ceil((i + 1) * L_in / L_out)

The right inverse is ``A^T (A A^T + eps I)^{-1}`` (reference
checkpoint_utils.py:64-131).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=256)
def _pool_matrix_np(out_len: int, in_len: int) -> np.ndarray:
    """(out_len, in_len) adaptive-average-pooling matrix, float64."""
    i = np.arange(out_len, dtype=np.int64)
    starts = (i * in_len) // out_len
    ends = ((i + 1) * in_len + out_len - 1) // out_len  # integer ceil
    A = np.zeros((out_len, in_len), dtype=np.float64)
    for k in range(out_len):
        s, e = int(starts[k]), int(ends[k])
        A[k, s:e] = 1.0 / max(e - s, 1)
    return A


@lru_cache(maxsize=256)
def _right_inverse_matrix_np(out_len: int, in_len: int, eps: float) -> np.ndarray:
    """(in_len, out_len) minimum-norm right inverse ``A^T (A A^T + eps I)^{-1}``."""
    A = _pool_matrix_np(out_len, in_len)
    AAT = A @ A.T
    if eps > 0:
        AAT = AAT + eps * np.eye(out_len, dtype=np.float64)
    return A.T @ np.linalg.solve(AAT, np.eye(out_len, dtype=np.float64))


def adaptive_pool_matrix(out_len: int, in_len: int, device=None) -> torch.Tensor:
    """(out_len, in_len) f32 pooling matrix on ``device``."""
    return torch.as_tensor(_pool_matrix_np(out_len, in_len), dtype=torch.float32,
                           device=device)


def right_inverse_matrix(out_len: int, in_len: int, eps: float = 1e-8,
                         device=None) -> torch.Tensor:
    """(in_len, out_len) f32 right-inverse matrix on ``device``."""
    return torch.as_tensor(_right_inverse_matrix_np(out_len, in_len, float(eps)),
                           dtype=torch.float32, device=device)


def adaptive_avg_pool1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """``(..., L_in) -> (..., out_len)`` adaptive average pooling (one f32
    matmul)."""
    in_len = x.shape[-1]
    if in_len == out_len:
        return x
    P = adaptive_pool_matrix(out_len, in_len, x.device)
    return torch.matmul(x.to(torch.float32), P.T)


def adaptive_avg_pool2d(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``(..., H, W) -> (..., out_h, out_w)``; separable: ``Py @ x @ Px^T``
    in f32."""
    out_h, out_w = out_hw
    H, W = x.shape[-2], x.shape[-1]
    if (H, W) == (out_h, out_w):
        return x
    Py = adaptive_pool_matrix(out_h, H, x.device)
    Px = adaptive_pool_matrix(out_w, W, x.device)
    return torch.matmul(torch.matmul(Py, x.to(torch.float32)), Px.T)


def upsample_pdf_right_inverse(y: torch.Tensor, target_len: int,
                               eps: float = 1e-8) -> torch.Tensor:
    """``y (..., L_out)`` -> the minimum-norm ``x_hat (..., target_len)``
    whose adaptive average pool gives back ``y`` (reference
    checkpoint_utils.py:64-131; contract at :70-83)."""
    M = right_inverse_matrix(y.shape[-1], int(target_len), eps, y.device)
    return torch.matmul(y.to(torch.float32), M.T)
