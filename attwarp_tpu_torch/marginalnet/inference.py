"""Learned-warp inference (counterpart of
``attwarp_tpu/marginalnet/inference.py``): MarginalNet predicts the
marginals and the CDF warp applies them, with no oracle attention pass
(BASELINE config 3)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID, MarginalNet
from attwarp_tpu_torch.numerics.cdf import cdf_from_density
from attwarp_tpu_torch.numerics.pooling import upsample_pdf_right_inverse
from attwarp_tpu_torch.warp.warp import warp_from_cdf


@torch.no_grad()
def predict_and_warp(
    model: MarginalNet,
    images: torch.Tensor,    # (B, H, W, 3) float [0, 1]
    fmap_v: torch.Tensor,    # (B, hv, wv, Dv) frozen MLLM visual tokens
    ttok: torch.Tensor,      # (B, Lt, Dt) frozen text tokens
    tmask: torch.Tensor,     # (B, Lt, 1)
    out_size: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(warped (B, H_out, W_out, 3), px (B, 24), py (B, 24))``:
    the model, the right-inverse upsample of its marginals to the image's
    width and height, their CDFs, then ``warp_from_cdf`` (K1 on a CUDA
    tensor)."""
    H, W = images.shape[1], images.shape[2]
    px, py = model(fmap_v, ATTENTION_GRID, ttok, tmask)
    Fx = cdf_from_density(torch.clamp(upsample_pdf_right_inverse(px, W), min=0.0))
    Fy = cdf_from_density(torch.clamp(upsample_pdf_right_inverse(py, H), min=0.0))
    return warp_from_cdf(images, Fx, Fy, out_size), px, py
