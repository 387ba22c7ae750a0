"""MarginalNet as a ``torch.nn.Module`` (counterpart of
``attwarp_tpu/marginalnet/model.py``).

Architecture parity with ``model/marginalnet_full_dataset/model.py:17-95``:
a FiLM-conditioned CNN over frozen MLLM visual tokens, text-pooled MLP
conditioning, and per-axis Conv1d heads emitting normalized marginal PDFs
``px (B, W)`` and ``py (B, H)`` through a guarded softmax.

The input stays NHWC ``fmap_v (B, hv, wv, Dv)``, as in JAX, and is permuted
once inside. Parameters are f32; ``compute_dtype`` bf16 (the default, as
JAX's) runs the layers under ``torch.autocast``, and the softmax in f32.
The upsample of the visual grid to 24x24 is ``jax.image.resize`` "linear"
(``extract/resize.py::resize_linear``: the identity for 24x24 features,
bilinear up, antialiased down). Parameter names are the flax modules';
``params_from_jax`` converts a flax parameter tree.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from attwarp_tpu_torch.extract.resize import resize_linear
from attwarp_tpu_torch.numerics.safe import safe_softmax

# The marginal-prediction grid: 24x24 = LLaVA-1.5's visual-token layout
# (576 patches). Single source of truth for training and inference.
ATTENTION_GRID = (24, 24)


def _flax_init_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's defaults: weights lecun_normal (a normal of variance
    1/fan_in truncated at two deviations), biases zero."""
    w = module.weight
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
        nn.init.zeros_(module.bias)


class MarginalNet(nn.Module):
    def __init__(self, dv: int, dt: int, hidden: int = 256, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden = hidden
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.proj_v1 = nn.Conv2d(dv, hidden, 1)
        self.proj_v2 = nn.Conv2d(hidden, hidden, 3, padding=1)
        self.txt_pool1 = nn.Linear(dt, hidden)
        self.txt_pool2 = nn.Linear(hidden, hidden)
        self.film = nn.Linear(hidden, 2 * hidden)
        for axis in ("x", "y"):
            setattr(self, f"head_{axis}_conv1", nn.Conv1d(hidden, hidden, 5, padding=2))
            setattr(self, f"head_{axis}_conv2", nn.Conv1d(hidden, 1, 1))
        generator = generator or torch.Generator().manual_seed(0)
        for m in self.children():
            _flax_init_(m, generator)

    def forward(self, fmap_v: torch.Tensor, out_hw: Tuple[int, int], txt_tok: torch.Tensor,
                txt_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``fmap_v (B, hv, wv, Dv)``, ``txt_tok (B, Lt, Dt)``, ``txt_mask
        (B, Lt, 1)`` -> ``(px (B, W), py (B, H))`` f32, ``out_hw = (H, W)``."""
        with torch.autocast(fmap_v.device.type, dtype=self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            logit_x, logit_y = self._logits(fmap_v, out_hw, txt_tok, txt_mask)
        px = safe_softmax(logit_x.to(torch.float32), dim=-1, eps=self.eps)
        py = safe_softmax(logit_y.to(torch.float32), dim=-1, eps=self.eps)
        return px, py

    def _logits(self, fmap_v, out_hw, txt_tok, txt_mask):
        cdt = self.compute_dtype
        fmap_v, txt_tok, txt_mask = (t.to(cdt) for t in (fmap_v, txt_tok, txt_mask))

        # 1) visual projection + bilinear resize to out_hw, channels last
        v = F.silu(self.proj_v1(fmap_v.permute(0, 3, 1, 2)))
        v = F.silu(self.proj_v2(v)).permute(0, 2, 3, 1)
        v = resize_linear(v, out_hw).to(cdt)                       # (B, H, W, hidden)

        # 2) masked text pooling + FiLM conditioning
        denom = torch.clamp(torch.sum(txt_mask, dim=1), min=1.0)   # (B, 1)
        t = (torch.sum(txt_tok * txt_mask, dim=1) / denom).to(cdt)  # (B, Dt)
        t = F.silu(self.txt_pool1(t))
        t = F.silu(self.txt_pool2(t))
        gamma, beta = torch.chunk(self.film(t), 2, dim=-1)
        v = gamma[:, None, None, :] * v + beta[:, None, None, :]

        # 3) per-axis heads: integrate out the other axis, Conv1d stack
        vx = torch.mean(v, dim=1)   # (B, W, hidden): over Y
        vy = torch.mean(v, dim=2)   # (B, H, hidden): over X
        return self._head(vx, "x"), self._head(vy, "y")

    def _head(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """(B, L, hidden) -> (B, L): Conv1d(k=5) -> SiLU -> Conv1d(k=1)."""
        h = F.silu(getattr(self, f"head_{axis}_conv1")(x.transpose(1, 2)))
        return getattr(self, f"head_{axis}_conv2")(h)[:, 0, :]


def params_from_jax(flax_params) -> Dict[str, torch.Tensor]:
    """A flax ``MarginalNet`` parameter tree -> this module's
    ``state_dict``: conv kernels HWIO -> OIHW, Conv1d ``(k, in, out)`` ->
    ``(out, in, k)``, Dense ``(in, out)`` -> Linear ``(out, in)``."""
    out = {}
    for name, p in flax_params.items():
        k = np.asarray(p["kernel"], np.float32)
        if k.ndim == 4:
            k = k.transpose(3, 2, 0, 1)
        elif k.ndim == 3:
            k = k.transpose(2, 1, 0)
        else:
            k = k.T
        out[f"{name}.weight"] = torch.as_tensor(np.array(k, order="C"))
        out[f"{name}.bias"] = torch.as_tensor(np.array(p["bias"], np.float32))
    return out
