"""CLIP vision tower (pre-LN ViT), counterpart of
``attwarp_tpu/models/clip_vit.py``.

HF ``CLIPVisionModel`` as LLaVA-1.5 uses it (openai/clip-vit-large-patch14-
336): patch embedding, class token, learned positions, pre-layernorm, N
blocks with QuickGELU, hidden states tapped at ``feature_layer``. The patch
embedding stays an unfold plus a matmul with the JAX ``patch_weight``
layout ``(hidden, P*P*3)``: no convolution, so cuDNN's TF32 default never
applies. Parameters are the JAX tree's names, as tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch


@dataclass(frozen=True)
class ClipVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# CLIP image normalization constants (OPENAI_CLIP_MEAN/STD).
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        return torch.nn.functional.gelu(
            x, approximate="none" if name == "gelu" else "tanh")
    raise ValueError(name)


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["weight"] + p["bias"]


def _lin(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return x @ p["weight"].T + p["bias"]


def _block(lp: Dict[str, Any], cfg: ClipVisionConfig, x: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    h = _ln(x, lp["layer_norm1"], cfg.layer_norm_eps)
    q = _lin(h, lp["q_proj"]).reshape(B, T, nh, hd)
    k = _lin(h, lp["k_proj"]).reshape(B, T, nh, hd)
    v = _lin(h, lp["v_proj"]).reshape(B, T, nh, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    probs = torch.softmax(logits * (1.0 / math.sqrt(hd)), dim=-1).to(x.dtype)
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
    x = x + _lin(attn, lp["out_proj"])
    h2 = _ln(x, lp["layer_norm2"], cfg.layer_norm_eps)
    return x + _lin(_act(_lin(h2, lp["fc1"]), cfg.hidden_act), lp["fc2"])


def clip_vision_features(
    params: Dict[str, Any],
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,   # (B, H, W, 3) NHWC, CLIP-normalized
    feature_layer: int = -2,
    drop_cls: bool = True,
) -> torch.Tensor:
    """Hidden states at ``feature_layer`` (HF ``output_hidden_states``
    indexing: 0 is the embedding output, i the output of block i), computed
    in the parameters' dtype. Returns (B, num_patches[, +1], hidden)."""
    B = pixel_values.shape[0]
    P = cfg.patch_size
    n = cfg.image_size // P
    x = pixel_values.to(params["patch_weight"].dtype)
    x = x.reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, n * n, P * P * 3)
    patches = x @ params["patch_weight"].T   # (B, n*n, hidden); no bias
    cls = params["class_embedding"].expand(B, 1, cfg.hidden_size)
    h = torch.cat([cls, patches], dim=1) + params["position_embedding"][None]
    h = _ln(h, params["pre_layrnorm"], cfg.layer_norm_eps)
    stop = feature_layer % (cfg.num_hidden_layers + 1)
    for i in range(stop):
        h = _block(params["layers"][i], cfg, h)
    return h[:, 1:] if drop_cls else h
