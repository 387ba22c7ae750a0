"""CLIP vision tower (pre-LN ViT), counterpart of
``attwarp_tpu/models/clip_vit.py``.

HF ``CLIPVisionModel`` as LLaVA-1.5 uses it (openai/clip-vit-large-patch14-
336): patch embedding, class token, learned positions, pre-layernorm, N
blocks with QuickGELU, hidden states tapped at ``feature_layer``. Under a
``SiglipVisionConfig`` the same blocks are HF ``SiglipVisionModel``'s
encoder (as Uni-MoE-2.0-Omni uses SigLIP-so400m-patch14-384): a patch
embedding with a bias (``patch_bias``), learned positions over the patches
alone, no class token and no pre-layernorm; its post-layernorm and pooling
head are not on the tapped path and not held. The patch
embedding stays an unfold plus a matmul with the JAX ``patch_weight``
layout ``(hidden, P*P*3)``: no convolution, so cuDNN's TF32 default never
applies. Parameters are the JAX tree's names, as tensors; a tensor-parallel
rank's tree (``parallel/llava_sharding.py``) holds its heads and FFN slice,
and the row-parallel ``out_proj``/``fc2`` sum over the ``model`` axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_
from attwarp_tpu_torch.numerics.quant import row_linear
from attwarp_tpu_torch.parallel.comm import all_gather, split_group


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


@dataclass(frozen=True)
class SiglipVisionConfig(ClipVisionConfig):
    """A SigLIP tower (the defaults: SigLIP-so400m-patch14-384's)."""

    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"


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


def _row(x: torch.Tensor, p: Dict[str, torch.Tensor], group) -> torch.Tensor:
    """``_lin`` of a row-parallel linear on a tensor-parallel rank
    (``numerics/quant.py::row_linear``), ``_lin`` itself otherwise."""
    return _lin(x, p) if group is None else row_linear(x, p, group)


def _block(lp: Dict[str, Any], cfg: ClipVisionConfig, x: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    hd = cfg.head_dim
    h = _ln(x, lp["layer_norm1"], cfg.layer_norm_eps)
    q = _lin(h, lp["q_proj"]).reshape(B, T, -1, hd)
    k = _lin(h, lp["k_proj"]).reshape(B, T, -1, hd)
    v = _lin(h, lp["v_proj"]).reshape(B, T, -1, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    probs = scaled_softmax_(logits, 1.0 / math.sqrt(hd))   # K4, over the logits
    attn = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, -1)
    x = x + _row(attn, lp["out_proj"], split_group(lp, "attn"))
    h2 = _ln(x, lp["layer_norm2"], cfg.layer_norm_eps)
    return x + _row(_act(_lin(h2, lp["fc1"]), cfg.hidden_act), lp["fc2"],
                    split_group(lp, "mlp"))


def clip_vision_features(
    params: Dict[str, Any],
    cfg: ClipVisionConfig,
    pixel_values: torch.Tensor,   # (B, H, W, 3) NHWC, CLIP-normalized
    feature_layer: int = -2,
    drop_cls: bool = True,
) -> torch.Tensor:
    """Hidden states at ``feature_layer`` (HF ``output_hidden_states``
    indexing: 0 is the embedding output, i the output of block i), computed
    in the parameters' dtype. Returns (B, num_patches[, +1], hidden): the
    class token's row is kept unless ``drop_cls`` (a SigLIP tower has
    none)."""
    B = pixel_values.shape[0]
    P = cfg.patch_size
    n = cfg.image_size // P
    x = pixel_values.to(params["patch_weight"].dtype)
    # a side that is no multiple of the patch (SigLIP's 384 px over 14 px
    # patches) loses its last pixels, as a stride-P convolution does
    x = x[:, :n * P, :n * P].reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, n * n, P * P * 3)
    patches = all_gather(x @ params["patch_weight"].T,   # (B, n*n, hidden); no bias
                         split_group(params, "patch"), -1)
    siglip = isinstance(cfg, SiglipVisionConfig)
    if siglip:
        h = patches + params["patch_bias"] + params["position_embedding"][None]
    else:
        cls = params["class_embedding"].expand(B, 1, cfg.hidden_size)
        h = torch.cat([cls, patches], dim=1) + params["position_embedding"][None]
        h = _ln(h, params["pre_layrnorm"], cfg.layer_norm_eps)
    stop = feature_layer % (cfg.num_hidden_layers + 1)
    for i in range(stop):
        h = _block(params["layers"][i], cfg, h)
    return h[:, 1:] if drop_cls and not siglip else h
