"""Kernel K4's CPU route (``kernels/attn_softmax.py``) and its call sites.

On a CPU tensor ``scaled_softmax_`` is its plain version copied over the
logits, which must be today's expression bit for bit: the towers' parity
with the JAX package rests on it. Each tower calls it once per block (and
per image in Qwen2-VL's), as ``k4.calls`` counts. K4 itself runs on the
card only (``tests/test_torch_kernels_cuda.py``).
"""

import math

import pytest
import torch

from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_
from attwarp_tpu_torch.models import qwen2vl
from attwarp_tpu_torch.models.clip_vit import (
    ClipVisionConfig,
    SiglipVisionConfig,
    clip_vision_features,
)
from attwarp_tpu_torch.utils import profiling


@pytest.mark.parametrize("scale", [1.0 / math.sqrt(80), 0.125], ids=["hd80", "hd64"])
@pytest.mark.parametrize("L", [577, 729, 2304])
def test_plain_route_is_todays_softmax_in_place(L, scale):
    g = torch.Generator().manual_seed(L)
    x = (torch.randn((2, 3, L), generator=g) * 30.0 / scale).to(torch.bfloat16)
    want = torch.softmax(x.float() * scale, -1).to(torch.bfloat16)
    out = scaled_softmax_(x, scale)
    assert out is x
    assert torch.equal(out, want)


def _clip_tree(cfg, siglip, g):
    D, F = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return torch.randn(shape, generator=g) * 0.02

    def lin(n_out, n_in):
        return {"weight": r(n_out, n_in), "bias": r(n_out)}

    def ln(n):
        return {"weight": 1.0 + r(n), "bias": r(n)}

    tree = {"patch_weight": r(D, cfg.patch_size ** 2 * 3),
            "layers": [{"layer_norm1": ln(D), "layer_norm2": ln(D),
                        **{k: lin(D, D) for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
                        "fc1": lin(F, D), "fc2": lin(D, F)}
                       for _ in range(cfg.num_hidden_layers)]}
    if siglip:
        tree.update(patch_bias=r(D), position_embedding=r(cfg.num_patches, D))
    else:
        tree.update(class_embedding=r(D), position_embedding=r(cfg.num_patches + 1, D),
                    pre_layrnorm=ln(D))
    return tree


def _qwen_tower(B, g):
    cfg = qwen2vl.Qwen2VLConfig(
        vision=qwen2vl.Qwen2VLVisionConfig(depth=3, embed_dim=32, hidden_size=64,
                                           num_heads=2, mlp_ratio=2),
        text=qwen2vl.Qwen2VLTextConfig(vocab_size=32, hidden_size=64, intermediate_size=64,
                                       num_hidden_layers=1, num_attention_heads=2,
                                       num_key_value_heads=1))
    v = cfg.vision
    params = qwen2vl.random_params(cfg, g, "cpu", torch.float32)["vision"]
    patches = torch.randn((B, 16, v.in_channels * v.temporal_patch_size * v.patch_size ** 2),
                          generator=g)
    return lambda: qwen2vl.qwen2vl_vision_features(params, v, patches, (4, 4)), v.depth * B


def _clip_family_tower(siglip, B, g):
    kind = SiglipVisionConfig if siglip else ClipVisionConfig
    cfg = kind(hidden_size=32, intermediate_size=64, num_hidden_layers=4,
               num_attention_heads=2, image_size=42, patch_size=14)
    params = _clip_tree(cfg, siglip, g)
    px = torch.randn((B, 42, 42, 3), generator=g)
    # feature_layer -2 runs all blocks but the last
    return lambda: clip_vision_features(params, cfg, px, feature_layer=-2), 3


@pytest.mark.parametrize("tower", ["qwen2vl", "clip", "siglip"])
def test_each_tower_calls_k4_once_a_block(tower):
    g = torch.Generator().manual_seed(0)
    B = 3
    run, want = (_qwen_tower(B, g) if tower == "qwen2vl"
                 else _clip_family_tower(tower == "siglip", B, g))
    with profiling.tracing() as rec:
        out = run()
    assert torch.isfinite(out).all()
    assert rec.counters["k4.calls"] == want
