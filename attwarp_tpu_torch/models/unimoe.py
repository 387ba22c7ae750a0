"""Uni-MoE-2.0-Omni for one image a sample (HF ``grin_qwen2_vl``,
https://huggingface.co/HIT-TMG/Uni-MoE-2.0-Omni).

- **Vision**: a SigLIP-so400m-patch14-384 tower (``models/clip_vit.py``
  under a ``SiglipVisionConfig``; 27 x 27 patches, features of the block
  before the last, no post-layernorm) and the linear aligner into the text
  width: 729 image tokens a 384 px image.
- **Text**: Qwen2-VL-7B's decoder (GQA 28/4, q/k/v biases, M-RoPE) with
  every FFN a dynamic-capacity mixture of experts (``models/moe.py``: Top-P
  routing over the routed experts and a null expert, the shared experts on
  every token). Prefill and the decode step are ``models/llama.py``'s, so
  K2, K3 and the decode graphs run as for Qwen2-VL; the expert layer is
  reached from the decoder's FFN.

The model is ``models/qwen2vl.py``'s ``Qwen2VLModel`` with this tower in
place of Qwen's: its prompt layout, M-RoPE positions (the image's grid with
no merge), splice and generate loop are Qwen2-VL's. The audio tower
(Whisper) and the speech generator are not on an image path and are left
out. ``UniMoEModel`` attaches a ``moe.MoETally`` to the decoder (``tally``)
and holds the router in float32 (``fp32_gate``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from attwarp_tpu_torch.models.clip_vit import SiglipVisionConfig, clip_vision_features
from attwarp_tpu_torch.models.moe import MoEConfig, MoETally
from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel, Qwen2VLTextConfig
from attwarp_tpu_torch.utils import profiling

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class UniMoETextConfig(Qwen2VLTextConfig):
    moe: MoEConfig = field(default_factory=MoEConfig)


@dataclass(frozen=True)
class UniMoEConfig:
    vision: SiglipVisionConfig = field(default_factory=SiglipVisionConfig)
    text: UniMoETextConfig = field(default_factory=UniMoETextConfig)
    vision_feature_layer: int = -2
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    pad_token_id: int = 151643
    eos_token_id: int = 151645


@profiling.span("vision")
def unimoe_vision_features(params: Dict[str, Any], cfg: UniMoEConfig,
                           pixels: torch.Tensor) -> torch.Tensor:
    """SigLIP-normalized pixels (B, S, S, 3) -> aligned image features
    (B, (S / patch)^2, text width)."""
    feats = clip_vision_features(params["vision"], cfg.vision, pixels,
                                 feature_layer=cfg.vision_feature_layer)
    a = params["aligner"]
    return F.linear(feats, a["weight"], a["bias"])


class UniMoEModel(Qwen2VLModel):
    """Config plus parameter tree, with Qwen2-VL's seam (``models/mllm.py``)
    over this tower. The tree is ``{"vision": SigLIP tower, "aligner":
    {"weight", "bias"}, "text": Qwen2-VL's decoder with a ``"moe"`` tree a
    layer in place of the MLP}``; building the model sets each router to
    float32 and attaches ``tally``, in place."""

    def __init__(self, cfg: UniMoEConfig, params: Dict[str, Any]):
        super().__init__(cfg, params)
        layers = params["text"]["layers"]
        for lp in layers:
            lp["moe"]["router"] = lp["moe"]["router"].to(torch.float32)
        self.tally = MoETally(len(layers), cfg.text.moe, self.device).attach(layers)

    @property
    def merge(self) -> int:
        return 1

    def image_features(self, pixels: torch.Tensor,
                       grid_thw: Tuple[int, int, int]) -> torch.Tensor:
        """The tower over SigLIP-normalized pixels: (B, S, S, 3) -> (B, n,
        D); one image shared by the batch, (S, S, 3), -> (n, D)."""
        if pixels.ndim == 3:
            return unimoe_vision_features(self.params, self.cfg, pixels[None])[0]
        return unimoe_vision_features(self.params, self.cfg, pixels)

    def image_input(self, pixels: torch.Tensor):
        """The tower takes the pixels themselves; the grid is the patches'."""
        n = pixels.shape[-2] // self.cfg.vision.patch_size
        return pixels, (1, n, n)


def random_params(cfg: UniMoEConfig, generator: torch.Generator, device,
                  dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random weights made on ``device`` from ``generator`` (on that
    device), scaled as ``qwen2vl.random_params``: normal / sqrt(fan_in)
    matrices, normal * 0.02 embeddings, positions and LM head, unit norms,
    zero biases."""
    v, t = cfg.vision, cfg.text
    m = t.moe

    def randn(*shape, std):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype).mul_(std)

    def mat(*shape):
        return randn(*shape, std=1.0 / math.sqrt(shape[-1]))

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def lin(n_out, n_in):
        return {"weight": mat(n_out, n_in), "bias": zeros(n_out)}

    def ln(n):
        return {"weight": ones(n), "bias": zeros(n)}

    E, Fv, D = v.hidden_size, v.intermediate_size, t.hidden_size
    kvd = t.kv_heads * t.head_dim
    return {
        "vision": {
            "patch_weight": mat(E, v.patch_size ** 2 * 3),
            "patch_bias": zeros(E),
            "position_embedding": randn(v.num_patches, E, std=0.02),
            "layers": [
                {"layer_norm1": ln(E), "layer_norm2": ln(E),
                 **{k: lin(E, E) for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
                 "fc1": lin(Fv, E), "fc2": lin(E, Fv)}
                for _ in range(v.num_hidden_layers)
            ],
        },
        "aligner": lin(D, E),
        "text": {
            "embed_tokens": randn(t.vocab_size, D, std=0.02),
            "lm_head": randn(t.vocab_size, D, std=0.02),
            "norm": ones(D),
            "layers": [
                {
                    "input_layernorm": ones(D),
                    "post_attention_layernorm": ones(D),
                    "q_proj": lin(D, D),
                    "k_proj": lin(kvd, D),
                    "v_proj": lin(kvd, D),
                    "o_proj": mat(D, D),
                    "moe": {
                        "router": mat(m.routed + m.null, D),
                        "gate_up": mat(m.routed, 2 * m.routed_width, D),
                        "down": mat(m.routed, D, m.routed_width),
                        "shared_gate_up": mat(m.shared, 2 * m.shared_width, D),
                        "shared_down": mat(m.shared, D, m.shared_width),
                    },
                }
                for _ in range(t.num_hidden_layers)
            ],
        },
    }
