"""LLaVA-1.5: CLIP tower -> MLP projector -> LLaMA (counterpart of
``attwarp_tpu/models/llava.py``).

Parameters are a plain tree of tensors with the JAX tree's layout and
names (``{"vision": ..., "projector": ..., "llama": ...}``):
``params_from_jax`` converts a JAX parameter tree (as numpy),
``port_hf_llava_weights`` an HF state dict, and ``random_params`` makes
random weights on the device from a seeded ``torch.Generator``.

``LlavaModel`` fills in the family seam of ``models/mllm.py``, whose
generate loop ``generate_with_attention`` runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig, clip_vision_features
from attwarp_tpu_torch.models.llama import ExtractSpec, LlamaConfig, embed, rope_cos_sin
from attwarp_tpu_torch.models.mllm import MLLM
from attwarp_tpu_torch.numerics.quant import is_quantized, row_linear
from attwarp_tpu_torch.parallel.comm import split_group
from attwarp_tpu_torch.utils import profiling


@dataclass(frozen=True)
class LlavaConfig:
    vision: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    text: LlamaConfig = field(default_factory=LlamaConfig)
    vision_feature_layer: int = -2
    projector_act: str = "gelu"
    image_token_index: int = 32000
    pad_token_id: int = 2
    eos_token_id: int = 2

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches


def _gelu(x: torch.Tensor, name: str) -> torch.Tensor:
    return F.gelu(x, approximate="none" if name == "gelu" else "tanh")


@profiling.span("vision")
def encode_images(params, cfg: LlavaConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """CLIP-normalized (B, S, S, 3) -> projected (B, n_img, D_text)."""
    feats = clip_vision_features(params["vision"], cfg.vision, pixel_values,
                                 feature_layer=cfg.vision_feature_layer,
                                 drop_cls=True)
    p = params["projector"]
    h = _gelu(feats @ p["linear_1"]["weight"].T + p["linear_1"]["bias"],
              cfg.projector_act)
    group = split_group(p, "mlp")
    if group is None:
        return h @ p["linear_2"]["weight"].T + p["linear_2"]["bias"]
    return row_linear(h, p["linear_2"], group)


def embed_and_splice(params, cfg: LlavaConfig, input_ids: torch.Tensor,
                     pixel_values: torch.Tensor) -> torch.Tensor:
    """``input_ids`` (HF-expanded: ``num_image_tokens`` image-token ids per
    sample) -> embeddings with the image tokens replaced, in order, by the
    projected image features."""
    emb = embed(params["llama"], torch.clamp(input_ids, min=0))
    img = encode_images(params, cfg, pixel_values).to(emb.dtype)   # (B, N, D)
    is_img = input_ids == cfg.image_token_index
    order = torch.clamp(torch.cumsum(is_img.to(torch.int64), dim=1) - 1,
                        0, img.shape[1] - 1)
    img_at = torch.gather(img, 1, order[..., None].expand(-1, -1, img.shape[2]))
    return torch.where(is_img[..., None], img_at, emb)


class LlavaModel(MLLM):
    """Config plus parameter tree: ``models/mllm.py``'s generate loop over
    LLaVA's seam. The prompt's positions count its valid tokens (HF's
    left-padding convention), so a row's rotary offset is minus its left
    pad; the map is the square of the CLIP tower's patches."""

    @property
    def text_params(self) -> Dict[str, Any]:
        return self.params["llama"]

    def prompt(self, ids: torch.Tensor, mask: torch.Tensor, image, host):
        """(embeddings, cos, sin, offset) of a left-padded prompt, the
        projected CLIP features of ``image`` (CLIP-normalized (B, S, S, 3),
        or None) spliced in (``models/mllm.py`` has the contract)."""
        tcfg = self.cfg.text
        embeds = (embed_and_splice(self.params, self.cfg, ids, image) if image is not None
                  else embed(self.text_params, ids))
        # HF left-padding convention: position ids count valid tokens
        positions = torch.clamp(torch.cumsum(mask.to(torch.int64), dim=1) - 1, min=0)
        cos, sin = rope_cos_sin(positions, tcfg.head_dim, tcfg.rope_theta)
        valid = mask if host is None else host[1]
        return embeds, cos, sin, valid.sum(1) - ids.shape[1]

    def decode_rope(self, positions: torch.Tensor):
        return rope_cos_sin(positions[:, None], self.cfg.text.head_dim, self.cfg.text.rope_theta)

    def map_shape(self, image) -> Tuple[int, int]:
        side = int(math.isqrt(self.cfg.num_image_tokens))
        return side, side

    def image_input(self, pixels: torch.Tensor) -> torch.Tensor:
        return pixels

    def forward_logits(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None,
                       extract_layer: ExtractSpec = None, use_flash: bool = False):
        """One prefill: (last-position logits (B, vocab) f32, the extract
        rows: (B, H, T) for a layer, (L, B, H, T) for a sequence, or
        None)."""
        return self._forward_logits(input_ids, attention_mask, pixel_values,
                                    extract_layer, use_flash)

    def generate_with_attention(
        self,
        input_ids: torch.Tensor,       # (B, T) expanded, left-padded
        pixel_values: torch.Tensor,    # (B, S, S, 3) CLIP-normalized
        attention_mask: torch.Tensor,  # (B, T) bool
        img_start: torch.Tensor,       # (B,) image-token span starts
        extract_layer: ExtractSpec = 20,
        max_new_tokens: int = 20,
        kv_quant: bool = False,
        use_flash: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Greedy decode (``MLLM._generate``). Returns (generated ids (B,
        max_new_tokens), maps): (B, n, n) for one extract layer, (L, B, n,
        n) for a sequence of layers, None when ``extract_layer`` is None.
        Decode step s of row b is at rotary position ``lengths[b] + s``,
        its count of valid prompt tokens plus s."""
        return self._generate(input_ids, attention_mask, pixel_values, img_start,
                              extract_layer, max_new_tokens, kv_quant, use_flash)


def config_from_dict(d: Dict[str, Any]) -> LlavaConfig:
    """``dataclasses.asdict`` of a LLaVA config (the port's or JAX's, they
    are field for field the same) -> ``LlavaConfig``."""
    return LlavaConfig(vision=ClipVisionConfig(**d["vision"]), text=LlamaConfig(**d["text"]),
                       **{k: v for k, v in d.items() if k not in ("vision", "text")})


def params_from_jax(tree, device=None, dtype=None):
    """A JAX LLaVA parameter tree (dicts and lists of arrays, e.g. after
    ``jax.device_get``) -> the same tree of tensors on ``device``, cast to
    ``dtype`` if given. An int8 linear (``{"q", "s"[, "b"]}``, from
    ``quantize_decoder_params`` or ``quantize_lm_head``) keeps its form:
    ``q`` stays int8, ``s`` and ``b`` f32 whatever ``dtype`` is."""
    if is_quantized(tree):
        return {k: torch.tensor(np.asarray(v, np.int8 if k == "q" else np.float32),
                                device=device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    t = torch.tensor(np.asarray(tree, dtype=np.float32))
    return t.to(device=device, dtype=dtype or torch.float32)


def _strip_prefix(key: str) -> str:
    """Both HF key layouts -> the classic one: ``model.language_model.X`` ->
    ``language_model.model.X``, ``model.vision_tower.X`` ->
    ``vision_tower.X``, ``model.multi_modal_projector.X`` ->
    ``multi_modal_projector.X`` (transformers >= 4.52); classic keys pass."""
    if key.startswith("model.language_model."):
        return "language_model.model." + key[len("model.language_model."):]
    if key.startswith(("model.vision_tower.", "model.multi_modal_projector.")):
        return key[len("model."):]
    return key


def port_hf_llava_weights(state_dict: Dict[str, torch.Tensor], cfg: LlavaConfig,
                          device=None, dtype=torch.float32) -> Dict[str, Any]:
    """An HF ``LlavaForConditionalGeneration`` state dict (either key
    layout) -> the port's parameter tree, every tensor cast to ``dtype`` on
    ``device`` straight from the state dict's tensors. The patch conv
    ``(hidden, 3, P, P)`` is reordered to the unfold layout ``(hidden,
    P*P*3)``, as the JAX port does."""
    sd = {_strip_prefix(k): v for k, v in state_dict.items()}

    def get(key):
        return sd[key].detach().to(device=device, dtype=dtype)

    def wb(prefix):
        return {"weight": get(prefix + ".weight"), "bias": get(prefix + ".bias")}

    vt = "vision_tower.vision_model."
    pw = sd[vt + "embeddings.patch_embedding.weight"]
    vision = {
        "patch_weight": pw.detach().permute(0, 2, 3, 1).reshape(pw.shape[0], -1)
                          .to(device=device, dtype=dtype),
        "class_embedding": get(vt + "embeddings.class_embedding"),
        "position_embedding": get(vt + "embeddings.position_embedding.weight"),
        "pre_layrnorm": wb(vt + "pre_layrnorm"),
        "layers": [
            {
                "layer_norm1": wb(f"{vt}encoder.layers.{i}.layer_norm1"),
                "layer_norm2": wb(f"{vt}encoder.layers.{i}.layer_norm2"),
                **{k: wb(f"{vt}encoder.layers.{i}.self_attn.{k}")
                   for k in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "fc1": wb(f"{vt}encoder.layers.{i}.mlp.fc1"),
                "fc2": wb(f"{vt}encoder.layers.{i}.mlp.fc2"),
            }
            for i in range(cfg.vision.num_hidden_layers)
        ],
    }
    projector = {k: wb(f"multi_modal_projector.{k}") for k in ("linear_1", "linear_2")}
    lm = "language_model.model."
    llama = {
        "embed_tokens": get(lm + "embed_tokens.weight"),
        "norm": get(lm + "norm.weight"),
        "layers": [
            {
                "input_layernorm": get(f"{lm}layers.{i}.input_layernorm.weight"),
                "post_attention_layernorm": get(
                    f"{lm}layers.{i}.post_attention_layernorm.weight"),
                **{k: get(f"{lm}layers.{i}.self_attn.{k}.weight")
                   for k in ("q_proj", "k_proj", "v_proj", "o_proj")},
                **{k: get(f"{lm}layers.{i}.mlp.{k}.weight")
                   for k in ("gate_proj", "up_proj", "down_proj")},
            }
            for i in range(cfg.text.num_hidden_layers)
        ],
    }
    for key in ("language_model.lm_head.weight", "lm_head.weight"):
        if key in sd:
            llama["lm_head"] = get(key)
            break
    return {"vision": vision, "projector": projector, "llama": llama}


def random_params(cfg: LlavaConfig, generator: torch.Generator, device,
                  dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random LLaVA weights made on ``device`` from ``generator`` (which
    must live on that device): normal(0, 0.02) matrices and embeddings, unit
    norms and zero biases — the init of
    ``__graft_entry__.py::_random_llava_params``."""
    v, t = cfg.vision, cfg.text

    def r(*shape):
        x = torch.randn(shape, generator=generator, device=device, dtype=dtype)
        return x.mul_(0.02)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def lin(n_out, n_in):
        return {"weight": r(n_out, n_in), "bias": zeros(n_out)}

    def ln(n):
        return {"weight": ones(n), "bias": zeros(n)}

    D, Dv = t.hidden_size, v.hidden_size
    return {
        "vision": {
            "patch_weight": r(Dv, v.patch_size * v.patch_size * 3),
            "class_embedding": r(Dv),
            "position_embedding": r(v.num_patches + 1, Dv),
            "pre_layrnorm": ln(Dv),
            "layers": [
                {
                    "layer_norm1": ln(Dv),
                    "layer_norm2": ln(Dv),
                    "q_proj": lin(Dv, Dv),
                    "k_proj": lin(Dv, Dv),
                    "v_proj": lin(Dv, Dv),
                    "out_proj": lin(Dv, Dv),
                    "fc1": lin(v.intermediate_size, Dv),
                    "fc2": lin(Dv, v.intermediate_size),
                }
                for _ in range(v.num_hidden_layers)
            ],
        },
        "projector": {"linear_1": lin(D, Dv), "linear_2": lin(D, D)},
        "llama": {
            "embed_tokens": r(t.vocab_size, D),
            "norm": ones(D),
            "lm_head": r(t.vocab_size, D),
            "layers": [
                {
                    "input_layernorm": ones(D),
                    "post_attention_layernorm": ones(D),
                    "q_proj": r(D, D),
                    "k_proj": r(t.kv_heads * t.head_dim, D),
                    "v_proj": r(t.kv_heads * t.head_dim, D),
                    "o_proj": r(D, D),
                    "gate_proj": r(t.intermediate_size, D),
                    "up_proj": r(t.intermediate_size, D),
                    "down_proj": r(D, t.intermediate_size),
                }
                for _ in range(t.num_hidden_layers)
            ],
        },
    }
