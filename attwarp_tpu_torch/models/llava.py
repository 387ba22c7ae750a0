"""LLaVA-1.5: CLIP tower -> MLP projector -> LLaMA (counterpart of
``attwarp_tpu/models/llava.py``).

Parameters are a plain tree of tensors with the JAX tree's layout and
names (``{"vision": ..., "projector": ..., "llama": ...}``):
``params_from_jax`` converts a JAX parameter tree (as numpy),
``port_hf_llava_weights`` an HF state dict, and ``random_params`` makes
random weights on the device from a seeded ``torch.Generator``.

``generate_with_attention`` is a Python decode loop with the JAX scan's
semantics: the same EOS/PAD rule, and each extract layer's row accumulated
at the prefill and at every decode step, finished rows included.
``extract_layer`` is None (answer only), one layer, or a sequence of layers
extracted in the same pass (``models/llama.py::extract_layers_tuple``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.extract.accumulator import accumulate_step, finalize, init_layer_carry
from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig, clip_vision_features
from attwarp_tpu_torch.models.llama import (
    ExtractSpec,
    LlamaConfig,
    embed,
    leased_kv_cache,
    llama_decode_step,
    llama_prefill,
    local_kv_heads,
)
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


class LlavaModel:
    """Config plus parameter tree, with the generate loop."""

    def __init__(self, cfg: LlavaConfig, params: Dict[str, Any]):
        self.cfg = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.params["llama"]["embed_tokens"].device

    def forward_logits(self, input_ids: torch.Tensor, pixel_values: torch.Tensor,
                       attention_mask: Optional[torch.Tensor] = None,
                       extract_layer: ExtractSpec = None, use_flash: bool = False):
        """One prefill: (last-position logits (B, vocab) f32, the extract
        rows: (B, H, T) for a layer, (L, B, H, T) for a sequence, or
        None)."""
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.bool,
                                        device=input_ids.device)
        embeds = embed_and_splice(self.params, self.cfg, input_ids, pixel_values)
        logits, _, row = llama_prefill(self.params["llama"], self.cfg.text, embeds,
                                       attention_mask, max_seq=input_ids.shape[1],
                                       extract_layer=extract_layer, use_flash=use_flash)
        return logits, row

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
        """Greedy decode. Returns (generated ids (B, max_new_tokens), maps):
        (B, n, n) for one extract layer, (L, B, n, n) for a sequence of
        layers (one accumulator each, in the spec's order), None when
        ``extract_layer`` is None: the answer-only path that builds no
        probabilities row. At ``max_new_tokens=0`` the maps are the
        prefill's rows alone and no decode step runs.

        ``kv_quant`` keeps the cache in int8, rounded up to a multiple of 64
        slots as in JAX (the extra slots stay masked). ``use_flash`` runs
        the prefill through kernel K2 (``llama_prefill``)."""
        cfg, tcfg, params = self.cfg, self.cfg.text, self.params
        B, T = input_ids.shape
        max_seq = T + max_new_tokens
        if kv_quant:
            max_seq = -(-max_seq // 64) * 64
        n_img = cfg.num_image_tokens
        side = int(math.isqrt(n_img))
        ones = torch.ones((B,), dtype=torch.float32, device=input_ids.device)

        def acc(carry, row):
            if carry is None:
                return None
            return accumulate_step(carry, row, img_start, ones, n_img)

        embeds = embed_and_splice(params, cfg, input_ids, pixel_values)
        # the cache comes from the pool, so the decode steps replay CUDA graphs
        with leased_kv_cache(tcfg, B, max_seq, embeds.device,
                             local_kv_heads(params["llama"], tcfg),
                             None if kv_quant else embeds.dtype) as kv:
            logits, kv, row0 = llama_prefill(
                params["llama"], tcfg, embeds, attention_mask, max_seq=max_seq,
                extract_layer=extract_layer, use_flash=use_flash, kv_quant=kv_quant,
                cache=kv,
            )
            del embeds
            carry = init_layer_carry(extract_layer, B, n_img, input_ids.device)
            carry = acc(carry, row0)
            tok = torch.argmax(logits, dim=-1)
            finished = tok == cfg.eos_token_id
            lengths = torch.sum(attention_mask.to(torch.int64), dim=1)
            full_mask = F.pad(attention_mask, (0, max_seq - T))
            toks = [tok.new_empty((B, 0))]
            for step in range(max_new_tokens):
                profiling.count("decode_steps")
                with profiling.span("decode_step"):
                    cur_len = T + step
                    full_mask[:, cur_len] = True
                    emb = embed(params["llama"], tok)[:, None, :]
                    logits, kv, row = llama_decode_step(
                        params["llama"], tcfg, emb, kv, cur_len, lengths + step,
                        full_mask, extract_layer=extract_layer,
                    )
                    # every step's row counts, finished rows included (HF generate
                    # keeps forwarding them; llava.py:384-411)
                    carry = acc(carry, row)
                    toks.append(tok[:, None])
                    nxt = torch.argmax(logits, dim=-1)
                    # finished rows continue with PAD, as HF generate does
                    nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id), nxt)
                    finished = finished | (nxt == cfg.eos_token_id)
                    tok = nxt
        maps = None if carry is None else finalize(carry, side)
        return torch.cat(toks, dim=1), maps


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
