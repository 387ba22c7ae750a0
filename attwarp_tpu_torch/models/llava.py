"""LLaVA-1.5: CLIP tower -> MLP projector -> LLaMA (counterpart of
``attwarp_tpu/models/llava.py``).

Parameters are a plain tree of tensors with the JAX tree's layout and
names (``{"vision": ..., "projector": ..., "llama": ...}``):
``params_from_jax`` converts a JAX parameter tree (as numpy) and
``random_params`` makes random weights on the device from a seeded
``torch.Generator``.

``generate_with_attention`` is a Python decode loop with the JAX scan's
semantics: the same EOS/PAD rule, and the extract layer's row accumulated
at the prefill and at every decode step, finished rows included.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.extract.accumulator import accumulate_step, finalize, init_carry
from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig, clip_vision_features
from attwarp_tpu_torch.models.llama import LlamaConfig, llama_decode_step, llama_prefill


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


def encode_images(params, cfg: LlavaConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """CLIP-normalized (B, S, S, 3) -> projected (B, n_img, D_text)."""
    feats = clip_vision_features(params["vision"], cfg.vision, pixel_values,
                                 feature_layer=cfg.vision_feature_layer,
                                 drop_cls=True)
    p = params["projector"]
    h = _gelu(feats @ p["linear_1"]["weight"].T + p["linear_1"]["bias"],
              cfg.projector_act)
    return h @ p["linear_2"]["weight"].T + p["linear_2"]["bias"]


def embed_and_splice(params, cfg: LlavaConfig, input_ids: torch.Tensor,
                     pixel_values: torch.Tensor) -> torch.Tensor:
    """``input_ids`` (HF-expanded: ``num_image_tokens`` image-token ids per
    sample) -> embeddings with the image tokens replaced, in order, by the
    projected image features."""
    emb = params["llama"]["embed_tokens"][torch.clamp(input_ids, min=0)]
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

    def generate_with_attention(
        self,
        input_ids: torch.Tensor,       # (B, T) expanded, left-padded
        pixel_values: torch.Tensor,    # (B, S, S, 3) CLIP-normalized
        attention_mask: torch.Tensor,  # (B, T) bool
        img_start: torch.Tensor,       # (B,) image-token span starts
        extract_layer: Optional[int] = 20,
        max_new_tokens: int = 20,
        kv_quant: bool = False,
        use_flash: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Greedy decode. Returns (generated ids (B, max_new_tokens), maps
        (B, n, n) of the extract layer, or None when ``extract_layer`` is
        None: the answer-only path that builds no probabilities row).

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
        logits, kv, row0 = llama_prefill(
            params["llama"], tcfg, embeds, attention_mask, max_seq=max_seq,
            extract_layer=extract_layer, use_flash=use_flash, kv_quant=kv_quant,
        )
        del embeds
        carry = None if extract_layer is None else init_carry(
            B, n_img, device=input_ids.device)
        carry = acc(carry, row0)
        tok = torch.argmax(logits, dim=-1)
        finished = tok == cfg.eos_token_id
        lengths = torch.sum(attention_mask.to(torch.int64), dim=1)
        full_mask = F.pad(attention_mask, (0, max_seq - T))
        toks = []
        for step in range(max_new_tokens):
            cur_len = T + step
            full_mask[:, cur_len] = True
            emb = params["llama"]["embed_tokens"][tok][:, None, :]
            logits, kv, row = llama_decode_step(
                params["llama"], tcfg, emb, kv, cur_len, lengths + step,
                full_mask, extract_layer=extract_layer,
            )
            # every step's row counts, finished rows included (HF generate
            # keeps forwarding them; llava.py:384-411)
            carry = acc(carry, row)
            toks.append(tok)
            nxt = torch.argmax(logits, dim=-1)
            # finished rows continue with PAD, as HF generate does
            nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id), nxt)
            finished = finished | (nxt == cfg.eos_token_id)
            tok = nxt
        maps = None if carry is None else finalize(carry, side)
        return torch.stack(toks, dim=1), maps


def config_from_dict(d: Dict[str, Any]) -> LlavaConfig:
    """``dataclasses.asdict`` of a LLaVA config (the port's or JAX's, they
    are field for field the same) -> ``LlavaConfig``."""
    return LlavaConfig(vision=ClipVisionConfig(**d["vision"]), text=LlamaConfig(**d["text"]),
                       **{k: v for k, v in d.items() if k not in ("vision", "text")})


def params_from_jax(tree, device=None, dtype=None):
    """A JAX LLaVA parameter tree (dicts and lists of arrays, e.g. after
    ``jax.device_get``) -> the same tree of tensors on ``device``, cast to
    ``dtype`` if given."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device, dtype) for v in tree]
    t = torch.tensor(np.asarray(tree, dtype=np.float32))
    return t.to(device=device, dtype=dtype or torch.float32)


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
