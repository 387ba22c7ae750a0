"""LLaMA decoder (counterpart of ``attwarp_tpu/models/llama.py``).

HF ``LlamaModel`` architecture: RMSNorm, rotary embeddings with
left-padding positions, grouped-query attention, SwiGLU MLP. Parameters are
the JAX tree's names, as tensors: ``embed_tokens``, ``norm``, ``lm_head`` and
``layers[i]`` with ``input_layernorm``, ``post_attention_layernorm`` and the
seven projection matrices ``(out, in)``.

``llama_prefill`` runs the dense prefill (JAX's default) or, with
``use_flash``, the flash prefill through kernel K2
(``kernels/flash_prefill.py``) under JAX's gate ``flash_prefill_supported``;
the extract layer's row then comes from the O(T) ``_last_row_probs``, so no
(T, T) matrix is built. Both are thin over ``decoder_prefill`` and
``decoder_decode_step``, which take the rotary cos/sin as given and so
serve Qwen2-VL's M-RoPE decoder too. ``llama_decode_step`` runs one token against
a dense or an int8 (``+kv8``) cache, at one position shared by the batch or
at each row's own position (the serving slots). With the int8 cache every
layer except the extract layer reads the cache through kernel K3
(``kernels/decode_attn.py``); the extract layer keeps the plain
``_attn_quantcache`` form because it needs the probabilities row.

The decode step writes the new token's K/V into the cache IN PLACE and then
reads the updated layer plane, which is a view and costs no copy. The JAX
step instead read the step-entry cache, merged the token inside the kernel
and appended every layer at the end (``make_decode_prep``, the ``prep=``
threading, ``append_decode_quant``): that order existed only because an XLA
custom call reading an updated buffer forced a copy, and is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8
from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill
from attwarp_tpu_torch.numerics.quant import apply_linear, lm_logits, quantize_kv


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # None -> MHA
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


class LlamaKVCache(NamedTuple):
    k: torch.Tensor  # (n_layers, B, max_seq, kv_heads, head_dim)
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(token, head) f32 scales
    (``numerics/quant.py::quantize_kv``)."""

    k_q: torch.Tensor  # int8 (n_layers, B, max_seq, kv_heads, head_dim)
    k_s: torch.Tensor  # f32  (n_layers, B, max_seq, kv_heads)
    v_q: torch.Tensor
    v_s: torch.Tensor


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int, dtype,
                  device) -> LlamaKVCache:
    shape = (cfg.num_hidden_layers, batch, max_seq, cfg.kv_heads, cfg.head_dim)
    return LlamaKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def init_quant_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                        device) -> QuantKVCache:
    shape = (cfg.num_hidden_layers, batch, max_seq, cfg.kv_heads, cfg.head_dim)

    def values():
        return torch.zeros(shape, dtype=torch.int8, device=device)

    def scales():
        return torch.zeros(shape[:-1], dtype=torch.float32, device=device)

    return QuantKVCache(values(), scales(), values(), scales())


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> (cos, sin) of shape (..., head_dim), f32 (HF
    layout: inv_freq over even indices, duplicated across both halves)."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=positions.device)
    freqs = positions[..., None].to(torch.float32) * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: (B, T, H, hd); cos, sin: (B, T, hd), cast to q's dtype."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, kv_heads, ...) -> (B, T, kv_heads*n_rep, ...)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def _attn(q, k, v, mask, cfg: LlamaConfig, want_probs: bool):
    """q (B,Tq,H,hd), k/v (B,Tk,kvH,hd), mask (B,Tq,Tk) bool. The q.k
    product rounds to q's dtype before the f32 softmax, as in JAX."""
    n_rep = cfg.num_attention_heads // cfg.kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits * (1.0 / math.sqrt(cfg.head_dim))
    logits = logits.masked_fill(~mask[:, None, :, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    B, Tq = out.shape[0], out.shape[1]
    return (out.reshape(B, Tq, cfg.hidden_size),
            probs[:, :, -1, :] if want_probs else None)


def _flash_kv_block(T: int, cap: int = 512) -> int:
    """Largest power-of-two divisor of the sequence length, capped (JAX's
    flash block rule, kept so both packages gate alike)."""
    b = 1
    while T % (b * 2) == 0 and (b * 2) <= cap:
        b *= 2
    return b


def flash_prefill_supported(T: int) -> bool:
    """JAX's gate, verbatim: flash engages from 256 tokens with a
    power-of-two block >= 64 dividing T; shorter prompts take the dense
    path. (Kernel K2 itself takes any T.)"""
    return T >= 256 and _flash_kv_block(T) >= 64


def _flash_attn(q, k, v, attention_mask, cfg):
    """Prefill attention through kernel K2: causal, left padding as
    segments, GQA by index. q (B,T,H,hd), k/v (B,T,kvH,hd) -> (B,T,D)."""
    return flash_prefill(q, k, v, attention_mask, 1.0 / math.sqrt(cfg.head_dim))


def _last_row_probs(q_last, k, mask_last, cfg):
    """Post-softmax attention of the last query position only: (B, H, T),
    O(B*H*T). q_last (B,H,hd), k (B,T,kvH,hd), mask_last (B,T) bool."""
    k = _repeat_kv(k, cfg.num_attention_heads // cfg.kv_heads)
    logits = torch.einsum("bhd,bkhd->bhk", q_last, k).to(torch.float32)
    logits = logits * (1.0 / math.sqrt(cfg.head_dim))
    logits = logits.masked_fill(~mask_last[:, None, :], torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1)


def _attn_quantcache(q, k_q, k_s, v_q, v_s, mask, cfg: LlamaConfig,
                     want_probs: bool):
    """Decode attention on one int8 cache plane with the scales factored out
    of the dots: ``scores = (q . k_q) * k_s``, ``out = (probs * v_s) .
    v_q``. q (B,1,H,hd); k_q/v_q (B,S,kvH,hd) int8; k_s/v_s (B,S,kvH) f32;
    mask (B,1,S) bool."""
    n_rep = cfg.num_attention_heads // cfg.kv_heads
    k_q = _repeat_kv(k_q, n_rep)
    v_q = _repeat_kv(v_q, n_rep)
    k_s = _repeat_kv(k_s, n_rep)                  # (B, S, H)
    v_s = _repeat_kv(v_s, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k_q.to(q.dtype))
    logits = logits.to(torch.float32) * k_s.permute(0, 2, 1)[:, :, None, :]
    logits = logits * (1.0 / math.sqrt(cfg.head_dim))
    logits = logits.masked_fill(~mask[:, None, :, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    pv = probs * v_s.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", pv.to(q.dtype), v_q.to(q.dtype))
    B, Tq = out.shape[0], out.shape[1]
    return (out.reshape(B, Tq, cfg.hidden_size),
            probs[:, :, -1, :] if want_probs else None)


def _mlp(lp: Dict[str, Any], cfg: LlamaConfig, x: torch.Tensor) -> torch.Tensor:
    h2 = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    return apply_linear(
        F.silu(apply_linear(h2, lp["gate_proj"])) * apply_linear(h2, lp["up_proj"]),
        lp["down_proj"],
    )


def layer_project(lp: Dict[str, Any], cfg: LlamaConfig, x):
    """A decoder layer's input norm and q/k/v projections of rows x
    (..., D), before rotary: (..., H*hd), (..., kvH*hd), (..., kvH*hd)."""
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    return tuple(apply_linear(h, lp[w]) for w in ("q_proj", "k_proj", "v_proj"))


def layer_residuals(lp: Dict[str, Any], cfg: LlamaConfig, x, attn):
    """A decoder layer after its attention: the o_proj and MLP residuals."""
    x = x + apply_linear(attn, lp["o_proj"])
    return x + _mlp(lp, cfg, x)


def final_logits(params: Dict[str, Any], cfg: LlamaConfig, x) -> torch.Tensor:
    """The final norm and the LM head of rows x (..., D): f32 logits."""
    return lm_logits(rms_norm(x, params["norm"], cfg.rms_norm_eps), params)


def _qkv(lp: Dict[str, Any], cfg: LlamaConfig, x, cos, sin):
    B, T, _ = x.shape
    q, k, v = layer_project(lp, cfg, x)
    q = q.reshape(B, T, cfg.num_attention_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


def _check_layer(extract_layer: Optional[int], cfg: LlamaConfig) -> None:
    if extract_layer is not None and not 0 <= extract_layer < cfg.num_hidden_layers:
        raise ValueError(f"extract_layer {extract_layer} out of range "
                         f"(no such decoder layer)")


def decoder_prefill(params, cfg, inputs_embeds, attention_mask, cos, sin,
                    max_seq: int, extract_layer: Optional[int] = None,
                    use_flash: bool = False, kv_quant: bool = False):
    """The prefill body of both families, given each position's rotary
    ``cos``/``sin`` (B, T, hd): LLaMA's from ``rope_cos_sin``, Qwen2-VL's
    from M-RoPE. Returns (last-position logits (B, vocab) f32, the KV cache
    allocated to ``max_seq`` slots, the extract layer's last-row
    probabilities (B, H, T) or None).

    ``use_flash`` takes kernel K2 where ``flash_prefill_supported`` says so;
    the row then comes from ``_last_row_probs`` (the causal mask's last row
    is ``attention_mask`` itself) and no (T, T) mask is built."""
    _check_layer(extract_layer, cfg)
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    flash = use_flash and flash_prefill_supported(T)
    if not flash:
        causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None]
        mask = causal & attention_mask[:, None, :]
    if kv_quant:
        cache = init_quant_kv_cache(cfg, B, max_seq, dev)
    else:
        cache = init_kv_cache(cfg, B, max_seq, inputs_embeds.dtype, dev)

    x = inputs_embeds
    row = None
    for i, lp in enumerate(params["layers"]):
        q, k, v = _qkv(lp, cfg, x, cos, sin)
        if flash:
            attn = _flash_attn(q, k, v, attention_mask, cfg)
            if i == extract_layer:
                row = _last_row_probs(q[:, -1], k, attention_mask, cfg)
        else:
            attn, r = _attn(q, k, v, mask, cfg, want_probs=(i == extract_layer))
            if r is not None:
                row = r
        if kv_quant:
            cache.k_q[i, :, :T], cache.k_s[i, :, :T] = quantize_kv(k)
            cache.v_q[i, :, :T], cache.v_s[i, :, :T] = quantize_kv(v)
        else:
            cache.k[i, :, :T] = k
            cache.v[i, :, :T] = v
        x = layer_residuals(lp, cfg, x, attn)
    return final_logits(params, cfg, x[:, -1]), cache, row


def llama_prefill(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,    # (B, T, D)
    attention_mask: torch.Tensor,   # (B, T) bool, False on left padding
    max_seq: int,
    extract_layer: Optional[int] = None,
    use_flash: bool = False,
    kv_quant: bool = False,
):
    """Full-prompt forward (``decoder_prefill`` with LLaMA's rotary
    positions). With ``kv_quant`` the cache is int8; the prefill's own
    attention still uses the exact keys and values, so its logits and row
    equal the dense-cache path's."""
    # HF left-padding convention: position ids count valid tokens
    positions = torch.clamp(torch.cumsum(attention_mask.to(torch.int64), dim=1) - 1, min=0)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return decoder_prefill(params, cfg, inputs_embeds, attention_mask, cos, sin,
                           max_seq, extract_layer, use_flash, kv_quant)


def append_token(kv, layer: int, at, k1: torch.Tensor, v1: torch.Tensor) -> None:
    """Write new keys and values ``(n, kvH, hd)`` into ``layer`` of the
    cache IN PLACE at ``at`` = (batch rows, positions), an index pair such
    as ``(:, 7)`` or ``(rows, cur_lens[rows])``; quantized per (token,
    head) on an int8 cache."""
    if isinstance(kv, QuantKVCache):
        kv.k_q[(layer, *at)], kv.k_s[(layer, *at)] = quantize_kv(k1)
        kv.v_q[(layer, *at)], kv.v_s[(layer, *at)] = quantize_kv(v1)
    else:
        kv.k[(layer, *at)] = k1
        kv.v[(layer, *at)] = v1


def attend_cache(kv, layer: int, q: torch.Tensor, kv_mask: torch.Tensor,
                 cfg) -> torch.Tensor:
    """One query per row (B, 1, H, hd) over cache plane ``layer`` where
    ``kv_mask`` (B, S) allows: kernel K3 on an int8 cache, ``_attn`` on a
    dense one. Returns (B, 1, hidden)."""
    if isinstance(kv, QuantKVCache):
        return decode_attn_int8(
            q[:, 0], kv.k_q, kv.k_s, kv.v_q, kv.v_s, kv_mask, layer=layer,
            sm_scale=1.0 / math.sqrt(cfg.head_dim),
        ).reshape(q.shape[0], 1, cfg.hidden_size)
    return _attn(q, kv.k[layer], kv.v[layer], kv_mask[:, None, :], cfg,
                 want_probs=False)[0]


def decoder_decode_step(params, cfg, token_embeds, kv, cur_len, cos, sin,
                        kv_mask, extract_layer: Optional[int] = None):
    """One token against the cache, given its rotary ``cos``/``sin``
    (B, 1, hd); the decode body of both families. Returns (logits (B, vocab)
    f32, the cache, the extract layer's probabilities row (B, H, max_seq) or
    None).

    ``cur_len`` is the cache position of the new token: one Python int for
    the whole batch (the generate loop), or a (B,) long tensor with each
    row's own position (the serving engines' slots). Each layer writes its
    new K/V there in place before it attends. On an int8 cache, every layer
    but ``extract_layer`` attends through kernel K3 over the whole cache
    with its layer index."""
    _check_layer(extract_layer, cfg)
    # one advanced-index write per cache tensor for per-slot positions (the
    # counterpart of JAX's serving/engine.py::_upd_slot)
    at = ((slice(None), cur_len) if isinstance(cur_len, int) else
          (torch.arange(token_embeds.shape[0], device=token_embeds.device), cur_len))
    x = token_embeds
    row = None
    for i, lp in enumerate(params["layers"]):
        q, k1, v1 = _qkv(lp, cfg, x, cos, sin)
        append_token(kv, i, at, k1[:, 0], v1[:, 0])
        if i != extract_layer:
            attn = attend_cache(kv, i, q, kv_mask, cfg)
        elif isinstance(kv, QuantKVCache):
            attn, row = _attn_quantcache(
                q, kv.k_q[i], kv.k_s[i], kv.v_q[i], kv.v_s[i],
                kv_mask[:, None, :], cfg, want_probs=True)
        else:
            attn, row = _attn(q, kv.k[i], kv.v[i], kv_mask[:, None, :], cfg,
                              want_probs=True)
        x = layer_residuals(lp, cfg, x, attn)
    return final_logits(params, cfg, x[:, 0]), kv, row


def llama_decode_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,     # (B, 1, D)
    kv,                             # LlamaKVCache | QuantKVCache, updated in place
    cur_len,                        # cache slot of the new token: int or (B,)
    positions: torch.Tensor,        # (B,) rope position of the new token
    kv_mask: torch.Tensor,          # (B, max_seq) bool incl. the new slot
    extract_layer: Optional[int] = None,
):
    """``decoder_decode_step`` at LLaMA's rotary ``positions``."""
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    return decoder_decode_step(params, cfg, token_embeds, kv, cur_len, cos, sin,
                               kv_mask, extract_layer)
