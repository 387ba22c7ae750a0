"""LLaMA decoder (counterpart of ``attwarp_tpu/models/llama.py``).

HF ``LlamaModel`` architecture: RMSNorm, rotary embeddings with
left-padding positions, grouped-query attention, SwiGLU MLP (or, in a layer
whose tree holds ``"moe"``, the routed experts of ``models/moe.py``, in
prefill and in the decode step alike). Parameters are
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
layer that ``extract_layer`` does not list reads the cache through kernel
K3 (``kernels/decode_attn.py``); a listed layer keeps the plain
``_attn_quantcache`` form because it needs the probabilities row. On the
card every layer writes the new token into an int8 cache through kernel K5
(``kernels/rope_append.py``: the rotary, the quantization and the write).
``extract_layer`` is None, a layer or a sequence of layers
(``extract_layers_tuple``), whose rows come back stacked in its order.

The decode step is written as ``decode_segment``s, split at the attention
call of every layer that ``extract_layer`` does not list. On the card, over
a cache leased from the pool (``lease_kv_cache``, as the generate loop of
``models/mllm.py`` and the serving engine take theirs), the segments are replayed from CUDA graphs
and K3 runs eagerly between them (``models/decode_graph.py``); elsewhere
the same segments run eagerly.

A tensor-parallel rank's tree (``parallel/llava_sharding.py``) carries a
``parallel/comm.py::ModelShard`` under ``"tp"``: the head counts come from
the tensors, the cache holds the rank's kv heads (``local_kv_heads``), the
attention and MLP outputs are summed over the ``model`` axis
(``numerics/quant.py::row_linear``), ``embed`` looks the vocabulary up per
shard and the extract rows and logits are gathered. A tree without it runs
with no collective.

The decode step writes the new token's K/V into the cache IN PLACE and then
reads the updated layer plane, which is a view and costs no copy. The JAX
step instead read the step-entry cache, merged the token inside the kernel
and appended every layer at the end (``make_decode_prep``, the ``prep=``
threading, ``append_decode_quant``): that order existed only because an XLA
custom call reading an updated buffer forced a copy, and is not ported.
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8
from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill
from attwarp_tpu_torch.kernels.rope_append import rope_append_int8
from attwarp_tpu_torch.models import decode_graph, moe
from attwarp_tpu_torch.numerics.quant import apply_linear, lm_logits, quantize_kv, row_linear
from attwarp_tpu_torch.parallel.comm import all_gather, all_reduce, split_group
from attwarp_tpu_torch.utils import profiling


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


def local_kv_heads(params: Dict[str, Any], cfg: LlamaConfig) -> int:
    """The kv heads a decoder tree holds: all of them, or on a
    tensor-parallel rank the ones its query heads read."""
    shard = params.get("tp")
    return cfg.kv_heads if shard is None else shard.kv_heads


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int, dtype,
                  device, kv_heads: Optional[int] = None) -> LlamaKVCache:
    shape = (cfg.num_hidden_layers, batch, max_seq, kv_heads or cfg.kv_heads, cfg.head_dim)
    return LlamaKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def init_quant_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int,
                        device, kv_heads: Optional[int] = None) -> QuantKVCache:
    shape = (cfg.num_hidden_layers, batch, max_seq, kv_heads or cfg.kv_heads, cfg.head_dim)

    def values():
        return torch.zeros(shape, dtype=torch.int8, device=device)

    def scales():
        return torch.zeros(shape[:-1], dtype=torch.float32, device=device)

    return QuantKVCache(values(), scales(), values(), scales())


def lease_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int, device, kv_heads: int,
                   dtype=None):
    """A zeroed cache from the pool (``models/decode_graph.py::KV_POOL``):
    int8 where ``dtype`` is None, else dense in ``dtype``. Its owner gives
    it back with ``release_kv_cache``; a decode step over a leased cache on
    the card replays CUDA graphs."""
    device = torch.device(device)
    key = ("int8" if dtype is None else dtype, cfg.num_hidden_layers, batch, max_seq,
           kv_heads, cfg.head_dim, device)
    make = (functools.partial(init_quant_kv_cache, cfg, batch, max_seq, device, kv_heads)
            if dtype is None else
            functools.partial(init_kv_cache, cfg, batch, max_seq, dtype, device, kv_heads))
    return decode_graph.KV_POOL.lease(key, make)


def release_kv_cache(kv) -> None:
    """Give a leased cache back to the pool (a no-op for any other)."""
    decode_graph.KV_POOL.release(kv)


@contextlib.contextmanager
def leased_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int, device, kv_heads: int,
                    dtype=None) -> Iterator[Any]:
    """``lease_kv_cache`` for the body, released at its end."""
    kv = lease_kv_cache(cfg, batch, max_seq, device, kv_heads, dtype)
    try:
        yield kv
    finally:
        release_kv_cache(kv)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


@functools.lru_cache(maxsize=None)
def rope_inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """HF's rotary ``inv_freq`` (f32, over the even indices), made on
    ``device`` once per (head_dim, theta, device): a decode step then copies
    nothing from the host."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    return torch.as_tensor(inv_freq, dtype=torch.float32, device=device)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> (cos, sin) of shape (..., head_dim), f32 (HF
    layout: inv_freq over even indices, duplicated across both halves)."""
    inv = rope_inv_freq(head_dim, theta, positions.device)
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
    product rounds to q's dtype before the f32 softmax, as in JAX. The head
    counts are the tensors' (a tensor-parallel rank's are its own)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits * (1.0 / math.sqrt(cfg.head_dim))
    logits = logits.masked_fill(~mask[:, None, :, :],
                                torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    B, Tq = out.shape[0], out.shape[1]
    return (out.reshape(B, Tq, -1),
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
    k = _repeat_kv(k, q_last.shape[1] // k.shape[2])
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
    n_rep = q.shape[2] // k_q.shape[2]
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
    return (out.reshape(B, Tq, -1),
            probs[:, :, -1, :] if want_probs else None)


def _mlp(lp: Dict[str, Any], cfg: LlamaConfig, x: torch.Tensor,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFN residual of rows x: the dense SwiGLU, or a layer's routed
    experts (``models/moe.py``; ``valid`` marks a prefill's token rows, and
    without it the step's static form runs)."""
    h2 = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    if "moe" in lp:
        return moe.moe_ffn(lp["moe"], cfg.moe, h2, valid)
    return row_linear(
        F.silu(apply_linear(h2, lp["gate_proj"])) * apply_linear(h2, lp["up_proj"]),
        lp["down_proj"], split_group(lp, "mlp"),
    )


def layer_project(lp: Dict[str, Any], cfg: LlamaConfig, x):
    """A decoder layer's input norm and q/k/v projections of rows x
    (..., D), before rotary: (..., H*hd), (..., kvH*hd), (..., kvH*hd)."""
    h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
    return tuple(apply_linear(h, lp[w]) for w in ("q_proj", "k_proj", "v_proj"))


def layer_residuals(lp: Dict[str, Any], cfg: LlamaConfig, x, attn, valid=None):
    """A decoder layer after its attention: the o_proj and MLP residuals
    (on a tensor-parallel rank each a row-parallel linear, summed over the
    ``model`` axis). ``valid`` (a prefill's attention mask) reaches an
    expert layer's routing."""
    x = x + row_linear(attn, lp["o_proj"], split_group(lp, "attn"))
    return x + _mlp(lp, cfg, x, valid)


def final_logits(params: Dict[str, Any], cfg: LlamaConfig, x) -> torch.Tensor:
    """The final norm and the LM head of rows x (..., D): f32 logits."""
    return lm_logits(rms_norm(x, params["norm"], cfg.rms_norm_eps), params)


def _qkv(lp: Dict[str, Any], cfg: LlamaConfig, x, cos, sin):
    B, T, _ = x.shape
    q, k, v = layer_project(lp, cfg, x)
    q = q.reshape(B, T, -1, cfg.head_dim)
    k = k.reshape(B, T, -1, cfg.head_dim)
    v = v.reshape(B, T, -1, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)
    return q, k, v


ExtractSpec = Union[None, int, Sequence[int]]


def extract_layers_tuple(extract_layer: ExtractSpec) -> Tuple[int, ...]:
    """An extract-layer spec (None, an int or a sequence of ints) as a tuple.
    A sequence extracts one probabilities row per listed layer in one
    forward pass (the training data of the reference's ``*_multilayer``
    roots needs several layers a sample)."""
    if extract_layer is None:
        return ()
    if isinstance(extract_layer, int):
        return (extract_layer,)
    return tuple(int(layer) for layer in extract_layer)


def _check_layer(extract_layer: ExtractSpec, cfg: LlamaConfig) -> Tuple[int, ...]:
    """The spec's layers, after checking that each is a decoder layer."""
    want = extract_layers_tuple(extract_layer)
    missing = [layer for layer in want if not 0 <= layer < cfg.num_hidden_layers]
    if missing:
        raise ValueError(f"extract_layer {missing} out of range "
                         f"(no such decoder layer)")
    return want


def embed(params: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    """The token embeddings of ``ids``. On a vocabulary-parallel rank each
    rank looks up the ids in its rows, zeros elsewhere, and the ranks' rows
    are summed (an id lies in one shard, so the sum is exact)."""
    w = params["embed_tokens"]
    group = split_group(params, "vocab")
    if group is None:
        return w[ids]
    local = ids - group.rank * w.shape[0]
    mine = (local >= 0) & (local < w.shape[0])
    rows = w[torch.where(mine, local, torch.zeros_like(local))]
    return all_reduce(torch.where(mine[..., None], rows, torch.zeros_like(rows)), group)


def _stack_rows(rows: Dict[int, torch.Tensor], extract_layer: ExtractSpec,
                params: Optional[Dict[str, Any]] = None):
    """The rows in the spec's container: None -> None, an int -> (B, H, T),
    a sequence -> (L, B, H, T) in the spec's order. A tensor-parallel
    rank's rows (its own heads) are gathered over the ``model`` axis."""
    if extract_layer is None:
        return None
    group = None if params is None else split_group(params, "attn")
    rows = {layer: all_gather(r, group, 1) for layer, r in rows.items()}
    if isinstance(extract_layer, int):
        return rows[extract_layer]
    return torch.stack([rows[layer] for layer in extract_layers_tuple(extract_layer)])


def decoder_prefill(params, cfg, inputs_embeds, attention_mask, cos, sin,
                    max_seq: int, extract_layer: ExtractSpec = None,
                    use_flash: bool = False, kv_quant: bool = False, cache=None):
    """The prefill body of both families, given each position's rotary
    ``cos``/``sin`` (B, T, hd): LLaMA's from ``rope_cos_sin``, Qwen2-VL's
    from M-RoPE. Returns (last-position logits (B, vocab) f32, the KV cache
    of ``max_seq`` slots, the extract rows or None): an int
    ``extract_layer`` gives its layer's last-row probabilities (B, H, T), a
    sequence one row per listed layer, (L, B, H, T) in the spec's order.
    The cache is allocated here, or is ``cache``, a zeroed one of that size
    and kind (``lease_kv_cache``), written in place.

    ``use_flash`` takes kernel K2 where ``flash_prefill_supported`` says so;
    the listed layers' rows then come from ``_last_row_probs`` (the causal
    mask's last row is ``attention_mask`` itself) and no (T, T) mask is
    built."""
    want = _check_layer(extract_layer, cfg)
    B, T, _ = inputs_embeds.shape
    # every position of the batch, padding included (the shapes)
    profiling.count("prefill_positions", B * T)
    with profiling.span("prefill", B=B, T=T):
        dev = inputs_embeds.device
        flash = use_flash and flash_prefill_supported(T)
        if not flash:
            causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None]
            mask = causal & attention_mask[:, None, :]
        kvh = local_kv_heads(params, cfg)
        if cache is None:
            if kv_quant:
                cache = init_quant_kv_cache(cfg, B, max_seq, dev, kvh)
            else:
                cache = init_kv_cache(cfg, B, max_seq, inputs_embeds.dtype, dev, kvh)
        elif (isinstance(cache, QuantKVCache) != kv_quant
              or tuple(cache[0].shape[1:4]) != (B, max_seq, kvh)):
            raise ValueError(f"decoder_prefill: the cache given is not a "
                             f"{'int8' if kv_quant else 'dense'} cache of "
                             f"({B}, {max_seq}, {kvh}) slots")

        x = inputs_embeds
        rows = {}
        for i, lp in enumerate(params["layers"]):
            q, k, v = _qkv(lp, cfg, x, cos, sin)
            if flash:
                attn = _flash_attn(q, k, v, attention_mask, cfg)
                if i in want:
                    rows[i] = _last_row_probs(q[:, -1], k, attention_mask, cfg)
            else:
                attn, r = _attn(q, k, v, mask, cfg, want_probs=i in want)
                if r is not None:
                    rows[i] = r
            if kv_quant:
                cache.k_q[i, :, :T], cache.k_s[i, :, :T] = quantize_kv(k)
                cache.v_q[i, :, :T], cache.v_s[i, :, :T] = quantize_kv(v)
            else:
                cache.k[i, :, :T] = k
                cache.v[i, :, :T] = v
            x = layer_residuals(lp, cfg, x, attn, attention_mask)
        return final_logits(params, cfg, x[:, -1]), cache, _stack_rows(rows, extract_layer, params)


def llama_prefill(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,    # (B, T, D)
    attention_mask: torch.Tensor,   # (B, T) bool, False on left padding
    max_seq: int,
    extract_layer: ExtractSpec = None,
    use_flash: bool = False,
    kv_quant: bool = False,
    cache=None,
):
    """Full-prompt forward (``decoder_prefill`` with LLaMA's rotary
    positions), into ``cache`` where given. With ``kv_quant`` the cache is
    int8; the prefill's own attention still uses the exact keys and values,
    so its logits and row equal the dense-cache path's."""
    # HF left-padding convention: position ids count valid tokens
    positions = torch.clamp(torch.cumsum(attention_mask.to(torch.int64), dim=1) - 1, min=0)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return decoder_prefill(params, cfg, inputs_embeds, attention_mask, cos, sin,
                           max_seq, extract_layer, use_flash, kv_quant, cache)


def every_row_at(pos):
    """``append_token``'s index pair for every row at ``pos``: one int for
    the batch, or a (B,) long tensor of each row's own position (one
    advanced-index write per cache tensor, the counterpart of JAX's
    serving/engine.py::_upd_slot)."""
    if isinstance(pos, int):
        return slice(None), pos
    return torch.arange(pos.shape[0], device=pos.device), pos


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
                 cfg, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One query per row (B, 1, H, hd) over cache plane ``layer`` where
    ``kv_mask`` (B, S) allows: kernel K3 on an int8 cache, ``_attn`` on a
    dense one. Returns (B, 1, hidden), written into ``out`` where given."""
    B = q.shape[0]
    if isinstance(kv, QuantKVCache):
        return decode_attn_int8(
            q[:, 0], kv.k_q, kv.k_s, kv.v_q, kv.v_s, kv_mask, layer=layer,
            sm_scale=1.0 / math.sqrt(cfg.head_dim),
            out=None if out is None else out.view(B, *q.shape[2:]),
        ).reshape(B, 1, -1)
    attn = _attn(q, kv.k[layer], kv.v[layer], kv_mask[:, None, :], cfg,
                 want_probs=False)[0]
    return attn if out is None else out.copy_(attn)


def _pre_attention(lp, cfg, x, cos, sin, kv, layer: int, pos) -> torch.Tensor:
    """A layer's input norm, q/k/v projections and rotary, with every row's
    new K/V written into the cache at ``pos`` (one int for the batch, or a
    (B,) long tensor of the rows' positions); returns q (B, 1, H, hd). On an
    int8 cache on the card the rotary and the write are one launch of
    kernel K5 (its plain version, ``apply_rope`` then ``append_token``, on
    the CPU)."""
    if isinstance(kv, QuantKVCache):
        return rope_append_int8(*layer_project(lp, cfg, x), cos, sin, kv, layer, pos)
    q, k1, v1 = _qkv(lp, cfg, x, cos, sin)
    append_token(kv, layer, every_row_at(pos), k1[:, 0], v1[:, 0])
    return q


def decode_segment(params, cfg, kv, lo: int, hi: int, x, attn, pos, cos, sin, kv_mask):
    """The part of a decode step between the attention of layer ``lo`` and
    that of layer ``hi``, two layers that ``extract_layer`` does not list:
    ``lo``'s o_proj and MLP residuals (``lo`` = -1: none, ``x`` is the
    token's embeddings), every listed layer in between whole (its
    probabilities row through the plain ``_attn_quantcache`` or ``_attn``),
    and ``hi``'s work before its attention (``hi`` = the layer count: the
    final norm and the LM head instead). Returns (x, ``hi``'s q or the f32
    logits (B, vocab), {listed layer: row}). Every row's new token is
    written at ``pos``, as ``_pre_attention`` takes it. The eager step and
    the graphs of ``models/decode_graph.py`` both run the step as these
    segments."""
    layers = params["layers"]
    rows = {}
    if lo >= 0:
        x = layer_residuals(layers[lo], cfg, x, attn)
    for i in range(lo + 1, hi):
        q = _pre_attention(layers[i], cfg, x, cos, sin, kv, i, pos)
        if isinstance(kv, QuantKVCache):
            a, rows[i] = _attn_quantcache(
                q, kv.k_q[i], kv.k_s[i], kv.v_q[i], kv.v_s[i],
                kv_mask[:, None, :], cfg, want_probs=True)
        else:
            a, rows[i] = _attn(q, kv.k[i], kv.v[i], kv_mask[:, None, :], cfg,
                               want_probs=True)
        x = layer_residuals(layers[i], cfg, x, a)
    if hi == len(layers):
        return x, final_logits(params, cfg, x[:, 0]), rows
    return x, _pre_attention(layers[hi], cfg, x, cos, sin, kv, hi, pos), rows


def decoder_decode_step(params, cfg, token_embeds, kv, cur_len, cos, sin,
                        kv_mask, extract_layer: ExtractSpec = None):
    """One token against the cache, given its rotary ``cos``/``sin``
    (B, 1, hd); the decode body of both families. Returns (logits (B, vocab)
    f32, the cache, the extract rows or None: (B, H, max_seq) for an int
    ``extract_layer``, (L, B, H, max_seq) for a sequence, in its order).

    ``cur_len`` is the cache position of the new token: one Python int for
    the whole batch (the generate loop), or a (B,) long tensor with each
    row's own position (the serving engines' slots). Each layer writes its
    new K/V there in place before it attends. On an int8 cache, every layer
    not listed in ``extract_layer`` attends through kernel K3 over the whole
    cache with its layer index; the listed ones take the plain
    ``_attn_quantcache``, which gives their probabilities rows.

    The step is ``decode_segment``s split at the attention of every layer
    not listed. On the card, over a cache from ``lease_kv_cache`` and a
    tree with no ``"tp"`` shard, they are replayed from CUDA graphs
    captured after the key's first step, the attention run eagerly between
    them (``models/decode_graph.py``); elsewhere they run eagerly."""
    want = _check_layer(extract_layer, cfg)
    L = cfg.num_hidden_layers
    ends = tuple(i for i in range(L) if i not in want) + (L,)
    graphs = decode_graph.graphs_for(params, kv, token_embeds,
                                     (cfg, want, token_embeds.dtype))
    if graphs is not None and graphs.graphs:
        logits, rows = graphs.replay(token_embeds, cur_len, cos, sin, kv_mask)
        return logits, kv, _stack_rows(rows, extract_layer, params)
    profiling.count("decode_graph.eager")
    x, attn, rows, lo = token_embeds, None, {}, -1
    for hi in ends:
        x, out, r = decode_segment(params, cfg, kv, lo, hi, x, attn, cur_len, cos, sin,
                                   kv_mask)
        rows.update(r)
        if hi < L:
            attn = attend_cache(kv, hi, out, kv_mask, cfg)
        lo = hi
    if graphs is not None:
        graphs.capture(
            functools.partial(decode_segment, params, cfg, kv),
            lambda layer, q, mask, into: attend_cache(kv, layer, q, mask, cfg, out=into),
            ends, token_embeds, cos, sin, kv_mask, cfg.num_attention_heads * cfg.head_dim)
    return out, kv, _stack_rows(rows, extract_layer, params)


def llama_decode_step(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    token_embeds: torch.Tensor,     # (B, 1, D)
    kv,                             # LlamaKVCache | QuantKVCache, updated in place
    cur_len,                        # cache slot of the new token: int or (B,)
    positions: torch.Tensor,        # (B,) rope position of the new token
    kv_mask: torch.Tensor,          # (B, max_seq) bool incl. the new slot
    extract_layer: ExtractSpec = None,
):
    """``decoder_decode_step`` at LLaMA's rotary ``positions``."""
    cos, sin = rope_cos_sin(positions[:, None], cfg.head_dim, cfg.rope_theta)
    return decoder_decode_step(params, cfg, token_embeds, kv, cur_len, cos, sin,
                               kv_mask, extract_layer)
