"""Sequence-parallel (context-parallel) prefill: ring attention over a mesh
axis (counterpart of ``attwarp_tpu/parallel/sp_prefill.py``).

Each of the axis's n ranks holds T/n of the prompt's positions, runs every
projection and MLP on its slice, and sees the whole history in attention
by passing K/V blocks around the ring (``parallel/comm.py::ring_shift``,
JAX's ``ppermute``). Per layer a rank computes its local q/k/v (rotary at
the GLOBAL positions, sliced with the embeddings), then n ring steps: its
queries attend the block it holds with a streaming softmax (running row max
``m``, denominator ``l`` and accumulator in f32: one softmax over the whole
row), and the block moves on. Causality is by ABSOLUTE index and left
padding by the key-validity bits that travel with each block, so the
masking is exact for any n. JAX's ring is plain ``jnp.einsum`` inside
``shard_map``, not a Pallas kernel, and ``_ring_attn`` is the same
arithmetic in PyTorch.

Every rank is given the whole ``inputs_embeds`` and ``attention_mask`` (as
JAX's function takes the unsharded arrays) and returns the dense path's
contract, replicated: (last logits (B, vocab) f32, the KV cache padded to
``max_seq`` with its sequence axis gathered whole, the extract rows or
None), so the decode step (and with it kernel K3) continues from the cache
unchanged. The extract row costs one all-gather of that layer's K, O(T).
``kv_quant`` quantizes each rank's block before the gather: exact against
quantizing the whole cache, since a scale never spans two tokens.

Pad-position caveat (as JAX's): at left-pad query positions (no visible
key anywhere) the ring emits zeros where the dense path emits a softmax
over a masked row, so activations and cache entries AT PAD SLOTS differ
between the two by construction. They are never compared and stay masked
downstream (the decode steps' masks).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from attwarp_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaKVCache,
    QuantKVCache,
    _check_layer,
    _last_row_probs,
    _repeat_kv,
    _stack_rows,
    apply_rope,
    final_logits,
    layer_project,
    layer_residuals,
    rope_cos_sin,
)
from attwarp_tpu_torch.numerics.quant import quantize_kv
from attwarp_tpu_torch.parallel.comm import Group, all_gather, all_reduce, ring_shift
from attwarp_tpu_torch.parallel.mesh import Mesh

_NEG = torch.finfo(torch.float32).min


def _check_max_seq(max_seq: Optional[int], T: int) -> int:
    """Validate the cache length up front."""
    if max_seq is None:
        return T
    if max_seq < T:
        raise ValueError(f"max_seq={max_seq} < prompt length T={T}")
    return max_seq


def _ring_attn(q, k, v, q_idx, k_idx, k_valid, head_dim: int, group: Group):
    """Streaming-softmax attention of local queries over the whole (ring)
    sequence. q (B, Tl, H, hd); k/v (B, Tl, kvH, hd), the local block;
    q_idx/k_idx (Tl,) absolute positions; k_valid (B, Tl) bool. Returns
    (B, Tl, H*hd) in q's dtype; each ring step scores one (Tl, Tl) block."""
    n_rep = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(head_dim)
    B, Tl, H, hd = q.shape
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Tl, hd), dtype=torch.float32, device=q.device)
    blk = (k, v, k_idx, k_valid)
    for step in range(group.size):
        kb, vb, kib, kvb = blk
        s = torch.einsum("bqhd,bkhd->bhqk", q, _repeat_kv(kb, n_rep)).to(torch.float32) * scale
        ok = (kib[None, :] <= q_idx[:, None])[None, None] & kvb[:, None, None, :]
        s = s.masked_fill(~ok, _NEG)
        nm = torch.maximum(m, s.amax(dim=-1))
        # rows with no visible key so far keep m = _NEG: renormalize against
        # a safe max, or exp(s - _NEG) would overflow
        sm = torch.where(nm == _NEG, torch.zeros_like(nm), nm)
        p = torch.exp(s - sm[..., None]).masked_fill(~ok, 0.0)
        corr = torch.where(m == _NEG, torch.zeros_like(m), torch.exp(m - sm))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, _repeat_kv(vb, n_rep).to(torch.float32))
        m = nm
        if step + 1 < group.size:
            blk = ring_shift(blk, group)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).reshape(B, Tl, H * hd).to(q.dtype)


def _sp_decoder(params, cfg, inputs_embeds, attention_mask, cos, sin, mesh: Mesh,
                axis: str, max_seq: Optional[int], extract_layer, kv_quant: bool):
    """The ring prefill body of both families, given each position's rotary
    cos/sin (B, T, hd) for the whole prompt."""
    group = mesh.axis(axis)
    B, T, _ = inputs_embeds.shape
    n = group.size
    if T % n:
        raise ValueError(f"prompt length {T} not divisible by {axis}={n}")
    max_seq = _check_max_seq(max_seq, T)
    want = _check_layer(extract_layer, cfg)
    Tl = T // n
    lo = group.rank * Tl

    def mine(t):
        return t[:, lo:lo + Tl]

    x, msk, cosl, sinl = (mine(t) for t in (inputs_embeds, attention_mask, cos, sin))
    aidx = torch.arange(lo, lo + Tl, device=x.device)
    ks, vs, rows = [], [], {}
    for i, lp in enumerate(params["layers"]):
        q, k, v = (t.reshape(B, Tl, -1, cfg.head_dim) for t in layer_project(lp, cfg, x))
        q, k = apply_rope(q, k, cosl, sinl)
        attn = _ring_attn(q, k, v, aidx, aidx, msk, cfg.head_dim, group)
        x = layer_residuals(lp, cfg, x, attn)
        ks.append(k)
        vs.append(v)
        if i in want:
            # the LAST query's probabilities over the whole history, on every
            # rank, from the gathered K (O(T), never (T, T))
            kf = all_gather(k, group, 1)
            mf = all_gather(msk, group, 1)
            qlast = all_gather(q[:, -1:], group, 1)[:, -1]
            rows[i] = _last_row_probs(qlast, kf, mf, cfg)
    # the prompt's last token lives on the last rank: its logits, summed
    # with the other ranks' zeros
    logits = final_logits(params, cfg, x[:, -1])
    logits = all_reduce(logits * float(group.rank == n - 1), group)
    kcat, vcat = torch.stack(ks), torch.stack(vs)        # (L, B, Tl, kvH, hd)
    pad5 = (0, 0, 0, 0, 0, max_seq - T)
    if kv_quant:
        parts = [all_gather(t, group, 2) for t in (*quantize_kv(kcat), *quantize_kv(vcat))]
        kq, ksc, vq, vsc = parts
        cache = QuantKVCache(F.pad(kq, pad5), F.pad(ksc, pad5[2:]),
                             F.pad(vq, pad5), F.pad(vsc, pad5[2:]))
    else:
        cache = LlamaKVCache(F.pad(all_gather(kcat, group, 2), pad5),
                             F.pad(all_gather(vcat, group, 2), pad5))
    return logits, cache, _stack_rows(rows, extract_layer)


def sp_prefill(
    params: Dict[str, Any],
    cfg: LlamaConfig,
    inputs_embeds: torch.Tensor,    # (B, T, D), whole on every rank
    attention_mask: torch.Tensor,   # (B, T) bool
    mesh: Mesh,
    axis: str = "data",
    max_seq: Optional[int] = None,
    extract_layer=None,
    kv_quant: bool = False,
):
    """Sequence-parallel ``llama_prefill`` over the mesh's ``axis``. T must
    divide by the axis size. Returns ``llama_prefill``'s contract (module
    docstring); ``kv_quant=True`` gives a ``QuantKVCache``."""
    # rotary positions follow the HF left-pad convention (valid-token
    # counts), computed over the whole prompt and sliced with the embeds
    positions = torch.clamp(torch.cumsum(attention_mask.to(torch.int64), dim=1) - 1, min=0)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    return _sp_decoder(params, cfg, inputs_embeds, attention_mask, cos, sin, mesh, axis,
                       max_seq, extract_layer, kv_quant)


def sp_prefill_qwen(
    params: Dict[str, Any],
    cfg,                            # Qwen2VLTextConfig
    inputs_embeds: torch.Tensor,    # (B, T, D)
    attention_mask: torch.Tensor,   # (B, T) bool
    cos: torch.Tensor,              # (B, T, head_dim) M-RoPE tables
    sin: torch.Tensor,
    mesh: Mesh,
    axis: str = "data",
    max_seq: Optional[int] = None,
    extract_layer=None,
    kv_quant: bool = False,
):
    """Sequence-parallel ``qwen2vl_prefill``: the same ring, given the whole
    prompt's M-RoPE tables (``get_mrope_positions`` + ``mrope_cos_sin``,
    the dense prefill's inputs), which are sliced with the embeds. Qwen2's
    q/k/v biases ride through ``layer_project``. Returns the dense path's
    contract; the cache feeds ``qwen2vl_decode_step`` unchanged."""
    return _sp_decoder(params, cfg, inputs_embeds, attention_mask, cos, sin, mesh, axis,
                       max_seq, extract_layer, kv_quant)
