"""A plain causal decoder (LLaMA / Qwen2 layers) for the benchmark's check.

Straight from the published equations: RMSNorm, rotary q and k, causal
softmax attention over every earlier position (grouped-query by repeating
the kv heads), the SwiGLU MLP, the final norm and the LM head. One
unpadded sequence at a time, no cache, no kernels; the layers run in the
outer loop so that each layer's weights are cast once for every sequence.

``precision`` is ``"f32"`` (the reference: every product in float32, TF32
off) or ``"fp8"`` (the control: the input rows and the weight rows of every
linear layer rounded to float8 e4m3 with a scale per row, the step below
the configuration's bfloat16; attention and norms stay float32).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch

E4M3_MAX = 448.0


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per row (last axis), back
    in float32."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Matmul:
    """``x @ w.T`` in the reference's precision; ``prep`` casts a weight
    once (and rounds it to fp8 rows in the control)."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}: f32 or fp8")
        self.fp8 = precision == "fp8"

    def prep(self, w: torch.Tensor) -> torch.Tensor:
        w = w.to(torch.float32)
        return fp8_rows(w) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        y = (fp8_rows(x) if self.fp8 else x) @ w.t()
        return y if b is None else y + b.to(torch.float32)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Dims:
    hidden: int
    heads: int
    kv_heads: int
    eps: float

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.to(torch.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos, sin (n, head_dim) of integer ``positions`` (n,), in float64
    then float32 (half the channels' frequencies, repeated)."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=positions.device) / head_dim))
    f = positions.to(torch.float64)[:, None] * inv[None, :]
    emb = torch.cat([f, f], dim=-1)
    return torch.cos(emb).to(torch.float32), torch.sin(emb).to(torch.float32)


def attention(q, k, v, dims: Dims):
    """Causal attention of one sequence: q (n, H, hd), k/v (n, kvH, hd) ->
    (out (n, H*hd), probs (H, n, n))."""
    n = q.shape[0]
    rep = dims.heads // dims.kv_heads
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(dims.head_dim)
    causal = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v).reshape(n, -1), p


def decoder_forward(layers: Sequence[Dict[str, Any]], norm_w, head_w, dims: Dims,
                    xs: List[torch.Tensor], tables: List[tuple], logit_from: List[int],
                    mm: Matmul, row_layer: Optional[int] = None,
                    row_from: Optional[List[int]] = None):
    """Every sequence ``xs[i]`` (n_i, D) f32 of input embeddings through the
    decoder, its rotary ``tables[i]`` = (cos, sin) (n_i, hd). Returns, per
    sequence, (logits (n_i - logit_from[i], vocab) f32 of the positions from
    ``logit_from[i]`` on, and with ``row_layer`` that layer's attention rows
    (n_i - row_from[i], H, n_i) of the queries from ``row_from[i]`` on)."""
    hd = dims.head_dim
    xs = [x.to(torch.float32) for x in xs]
    rows: List[Optional[torch.Tensor]] = [None] * len(xs)
    for li, lp in enumerate(layers):
        w = {k: mm.prep(lp[k] if not isinstance(lp[k], dict) else lp[k]["weight"])
             for k in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                       "down_proj")}
        bias = {k: lp[k]["bias"] for k in ("q_proj", "k_proj", "v_proj")
                if isinstance(lp[k], dict)}
        for i, x in enumerate(xs):
            n = x.shape[0]
            cos, sin = tables[i]
            h = rms_norm(x, lp["input_layernorm"], dims.eps)
            q = mm(h, w["q_proj"], bias.get("q_proj")).reshape(n, dims.heads, hd)
            k = mm(h, w["k_proj"], bias.get("k_proj")).reshape(n, dims.kv_heads, hd)
            v = mm(h, w["v_proj"], bias.get("v_proj")).reshape(n, dims.kv_heads, hd)
            q = q * cos[:, None] + rotate_half(q) * sin[:, None]
            k = k * cos[:, None] + rotate_half(k) * sin[:, None]
            out, p = attention(q, k, v, dims)
            if li == row_layer:
                rows[i] = p[:, row_from[i]:, :].permute(1, 0, 2).contiguous()
            del p
            x = x + mm(out, w["o_proj"])
            h2 = rms_norm(x, lp["post_attention_layernorm"], dims.eps)
            g = mm(h2, w["gate_proj"])
            x = x + mm(torch.nn.functional.silu(g) * mm(h2, w["up_proj"]), w["down_proj"])
            xs[i] = x
        del w
    head = mm.prep(head_w)
    out = []
    for i, x in enumerate(xs):
        h = rms_norm(x[logit_from[i]:], norm_w, dims.eps)
        out.append((mm(h, head), rows[i]))
    return out


def splice(embed_w: torch.Tensor, ids: torch.Tensor, image_token: int,
           feats: torch.Tensor) -> torch.Tensor:
    """Token embeddings (n, D) f32 of ``ids`` (n,), the prompt's image-token
    positions (the first ``n_img`` of them; a served token may have the
    image token's id, and is embedded as any other) replaced in order by
    ``feats`` (n_img, D)."""
    x = embed_w[torch.clamp(ids, 0, embed_w.shape[0] - 1)].to(torch.float32)
    at = (ids == image_token).nonzero()[:feats.shape[0], 0]
    if at.numel() != feats.shape[0]:
        raise ValueError(f"{at.numel()} image tokens for {feats.shape[0]} features")
    x[at] = feats.to(torch.float32)
    return x
