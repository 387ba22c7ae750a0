"""int8 quantization: the w8a8 weight forms (``+int8``, ``+lm8``) and the
int8 KV cache (``+kv8``) (counterpart of ``attwarp_tpu/numerics/quant.py``).

Weights: symmetric per-output-channel int8, ``s = max(max|w|, 1e-12) /
127`` over the input axis, one f32 scale per output feature, a bias kept in
f32. Activations: symmetric per-token int8 over the last axis, computed on
the fly. The product is int8 x int8 with int32 accumulation
(``int8_matmul``), rescaled in f32 by the activation scale, then the
weight scale. Every step is the JAX function's, op for op, so the CPU path
is bit-equal to JAX's.

``int8_matmul`` is the one place the int8 product runs:

- CPU tensors: ``torch._int_mm`` on the CPU (any shape; exact);
- CUDA tensors: ``torch._int_mm`` (cuBLASLt int8 GEMM). It takes more than
  16 rows and inner and output widths that are multiples of 8, so decode
  rows (M <= 16) are padded with zero rows to ``INT_MM_MIN_ROWS`` and the
  result sliced (``int8_matmul.padded`` counts those calls). A width it
  cannot take raises: there is no dequantized fallback.

The JAX package computes this product with XLA's ``dot_general``
(``preferred_element_type=int32``), not with a Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from attwarp_tpu_torch.models.moe import refuse_experts
from attwarp_tpu_torch.parallel.comm import Group, all_gather, all_reduce, split_group

DECODER_LINEAR_KEYS: Tuple[str, ...] = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

INT_MM_MIN_ROWS = 24   # the least multiple of 8 above cuBLASLt's 16-row floor


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


def quantize_linear(w: Any) -> Dict[str, torch.Tensor]:
    """One linear to int8 on its own device: a dense ``(out, in)`` matrix or
    a ``{"weight", "bias"}`` dict -> ``{"q": int8 (out, in), "s": f32
    (out,)}``, plus ``"b"`` (f32) where there is a bias. Idempotent."""
    if is_quantized(w):
        return w
    bias = None
    if isinstance(w, dict):
        bias, w = w["bias"], w["weight"]
    w32 = w.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(w32), dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / s[:, None]), -127, 127).to(torch.int8)
    out = {"q": q, "s": s}
    if bias is not None:
        out["b"] = bias.to(torch.float32)
    return out


def quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token activation quantization: ``h (..., K)`` -> (int8 ``(...,
    K)``, f32 scale ``(..., 1)``), the scale ``max(max|h|, 1e-12) / 127``
    over the last axis."""
    h32 = h.to(torch.float32)
    ascale = torch.clamp(torch.amax(torch.abs(h32), dim=-1, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(h32 / ascale), -127, 127).to(torch.int8), ascale


def int8_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``a_q (M, K) @ w_q (N, K).T`` for int8 operands -> int32 ``(M, N)``,
    exact (see the module docstring for the two routes)."""
    if a_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_matmul: int8 operands, got {a_q.dtype} and {w_q.dtype}")
    if a_q.device.type == "cpu":
        return torch._int_mm(a_q, w_q.t())
    M, K = a_q.shape
    N = w_q.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"int8_matmul: inner width {K} and output width {N} must be "
                         f"multiples of 8 for the CUDA int8 GEMM")
    if M < INT_MM_MIN_ROWS:
        a_q = F.pad(a_q, (0, 0, 0, INT_MM_MIN_ROWS - M))
        int8_matmul.padded += 1
    # (N, K) row-major transposed is the column-major (K, N) cuBLASLt wants
    y = torch._int_mm(a_q.contiguous(), w_q.t())
    int8_matmul.launches += 1
    return y[:M]


int8_matmul.launches = 0
int8_matmul.padded = 0


def rescale(y: torch.Tensor, ascale: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The int32 product back to f32: ``(y * ascale) * s``, ``+ b`` where
    the weight has one (JAX's order)."""
    out = y.to(torch.float32) * ascale * w["s"]
    return out + w["b"] if "b" in w else out


def w8a8(h: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dynamic-activation w8a8 product of ``h (..., K)`` with an int8 weight,
    in f32 ``(..., N)``."""
    hq, ascale = quantize_rows(h)
    y = int8_matmul(hq.reshape(-1, hq.shape[-1]), w["q"])
    return rescale(y.reshape(*h.shape[:-1], -1), ascale, w)


def apply_linear(h: torch.Tensor, w: Any) -> torch.Tensor:
    """``h @ W.T (+ b)`` for every weight form the decoders use: a dense
    ``(out, in)`` matrix, a ``{"weight", "bias"}`` dict, or an int8
    ``{"q", "s"[, "b"]}`` (w8a8, the result in ``h``'s dtype)."""
    if not isinstance(w, dict):
        return F.linear(h, w)
    if is_quantized(w):
        return w8a8(h, w).to(h.dtype)
    return F.linear(h, w["weight"], w["bias"])


def row_linear(h: torch.Tensor, w: Any, group: Optional[Group]) -> torch.Tensor:
    """``apply_linear`` of a row-parallel linear: ``h`` holds this rank's
    slice of the input features and ``w`` the matching columns. The
    partial products are summed over ``group`` and the bias added once;
    with no group it is ``apply_linear``. An int8 weight quantizes ``h``
    with the per-token scale of the whole row (a max over the group) and
    sums the int32 products, so the result is bit-equal to the unsharded
    w8a8 product."""
    if group is None:
        return apply_linear(h, w)
    if not isinstance(w, dict):
        return all_reduce(F.linear(h, w), group)
    if not is_quantized(w):
        return all_reduce(F.linear(h, w["weight"]), group) + w["bias"]
    h32 = h.to(torch.float32)
    amax = all_reduce(torch.amax(torch.abs(h32), dim=-1, keepdim=True), group, "max")
    ascale = torch.clamp(amax, min=1e-12) / 127.0
    hq = torch.clamp(torch.round(h32 / ascale), -127, 127).to(torch.int8)
    y = all_reduce(int8_matmul(hq.reshape(-1, hq.shape[-1]), w["q"]), group)
    return rescale(y.reshape(*h.shape[:-1], -1), ascale, w).to(h.dtype)


def lm_logits(x: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
    """Final hidden ``(B, hidden)`` -> f32 logits ``(B, vocab)`` through
    ``params["lm_head"]`` (or the tied ``embed_tokens``): the dense head in
    f32, as the JAX dense head computes it (greedy tokens depend on it), or
    the int8 head (``+lm8``) as a w8a8 product. A vocabulary-parallel head
    (``parallel/llava_sharding.py``) gathers its ranks' logits."""
    w = params.get("lm_head", params["embed_tokens"])
    if is_quantized(w):
        out = w8a8(x, w)
    else:
        out = F.linear(x.to(torch.float32), w.to(torch.float32))
    return all_gather(out, split_group(params, "vocab"), -1)


def quantize_lm_head(params: Dict[str, Any]) -> Dict[str, Any]:
    """An int8 ``lm_head`` in ``params``, in place (untied from
    ``embed_tokens`` where it was tied: the embedding lookup keeps its
    dtype). Returns ``params``."""
    params["lm_head"] = quantize_linear(params.get("lm_head", params["embed_tokens"]))
    return params


def quantize_decoder_params(params: Dict[str, Any],
                            keys: Sequence[str] = DECODER_LINEAR_KEYS) -> Dict[str, Any]:
    """Every layer's ``keys`` linears of a LLaMA/Qwen2 decoder tree in int8,
    in place and one layer at a time on the weights' device, so that each
    layer's dense weights are freed as its int8 form is made and no second
    tree is ever held (JAX's returns a new tree). Embeddings, LM head and
    norms pass through. Returns ``params``. A tree with routed experts is
    refused (no expert layer has an int8 form)."""
    refuse_experts(params, "quantize_decoder_params (+int8)")
    layers = params["layers"]
    for i, lp in enumerate(layers):
        layers[i] = {k: (quantize_linear(v) if k in keys else v) for k, v in lp.items()}
    return params


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(token, head) int8: ``x (..., hd)`` -> ``(q int8 (...,
    hd), s f32 (...))`` with ``s = max|x| / 127`` over the last axis.
    Bit-equal to the JAX form (both round half to even)."""
    x32 = x.to(torch.float32)
    s = torch.clamp(torch.amax(torch.abs(x32), dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(x32 / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of ``quantize_kv`` in ``dtype``."""
    return q.to(dtype) * s[..., None].to(dtype)
