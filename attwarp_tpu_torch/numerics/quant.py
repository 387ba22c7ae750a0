"""int8 KV-cache quantization and the linear/logit forms the decoder uses
(counterpart of ``attwarp_tpu/numerics/quant.py``).

Ported: ``quantize_kv``/``dequantize_kv`` (the ``+kv8`` cache), the dense
and biased ``apply_linear`` forms and the dense ``lm_logits`` head. The w8a8
weight forms (``+int8``, ``+lm8``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


def apply_linear(h: torch.Tensor, w: Any) -> torch.Tensor:
    """``h @ W.T (+ b)`` for a dense ``(out, in)`` weight or a ``{"weight",
    "bias"}`` dict."""
    if isinstance(w, dict):
        if "q" in w:
            raise NotImplementedError("w8a8 int8 linears are not ported yet")
        return F.linear(h, w["weight"], w["bias"])
    return F.linear(h, w)


def lm_logits(x: torch.Tensor, params: Dict[str, Any]) -> torch.Tensor:
    """Final hidden ``(B, hidden)`` -> f32 logits ``(B, vocab)`` through
    ``params["lm_head"]`` (or the tied ``embed_tokens``), in f32 as the JAX
    dense head computes it (greedy tokens depend on it)."""
    w = params.get("lm_head", params["embed_tokens"])
    return F.linear(x.to(torch.float32), w.to(torch.float32))


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
