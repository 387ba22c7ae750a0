"""Kernel K2: causal prefill attention with left padding.

``flash_prefill(q, k, v, attention_mask, sm_scale)``:

- ``q`` (B, T, H, hd), ``k``/``v`` (B, T, kvH, hd): post-RoPE queries, keys
  and values of a whole prompt;
- ``attention_mask`` (B, T) bool, False on left padding;
- returns (B, T, H * hd) in q's dtype.

Query ``i`` attends key ``j`` iff ``j <= i`` and both are padding or both
are valid: the segment ids of the TPU kernel (``seg = where(mask, 2, 1)``).
Every row attends at least itself, so padded rows stay finite. GQA by
index: head ``h`` reads kv head ``h // (H // kvH)``, with no repeated copy.

- CPU tensors: ``flash_prefill_plain``, the same function as dense masked
  attention (dots in q's dtype, f32 softmax, as ``models/llama.py::_attn``).
- CUDA tensors: ``csrc/flash_prefill.cu`` (bf16 in and out, f32 softmax and
  accumulation; head_dim 128, any T; TMA loads and wgmma), or an
  exception.

Replaces the TPU kernel ``attwarp_tpu/models/llama.py:218`` ``_flash_attn``
(JAX's Pallas TPU ``flash_attention`` with segment ids).
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.kernels._build import check_launch, library, require_cuda
from attwarp_tpu_torch.utils import profiling

HEAD_DIM = 128   # the only head_dim the CUDA kernel takes (as on the TPU)


def flash_prefill_plain(q, k, v, attention_mask, sm_scale: float) -> torch.Tensor:
    """Plain PyTorch K2: dense attention, causal and within the segment
    (padding with padding, valid with valid)."""
    B, T, H, hd = q.shape
    kvH = k.shape[2]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    allowed = causal[None] & (attention_mask[:, :, None] == attention_mask[:, None, :])
    qg = q.reshape(B, T, kvH, H // kvH, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(q.dtype)).to(torch.float32)
    s = s * sm_scale
    s = s.masked_fill(~allowed[:, None, None], torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p.to(q.dtype), v.to(q.dtype))
    return out.reshape(B, T, H * hd)


def flash_prefill(q, k, v, attention_mask, sm_scale: float) -> torch.Tensor:
    profiling.count("k2.calls")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, attention_mask, sm_scale)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill: q must be (B, T, H, hd) and k/v (B, T, "
                         f"kvH, hd); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, T, H, hd = q.shape
    kvH = k.shape[2]
    if tuple(k.shape) != (B, T, kvH, hd):
        raise ValueError(f"flash_prefill: k/v must be ({B}, {T}, kvH, {hd}); "
                         f"got {tuple(k.shape)}")
    if hd != HEAD_DIM or H % kvH:
        raise ValueError(f"flash_prefill: need head_dim {HEAD_DIM} and H "
                         f"divisible by kvH; got hd={hd}, H={H}, kvH={kvH}")
    if tuple(attention_mask.shape) != (B, T) or attention_mask.dtype != torch.bool:
        raise ValueError(f"flash_prefill: attention_mask must be ({B}, {T}) bool")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_floating_point():
            raise TypeError(f"flash_prefill: {name} must be floating, got {t.dtype}")
    qb, kb, vb = (t.to(torch.bfloat16).contiguous() for t in (q, k, v))
    mask = attention_mask.contiguous()
    require_cuda("flash_prefill", qb, kb, vb, mask)
    out = torch.empty((B, T, H * hd), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().attwarp_flash_prefill(
            qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), mask.data_ptr(),
            out.data_ptr(), B, T, H, kvH, hd, float(sm_scale), stream,
        )
    check_launch(rc, "flash_prefill")
    flash_prefill.launches += 1
    return out.to(q.dtype)


flash_prefill.launches = 0
