"""Kernel K5: the decode step's new token into the int8 KV cache.

``rope_append_int8(q, k, v, cos, sin, kv, layer, pos)``:

- ``q`` (B, 1, H * hd), ``k`` and ``v`` (B, 1, kvH * hd): the step's
  projections, in the activations' dtype;
- ``cos``, ``sin`` (B, 1, hd) f32: each row's rotary tables;
- ``kv``: a ``models/llama.py::QuantKVCache``, written IN PLACE at plane
  ``layer``: row ``b``'s rotated k and its v, quantized per (token, head)
  as ``numerics/quant.py::quantize_kv`` does, at position ``pos`` (one int
  for every row) or ``pos[b]`` (a (B,) int64 tensor on the cache's device);
- returns the rotated q (B, 1, H, hd) in q's dtype, what kernel K3 takes.

- CPU tensors: ``rope_append_int8_plain``, the eager sequence
  ``models/llama.py::apply_rope`` then ``append_token`` that the step runs
  on the CPU and ran on the card before K5.
- CUDA tensors: ``csrc/rope_append_int8.cu`` (bf16 or float32, head_dim
  128, as K3), or an exception. One launch: a warp per (row, head) of q, k
  and v; its outputs are bit-equal to the eager sequence on the card. A
  position tensor's entry outside [0, S) stops the kernel (a device trap,
  as the eager index write's bound check).

Replaces no TPU kernel: the JAX rotary and ``quantize_kv`` are plain jnp
code, and the TPU's decode attention merged the new token inside its kernel
(``attwarp_tpu/ops/pallas_decode_attn.py``). Called by
``models/llama.py::_pre_attention`` once a layer a decode step, inside the
decode graphs (``models/decode_graph.py`` replays its launches).
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.kernels._build import check_launch, library, require_cuda

HEAD_DIM = 128   # the only head_dim the CUDA kernel takes (as K3)
_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def rope_append_int8_plain(q, k, v, cos, sin, kv, layer: int, pos) -> torch.Tensor:
    """Plain PyTorch K5: the decode step's own eager sequence,
    ``models/llama.py::apply_rope`` then ``append_token`` at (``layer``,
    every row, ``pos``)."""
    # imported here: models/llama.py imports this module
    from attwarp_tpu_torch.models.llama import append_token, apply_rope, every_row_at

    B, hd = q.shape[0], kv.k_q.shape[-1]
    q, k = apply_rope(q.reshape(B, 1, -1, hd), k.reshape(B, 1, -1, hd), cos, sin)
    append_token(kv, layer, every_row_at(pos), k[:, 0], v.reshape(B, -1, hd))
    return q


def rope_append_int8(q, k, v, cos, sin, kv, layer: int, pos) -> torch.Tensor:
    if q.device.type == "cpu":
        return rope_append_int8_plain(q, k, v, cos, sin, kv, layer, pos)
    L, B, S, kvH, hd = kv.k_q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"rope_append_int8: need head_dim {HEAD_DIM}, got {hd}")
    if q.dtype not in _ELEM_BYTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"rope_append_int8: q, k, v must be one dtype of bfloat16 or "
                        f"float32, got {q.dtype}, {k.dtype}, {v.dtype}")
    H = q.numel() // (B * hd)
    if (q.shape[0] != B or H == 0 or q.numel() != B * H * hd or k.shape != v.shape
            or k.shape[0] != B or k.numel() != B * kvH * hd):
        raise ValueError(f"rope_append_int8: need q (B, H*hd), k and v (B, kvH*hd) with "
                         f"(B, kvH, hd) = ({B}, {kvH}, {hd}); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.numel() != B * hd:
            raise ValueError(f"rope_append_int8: {name} must be ({B}, 1, {hd}) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t, dt in (("k_q", kv.k_q, torch.int8), ("v_q", kv.v_q, torch.int8),
                        ("k_s", kv.k_s, torch.float32), ("v_s", kv.v_s, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"rope_append_int8: {name} must be {dt}, got {t.dtype}")
    if tuple(kv.v_q.shape) != (L, B, S, kvH, hd) or tuple(kv.k_s.shape) != (L, B, S, kvH) \
            or tuple(kv.v_s.shape) != (L, B, S, kvH):
        raise ValueError("rope_append_int8: the cache must be (L, B, S, kvH, hd) values and "
                         "(L, B, S, kvH) scales")
    if not 0 <= layer < L:
        raise ValueError(f"rope_append_int8: layer {layer} not in [0, {L})")
    if isinstance(pos, int):
        if not 0 <= pos < S:
            raise ValueError(f"rope_append_int8: position {pos} not in [0, {S})")
        pos_t, pos0 = None, pos
    else:
        if pos.dtype != torch.int64 or tuple(pos.shape) != (B,):
            raise ValueError(f"rope_append_int8: positions must be ({B},) int64, got "
                             f"{tuple(pos.shape)} {pos.dtype}")
        pos_t, pos0 = pos, 0
    q_out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    require_cuda("rope_append_int8", q, k, v, cos, sin, q_out, *kv,
                 *(() if pos_t is None else (pos_t,)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().attwarp_rope_append_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            q_out.data_ptr(), kv.k_q.data_ptr(), kv.k_s.data_ptr(), kv.v_q.data_ptr(),
            kv.v_s.data_ptr(), None if pos_t is None else pos_t.data_ptr(), pos0,
            L, B, S, H, kvH, hd, int(layer), _ELEM_BYTES[q.dtype], stream,
        )
    check_launch(rc, "rope_append_int8")
    rope_append_int8.launches += 1
    return q_out


rope_append_int8.launches = 0
