"""Kernel K4: the scaled row softmax between a vision tower's two attention
products, in place.

``scaled_softmax_(logits, scale)``:

- ``logits`` (..., L): one attention product's logits, contiguous;
- returns ``logits``, overwritten by ``softmax(logits.float() * scale, -1)``
  in its own dtype.

- CPU tensors: ``scaled_softmax_plain``, copied over the logits.
- CUDA tensors: ``csrc/attn_softmax.cu`` (bf16 or float32; one read and
  one write of each value for rows up to 2304, three reads beyond), or an
  exception.

Replaces no TPU kernel: the JAX towers' softmax is plain einsum code. It is
called once per block by ``models/clip_vit.py`` (CLIP, SigLIP) and once per
block and image by ``models/qwen2vl.py``.
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.kernels._build import check_launch, library, require_cuda
from attwarp_tpu_torch.utils import profiling

_ELEM_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def scaled_softmax_plain(logits: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch K4: the softmax in f32, returned in logits' dtype."""
    return torch.softmax(logits.float() * scale, dim=-1).to(logits.dtype)


def scaled_softmax_(logits: torch.Tensor, scale: float) -> torch.Tensor:
    profiling.count("k4.calls")
    if logits.device.type == "cpu":
        return logits.copy_(scaled_softmax_plain(logits, scale))
    if logits.dtype not in _ELEM_BYTES:
        raise TypeError(f"scaled_softmax_: logits must be bfloat16 or float32, "
                        f"got {logits.dtype}")
    L = logits.shape[-1] if logits.ndim else 0
    if L < 1 or logits.numel() == 0:
        raise ValueError(f"scaled_softmax_: rows of at least 1 value, got shape "
                         f"{tuple(logits.shape)}")
    if logits.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("scaled_softmax_: the CUDA kernel has no backward")
    require_cuda("scaled_softmax_", logits)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().attwarp_attn_softmax(
            logits.data_ptr(), logits.numel() // L, L, _ELEM_BYTES[logits.dtype],
            float(scale), stream,
        )
    check_launch(rc, "scaled_softmax_")
    scaled_softmax_.launches += 1
    return logits


scaled_softmax_.launches = 0
