"""Attention accumulation over decode steps (counterpart of
``attwarp_tpu/extract/accumulator.py``).

Semantics of the reference's ``MaskHookLogger`` / ``BatchMaskHookLogger``
(attention_extraction/llava.py:93-132, 384-411):

per step:  row = attn[:, heads, -1, st:ed]            (post-softmax)
           row = row / (row.sum(-1, keepdims) + 1e-12) (re-normalize slice)
           row = row.mean(heads)
finalize:  mean over accumulated steps; uniform 1/576 if no steps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NUM_IMAGE_TOKENS = 576  # 24x24 patches for LLaVA-1.5 (llava.py:50)


class AttnCarry(NamedTuple):
    total: torch.Tensor  # (..., B, num_image_tokens) running sum of per-step rows
    count: torch.Tensor  # (..., B) number of accumulated steps


def init_carry(batch: int, num_image_tokens: int = NUM_IMAGE_TOKENS,
               device=None, layers: Optional[int] = None) -> AttnCarry:
    """An empty carry; with ``layers`` one per extracted layer, stacked
    along a leading axis (JAX ``vmap``s the same carry over that axis)."""
    lead = (batch,) if layers is None else (layers, batch)
    return AttnCarry(
        total=torch.zeros((*lead, num_image_tokens), dtype=torch.float32,
                          device=device),
        count=torch.zeros(lead, dtype=torch.float32, device=device),
    )


def init_layer_carry(extract_layer, batch: int, num_image_tokens: int,
                     device=None) -> Optional[AttnCarry]:
    """The carry an extract-layer spec needs: None for the answer-only path
    (``extract_layer`` None), one carry for a layer, a carry per layer along
    a leading axis for a sequence of layers."""
    if extract_layer is None:
        return None
    layers = None if isinstance(extract_layer, int) else len(tuple(extract_layer))
    return init_carry(batch, num_image_tokens, device=device, layers=layers)


def slice_and_pool_attention(
    attn_probs: torch.Tensor,   # (..., B, H, kv_len) post-softmax rows
    img_start: torch.Tensor,    # (B,) per-sample image-token start
    num_image_tokens: int = NUM_IMAGE_TOKENS,
) -> torch.Tensor:
    """Per-sample slice [st, st+N) (shifted by left padding), renormalize,
    mean over heads -> (..., B, N). Positions past the row's end count as
    0. Leading axes (one per extracted layer) share ``img_start``."""
    B, H, kv = attn_probs.shape[-3:]
    pos = torch.arange(num_image_tokens, device=attn_probs.device)[None, :]
    idx = img_start.to(torch.int64)[:, None] + pos               # (B, N)
    valid = idx < kv
    idx = torch.clamp(idx, 0, kv - 1)
    shape = (*attn_probs.shape[:-1], num_image_tokens)
    rows = torch.gather(attn_probs.to(torch.float32), -1,
                        idx[:, None, :].expand(shape))
    rows = torch.where(valid[:, None, :], rows, torch.zeros_like(rows))
    rows = rows / (torch.sum(rows, dim=-1, keepdim=True) + 1e-12)
    return torch.mean(rows, dim=-2)


def accumulate_step(
    carry: AttnCarry,
    attn_probs: torch.Tensor,  # (..., B, H, kv_len), the carry's leading axes
    img_start: torch.Tensor,   # (B,)
    active: torch.Tensor,      # (B,) 1.0 while the sample is still generating
    num_image_tokens: int = NUM_IMAGE_TOKENS,
) -> AttnCarry:
    row = slice_and_pool_attention(attn_probs, img_start, num_image_tokens)
    act = active.to(torch.float32)
    return AttnCarry(total=carry.total + row * act[:, None],
                     count=carry.count + act)


def finalize(carry: AttnCarry, side: int = 24,
             side_w: Optional[int] = None) -> torch.Tensor:
    """Mean over steps -> (..., B, side, side_w or side); uniform where no
    step was accumulated (llava.py:126-128, 404-408). ``side_w`` serves
    rectangular grids (Qwen2-VL on non-square images)."""
    n = carry.total.shape[-1]
    uniform = torch.full_like(carry.total, 1.0 / n)
    mean = carry.total / torch.clamp(carry.count[..., None], min=1.0)
    out = torch.where(carry.count[..., None] > 0, mean, uniform)
    return out.reshape(*out.shape[:-1], side, side if side_w is None else side_w)
