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
    total: torch.Tensor  # (B, num_image_tokens) running sum of per-step rows
    count: torch.Tensor  # (B,) number of accumulated steps


def init_carry(batch: int, num_image_tokens: int = NUM_IMAGE_TOKENS,
               device=None) -> AttnCarry:
    return AttnCarry(
        total=torch.zeros((batch, num_image_tokens), dtype=torch.float32,
                          device=device),
        count=torch.zeros((batch,), dtype=torch.float32, device=device),
    )


def slice_and_pool_attention(
    attn_probs: torch.Tensor,   # (B, H, kv_len) post-softmax row
    img_start: torch.Tensor,    # (B,) per-sample image-token start
    num_image_tokens: int = NUM_IMAGE_TOKENS,
) -> torch.Tensor:
    """Per-sample slice [st, st+N) (shifted by left padding), renormalize,
    mean over heads -> (B, N). Positions past the row's end count as 0."""
    B, H, kv = attn_probs.shape
    pos = torch.arange(num_image_tokens, device=attn_probs.device)[None, :]
    idx = img_start.to(torch.int64)[:, None] + pos               # (B, N)
    valid = idx < kv
    idx = torch.clamp(idx, 0, kv - 1)
    rows = torch.gather(attn_probs.to(torch.float32), 2,
                        idx[:, None, :].expand(B, H, num_image_tokens))
    rows = torch.where(valid[:, None, :], rows, torch.zeros_like(rows))
    rows = rows / (torch.sum(rows, dim=-1, keepdim=True) + 1e-12)
    return torch.mean(rows, dim=1)


def accumulate_step(
    carry: AttnCarry,
    attn_probs: torch.Tensor,  # (B, H, kv_len)
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
    """Mean over steps -> (B, side, side_w or side); uniform where no step
    was accumulated (llava.py:126-128, 404-408). ``side_w`` serves
    rectangular grids (Qwen2-VL on non-square images)."""
    n = carry.total.shape[-1]
    uniform = torch.full_like(carry.total, 1.0 / n)
    mean = carry.total / torch.clamp(carry.count[:, None], min=1.0)
    out = torch.where(carry.count[:, None] > 0, mean, uniform)
    return out.reshape(out.shape[0], side, side if side_w is None else side_w)
