"""Cross-attention-sourced warping, the SD-warp ablation (counterpart of
``attwarp_tpu/warp/cross_attention.py``; reference
``Ablations/Stable_diffusion_based_warp.py``).

- ``compute_token_importance`` (:310-360): mean per-token attention mass
  over the captured maps, with timestep and layer selection.
- ``aggregate_attention_map_for_tokens`` (:365-402): the top-k token
  channels summed into 2-D maps, resized to the largest grid with cv2's
  cubic, averaged, min-max normalized.
- ``run_cross_attention_warp``: the whole ablation with an injectable
  ``capture_fn``; ``warp/sd_capture.py::make_sd_capture_fn`` builds the
  Stable Diffusion one.

Captured-map convention: ``{timestep: {layer_key: (B, heads, H, W,
tokens)}}``, each map a tensor (the capture keeps them on the card, about
250 MB a timestep at SD 2.1's geometry) or a numpy array. Maps are reduced
where they lie; only the top-k token indices cross to the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.blend import resize_cubic
from attwarp_tpu_torch.warp.iterative import condition_attention_map, iterative_warp
from attwarp_tpu_torch.warp.transforms import Transform


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


def _token_mass(a) -> torch.Tensor:
    """Per-token sum of one map over (B, heads, H, W), in float64 as JAX's
    NumPy sums it, so that the top-k order is the same."""
    return torch.sum(_tensor(a).to(torch.float64), dim=(0, 1, 2, 3))


def compute_token_importance(
    captured_maps: Dict,
    inference_step_selection: Optional[Sequence] = None,
    num_layers: Optional[int] = None,
    last_timestep: bool = False,
) -> torch.Tensor:
    """Per-token importance ``(tokens,)`` float64 on the maps' device: the
    attention mass summed over (B, heads, H, W), averaged over the selected
    timesteps and layers (``last_timestep``: the last layer key of the
    last timestep alone)."""
    if last_timestep:
        layer_dict = captured_maps[max(captured_maps.keys())]
        return _token_mass(layer_dict[max(layer_dict.keys())])

    timesteps = (
        [t for t in captured_maps if t in inference_step_selection]
        if inference_step_selection is not None
        else list(captured_maps.keys())
    )
    scores: List[torch.Tensor] = []
    for t in timesteps:
        keys = sorted(captured_maps[t].keys())
        if num_layers is not None:
            keys = keys[-num_layers:]
        scores.extend(_token_mass(captured_maps[t][k]) for k in keys)
    if not scores:
        raise ValueError("No attention maps to compute token importance")
    return torch.mean(torch.stack(scores), dim=0)


def aggregate_attention_map_for_tokens(
    captured_maps: Dict,
    token_indices: Sequence[int],
    inference_step_selection: Optional[Sequence] = None,
    num_last_layers: int = 1,
) -> torch.Tensor:
    """The selected token channels of each map summed to a 2-D map, every
    map resized to the largest grid, averaged and min-max normalized to [0,
    1]: ``(H, W)`` f32 on the maps' device."""
    maps_2d: List[torch.Tensor] = []
    steps = sorted(captured_maps.keys())
    if inference_step_selection is not None:
        steps = [s for s in steps if s in inference_step_selection]
    idx = [int(i) for i in token_indices]
    for step in steps:
        layer_dict = captured_maps[step]
        for key in sorted(layer_dict.keys())[-num_last_layers:]:
            attn = _tensor(layer_dict[key]).to(torch.float32)       # (B, heads, H, W, T)
            sel = attn[..., torch.as_tensor(idx, dtype=torch.int64, device=attn.device)]
            maps_2d.append(torch.sum(sel, dim=(0, 1, -1)))
    if not maps_2d:
        raise ValueError("No attention maps to aggregate")

    max_h = max(m.shape[0] for m in maps_2d)
    max_w = max(m.shape[1] for m in maps_2d)
    out = torch.stack([m if tuple(m.shape) == (max_h, max_w) else resize_cubic(m, (max_h, max_w))
                       for m in maps_2d]).mean(dim=0)
    out = out - out.min()
    return out / (out.max() + 1e-9)


def run_cross_attention_warp(
    image,
    prompt: str,
    capture_fn: Callable,
    top_k: int = 20,
    iterations: int = 1,
    width: int = 500,
    height: int = 500,
    transform: Transform = Transform.IDENTITY,
    exp_scale: float = 1.0,
    exp_divisor: float = 1.0,
    apply_inverse: bool = False,
    num_last_layers: int = 1,
    device="cuda",
):
    """The whole ablation: capture -> token importance -> top-k aggregation
    -> cubic upsample and Gaussian conditioning -> iterative warp.

    ``image (H, W, 3)``, a numpy array or a tensor; ``capture_fn(image,
    prompt)`` returns the captured-map dict (Stable Diffusion: truncated DDIM
    inversion, then a forward denoise with recording cross-attention
    processors). The conditioning and the warps run on ``device``, the card
    unless the caller asks for the CPU (without a card, ``cuda`` raises).

    Returns (the list of warp iterates, each ``(height, width, 3)`` f32, and
    the conditioned ``(H, W)`` map), tensors on ``device``."""
    device = require_device(device, "run_cross_attention_warp")
    captured = capture_fn(image, prompt)
    scores = compute_token_importance(captured)
    top = torch.argsort(scores, stable=True)[-top_k:].flip(0).tolist()
    att_lr = aggregate_attention_map_for_tokens(captured, top, num_last_layers=num_last_layers)
    img = _tensor(image).to(device=device, dtype=torch.float32)
    att = condition_attention_map(att_lr.to(device), tuple(img.shape[:2]))
    outs = iterative_warp(img, att, width, height, iterations=iterations,
                          transform=transform, exp_scale=exp_scale,
                          exp_divisor=exp_divisor, apply_inverse=apply_inverse)
    return outs, att
