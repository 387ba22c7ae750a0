"""Warp orchestration for one image and its artifact files (counterpart of
``attwarp_tpu/warp/io.py``).

``save_warped_image`` (reference new_method.py:405-506): load the image,
coerce the attention map (array, PIL image or list; a 3-D map is averaged
over its last axis), save the original and a JET overlay, resize the image
to the map's size, warp it on ``device`` (kernel K1 on a CUDA device) and
save the result. The warp runs on the card unless the caller passes
``device="cpu"``. Files go through ``data/imageio.py``; resizes equal
``jax.image.resize`` "linear" (``extract/resize.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch

from attwarp_tpu_torch.data.imageio import read_rgb, write_png
from attwarp_tpu_torch.extract.resize import resize_linear
from attwarp_tpu_torch.utils.colormap import apply_jet
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.transforms import Transform, WarpParams
from attwarp_tpu_torch.warp.warp import warp_image_by_attention

EPSILON = 1e-9


def _is_pil(x) -> bool:
    return type(x).__module__.startswith("PIL.")


def load_image_rgb(path_or_image) -> np.ndarray:
    """Path / PIL image / array -> (H, W, 3) uint8 RGB (an array that is not
    uint8 is rounded and clipped)."""
    if isinstance(path_or_image, str):
        return read_rgb(path_or_image)
    if _is_pil(path_or_image):
        return np.asarray(path_or_image.convert("RGB"))
    arr = np.asarray(path_or_image)
    if arr.dtype != np.uint8:
        arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    return arr


def coerce_att_map(att_map, default_hw: Tuple[int, int] = (500, 500)) -> np.ndarray:
    """Array / PIL image / list -> a 2-D float32 map; a list gives its first
    element (an empty one a map of 128s), a 3-D map its mean over the last
    axis (new_method.py:432-452)."""
    if isinstance(att_map, list):
        if not att_map:
            return np.ones(default_hw, dtype=np.float32) * 128
        att_map = att_map[0]
    att_map = np.squeeze(np.asarray(att_map, dtype=np.float32))
    if att_map.ndim == 3:
        att_map = att_map.mean(axis=2)
    if att_map.ndim != 2:
        raise ValueError(f"Attention map must be 2D, got shape {att_map.shape}")
    return att_map


def _resize_u8(image: np.ndarray, out_hw: Tuple[int, int], device=None) -> np.ndarray:
    """(H, W, C) -> (*out_hw, C) uint8, bilinear as ``jax.image.resize``."""
    x = torch.as_tensor(np.asarray(image, np.float32), device=device)[None]
    out = resize_linear(x, out_hw)[0].cpu().numpy()
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_image_to_match_attmap(image: np.ndarray, att_map: np.ndarray,
                                 device=None) -> np.ndarray:
    """The image resized (half-pixel centres, cv2 INTER_LINEAR convention) to
    the map's H x W (new_method.py:355-376)."""
    th, tw = att_map.shape[:2]
    if image.shape[:2] == (th, tw):
        return image.copy()
    return _resize_u8(image, (th, tw), device)


def attention_overlay(image: np.ndarray, att_map: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """Resize the map to the image first, then min-max normalize it (so the
    overlay keeps the full JET range when upsampling smooths the peak,
    new_method.py:461-469), colormap and alpha-blend."""
    a = np.asarray(att_map, np.float64)
    if a.shape[:2] != image.shape[:2]:
        x = torch.as_tensor(a, dtype=torch.float32)[None, ..., None]
        a = resize_linear(x, image.shape[:2])[0, ..., 0].numpy().astype(np.float64)
    lo, hi = a.min(), a.max()
    a = (a - lo) / (hi - lo) if hi > lo + EPSILON else np.zeros_like(a)
    heat = apply_jet(np.clip(a * 255, 0, 255).astype(np.uint8))
    out = heat.astype(np.float64) * alpha + image.astype(np.float64) * (1 - alpha)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def save_warped_image(
    image_path,
    att_map,
    original_image_save_path: Optional[str],
    masked_overlay_save_path: Optional[str],
    output_path: str,
    vis_path: Optional[str] = None,
    width: int = 500,
    height: int = 500,
    transform: Union[str, Transform] = "identity",
    exp_scale: float = 1.0,
    exp_divisor: float = 1.0,
    apply_inverse: bool = False,
    attention_alpha: float = 0.5,
    device="cuda",
) -> bool:
    """Warp one image by its map and save the warped image (plus the
    original, the overlay and the strip where their paths are given).
    The resize and the warp run on ``device``, the card (kernel K1) unless
    the caller asks for the CPU; without a card, ``cuda`` raises. Returns
    False, after printing the error, where any later step fails."""
    device = require_device(device, "save_warped_image")
    try:
        image = load_image_rgb(image_path)
        if original_image_save_path:
            write_png(original_image_save_path, image)

        att = coerce_att_map(att_map, default_hw=(height, width))

        if masked_overlay_save_path:
            write_png(masked_overlay_save_path,
                      attention_overlay(image, att, attention_alpha))

        image_for_warping = resize_image_to_match_attmap(image, att, device)
        params = WarpParams(
            transform=Transform.from_name(
                transform.value if isinstance(transform, Transform) else transform),
            exp_scale=exp_scale,
            exp_divisor=exp_divisor,
            apply_inverse_to_marginals=apply_inverse,
        )
        warped = warp_image_by_attention(
            torch.as_tensor(image_for_warping, dtype=torch.float32, device=device),
            torch.as_tensor(att, device=device), width, height, params,
        ).cpu().numpy()
        warped8 = np.clip(np.rint(warped), 0, 255).astype(np.uint8)
        write_png(output_path, warped8)

        if vis_path:
            save_visualization_strip(image_for_warping, att, warped8, vis_path,
                                     params.transform.value, attention_alpha)
        return True
    except Exception as e:
        print(f"Error during processing: {e}")
        return False


def save_visualization_strip(
    image: np.ndarray,
    att_map: np.ndarray,
    warped_image: np.ndarray,
    output_path: str,
    transform_name: str,
    attention_alpha: float = 0.5,
) -> None:
    """Three panels [original | attention overlay | warped] with labels and a
    20 px grid on the warped panel (new_method.py:285-353). The labels are
    drawn with Pillow's default font, so this needs Pillow."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as exc:
        raise RuntimeError(f"{output_path}: the visualization strip draws its "
                           f"labels with Pillow, which is not installed") from exc

    overlay = attention_overlay(image, att_map, attention_alpha)
    h = max(image.shape[0], warped_image.shape[0])

    def fit(im: np.ndarray) -> np.ndarray:
        if im.shape[0] == h:
            return im
        return _resize_u8(im, (h, int(im.shape[1] * (h / im.shape[0]))))

    panels = [fit(image), fit(overlay), fit(warped_image)]
    strip = np.concatenate(panels, axis=1)
    img = Image.fromarray(strip)
    draw = ImageDraw.Draw(img)
    x = 0
    for label, panel in zip(
            ["Original", "Attention Map", f"Warped ({transform_name})"], panels):
        draw.text((x + 10, 10), label, fill=(255, 255, 255))
        if x:
            draw.line([(x, 0), (x, h)], fill=(255, 255, 255), width=2)
        x += panel.shape[1]
    x0 = panels[0].shape[1] + panels[1].shape[1]
    for gx in range(x0, strip.shape[1], 20):
        draw.line([(gx, 0), (gx, h)], fill=(255, 255, 255), width=1)
    for gy in range(0, h, 20):
        draw.line([(x0, gy), (strip.shape[1], gy)], fill=(255, 255, 255), width=1)
    write_png(output_path, np.asarray(img))


def next_run_dir(base_output_dir: str) -> str:
    """A new ``run_N`` directory under ``base_output_dir``, N counting up
    from 0 (new_method.py:534-545)."""
    os.makedirs(base_output_dir, exist_ok=True)
    run_id = 0
    while True:
        d = os.path.join(base_output_dir, f"run_{run_id}")
        if not os.path.exists(d):
            os.makedirs(d)
            return d
        run_id += 1
