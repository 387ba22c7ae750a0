"""Attention-guided warp (counterpart of ``warp_batch_by_attention`` and
``warp_image_by_attention`` in ``attwarp_tpu/warp/warp.py``).

The grid maps (transform -> marginals -> CDF -> inverse map) are plain
PyTorch; the resample is kernel K1 (``kernels/warp_resample.py``) at every
image size. JAX's ``method`` ladder (``mm``, ``mm_int8``, ``pallas`` by
size) chose among TPU forms and is not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from attwarp_tpu_torch.kernels.warp_resample import warp_resample
from attwarp_tpu_torch.warp.grid import attention_profiles, inverse_axis_map
from attwarp_tpu_torch.warp.transforms import WarpParams


def warp_grid_maps(
    att_maps: torch.Tensor, image_hw: Tuple[int, int], new_width: int,
    new_height: int, params: WarpParams = WarpParams(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``att_maps (B, h, w)`` -> source coordinates ``map_x (B, new_width)``
    and ``map_y (B, new_height)`` in the pixels of an ``image_hw`` image.

    An attention map coarser than the image is inverted at attention
    resolution and rescaled from cells to pixels (c -> c * W / w): the same
    as nearest-upsampling the map first, since the piecewise-constant
    density integrates to the same CDF."""
    H, W = image_hw
    h, w = att_maps.shape[-2], att_maps.shape[-1]
    px, py, tx, ty = attention_profiles(att_maps, params)
    map_x = inverse_axis_map(px, tx, new_width)
    map_y = inverse_axis_map(py, ty, new_height)
    if (h, w) != (H, W):
        map_x = map_x * (W / w)
        map_y = map_y * (H / h)
    return map_x, map_y


def warp_batch_by_attention(
    images: torch.Tensor,
    att_maps: torch.Tensor,
    new_width: int,
    new_height: int,
    params: WarpParams = WarpParams(),
) -> torch.Tensor:
    """``images (B, H, W, C)``, ``att_maps (B, h, w)`` -> warped ``(B,
    new_height, new_width, C)`` f32, on the images' device."""
    map_x, map_y = warp_grid_maps(att_maps, images.shape[1:3], new_width,
                                  new_height, params)
    return warp_resample(images.to(torch.float32).contiguous(),
                         map_x.contiguous(), map_y.contiguous())


def warp_image_by_attention(
    image: torch.Tensor,
    att_map: torch.Tensor,
    new_width: int,
    new_height: int,
    params: WarpParams = WarpParams(),
) -> torch.Tensor:
    """Warp one ``image (H, W[, C])`` by ``att_map (H, W)`` to ``(new_height,
    new_width[, C])`` f32 (reference new_method.py:198-283): a batch of one
    through ``warp_batch_by_attention``, so K1 on a CUDA tensor and its
    plain version on a CPU tensor. The reference resizes the image to the
    map first (``warp/io.py::save_warped_image`` does too); a map of
    another size is inverted at its own resolution and rescaled, as in
    ``warp_batch_by_attention``."""
    x = image if image.ndim == 3 else image[..., None]
    out = warp_batch_by_attention(x[None], att_map[None], new_width, new_height, params)[0]
    return out if image.ndim == 3 else out[..., 0]
