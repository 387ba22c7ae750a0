"""Kernel K1: the separable bilinear warp resample.

``warp_resample(images, map_x, map_y)`` warps channels-last ``images (B, H,
W, C)`` f32 with per-sample source coordinates ``map_x (B, W_out)`` and
``map_y (B, H_out)`` into ``(B, H_out, W_out, C)`` f32, with
``cv2.remap(INTER_LINEAR, BORDER_REPLICATE)`` semantics.

- CPU tensors: the plain version, ``warp/resample.py::remap_bilinear_separable``.
- CUDA tensors: ``csrc/warp_resample.cu``, or an exception.

Replaces the TPU kernel ``attwarp_tpu/ops/pallas_warp.py::warp_batch_pallas_cf``.
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.kernels._build import check_launch, library, require_cuda
from attwarp_tpu_torch.warp.resample import remap_bilinear_separable


def warp_resample(images: torch.Tensor, map_x: torch.Tensor,
                  map_y: torch.Tensor) -> torch.Tensor:
    if images.device.type == "cpu":
        return remap_bilinear_separable(images, map_x, map_y)
    if images.ndim != 4 or map_x.ndim != 2 or map_y.ndim != 2:
        raise ValueError(f"warp_resample: want images (B, H, W, C), maps "
                         f"(B, n); got {tuple(images.shape)}, "
                         f"{tuple(map_x.shape)}, {tuple(map_y.shape)}")
    B, H, W, C = images.shape
    if map_x.shape[0] != B or map_y.shape[0] != B:
        raise ValueError("warp_resample: maps must have the images' batch size")
    for name, t in (("images", images), ("map_x", map_x), ("map_y", map_y)):
        if t.dtype != torch.float32:
            raise TypeError(f"warp_resample: {name} must be float32, got {t.dtype}")
    if H == 0 or W == 0:
        raise ValueError("warp_resample: empty source image")
    require_cuda("warp_resample", images, map_x, map_y)
    H_out, W_out = map_y.shape[1], map_x.shape[1]
    out = torch.empty((B, H_out, W_out, C), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().attwarp_warp_resample(
            images.data_ptr(), map_x.data_ptr(), map_y.data_ptr(),
            out.data_ptr(), B, H, W, C, H_out, W_out, stream,
        )
    check_launch(rc, "warp_resample")
    warp_resample.launches += 1
    return out


warp_resample.launches = 0
