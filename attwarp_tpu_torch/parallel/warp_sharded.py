"""Data-parallel batched warping (counterpart of
``attwarp_tpu/parallel/warp_sharded.py``).

Each warp is local to its image, so the batch splits over the ``data`` axis
with no exchange at all: every rank warps its own slice through
``warp/warp.py::warp_batch_by_attention`` (the grid maps, then kernel K1 on
a CUDA tensor). The optional gather, for a caller that wants the whole
batch on every rank, is the one collective.
"""

from __future__ import annotations

import torch

from attwarp_tpu_torch.parallel.comm import all_gather
from attwarp_tpu_torch.parallel.mesh import Mesh
from attwarp_tpu_torch.warp.transforms import WarpParams
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention


def make_sharded_warp(mesh: Mesh, new_width: int, new_height: int,
                      params: WarpParams = WarpParams(), gather: bool = False):
    """Returns ``fn(images (b, H, W, C), atts (b, h, w)) -> warped (b,
    H_out, W_out, C)`` over this rank's slice (``parallel/mesh.py::
    shard_batch`` of a batch whose size divides by the data axis), or the
    whole batch, every rank's slice in data order, with ``gather``. JAX's
    ``method`` (its ladder of TPU resample forms) has no counterpart: the
    resample is K1."""

    def local_warp(images: torch.Tensor, atts: torch.Tensor) -> torch.Tensor:
        out = warp_batch_by_attention(images, atts, new_width, new_height, params)
        return all_gather(out, mesh.data, 0) if gather else out

    return local_warp
