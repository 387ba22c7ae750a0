"""Kernel K1: the separable bilinear warp resample.

``warp_resample(images, map_x, map_y)`` warps channels-last ``images (B, H,
W, C)`` f32 with per-sample source coordinates ``map_x (B, W_out)`` and
``map_y (B, H_out)`` into ``(B, H_out, W_out, C)`` f32, with
``cv2.remap(INTER_LINEAR, BORDER_REPLICATE)`` semantics.

- CPU tensors: the plain version, ``warp/resample.py::remap_bilinear_separable``.
- CUDA tensors: ``csrc/warp_resample.cu``, or an exception.

Replaces the TPU kernel ``attwarp_tpu/ops/pallas_warp.py::warp_batch_pallas_cf``.

``k1_plan`` cuts the work into blocks for a card of ``sm_count`` SMs: one
block per (image, band of ``rows`` output rows, tile of ``tile`` output
columns), with ``slots`` staged source rows of ``cap`` floats each in a ring
in shared memory (see the CUDA source for what each part does).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from attwarp_tpu_torch.kernels._build import check_launch, library, require_cuda
from attwarp_tpu_torch.warp.resample import remap_bilinear_separable

THREADS = 128                # one block; also the entry scan's width
MAX_ROWS = THREADS // 2      # the kernel's limit: two source-row entries per output row
MAX_SLOTS = 16               # the ring's mbarriers (the kernel's kMaxSlots)
SMEM_PER_SM = 228 * 1024     # H100: shared memory per SM
SMEM_BLOCK = 232448          # H100: the most one block may use (227 KB)
BLOCK_BUDGET = SMEM_PER_SM // 2 - 1024   # a tile's plan: two blocks per SM
MAX_BLOCKS_PER_SM = 2048 // THREADS
BLOCKS_PER_SM = 4            # the grid the plan aims for
BAND_ROWS = 4                # the longest band it picks


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def k1_smem(rows: int, tile: int, C: int, slots: int, cap: int) -> int:
    """Shared memory of one block, as the kernel lays it out: the slots'
    mbarriers, the ring, the warps' output staging (128 floats each), the
    x-tap table (two offsets and a fraction per output float), the band's
    entries and y fractions, and scratch."""
    return (8 * MAX_SLOTS + 4 * slots * cap + 16 * THREADS + 12 * _up4(tile * C)
            + 4 * (2 * rows + 2 * rows + rows) + 4 * (2 + THREADS // 32))


class K1Plan(NamedTuple):
    """A launch plan of K1 (immutable: ``k1_plan`` caches one per shape)."""
    threads: int
    rows: int
    tile: int
    tiles: int
    slots: int
    cap: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=256)
def k1_plan(B: int, H: int, W: int, C: int, H_out: int, W_out: int,
            sm_count: int) -> K1Plan:
    """The launch plan of K1 for one shape on a card of ``sm_count`` SMs.

    - ``tile``: output columns per block. All of them, unless the x-tap
      table and two whole staged rows do not fit in ``BLOCK_BUDGET``; then
      the widest tile that does, its staged span sized for twice the
      average source width of a tile (a block whose maps need more reads
      its taps from global memory instead).
    - ``rows``: output rows per block, so that the grid has about
      ``BLOCKS_PER_SM`` blocks per SM where the output allows (one row per
      block at the dataset driver's B=1), at most ``BAND_ROWS``.
    - ``slots``: staged source rows per block: a double buffer, and a third
      slot where whole rows are staged and the grid is more than one wave
      of the blocks the card holds at once, so that a row's copy is in
      flight two rows ahead. In a single wave every block asks for its
      first rows at once, and fewer of them arrive sooner. (The card's sweep
      over rows and slots at the three timed shapes, in ``PERF.md``: bands
      of one to four rows and two or three slots were fastest; deeper rings
      and longer bands were slower at every shape.)
    """
    row_f = W * C
    tile = W_out
    cap = _up4(row_f)
    if k1_smem(MAX_ROWS, tile, C, 2, cap) > BLOCK_BUDGET:
        for k in range(2, W_out + 1):
            tile = max(4, (-(-W_out // k)) // 4 * 4)
            cols = min(W, 2 * -(-tile * W // W_out) + 2)
            cap = _up4(cols * C) + 4            # the span's rounding to 16 bytes
            if k1_smem(MAX_ROWS, tile, C, 2, cap) <= BLOCK_BUDGET or tile == 4:
                break
        room = (BLOCK_BUDGET - k1_smem(MAX_ROWS, tile, C, 0, 0)) // 8 // 4 * 4
        cap = min(cap, max(room, 0))
    tiles = -(-W_out // tile)
    rows = min(BAND_ROWS, max(1, -(-B * H_out * tiles // (BLOCKS_PER_SM * sm_count))))
    rows = -(-H_out // -(-H_out // rows))      # even bands within an image
    blocks = B * -(-H_out // rows) * tiles
    slots = 0
    if cap > 0:
        per_sm = min(MAX_BLOCKS_PER_SM, SMEM_PER_SM // (k1_smem(rows, tile, C, 3, cap) + 1024))
        slots = 3 if cap >= row_f and blocks > per_sm * sm_count else 2
    cap = cap if slots else 0
    return K1Plan(THREADS, rows, tile, tiles, slots, cap,
                  k1_smem(rows, tile, C, slots, cap), blocks)


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
    if max(H * W * C, H_out * W_out * C) >= 2**31:
        raise ValueError("warp_resample: one image must hold fewer than 2^31 values")
    out = torch.empty((B, H_out, W_out, C), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(images.device).multi_processor_count
    plan = k1_plan(B, H, W, C, H_out, W_out, sms)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = library().attwarp_warp_resample(
            images.data_ptr(), map_x.data_ptr(), map_y.data_ptr(),
            out.data_ptr(), B, H, W, C, H_out, W_out, plan.rows, plan.tile,
            plan.slots, plan.cap, plan.threads, plan.smem, stream,
        )
    check_launch(rc, "warp_resample")
    warp_resample.launches += 1
    return out


warp_resample.launches = 0
