"""Attention-guided warp throughput, the reference's headline (counterpart
of the root ``bench.py``).

The whole warp per image: attention transform -> marginal profiles -> CDF
-> inverse maps (``warp/warp.py::warp_grid_maps``) -> separable bilinear
resample (kernel K1), batch 128, 24x24 attention driving a 336x336x3 f32
warp. 200 warps are chained: each output is the next input, and the
attention depends on that carry (``atts + out[0, 0, 0, 0] * 1e-20``), so no
stage can be hoisted. The best of 3 chains on the host clock, the device
synchronized.

    python -m attwarp_tpu_torch.tools.bench [--device cuda]

Prints every chain, then one JSON line
``{"metric": "attention_warp_throughput_336px_b128", "value": N, "unit":
"warps/sec/gpu"}``. The JAX tool's ``vs_baseline`` compared against a TPU
target; no TPU figure is a target here, so it has none.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from attwarp_tpu_torch.tools.bench_utils import repeat, report
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.transforms import WarpParams
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

BATCH, IMG, ATT, ITERS = 128, 336, 24, 200


def inputs(device, B: int = BATCH, img: int = IMG, att: int = ATT):
    """(images (B, img, img, 3), attention (B, att, att)), f32 uniform from
    seed 0, on ``device``."""
    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.random((B, img, img, 3)), dtype=torch.float32, device=device)
    atts = torch.as_tensor(rng.random((B, att, att)), dtype=torch.float32, device=device)
    return images, atts


def chained(images, atts, iters: int, params: WarpParams = WarpParams()):
    """``iters`` warps, each output the next input, the attention nudged by
    the carry."""
    img = images.shape[1]
    out = images
    for _ in range(iters):
        out = warp_batch_by_attention(out, atts + out[0, 0, 0, 0] * 1e-20, img, img, params)
    return out


def run(device="cuda", B: int = BATCH, img: int = IMG, att: int = ATT,
        iters: int = ITERS, repeats: int = 3) -> dict:
    """One warm-up chain, then ``repeats`` timed chains; warps/s of the
    fastest. Returns the figures and the last chain's output."""
    device = torch.device(device)
    images, atts = inputs(device, B, img, att)
    chained(images, atts, iters)
    timing, out = repeat(lambda: chained(images, atts, iters), repeats, device)
    report(f"warp {img}px b{B}, chains of {iters} (ms a batch)", timing, device, per=iters)
    return {"warps_per_s": B * iters / timing["min"], "timing": timing, "out": out}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench (PyTorch): warps/s at 336 px, batch 128")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    device = require_device(parser().parse_args(argv).device, "bench")
    r = run(device)
    print(json.dumps({"metric": "attention_warp_throughput_336px_b128",
                      "value": round(r["warps_per_s"], 1), "unit": "warps/sec/gpu"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
