"""The warp headline split into its terms (counterpart of
``tools/profile_warp_terms.py``), at 336 px, batch 128, 24x24 attention:

  full       the benched warp (``tools/bench.py``): grid maps + K1
  grid       transform -> marginals -> CDF -> inverse maps
             (``warp/warp.py::warp_grid_maps``)
  resample   K1 alone (``kernels/warp_resample.py``), the maps held fixed

The port has no interpolation-matrix build (JAX's ``method="mm"``), so
``grid`` ends at the maps. Each term is a chain of ``iters`` calls, each
output feeding the next input (as ``tools/bench.py``), timed as the best
of 3 on the host clock with the device synchronized; us per image.

    python -m attwarp_tpu_torch.tools.profile_warp_terms [--img 336] [--batch 128] [--att 24] [--iters 200] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import torch

from attwarp_tpu_torch.kernels.warp_resample import warp_resample
from attwarp_tpu_torch.tools.bench import chained, inputs
from attwarp_tpu_torch.tools.bench_utils import card, repeat, report
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.transforms import WarpParams
from attwarp_tpu_torch.warp.warp import warp_grid_maps


def run(device="cuda", B: int = 128, img: int = 336, att: int = 24, iters: int = 200,
        repeats: int = 3) -> dict:
    """The three terms, each warmed once then timed ``repeats`` times.
    Returns us per image of each and the shape."""
    device = torch.device(device)
    params = WarpParams()
    images, atts = inputs(device, B, img, att)
    maps = warp_grid_maps(atts, (img, img), img, img, params)

    def grid():
        carry = torch.zeros((), device=device)
        for _ in range(iters):
            mx, my = warp_grid_maps(atts + carry * 1e-20, (img, img), img, img, params)
            carry = mx[0, 0] + my[0, 0]
        return carry

    def resample():
        out = images
        for _ in range(iters):
            out = warp_resample(out, maps[0] + out[0, 0, 0, 0] * 1e-20, maps[1])
        return out

    terms = {"full": lambda: chained(images, atts, iters, params), "grid": grid,
             "resample": resample}
    res = {}
    for name, fn in terms.items():
        fn()
        timing, _ = repeat(fn, repeats, device)
        report(f"warp term {name}, {img}px b{B}, chains of {iters} (ms a batch)", timing,
               device, per=iters)
        res[f"{name}_us_per_image"] = timing["min"] / iters / B * 1e6
    res["shape"] = {"img": img, "batch": B, "att": att, "iters": iters}
    res["full_warps_per_sec"] = 1e6 / res["full_us_per_image"]
    res["sum_grid_plus_resample_us"] = res["grid_us_per_image"] + res["resample_us_per_image"]
    res["card"] = card(device)
    return res


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("profile_warp_terms (PyTorch)")
    ap.add_argument("--img", type=int, default=336)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--att", type=int, default=24)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "profile_warp_terms")
    res = run(device, args.batch, args.img, args.att, args.iters)
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
