"""Phase breakdown of ``AttWarpPipeline.run`` at LLaVA-1.5-7B shape
(counterpart of ``tools/profile_pipeline.py``): where the milliseconds of
the two-pass flow go.

Each phase of the pipeline's flow for one shape group is timed apart, on
the host clock with a device synchronize at both ends, on the inputs of
``tools/bench_pipeline.py``: preprocess (upload and resize to the tower's
input), pass-1 extract, the bucketed 0-255 image, the MOTA masks, the
batched warp (K1), pass-2 preprocess, pass-2 answer. The first iteration
warms up; the last is the one to read.

    python -m attwarp_tpu_torch.tools.profile_pipeline [mode] [batch] [--device cuda]

mode: bf16 | int8[+flash][+kv8] (default int8+flash); batch default 16.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from attwarp_tpu_torch.extract.resize import (
    resize_images_batch,
    resize_scale_device,
    to01_scale,
)
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.pipeline import AttWarpPipeline
from attwarp_tpu_torch.tools.bench_pipeline import QUESTION
from attwarp_tpu_torch.tools.bench_utils import (
    card,
    make_llava_7b_backend,
    random_images,
    sync,
)
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.warp.blend import mota_mask
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

PHASES = ("preproc1", "extract", "bucket", "masks", "warp", "preproc2", "answer")


def phases(pipe: AttWarpPipeline, images, questions) -> dict:
    """One pass of the pipeline's flow over same-shape ``images``, each
    phase timed apart: {phase: seconds}, and the answers."""
    backend, dev = pipe.backend, pipe.backend.device
    t, out = {}, {}

    def timed(name, fn):
        sync(dev)
        t0 = time.perf_counter()
        r = fn()
        sync(dev)
        t[name] = time.perf_counter() - t0
        return r

    size = backend.image_size
    tgt = pipe._bucket_target(images[0].shape[:2])
    batch_in = timed("preproc1", lambda: resize_images_batch(images, size, dev))
    maps, _ = timed("extract", lambda: backend.extract(batch_in, questions,
                                                       max_new_tokens=pipe.max_new_tokens))
    img255 = timed("bucket", lambda: resize_scale_device(
        torch.as_tensor(np.stack(images)).to(dev), 255.0 * to01_scale(images[0]), tgt))
    masks = timed("masks", lambda: mota_mask(maps, tgt, enhance_coe=pipe.enhance_coe,
                                             kernel_size=pipe.kernel_size))
    warped = timed("warp", lambda: warp_batch_by_attention(
        img255, masks.to(torch.float32), pipe.warp_size, pipe.warp_size, pipe.params))
    pix2 = timed("preproc2", lambda: resize_scale_device(warped, 1.0 / 255.0, (size, size)))
    out["answers"] = timed("answer", lambda: backend.answer_batch(
        pix2, questions, max_new_tokens=pipe.max_new_tokens))
    out["maps"], out["warped"] = maps, warped
    return t, out


def run(backend, B: int = 16, iters: int = 2, label: str = "") -> dict:
    """``iters`` passes of ``phases`` on fresh images; every iteration
    printed. Returns the last iteration's phase seconds, inputs and
    outputs."""
    pipe = AttWarpPipeline(backend, warp_size=500, max_new_tokens=20)
    rng = np.random.default_rng(0)
    questions = [QUESTION] * B
    for it in range(iters):
        images = random_images(rng, B)
        t, out = phases(pipe, images, questions)
        total = sum(t.values())
        print(f"profile {label} B={B} iter {it}: total {total * 1e3:.1f} ms | " +
              " | ".join(f"{k} {v * 1e3:.1f}" for k, v in t.items()) +
              f" | {card(backend.device)}")
    return {"seconds": t, "total": total, "images": images, "questions": questions, **out}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("profile_pipeline (PyTorch)")
    p.add_argument("mode", nargs="?", default="int8+flash")
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "profile_pipeline")
    backend, label = make_llava_7b_backend(args.mode, tokenizer=DryRunTokenizer(),
                                           device=device)
    run(backend, args.batch, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
