"""End-to-end two-pass pipeline throughput at LLaVA-1.5-7B shape
(counterpart of ``tools/bench_pipeline.py``).

The product number: extract attention (pass 1) -> MOTA mask -> warp ->
answer on the warped image (pass 2), as samples/s on one card, through the
real ``AttWarpPipeline.run`` (device resizes, tokenization, the batched
warp through K1 and both MLLM passes, K2 under ``+flash`` and K3 under
``+kv8``). Random weights at the exact 7B geometry with the dry-run
word-level tokenizer, 480x640 images, a 500 px warp, 20 new tokens a pass.

    python -m attwarp_tpu_torch.tools.bench_pipeline [mode] [batch] [--device cuda]

mode: bf16 | int8[+flash][+kv8] (default int8+flash); batch default 16.
One warm-up run, then 3 repeats of 2 runs on fresh images, each repeat
printed; the figure is the min, as the JAX tool's. ``--trace DIR`` runs the
repeats inside ``utils/profiling.py::device_trace`` (``DIR/trace.json``).
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np

from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.pipeline import AttWarpPipeline
from attwarp_tpu_torch.tools.bench_utils import (
    card,
    make_llava_7b_backend,
    random_images,
    repeat,
    report,
)
from attwarp_tpu_torch.utils.device import require_device
from attwarp_tpu_torch.utils.profiling import device_trace

QUESTION = "what is the text on the label?"


def run(backend, B: int = 16, repeats: int = 3, iters: int = 2, trace_dir=None,
        label: str = "") -> dict:
    """Warm-up run, then ``repeats`` x ``iters`` timed runs of
    ``AttWarpPipeline.run`` on B fresh images a repeat (inside
    ``device_trace(trace_dir)`` where given). Returns the figures, the last
    repeat's images and questions and its ``AttWarpResult``."""
    pipe = AttWarpPipeline(backend, warp_size=500, max_new_tokens=20)
    rng = np.random.default_rng(0)
    questions = [QUESTION] * B
    res = pipe.run(random_images(rng, B), questions)
    if not np.isfinite(res.warped).all():
        raise RuntimeError("bench_pipeline: warped images not finite")
    print(f"first batch: maps {res.attention_maps.shape}, warped {res.warped.shape}, "
          f"answers {len(res.second_answers)}")

    def batches(images):
        for _ in range(iters):
            out = pipe.run(images, questions)
        return images, out

    dev = backend.device
    with device_trace(trace_dir) if trace_dir else contextlib.nullcontext():
        timing, (images, res) = repeat(batches, repeats, dev,
                                       inputs=lambda: (random_images(rng, B),))
    report(f"pipeline {label} B={B}, {iters} runs a repeat (ms a batch: extract 640-token "
           f"prefill + 20 decode -> mask -> 500 px warp -> answer 20 new)",
           timing, dev, per=iters)
    sps = B * iters / timing["min"]
    print(f"pipeline {label}: {sps:.3f} samples/s end-to-end (min), "
          f"{B * iters / timing['median']:.3f} (median) | {card(dev)}")
    return {"samples_per_s": sps, "timing": timing, "images": images,
            "questions": questions, "result": res}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_pipeline (PyTorch)")
    p.add_argument("mode", nargs="?", default="int8+flash")
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace", default=None, help="write a device trace of the repeats here")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "bench_pipeline")
    backend, label = make_llava_7b_backend(args.mode, tokenizer=DryRunTokenizer(),
                                           device=device)
    run(backend, args.batch, trace_dir=args.trace, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
