"""Span breakdown of ``AttWarpPipeline.run`` at LLaVA-1.5-7B shape
(counterpart of ``tools/profile_pipeline.py``): where the milliseconds of
the two-pass flow go.

Runs the pipeline itself under ``utils/profiling.py::tracing`` on the
inputs of ``tools/bench_pipeline.py`` and prints the summed host seconds of
each of its spans (``PHASES``; ``decode_step`` and ``prefill`` summed over
both passes). Spans do not synchronise the device, so a span that launches
work ends before its work does, and the wait shows in the next span that
fetches (``pipeline.to_host``, ``backend.detokenize``). The first iteration
warms up; the last is the one to read.

    python -m attwarp_tpu_torch.tools.profile_pipeline [mode] [batch] [--device cuda]

mode: bf16 | int8[+flash][+kv8] (default int8+flash); batch default 16.
"""

from __future__ import annotations

import argparse

import numpy as np

from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.pipeline import AttWarpPipeline
from attwarp_tpu_torch.tools.bench_pipeline import QUESTION
from attwarp_tpu_torch.tools.bench_utils import card, make_llava_7b_backend, random_images
from attwarp_tpu_torch.utils import profiling
from attwarp_tpu_torch.utils.device import require_device

# the spans of one LLaVA pipeline run, outermost first
PHASES = ("pipeline.run", "pipeline.resize", "backend.extract", "backend.prepare", "vision",
          "prefill", "decode_step", "backend.detokenize", "pipeline.group", "pipeline.mask",
          "pipeline.warp", "pipeline.to_host", "backend.answer")


def run(backend, B: int = 16, iters: int = 2, label: str = "") -> dict:
    """``iters`` pipeline runs on fresh images, each under the recorder;
    every iteration printed. Returns the last iteration's seconds by span,
    its inputs and outputs."""
    pipe = AttWarpPipeline(backend, warp_size=500, max_new_tokens=20)
    rng = np.random.default_rng(0)
    questions = [QUESTION] * B
    for it in range(iters):
        images = random_images(rng, B)
        with profiling.tracing() as rec:
            res = pipe.run(images, questions)
        t = rec.seconds()
        print(f"profile {label} B={B} iter {it}: total {t['pipeline.run'] * 1e3:.1f} ms | " +
              " | ".join(f"{k} {t[k] * 1e3:.1f}" for k in PHASES[1:] if k in t) +
              f" | {card(backend.device)}")
    return {"seconds": t, "total": t["pipeline.run"], "images": images, "questions": questions,
            "answers": res.second_answers, "maps": res.attention_maps, "warped": res.warped}


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
