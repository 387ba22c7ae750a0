"""End-to-end batched extraction throughput at LLaVA-1.5-7B shape
(counterpart of ``tools/bench_extract.py``).

The framework's dominant production cost: image preprocess -> CLIP tower
-> 640-token prefill -> 20-token greedy decode with layer-20 attention
accumulated -> 24x24 maps, as samples/s on one card. Each round resizes
and CLIP-normalizes fresh host images on the device (the dataset driver's
path) and calls ``LlavaBackend.extract_from_ids`` on left-padded ids whose
576-token image span starts at 32.

    python -m attwarp_tpu_torch.tools.bench_extract [mode] [batch] [--device cuda]

mode: bf16 | int8[+kv8][+flash] (default bf16); batch default 1. One
warm-up round, then 3 repeats of 4 rounds, each repeat printed.
"""

from __future__ import annotations

import argparse

import numpy as np

from attwarp_tpu_torch.extract.resize import clip_pixels
from attwarp_tpu_torch.tools.bench_utils import card, make_llava_7b_backend, repeat, report
from attwarp_tpu_torch.utils.device import require_device

T, NEW, LAYER, SPAN_AT = 640, 20, 20, 32


def prompt(backend, B: int, rng: np.random.Generator, T: int = T):
    """(ids (B, T), mask (B, T)) as the JAX tool draws them: random text ids
    below the image token (31999 at 7B) with the image span at ``SPAN_AT``,
    no padding."""
    cfg = backend.model.cfg
    ids = rng.integers(3, min(31999, cfg.image_token_index), size=(B, T)).astype(np.int64)
    ids[:, SPAN_AT:SPAN_AT + cfg.num_image_tokens] = cfg.image_token_index
    return ids, np.ones((B, T), np.int64)


def one_round(backend, ids, mask, images, max_new_tokens: int = NEW):
    """The driver's per-batch work: host images resized and CLIP-normalized
    on the device, then ``extract_from_ids``. Returns (tokens, maps)."""
    pixels = clip_pixels(list(images), backend.image_size, backend.device)
    return backend.extract_from_ids(ids, mask, pixels, max_new_tokens=max_new_tokens)


def run(backend, B: int = 1, repeats: int = 3, iters: int = 4, T: int = T,
        new: int = NEW, label: str = "") -> dict:
    """Warm-up round, then ``repeats`` x ``iters`` timed rounds on B fresh
    images a repeat. Returns the figures, the last round's ids, mask,
    images, tokens and maps."""
    rng = np.random.default_rng(0)
    ids, mask = prompt(backend, B, rng, T)

    def images():
        return ((rng.random((B, 480, 640, 3)) * 255).astype(np.uint8),)

    n = backend.num_patches_side
    gen, maps = one_round(backend, ids, mask, *images(), new)
    if tuple(maps.shape) != (B, n, n) or not bool(maps.isfinite().all()):
        raise RuntimeError(f"bench_extract: maps {tuple(maps.shape)} not finite (B, {n}, {n})")

    def rounds(imgs):
        for _ in range(iters):
            out = one_round(backend, ids, mask, imgs, new)
        return imgs, out

    dev = backend.device
    timing, (imgs, (gen, maps)) = repeat(rounds, repeats, dev, inputs=images)
    report(f"extract {label} B={B}, {iters} rounds a repeat (ms a batch: prefill {T} + "
           f"{new} decode + maps)", timing, dev, per=iters)
    sps = B * iters / timing["min"]
    print(f"extract {label}: {sps:.3f} samples/s (min), "
          f"{B * iters / timing['median']:.3f} (median) | {card(dev)}")
    return {"samples_per_s": sps, "timing": timing, "ids": ids, "mask": mask,
            "images": imgs, "tokens": gen, "maps": maps}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_extract (PyTorch)")
    p.add_argument("mode", nargs="?", default="bf16")
    p.add_argument("batch", nargs="?", type=int, default=1)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "bench_extract")
    backend, label = make_llava_7b_backend(args.mode, extract_layer=LAYER, device=device)
    print(f"B={args.batch} T={T} new={NEW}")
    run(backend, args.batch, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
