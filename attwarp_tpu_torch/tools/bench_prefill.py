"""7B prefill throughput at the extraction shape, dense against flash
attention (counterpart of ``tools/bench_prefill.py``).

``llama_prefill`` at LLaVA-1.5-7B text width (32 layers, 4096 wide, 32
heads) with layer-20 extraction on bf16 weights, B=8 x T=640 random
embeddings: ``dense`` attention or ``flash`` (kernel K2). Prints ms per
prefill, samples/s and TFLOP/s, counted as the JAX tool's 2 x 6.74e9 x B x
T, with their share of the card's bf16 peak (``kernels/roofline.py``).

    python -m attwarp_tpu_torch.tools.bench_prefill [dense|flash] [batch] [seqlen] [--device cuda]

One warm-up prefill, then 3 repeats of 4 prefills, each repeat printed.
Each prefill is independent: eager PyTorch neither returns early nor drops
work, so the JAX tool's probe chain is not needed.
"""

from __future__ import annotations

import argparse

import torch

from attwarp_tpu_torch.kernels.roofline import BF16_FLOPS
from attwarp_tpu_torch.models.llama import llama_prefill
from attwarp_tpu_torch.tools.bench_utils import (
    card,
    make_llava_7b_backend,
    repeat,
    report,
    tree_bytes,
)
from attwarp_tpu_torch.utils.device import require_device

ITERS, EXTRACT_LAYER = 4, 20
LLAMA_7B_PARAMS = 6.74e9   # the JAX tool's matmul parameter count


def check_mode(mode: str) -> bool:
    """``dense`` or ``flash`` -> use_flash."""
    if mode not in ("dense", "flash"):
        raise ValueError(f"mode {mode!r}: expected dense or flash")
    return mode == "flash"


def timed_prefill(prefill, flops: float, B: int, T: int, device, label: str,
                  repeats: int = 3, iters: int = ITERS) -> dict:
    """Warm-up call of ``prefill()``, then ``repeats`` x ``iters`` timed
    calls; ms a prefill, samples/s, TFLOP/s for ``flops`` a prefill and its
    share of the bf16 peak (on a card only). Returns the figures and the
    last logits and row."""
    prefill()

    def prefills():
        for _ in range(iters):
            out = prefill()
        return out

    timing, (logits, row) = repeat(prefills, repeats, device)
    report(f"{label} prefill B={B} T={T}, {iters} a repeat (ms a prefill)", timing, device,
           per=iters)
    per = timing["min"] / iters
    out = {"ms": per * 1e3, "samples_per_s": B / per, "timing": timing, "logits": logits,
           "row": row, "tflops": None, "peak_share": None}
    rate = "TFLOP/s not measured (a CPU run)"
    if torch.device(device).type == "cuda":
        out["tflops"] = flops / per / 1e12
        out["peak_share"] = out["tflops"] * 1e12 / BF16_FLOPS
        rate = (f"{out['tflops']:.1f} TFLOP/s bf16, {100 * out['peak_share']:.1f}% of the "
                f"{BF16_FLOPS / 1e12:g} TFLOP/s peak")
    print(f"{label}: {per * 1e3:.2f} ms/prefill at B={B} T={T} ({B / per:.2f} samples/s; "
          f"{rate}) | {card(device)}")
    return out


def run(text_params, cfg, use_flash: bool, B: int = 8, T: int = 640, repeats: int = 3,
        iters: int = ITERS, device="cuda", seed: int = 0,
        extract_layer: int = EXTRACT_LAYER) -> dict:
    """``llama_prefill`` of B x T random bf16 embeddings (normal x 0.1 from
    ``seed``) over ``text_params``, extracting ``extract_layer``'s row; see
    ``timed_prefill``. Returns its figures and the embeddings."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = text_params["embed_tokens"].dtype
    emb = torch.randn((B, T, cfg.hidden_size), generator=g, device=device, dtype=dtype) * 0.1
    mask = torch.ones((B, T), dtype=torch.bool, device=device)

    def prefill():
        logits, _kv, row = llama_prefill(text_params, cfg, emb, mask, max_seq=T,
                                         extract_layer=extract_layer, use_flash=use_flash)
        return logits, row

    out = timed_prefill(prefill, 2 * LLAMA_7B_PARAMS * B * T, B, T, device,
                        "flash" if use_flash else "dense", repeats, iters)
    return {**out, "embeds": emb, "mask": mask}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_prefill (PyTorch)")
    p.add_argument("mode", nargs="?", default="dense")
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("seqlen", nargs="?", type=int, default=640)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "bench_prefill")
    use_flash = check_mode(args.mode)
    backend, _ = make_llava_7b_backend("bf16", device=device)
    text = backend.model.params["llama"]
    print(f"text params: {tree_bytes(text) / 2**30:.2f} GiB bf16; B={args.batch} "
          f"T={args.seqlen} mode={args.mode}")
    run(text, backend.model.cfg.text, use_flash, args.batch, args.seqlen, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
