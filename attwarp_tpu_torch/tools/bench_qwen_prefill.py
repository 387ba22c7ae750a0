"""Qwen2-VL-7B text prefill throughput, dense against flash attention
(counterpart of ``tools/bench_qwen_prefill.py``).

The second family's extraction prefill (M-RoPE; GQA 28 query over 4 kv
heads, 3584 wide, 28 layers) at the 640-token bucket with layer-20
extraction on bf16 weights: ``qwen2vl_prefill`` with ``dense`` attention
or ``flash`` (kernel K2). TFLOP/s are counted as the JAX tool's 2 x (the
text tree's parameters) x B x T.

    python -m attwarp_tpu_torch.tools.bench_qwen_prefill [dense|flash] [batch] [seqlen] [--device cuda]

One warm-up prefill, then 3 repeats of 4 prefills, each repeat printed.
"""

from __future__ import annotations

import argparse

import torch

from attwarp_tpu_torch.models.qwen2vl import mrope_cos_sin, qwen2vl_prefill
from attwarp_tpu_torch.tools.bench_prefill import EXTRACT_LAYER, ITERS, check_mode, timed_prefill
from attwarp_tpu_torch.tools.bench_utils import (
    make_qwen2vl_7b_backend,
    tree_bytes,
    tree_numel,
)
from attwarp_tpu_torch.utils.device import require_device


def run(text_params, cfg, use_flash: bool, B: int = 8, T: int = 640, repeats: int = 3,
        iters: int = ITERS, device="cuda", seed: int = 0,
        extract_layer: int = EXTRACT_LAYER) -> dict:
    """``qwen2vl_prefill`` of B x T random bf16 embeddings (normal x 0.1 from
    ``seed``) at text positions 0..T-1 on all three M-RoPE streams,
    extracting ``extract_layer``'s row; see
    ``bench_prefill.timed_prefill``. Returns its figures, the embeddings
    and the rotary tables."""
    device = torch.device(device)
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = text_params["embed_tokens"].dtype
    emb = torch.randn((B, T, cfg.hidden_size), generator=g, device=device, dtype=dtype) * 0.1
    mask = torch.ones((B, T), dtype=torch.bool, device=device)
    pos = torch.arange(T, device=device)[None, None, :].expand(3, B, T)
    cos, sin = mrope_cos_sin(pos, cfg)

    def prefill():
        logits, _kv, row = qwen2vl_prefill(text_params, cfg, emb, mask, cos, sin, max_seq=T,
                                           extract_layer=extract_layer, use_flash=use_flash)
        return logits, row

    out = timed_prefill(prefill, 2 * tree_numel(text_params) * B * T, B, T, device,
                        "qwen flash" if use_flash else "qwen dense", repeats, iters)
    return {**out, "embeds": emb, "mask": mask, "cos": cos, "sin": sin}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_qwen_prefill (PyTorch)")
    p.add_argument("mode", nargs="?", default="dense")
    p.add_argument("batch", nargs="?", type=int, default=8)
    p.add_argument("seqlen", nargs="?", type=int, default=640)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "bench_qwen_prefill")
    use_flash = check_mode(args.mode)
    backend, _ = make_qwen2vl_7b_backend("bf16", device=device)
    text = backend.model.params["text"]
    print(f"text params: {tree_bytes(text) / 2**30:.2f} GiB bf16; B={args.batch} "
          f"T={args.seqlen} mode={args.mode}")
    run(text, backend.model.cfg.text, use_flash, args.batch, args.seqlen, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
