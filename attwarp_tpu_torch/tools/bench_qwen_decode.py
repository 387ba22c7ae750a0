"""Qwen2-VL-7B decode-step throughput (counterpart of
``tools/bench_qwen_decode.py``): the chain of ``tools/bench_decode.py`` at
the Qwen2-VL-7B text geometry (28 layers, 3584 wide, GQA 28 query over 4
kv heads), the decode position on all three M-RoPE streams.

    python -m attwarp_tpu_torch.tools.bench_qwen_decode [bf16|int8[+kv8][+lm8]] [batch] [steps] [--device cuda]

Defaults int8+kv8, B=16, 16 steps. One warm-up chain, then 3 timed chains,
each printed.
"""

from __future__ import annotations

import argparse

import torch

from attwarp_tpu_torch.models.qwen2vl import mrope_cos_sin, qwen2vl_decode_step
from attwarp_tpu_torch.tools.bench_decode import T_CTX, decode_cache, split_lm8, timed_chain
from attwarp_tpu_torch.tools.bench_utils import make_qwen2vl_7b_backend
from attwarp_tpu_torch.utils.device import require_device


def run(text_params, cfg, kv8: bool, B: int = 16, steps: int = 16, repeats: int = 3,
        device="cuda", seed: int = 0, label: str = "") -> dict:
    """Chained ``qwen2vl_decode_step``s over ``text_params`` from a random
    bf16 embedding (normal x 0.1, from ``seed``); see
    ``bench_decode.timed_chain``. Returns its figures and the first
    embedding."""
    device = torch.device(device)
    dtype = text_params["embed_tokens"].dtype
    kv, kv_mask = decode_cache(cfg, B, steps, kv8, dtype, device)
    cos1, sin1 = mrope_cos_sin(torch.full((3, B, 1), T_CTX, device=device), cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    emb0 = torch.randn((B, 1, cfg.hidden_size), generator=g, device=device, dtype=dtype) * 0.1

    def step(emb):
        return qwen2vl_decode_step(text_params, cfg, emb, kv, T_CTX, cos1, sin1, kv_mask)[0]

    return {**timed_chain(step, text_params, emb0, steps, repeats, device, "qwen " + label),
            "emb0": emb0}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_qwen_decode (PyTorch)")
    p.add_argument("mode", nargs="?", default="int8+kv8")
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("steps", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "bench_qwen_decode")
    mode, lm8 = split_lm8(args.mode)
    backend, label = make_qwen2vl_7b_backend(mode, device=device)
    if lm8:
        backend.quantize_lm_head()
        label += "+lm8"
    run(backend.model.params["text"], backend.model.cfg.text, backend.kv_quant, args.batch,
        args.steps, device=device, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
