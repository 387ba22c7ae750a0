"""Decode-step throughput at LLaVA-1.5-7B shape: bf16 against int8 (w8a8)
weights, optionally with an int8 KV cache (``+kv8``, kernel K3) and an int8
LM head (``+lm8``) (counterpart of ``tools/bench_decode.py``).

A chain of ``llama_decode_step``s after a 640-token context, each step's
argmax feeding the next step's embedding: the one data dependency the work
itself has. Prints ms per step, tok/s and the cache's GiB.

    python -m attwarp_tpu_torch.tools.bench_decode [bf16|int8[+kv8][+lm8]] [batch] [steps] [--device cuda]

One warm-up chain, then 3 timed chains (default 16 steps), each printed.
As the JAX tool, every step writes the cache position after the context
(the cache holds zeros, the mask allows context + 1 positions), so every
chain does the same work.
"""

from __future__ import annotations

import argparse

import torch

from attwarp_tpu_torch.models.llama import (
    embed,
    init_kv_cache,
    init_quant_kv_cache,
    llama_decode_step,
)
from attwarp_tpu_torch.tools.bench_utils import (
    card,
    make_llava_7b_backend,
    repeat,
    report,
    tree_bytes,
)
from attwarp_tpu_torch.utils.device import require_device

T_CTX = 640


def split_lm8(mode: str):
    """'int8+kv8+lm8' -> ('int8+kv8', lm8)."""
    return mode.replace("+lm8", ""), "+lm8" in mode


def decode_cache(cfg, B: int, steps: int, kv8: bool, dtype, device):
    """The chain's cache: context + steps positions (int8: rounded up to a
    multiple of 64, as generate and the engines allocate), zeros; the mask
    allows the context and the new position."""
    max_seq = T_CTX + steps
    if kv8:
        max_seq = -(-max_seq // 64) * 64
        kv = init_quant_kv_cache(cfg, B, max_seq, device)
    else:
        kv = init_kv_cache(cfg, B, max_seq, dtype, device)
    print(f"kv cache: {tree_bytes(list(kv)) / 2**30:.2f} GiB "
          f"({'int8' if kv8 else 'bf16'}, B={B})")
    kv_mask = (torch.arange(max_seq, device=device) < T_CTX + 1)[None].expand(B, max_seq)
    return kv, kv_mask.contiguous()


def timed_chain(step, text_params, emb0, steps: int, repeats: int, device,
                label: str) -> dict:
    """One warm-up chain of ``steps`` x ``step(emb) -> logits``, each argmax
    embedded as the next input, then ``repeats`` timed chains. Returns ms a
    step, tok/s, the figures and the last chain's tokens (B, steps)."""
    B = emb0.shape[0]

    def chain():
        emb, toks = emb0, []
        for _ in range(steps):
            nxt = torch.argmax(step(emb), dim=-1)
            toks.append(nxt)
            emb = embed(text_params, nxt)[:, None, :]
        return torch.stack(toks, dim=1)

    chain()
    timing, tokens = repeat(chain, repeats, device)
    report(f"{label} decode B={B}, chains of {steps} steps (ms a step)", timing, device,
           per=steps)
    per = timing["min"] / steps
    print(f"{label}: {timing['min'] * 1e3:.1f} ms for {steps} steps -> {per * 1e3:.2f} "
          f"ms/step ({B / per:.1f} tok/s at B={B}) | {card(device)}")
    return {"ms_per_step": per * 1e3, "tok_s": B / per, "timing": timing, "tokens": tokens}


def run(text_params, cfg, kv8: bool, B: int = 1, steps: int = 16, repeats: int = 3,
        device="cuda", seed: int = 0, label: str = "") -> dict:
    """Chained ``llama_decode_step``s over ``text_params`` from a random
    bf16 embedding (normal, from ``seed``); see ``timed_chain``. Returns its
    figures and the first embedding."""
    device = torch.device(device)
    dtype = text_params["embed_tokens"].dtype
    kv, kv_mask = decode_cache(cfg, B, steps, kv8, dtype, device)
    positions = torch.full((B,), T_CTX, dtype=torch.int64, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    emb0 = torch.randn((B, 1, cfg.hidden_size), generator=g, device=device, dtype=dtype)

    def step(emb):
        return llama_decode_step(text_params, cfg, emb, kv, T_CTX, positions, kv_mask)[0]

    return {**timed_chain(step, text_params, emb0, steps, repeats, device, label),
            "emb0": emb0}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_decode (PyTorch)")
    p.add_argument("mode", nargs="?", default="bf16")
    p.add_argument("batch", nargs="?", type=int, default=1)
    p.add_argument("steps", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "bench_decode")
    mode, lm8 = split_lm8(args.mode)
    backend, label = make_llava_7b_backend(mode, device=device)
    if lm8:
        backend.quantize_lm_head()
        label += "+lm8"
    run(backend.model.params["llama"], backend.model.cfg.text, backend.kv_quant, args.batch,
        args.steps, device=device, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
