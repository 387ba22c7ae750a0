"""Per-term profile of one ``int8+kv8`` decode step (counterpart of
``tools/profile_decode_terms.py``).

The decode benches time the whole step (``tools/bench_decode.py``,
``tools/bench_qwen_decode.py``); this tool times its parts as chains of
``steps`` on w8a8 weights and an int8 cache after a 640-token context:

  full          the real step (the bench tools' chain)
  full_lm8      the real step with the int8 LM head
  kernel        L chained K3 calls (each layer's output is the next one's
                query) and each layer's append of the new K/V
  linears_only  the L layers with the attention replaced by identity:
                the weight stream, activation quantization, norms and the
                new token's K/V quantization
  lm_head_dense, lm_head_int8
                final norm + logits + argmax + next-token embedding

JAX's per-step operand preparation (``prepare_decode_attn_operands``,
``make_decode_prep``) and its relay constant are not ported, so they have
no term. Each term: one warm-up chain, then the best of 3 on the host
clock with the device synchronized, in ms a step, beside the card's least
time to stream the bytes of the cache, the decoder's weights and the head
(``kernels/roofline.py``).

    python -m attwarp_tpu_torch.tools.profile_decode_terms [--family qwen|llava] [--batch 0] [--steps 16] [--out FILE] [--device cuda]

``--batch 0`` is 64 for Qwen2-VL-7B, 32 for LLaVA-1.5-7B.
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8
from attwarp_tpu_torch.kernels.roofline import HBM_BYTES_PER_S
from attwarp_tpu_torch.models.llama import (
    append_token,
    embed,
    final_logits,
    init_quant_kv_cache,
    llama_decode_step,
    rms_norm,
)
from attwarp_tpu_torch.models.qwen2vl import mrope_cos_sin, qwen2vl_decode_step
from attwarp_tpu_torch.numerics.quant import apply_linear, quantize_kv, quantize_lm_head
from attwarp_tpu_torch.tools.bench_decode import T_CTX
from attwarp_tpu_torch.tools.bench_utils import (
    card,
    make_llava_7b_backend,
    make_qwen2vl_7b_backend,
    repeat,
    report,
    tree_bytes,
)
from attwarp_tpu_torch.utils.device import require_device


def run(text_params, cfg, qwen: bool, B: int, steps: int = 16, repeats: int = 3,
        device="cuda", seed: int = 0) -> dict:
    """Every term over ``text_params`` (int8 decoder linears; the LM head
    is quantized in place before the ``*_lm8``/``*_int8`` terms). Returns
    ms a step of each term and the HBM floors."""
    device = torch.device(device)
    L, H, kvH, hd = (cfg.num_hidden_layers, cfg.num_attention_heads, cfg.kv_heads,
                     cfg.head_dim)
    max_seq = -(-(T_CTX + steps) // 64) * 64
    kv = init_quant_kv_cache(cfg, B, max_seq, device)
    kv_mask = (torch.arange(max_seq, device=device) < T_CTX + 1)[None].expand(B, max_seq)
    kv_mask = kv_mask.contiguous()
    g = torch.Generator(device=device).manual_seed(seed)
    dtype = text_params["embed_tokens"].dtype
    emb0 = torch.randn((B, 1, cfg.hidden_size), generator=g, device=device, dtype=dtype) * 0.1
    q0 = torch.randn((B, H, hd), generator=g, device=device, dtype=torch.bfloat16)
    new_k = torch.randn((B, kvH, hd), generator=g, device=device, dtype=dtype)
    if qwen:
        cos1, sin1 = mrope_cos_sin(torch.full((3, B, 1), T_CTX, device=device), cfg)

        def step(emb):
            return qwen2vl_decode_step(text_params, cfg, emb, kv, T_CTX, cos1, sin1,
                                       kv_mask)[0]
    else:
        positions = torch.full((B,), T_CTX, dtype=torch.int64, device=device)

        def step(emb):
            return llama_decode_step(text_params, cfg, emb, kv, T_CTX, positions, kv_mask)[0]

    def full():
        emb = emb0
        for _ in range(steps):
            emb = embed(text_params, torch.argmax(step(emb), dim=-1))[:, None, :]
        return emb

    def kernel():
        q = q0
        for _ in range(steps):
            for i in range(L):
                append_token(kv, i, (slice(None), T_CTX), new_k, new_k)
                q = decode_attn_int8(q, kv.k_q, kv.k_s, kv.v_q, kv.v_s, kv_mask, layer=i,
                                     sm_scale=1.0 / math.sqrt(hd)).reshape(B, H, hd)
        return q

    def linears_only():
        x = emb0
        for _ in range(steps):
            for lp in text_params["layers"]:
                h = rms_norm(x, lp["input_layernorm"], cfg.rms_norm_eps)
                qv = apply_linear(h, lp["q_proj"])
                quantize_kv(apply_linear(h, lp["k_proj"]).reshape(B, 1, kvH, hd))
                quantize_kv(apply_linear(h, lp["v_proj"]).reshape(B, 1, kvH, hd))
                x = x + apply_linear(qv, lp["o_proj"])        # identity attention
                h2 = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
                x = x + apply_linear(F.silu(apply_linear(h2, lp["gate_proj"]))
                                     * apply_linear(h2, lp["up_proj"]), lp["down_proj"])
            x = x * 0.5
        return x

    def lm_head():
        x = emb0
        for _ in range(steps):
            nxt = torch.argmax(final_logits(text_params, cfg, x[:, 0]), dim=-1)
            x = embed(text_params, nxt)[:, None, :]
        return x

    ms = {}

    def term(name, fn):
        fn()
        timing, _ = repeat(fn, repeats, device)
        report(f"decode term {name}, B={B}, chains of {steps} (ms a step)", timing, device,
               per=steps)
        ms[name] = timing["min"] / steps * 1e3

    for name, fn in (("full", full), ("kernel", kernel), ("linears_only", linears_only),
                     ("lm_head_dense", lm_head)):
        term(name, fn)
    head_bytes = tree_bytes(text_params["lm_head"])
    quantize_lm_head(text_params)
    term("full_lm8", full)
    term("lm_head_int8", lm_head)

    dec_bytes = tree_bytes(text_params["layers"])
    floors = {"cache_read_ms": tree_bytes(list(kv)) / HBM_BYTES_PER_S * 1e3,
              "decoder_weights_ms": dec_bytes / HBM_BYTES_PER_S * 1e3,
              "lm_head_ms": head_bytes / HBM_BYTES_PER_S * 1e3}
    attributed = ms["kernel"] + ms["linears_only"] + ms["lm_head_dense"]
    return {"batch": B, "steps": steps, "ctx": T_CTX, "max_seq": max_seq, "ms_per_step": ms,
            "hbm_floors_ms": floors, "attributed_ms": attributed,
            "residual_ms_full_minus_attributed": ms["full"] - attributed,
            "lm8_full_step_saving_ms": ms["full"] - ms["full_lm8"], "card": card(device)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("profile_decode_terms (PyTorch)")
    ap.add_argument("--family", choices=("qwen", "llava"), default="qwen")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = require_device(args.device, "profile_decode_terms")
    qwen = args.family == "qwen"
    make = make_qwen2vl_7b_backend if qwen else make_llava_7b_backend
    backend, _ = make("int8+kv8", device=device)
    text = backend.model.text_params
    B = args.batch or (64 if qwen else 32)
    res = {"family": args.family, **run(text, backend.model.cfg.text, qwen, B, args.steps,
                                        device=device)}
    print(json.dumps(res, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
