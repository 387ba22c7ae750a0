"""Kernel K5's CPU route (``kernels/rope_append.py::rope_append_int8`` on
CPU tensors, which runs ``rope_append_int8_plain``: the decode step's
``models/llama.py::apply_rope`` then ``append_token``) against the rotary
and a row-by-row cache write: the step's projections reach the rotary in
their heads, and each row's new token lands at its own position and
nowhere else. This file imports no JAX."""

import pytest
import torch

from attwarp_tpu_torch.kernels.rope_append import rope_append_int8
from attwarp_tpu_torch.models import qwen2vl
from attwarp_tpu_torch.models.llama import (
    LlamaConfig,
    QuantKVCache,
    apply_rope,
    init_quant_kv_cache,
    rope_cos_sin,
)
from attwarp_tpu_torch.numerics.quant import quantize_kv

LLAMA = LlamaConfig(vocab_size=16, hidden_size=512, intermediate_size=8, num_hidden_layers=3,
                    num_attention_heads=4)
QWEN = qwen2vl.Qwen2VLTextConfig(vocab_size=16, hidden_size=512, intermediate_size=8,
                                 num_hidden_layers=3, num_attention_heads=4,
                                 num_key_value_heads=2, mrope_section=(16, 24, 24))

# (name, family, dtype, per-row positions)
CASES = [
    ("llama-mha-bf16-int-pos", "llama", torch.bfloat16, False),
    ("llama-mha-bf16-per-row", "llama", torch.bfloat16, True),
    ("llama-mha-f32-int-pos", "llama", torch.float32, False),
    ("qwen-gqa-mrope-bf16-int-pos", "qwen", torch.bfloat16, False),
    ("qwen-gqa-mrope-bf16-per-row", "qwen", torch.bfloat16, True),
    ("qwen-gqa-mrope-f32-per-row", "qwen", torch.float32, True),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_apply_rope_then_append_token(case):
    """The rotated q and every cache tensor bit for bit, over a cache full
    of earlier tokens: only (layer, row, position) changes. Row 0 is
    left-padded (its rotary position lies 5 below its cache position)."""
    _, family, dtype, per_row = case
    cfg = LLAMA if family == "llama" else QWEN
    B, S, layer, hd = 3, 16, 1, cfg.head_dim
    H, kvH = cfg.num_attention_heads, cfg.kv_heads
    g = torch.Generator().manual_seed(11)
    kv = init_quant_kv_cache(cfg, B, S, "cpu")
    for t in (kv.k_q, kv.v_q):
        t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
    for t in (kv.k_s, kv.v_s):
        t.copy_(torch.rand(t.shape, generator=g) * 0.02)
    before = QuantKVCache(*(t.clone() for t in kv))
    pos = torch.tensor([9, 12, 7]) if per_row else 9
    cache_pos = pos if per_row else torch.full((B,), pos)
    rope_pos = cache_pos - torch.tensor([5, 0, 0])
    if family == "llama":
        cos, sin = rope_cos_sin(rope_pos[:, None], hd, cfg.rope_theta)
    else:
        cos, sin = qwen2vl.mrope_cos_sin(
            torch.stack([rope_pos, rope_pos // 2, rope_pos + 3])[:, :, None], cfg)
    # a spread of magnitudes, so that products and sums round at every step
    q = (torch.randn((B, 1, H * hd), generator=g) * 3.0).to(dtype)
    k = (torch.randn((B, 1, kvH * hd), generator=g) * 3.0).to(dtype)
    v = (torch.randn((B, 1, kvH * hd), generator=g) * 0.3).to(dtype)
    k[1, 0, :hd] = 0   # a head of zeros: the scale's 1e-8 floor

    want_kv = QuantKVCache(*(t.clone() for t in kv))
    want_q, want_k = apply_rope(q.reshape(B, 1, H, hd), k.reshape(B, 1, kvH, hd), cos, sin)
    for b in range(B):
        p = int(cache_pos[b])
        want_kv.k_q[layer, b, p], want_kv.k_s[layer, b, p] = quantize_kv(want_k[b, 0])
        want_kv.v_q[layer, b, p], want_kv.v_s[layer, b, p] = quantize_kv(
            v[b, 0].reshape(kvH, hd))

    got_q = rope_append_int8(q, k, v, cos, sin, kv, layer, pos)
    assert got_q.dtype == dtype and got_q.shape == (B, 1, H, hd)
    assert torch.equal(got_q, want_q)
    for got, want in zip(kv, want_kv):
        assert torch.equal(got, want)
    # only the new token's slots changed
    written = torch.zeros((kv.k_s.shape[:3]), dtype=torch.bool)
    written[layer, torch.arange(B), cache_pos] = True
    for got, old in zip(kv, before):
        changed = got != old
        while changed.ndim > 3:
            changed = changed.any(-1)
        assert not (changed & ~written).any()
    assert (kv.k_q[layer, 1, cache_pos[1], 0] == 0).all()
    assert kv.k_s[layer, 1, cache_pos[1], 0].item() == torch.tensor(1e-8) / 127.0
