"""Kernel K3's plain version (``decode_attn_plain``) and ``quantize_kv``
against the JAX package.

The port writes the current token into the cache first and reads the
updated plane; the TPU kernel reads the step-entry cache and merges the
token itself. So the comparisons are: port(updated cache, mask with the
token) == JAX(``_attn_quantcache`` on the updated plane) and == JAX(Pallas
kernel on the stale cache plus the token). The CUDA kernel is compared with
the plain version on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attwarp_tpu.models.llama import LlamaConfig as JLlamaConfig
from attwarp_tpu.models.llama import _attn_quantcache as j_attn_quantcache
from attwarp_tpu.numerics.quant import quantize_kv as j_quantize_kv
from attwarp_tpu.ops.pallas_decode_attn import (
    decode_attn_quantcache,
    prepare_decode_attn_operands,
)

from attwarp_tpu_torch.kernels.decode_attn import decode_attn_int8, decode_attn_plain
from attwarp_tpu_torch.models.llama import LlamaConfig, _attn_quantcache
from attwarp_tpu_torch.numerics.quant import dequantize_kv, quantize_kv


def _case(L, B, S, H, kvH, hd, seed=0):
    """Stale int8 cache, the current token's quantized K/V at ``cur``, a
    left-padded history [pad, cur) and the mask with and without the token."""
    rng = np.random.default_rng(seed)
    c = dict(
        k_q=rng.integers(-127, 128, (L, B, S, kvH, hd)).astype(np.int8),
        v_q=rng.integers(-127, 128, (L, B, S, kvH, hd)).astype(np.int8),
        k_s=(rng.uniform(0.5, 1.5, (L, B, S, kvH)) / 127).astype(np.float32),
        v_s=(rng.uniform(0.5, 1.5, (L, B, S, kvH)) / 127).astype(np.float32),
        k1_q=rng.integers(-127, 128, (B, 1, kvH, hd)).astype(np.int8),
        v1_q=rng.integers(-127, 128, (B, 1, kvH, hd)).astype(np.int8),
        k1_s=(rng.uniform(0.5, 1.5, (B, 1, kvH)) / 127).astype(np.float32),
        v1_s=(rng.uniform(0.5, 1.5, (B, 1, kvH)) / 127).astype(np.float32),
        q=rng.standard_normal((B, 1, H, hd)).astype(np.float32),
    )
    cur = np.array([S - 3 - 7 * (b % 2) for b in range(B)])
    pad = np.array([5 * (1 - b % 2) for b in range(B)])
    ar = np.arange(S)[None, :]
    c["strict"] = (ar >= pad[:, None]) & (ar < cur[:, None])
    c["full"] = c["strict"] | (ar == cur[:, None])
    c["cur"] = cur
    return c


def _updated(c):
    """The cache with the token written at ``cur`` (every layer)."""
    out = {k: c[k].copy() for k in ("k_q", "k_s", "v_q", "v_s")}
    bi = np.arange(c["q"].shape[0])
    for name, new in (("k_q", "k1_q"), ("k_s", "k1_s"), ("v_q", "v1_q"),
                      ("v_s", "v1_s")):
        out[name][:, bi, c["cur"]] = c[new][:, 0]
    return out


def test_quantize_kv_bit_equal(rng):
    """Both round half to even, on the same f32 division: bit-equal."""
    x = (rng.standard_normal((3, 7, 4, 128)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0                                # all-zero row: the 1e-8 floor
    x[1, 2, 1, :4] = [0.5, -0.5, 1.5, 2.5]          # exact ties after scaling
    jq, js = j_quantize_kv(jnp.asarray(x))
    tq, ts = quantize_kv(torch.as_tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(dequantize_kv(tq, ts, torch.float32).numpy(), x,
                               atol=float(np.abs(x).max()) / 127)


@pytest.mark.parametrize("H,kvH", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_plain_matches_attn_quantcache(H, kvH):
    """f32 q: the plain K3 == JAX ``_attn_quantcache`` on the updated plane
    (same algorithm; 1e-5 covers the f32 summation order), and == the
    port's own ``_attn_quantcache``."""
    L, B, S, hd, layer = 2, 2, 64, 32, 1
    c = _case(L, B, S, H, kvH, hd, seed=1)
    u = _updated(c)
    jcfg = JLlamaConfig(vocab_size=8, hidden_size=H * hd, intermediate_size=8,
                        num_hidden_layers=L, num_attention_heads=H,
                        num_key_value_heads=kvH)
    ref, _ = j_attn_quantcache(
        jnp.asarray(c["q"]), *(jnp.asarray(u[k][layer]) for k in ("k_q", "k_s", "v_q", "v_s")),
        jnp.asarray(c["full"])[:, None, :], jcfg, want_probs=False)
    T = {k: torch.as_tensor(v) for k, v in u.items()}
    q = torch.as_tensor(c["q"])
    mask = torch.as_tensor(c["full"])
    got = decode_attn_plain(q[:, 0], T["k_q"], T["k_s"], T["v_q"], T["v_s"],
                            mask, layer, 1.0 / np.sqrt(hd))
    np.testing.assert_allclose(got.reshape(B, -1).numpy(),
                               np.asarray(ref).reshape(B, -1), atol=1e-5)
    tcfg = LlamaConfig(vocab_size=8, hidden_size=H * hd, intermediate_size=8,
                       num_hidden_layers=L, num_attention_heads=H,
                       num_key_value_heads=kvH)
    mine, _ = _attn_quantcache(q, T["k_q"][layer], T["k_s"][layer], T["v_q"][layer],
                               T["v_s"][layer], mask[:, None, :], tcfg, False)
    np.testing.assert_allclose(got.reshape(B, -1).numpy(),
                               mine.reshape(B, -1).numpy(), atol=1e-6)


@pytest.mark.parametrize("H,kvH", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_plain_matches_pallas_kernel_interpret(H, kvH):
    """bf16 q at head_dim 128 against the TPU kernel in interpret mode, as
    ``tests/test_pallas_decode_attn.py`` runs it (one jitted dispatch,
    blocked). Both round the q.k and p.v products to bf16 at different
    points, hence 2e-2 absolute (outputs are O(1)) and cos > 0.9999."""
    L, B, S, hd, layer = 2, 2, 128, 128, 1
    c = _case(L, B, S, H, kvH, hd, seed=2)
    qb = jnp.asarray(c["q"], jnp.bfloat16)

    def run(q, k_q, k_s, v_q, v_s, k1_q, k1_s, v1_q, v1_s, strict):
        ksx, vsx, bias = prepare_decode_attn_operands(k_s, v_s, strict)
        return decode_attn_quantcache(
            q, k_q, ksx, v_q, vsx, bias, k1_q, k1_s, v1_q, v1_s,
            num_heads=H, sm_scale=1.0 / np.sqrt(hd), layer=layer)

    args = [qb] + [jnp.asarray(c[k]) for k in (
        "k_q", "k_s", "v_q", "v_s", "k1_q", "k1_s", "v1_q", "v1_s", "strict")]
    with pltpu.force_tpu_interpret_mode():
        ref = jax.block_until_ready(jax.jit(run)(*args))
    ref = np.asarray(ref, np.float32).reshape(B, H, hd)

    u = _updated(c)
    T = {k: torch.as_tensor(v) for k, v in u.items()}
    q = torch.as_tensor(c["q"]).to(torch.bfloat16)[:, 0]
    got = decode_attn_plain(q, T["k_q"], T["k_s"], T["v_q"], T["v_s"],
                            torch.as_tensor(c["full"]), layer,
                            1.0 / np.sqrt(hd)).to(torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2)
    cos = np.sum(got * ref) / (np.linalg.norm(got) * np.linalg.norm(ref))
    assert cos > 0.9999


def test_wrapper_on_cpu_runs_plain():
    """A CPU tensor takes the plain version and launches nothing."""
    c = _case(1, 2, 32, 2, 2, 128, seed=3)
    T = {k: torch.as_tensor(v) for k, v in _updated(c).items()}
    q = torch.as_tensor(c["q"])[:, 0]
    mask = torch.as_tensor(c["full"])
    before = decode_attn_int8.launches
    got = decode_attn_int8(q, T["k_q"], T["k_s"], T["v_q"], T["v_s"], mask, 0, 0.1)
    assert decode_attn_int8.launches == before
    torch.testing.assert_close(
        got, decode_attn_plain(q, T["k_q"], T["k_s"], T["v_q"], T["v_s"], mask, 0, 0.1),
        rtol=0, atol=0)


def test_plain_serving_masks():
    """Serving-slot masks: a row's own [start, cur] window equals that row
    alone (its neighbours' windows do not leak in), and a row with no valid
    position returns zeros, as the CUDA kernel does."""
    c = _case(2, 3, 48, 4, 2, 16, seed=4)
    T = {k: torch.as_tensor(v) for k, v in _updated(c).items()}
    q = torch.as_tensor(c["q"])[:, 0]
    mask = torch.zeros((3, 48), dtype=torch.bool)
    mask[0, 7:30] = True
    mask[1, 0] = True                      # a retired slot: position 0 only
    got = decode_attn_plain(q, T["k_q"], T["k_s"], T["v_q"], T["v_s"], mask, 1, 0.25)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    for b in (0, 1):
        one = decode_attn_plain(q[b:b + 1], *(T[k][:, b:b + 1] for k in ("k_q", "k_s", "v_q", "v_s")),
                                mask[b:b + 1], 1, 0.25)
        torch.testing.assert_close(got[b:b + 1], one, rtol=1e-6, atol=1e-6)
    # position 0 alone: the output is that token's dequantized value
    v0 = T["v_q"][1, 1, 0].float() * T["v_s"][1, 1, 0][:, None]
    torch.testing.assert_close(got[1].reshape(2, 2, 16), v0[:, None].expand(2, 2, 16),
                               rtol=1e-6, atol=1e-6)
