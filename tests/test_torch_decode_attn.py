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

from attwarp_tpu_torch.kernels.decode_attn import (
    BLOCKS_PER_SM,
    MAX_LEN,
    decode_attn_int8,
    decode_attn_plain,
    decode_attn_split_plain,
    decode_split_plan,
)
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


# (H, kvH, S, n_split, chunk, windows): each row's [start, cur] window, or
# None for a row with no valid position (a free slot)
SPLIT_CASES = {
    "mha": (4, 4, 64, 4, 16, [(5, 60), (0, 63)]),
    "gqa": (8, 2, 64, 4, 16, [(5, 60), (0, 63)]),
    "single_split": (8, 2, 48, 1, 48, [(3, 40), (0, 47)]),
    "ragged_last_chunk": (8, 2, 70, 5, 16, [(2, 69), (0, 65)]),
    "split_masked_by_padding": (4, 2, 64, 4, 16, [(37, 63), (20, 50)]),
    "free_slot_row": (4, 2, 64, 4, 16, [(9, 55), None]),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_merge_plain_matches(case):
    """The CUDA kernel's split-and-merge arithmetic (``decode_attn_split_plain``)
    == ``decode_attn_plain`` and == JAX ``_attn_quantcache`` in f32, to
    1e-5 (only the summation order differs). A row with no valid position
    returns zeros in both port forms (JAX's softmax over an all-masked row
    is left out of that comparison)."""
    H, kvH, S, n_split, chunk, windows = SPLIT_CASES[case]
    L, B, hd, layer = 2, len(windows), 32, 1
    assert -(-S // chunk) == n_split
    c = _case(L, B, S, H, kvH, hd, seed=7)
    T = {k: torch.as_tensor(c[k]) for k in ("k_q", "k_s", "v_q", "v_s")}
    mask = torch.zeros((B, S), dtype=torch.bool)
    for b, w in enumerate(windows):
        if w is not None:
            mask[b, w[0]:w[1] + 1] = True
    q = torch.as_tensor(c["q"])[:, 0]
    sm = 1.0 / np.sqrt(hd)
    got = decode_attn_split_plain(q, *T.values(), mask, layer, sm, n_split, chunk)
    ref = decode_attn_plain(q, *T.values(), mask, layer, sm)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    jcfg = JLlamaConfig(vocab_size=8, hidden_size=H * hd, intermediate_size=8,
                        num_hidden_layers=L, num_attention_heads=H,
                        num_key_value_heads=kvH)
    jref, _ = j_attn_quantcache(
        jnp.asarray(c["q"]), *(jnp.asarray(c[k][layer]) for k in ("k_q", "k_s", "v_q", "v_s")),
        jnp.asarray(mask.numpy())[:, None, :], jcfg, want_probs=False)
    jref = np.asarray(jref).reshape(B, H, hd)
    for b, w in enumerate(windows):
        if w is None:
            assert not got[b].any()
        else:
            np.testing.assert_allclose(got[b].numpy(), jref[b], atol=1e-5)


@pytest.mark.parametrize("B,kvH,S", [(4, 32, 704), (4, 4, 704), (16, 32, 768), (8, 4, 768),
                                     (1, 4, 16), (3, 4, 200), (1, 32, 1000), (1, 1, 4100),
                                     (2, 4, 40000)])
def test_split_plan_covers_and_fills(B, kvH, S):
    """Every position in exactly one split, no split empty or longer than
    ``MAX_LEN`` (so any S has a plan), and at the four timed shapes (the
    first four) on the H100's 132 SMs the grid the plan aims for: about
    ``BLOCKS_PER_SM`` blocks per SM (chunks round up to 16 positions), the
    LLaVA serving pool's plane streamed in splits of ``STREAM_LEN``."""
    n_split, chunk = decode_split_plan(B, kvH, S, 132)
    owner = np.zeros(S, int)
    for s in range(n_split):
        lo, hi = s * chunk, min(S, (s + 1) * chunk)
        assert hi > lo
        owner[lo:hi] += 1
    assert (owner == 1).all()
    assert 0 < chunk <= MAX_LEN and chunk % 16 == 0
    blocks = {(4, 32, 704): (3, 384), (4, 4, 704): (15, 240), (16, 32, 768): (6, 3072),
              (8, 4, 768): (8, 256)}
    if (B, kvH, S) in blocks:
        assert (n_split, n_split * kvH * B) == blocks[(B, kvH, S)]
        assert n_split * kvH * B >= 0.8 * BLOCKS_PER_SM * 132
