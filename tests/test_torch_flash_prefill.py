"""Kernel K2's plain version and the port's flash prefill against the JAX
package.

JAX's K2 (``models/llama.py::_flash_attn``, Pallas TPU ``flash_attention``)
runs on the CPU in interpret mode, as ``tests/test_flash_prefill.py`` runs
it: one ``jax.jit`` dispatch, blocked inside ``force_tpu_interpret_mode``
before anything else dispatches (the interpreter's callbacks can deadlock
against a concurrent eager dispatch). The interpreter computes in f32, like
the port's plain version on the CPU, so the point is the algorithm: 1e-5
absolute on attention outputs and probabilities, 1e-4 relative on logits.
head_dim is 128 and T = 256 wherever flash has to engage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as graft
from attwarp_tpu.models import ClipVisionConfig as JClip
from attwarp_tpu.models import LlamaConfig as JLlama
from attwarp_tpu.models import LlavaConfig as JLlava
from attwarp_tpu.models import LlavaModel as JLlavaModel
from attwarp_tpu.models import llama as jllama

from attwarp_tpu_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain
from attwarp_tpu_torch.models import llama as tllama
from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, params_from_jax

from test_flash_prefill import _llama_params

TEXT = {
    "mha": dict(vocab_size=128, hidden_size=256, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2),
    "gqa": dict(vocab_size=128, hidden_size=512, intermediate_size=512,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
}


def _interpret(fn, *args):
    """One jitted dispatch of ``fn`` in interpret mode, blocked inside."""
    with pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)(*args))


def _padded_mask(B, T, pad=7):
    mask = np.ones((B, T), bool)
    mask[0, :pad] = False    # left padding on one row
    return mask


@pytest.mark.parametrize("geom", ["mha", "gqa"])
def test_plain_matches_jax_flash_attn(geom):
    """Every row, padded rows included (both attend their own segment)."""
    cfg = JLlama(**TEXT[geom])
    B, T, hd = 2, 256, cfg.head_dim
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, T, cfg.num_attention_heads, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, cfg.kv_heads, hd)).astype(np.float32)
            for _ in range(2))
    mask = _padded_mask(B, T)
    ref = np.asarray(_interpret(
        lambda a, b, c, m: jllama._flash_attn(a, b, c, m, cfg),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))
    got = flash_prefill_plain(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                              torch.as_tensor(mask), 1.0 / np.sqrt(hd))
    assert got.shape == (B, T, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_flash_gate_matches_jax():
    """Both packages pick dense or flash at the same T."""
    for T in range(1, 2049):
        assert tllama.flash_prefill_supported(T) == jllama.flash_prefill_supported(T), T
        assert tllama._flash_kv_block(T) == jllama._flash_kv_block(T), T


def test_wrapper_on_cpu_runs_plain():
    """A CPU tensor takes the plain version and launches nothing; the plain
    version equals the dense ``_attn`` on every row when nothing is padded
    (the segment mask is then the causal mask)."""
    cfg = tllama.LlamaConfig(**TEXT["gqa"])
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 40, 4, 128), generator=g)
    k, v = (torch.randn((2, 40, 2, 128), generator=g) for _ in range(2))
    mask = torch.ones((2, 40), dtype=torch.bool)
    before = flash_prefill.launches
    out = flash_prefill(q, k, v, mask, 1.0 / np.sqrt(128))
    assert flash_prefill.launches == before
    causal = torch.tril(torch.ones((40, 40), dtype=torch.bool))[None].expand(2, 40, 40)
    dense, _ = tllama._attn(q, k, v, causal, cfg, want_probs=False)
    torch.testing.assert_close(out, dense, rtol=0, atol=1e-6)


@pytest.mark.parametrize("geom", ["mha", "gqa"])
def test_llama_prefill_flash_matches_jax(geom):
    """The port's flash prefill (K2's plain version, the row from
    ``_last_row_probs``) against JAX's flash prefill in interpret mode."""
    jcfg, tcfg = JLlama(**TEXT[geom]), tllama.LlamaConfig(**TEXT[geom])
    jparams = _llama_params(jcfg)
    tparams = params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(1)
    B, T = 2, 256
    emb = (rng.standard_normal((B, T, jcfg.hidden_size)) * 0.1).astype(np.float32)
    mask = _padded_mask(B, T)
    lj, _, rj = _interpret(
        lambda p, e, m: jllama.llama_prefill(p, jcfg, e, m, max_seq=T,
                                             extract_layer=1, use_flash=True),
        jparams, jnp.asarray(emb), jnp.asarray(mask))
    lt, _, rt = tllama.llama_prefill(tparams, tcfg, torch.as_tensor(emb),
                                     torch.as_tensor(mask), max_seq=T,
                                     extract_layer=1, use_flash=True)
    lj, rj = np.asarray(lj), np.asarray(rj)
    assert np.max(np.abs(lt.numpy() - lj)) / np.max(np.abs(lj)) <= 1e-4
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-5)
    assert float(rt[0, :, :7].max()) < 1e-6   # padding carries no attention


def test_llava_generate_flash_matches_jax():
    """``generate_with_attention(use_flash=True)`` ids-level at T = 256:
    tokens equal, maps within 1e-5."""
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, image_size=28, patch_size=14)
    text = dict(TEXT["mha"], intermediate_size=256)
    jcfg = JLlava(vision=JClip(**vision), text=JLlama(**text), image_token_index=99)
    tcfg = LlavaConfig(vision=ClipVisionConfig(**vision),
                       text=tllama.LlamaConfig(**text), image_token_index=99)
    jparams = graft._random_llava_params(jcfg, jax.random.PRNGKey(3))
    jm = JLlavaModel(jcfg, jparams)
    tm = LlavaModel(tcfg, params_from_jax(jax.device_get(jparams)))
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 90, size=(2, 256)).astype(np.int64)
    ids[:, 2:6] = 99
    pix = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    mask = _padded_mask(2, 256, pad=1)
    start = np.array([2, 2], np.int32)
    with pltpu.force_tpu_interpret_mode():
        gj, mj = jax.block_until_ready(jm.generate_with_attention(
            jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(mask), jnp.asarray(start),
            extract_layer=1, max_new_tokens=3, use_flash=True))
    gt, mt = tm.generate_with_attention(
        torch.as_tensor(ids), torch.as_tensor(pix), torch.as_tensor(mask),
        torch.as_tensor(start), extract_layer=1, max_new_tokens=3, use_flash=True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)


# The roofline helper (``kernels/roofline.py``) at the shapes chip_smoke.py
# times, against the closed forms written out: K2 reads q, k, v and the
# mask once and writes out once (bf16), and does 4 * 128 flops per allowed
# (query, key) pair and head; the pairs of a row with p pads are the causal
# triangles of its padding and of its valid part.
K2_PADS = lambda B: [(37 * b) % 61 for b in range(B)]   # chip_smoke._k2_case


@pytest.mark.parametrize("B,T,H,kvH", [(4, 640, 32, 32), (4, 640, 28, 4),
                                       (8, 704, 32, 32), (8, 704, 28, 4)])
def test_roofline_k2_counts(B, T, H, kvH):
    from attwarp_tpu_torch.kernels import roofline

    pads = K2_PADS(B)
    nbytes, flops = roofline.k2_work(B, T, H, kvH, pads)
    assert nbytes == 2 * (B * T * H * 128 * 2 + 2 * B * T * kvH * 128) + B * T
    pairs = sum(p * (p + 1) // 2 + (T - p) * (T - p + 1) // 2 for p in pads)
    assert flops == 4 * 128 * H * pairs
    if (B, T, H) == (4, 640, 32):   # pads 0, 37, 13, 50, written out
        assert pads == [0, 37, 13, 50]
        assert nbytes == 83_888_640 and flops == 4 * 128 * 32 * 760_518
    b = roofline.bound(nbytes, flops)
    assert b["bound_ms"] == pytest.approx(1e3 * max(nbytes / 3.35e12, flops / 989e12))
    assert b["bound_by"] == ("bytes" if nbytes / 3.35e12 >= flops / 989e12 else "operations")


def _k3_windows(B, S, serve):
    """chip_smoke's K3 masks: [pad, cur] per row, or the serving pool's
    windows (a retired slot's [0, 0] and a free slot's [0, 17] last)."""
    if not serve:
        return [((37 * b) % 64, S - 44 + 3 * b) for b in range(B)]
    rows = [((37 * b) % 64, (640, 704)[b % 2] + (11 * b) % 60) for b in range(B - 2)]
    return rows + [(0, 0), (0, 17)]


@pytest.mark.parametrize("B,S,H,kvH,serve", [(4, 704, 32, 32, False), (4, 704, 28, 4, False),
                                             (16, 768, 32, 32, True), (8, 768, 28, 4, True)])
def test_roofline_k3_counts(B, S, H, kvH, serve):
    """K3 reads only the allowed positions' int8 K and V rows (128 bytes
    each) and their two f32 scales for every kv head, q and out in bf16,
    and the mask; 4 * 128 flops per allowed position and query head."""
    from attwarp_tpu_torch.kernels import roofline

    n_valid = sum(cur - start + 1 for start, cur in _k3_windows(B, S, serve))
    nbytes, flops = roofline.k3_work(B, S, H, kvH, n_valid)
    assert nbytes == n_valid * kvH * (128 + 128 + 4 + 4) + 2 * B * H * 128 * 2 + B * S
    assert flops == 4 * 128 * H * n_valid
    if not serve and H == 32:   # windows [0, 660], [37, 663], [10, 666], [47, 669]
        assert n_valid == 2568 and nbytes == 21_762_816
    assert roofline.bound(nbytes, flops)["bound_by"] == "bytes"


def test_roofline_k1_counts():
    """K1 at the pipeline's warp, (4, 512, 640, 3) -> 500 x 500, all f32:
    image and maps in, warped image out; 9 flops per output value."""
    from attwarp_tpu_torch.kernels import roofline

    nbytes, flops = roofline.k1_work(4, 512, 640, 3, 500, 500)
    assert nbytes == 4 * (4 * 512 * 640 * 3 + 4 * (500 + 500) + 4 * 500 * 500 * 3) == 27_744_640
    assert flops == 9 * 4 * 500 * 500 * 3
    b = roofline.bound(nbytes, flops, roofline.F32_FLOPS)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(27_744_640 / 3.35e9)
