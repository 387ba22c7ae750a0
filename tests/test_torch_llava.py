"""The port's LLaVA (CLIP tower, projector, LLaMA prefill and decode, the
generate loop) against the JAX package on the same weights.

A tiny ``LlavaConfig`` gets random JAX weights from
``__graft_entry__._random_llava_params``, converted by ``params_from_jax``.
Everything runs in f32 on both sides, where the point is the algorithm:
1e-5 covers f32 summation order; greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from attwarp_tpu.models import ClipVisionConfig as JClip
from attwarp_tpu.models import LlamaConfig as JLlama
from attwarp_tpu.models import LlavaConfig as JLlava
from attwarp_tpu.models import LlavaModel as JLlavaModel
from attwarp_tpu.models.llama import llama_prefill as j_prefill
from attwarp_tpu.models.llava import embed_and_splice as j_splice
from attwarp_tpu.models.llava import encode_images as j_encode

from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
from attwarp_tpu_torch.models.llama import LlamaConfig, llama_prefill
from attwarp_tpu_torch.models.llava import (
    LlavaConfig,
    LlavaModel,
    embed_and_splice,
    encode_images,
    params_from_jax,
    random_params,
)

IMG_TOK = 120
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=56, patch_size=14)
TEXT = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2)


def tiny_configs():
    jcfg = JLlava(vision=JClip(**VISION), text=JLlama(**TEXT),
                  image_token_index=IMG_TOK)
    tcfg = LlavaConfig(vision=ClipVisionConfig(**VISION), text=LlamaConfig(**TEXT),
                       image_token_index=IMG_TOK)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    jparams = graft._random_llava_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.device_get(jparams))
    return JLlavaModel(jcfg, jparams), LlavaModel(tcfg, tparams)


def _inputs(seed=0):
    """Two left-padded prompts with a 16-token image span each."""
    rng = np.random.default_rng(seed)
    T = 26
    ids = np.full((2, T), 2, np.int64)       # pad id 2 on the left
    mask = np.zeros((2, T), bool)
    for b, (pre, post) in enumerate(((3, 7), (1, 5))):   # 26 and 22 tokens
        body = ([1] + list(rng.integers(3, 100, pre - 1)) + [IMG_TOK] * 16
                + list(rng.integers(3, 100, post)))
        ids[b, T - len(body):] = body
        mask[b, T - len(body):] = True
    pix = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    img_start = np.argmax(ids == IMG_TOK, axis=1)
    return ids, mask, pix, img_start


def test_config_copies_match_jax():
    jcfg, tcfg = tiny_configs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for J, T in ((JClip, ClipVisionConfig), (JLlama, LlamaConfig), (JLlava, LlavaConfig)):
        assert dataclasses.asdict(J()) == dataclasses.asdict(T())


def test_encode_images_matches_jax(models):
    jm, tm = models
    _, _, pix, _ = _inputs()
    ref = np.asarray(j_encode(jm.params, jm.cfg, jnp.asarray(pix)))
    got = encode_images(tm.params, tm.cfg, torch.as_tensor(pix)).numpy()
    assert got.shape == (2, 16, 64)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_prefill_logits_and_extract_row_match_jax(models):
    jm, tm = models
    ids, mask, pix, _ = _inputs()
    emb_j = j_splice(jm.params, jm.cfg, jnp.asarray(ids), jnp.asarray(pix))
    emb_t = embed_and_splice(tm.params, tm.cfg, torch.as_tensor(ids), torch.as_tensor(pix))
    np.testing.assert_allclose(emb_t.numpy(), np.asarray(emb_j), atol=1e-5)
    T = ids.shape[1]
    lj, _, rj = j_prefill(jm.params["llama"], jm.cfg.text, emb_j, jnp.asarray(mask),
                          max_seq=T + 4, extract_layer=1)
    lt, cache, rt = llama_prefill(tm.params["llama"], tm.cfg.text, emb_t,
                                  torch.as_tensor(mask), max_seq=T + 4,
                                  extract_layer=1, kv_quant=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    assert cache.k_q.shape == (3, 2, T + 4, 2, 16) and cache.k_q.dtype == torch.int8


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
def test_generate_with_attention_matches_jax(models, kv_quant):
    """Greedy tokens identical and maps within 1e-5, with the dense and the
    int8 cache (on the CPU, K3's plain version serves the kv8 decode)."""
    jm, tm = models
    ids, mask, pix, img_start = _inputs(seed=1)
    gj, mj = jm.generate_with_attention(
        jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(mask),
        jnp.asarray(img_start, jnp.int32), extract_layer=1, max_new_tokens=5,
        kv_quant=kv_quant)
    gt, mt = tm.generate_with_attention(
        torch.as_tensor(ids), torch.as_tensor(pix), torch.as_tensor(mask),
        torch.as_tensor(img_start), extract_layer=1, max_new_tokens=5,
        kv_quant=kv_quant)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert mt.shape == (2, 4, 4)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    ga, none = tm.generate_with_attention(
        torch.as_tensor(ids), torch.as_tensor(pix), torch.as_tensor(mask),
        torch.as_tensor(img_start), extract_layer=None, max_new_tokens=5,
        kv_quant=kv_quant)
    assert none is None
    np.testing.assert_array_equal(ga.numpy(), gt.numpy())


def test_random_params_tree_matches_jax_init():
    """random_params builds the JAX init's tree: same keys and shapes, unit
    norms, zero biases, std 0.02 matrices."""
    jcfg, tcfg = tiny_configs()
    jtree = jax.device_get(graft._random_llava_params(jcfg, jax.random.PRNGKey(0)))
    ttree = random_params(tcfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), ttree))[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == b.shape, path
    t = ttree["llama"]
    assert torch.all(t["norm"] == 1) and torch.all(ttree["projector"]["linear_1"]["bias"] == 0)
    assert abs(float(t["embed_tokens"].std()) - 0.02) < 2e-3


def test_accumulator_matches_jax(rng):
    """Per-step slicing (a span running past the row's end), renormalizing,
    head-averaging, accumulation and finalize (uniform where no step was
    counted) equal JAX's; 1e-6 on probabilities."""
    from attwarp_tpu.extract import accumulator as ja
    from attwarp_tpu_torch.extract import accumulator as ta

    rows = rng.random((3, 2, 4, 30)).astype(np.float32)   # steps, B, H, kv
    start = np.array([5, 20], np.int32)                  # 20 + 16 > 30
    active = [np.array([1.0, 1.0], np.float32), np.array([1.0, 0.0], np.float32),
              np.array([0.0, 1.0], np.float32)]
    jc, tc = ja.init_carry(2, 16), ta.init_carry(2, 16)
    for r, act in zip(rows, active):
        jc = ja.accumulate_step(jc, jnp.asarray(r), jnp.asarray(start), jnp.asarray(act), 16)
        tc = ta.accumulate_step(tc, torch.as_tensor(r), torch.as_tensor(start),
                                torch.as_tensor(act), 16)
    np.testing.assert_allclose(ta.finalize(tc, 4).numpy(), np.asarray(ja.finalize(jc, 4)),
                               atol=1e-6)
    empty = ta.finalize(ta.init_carry(1, 16), 4).numpy()
    np.testing.assert_array_equal(empty, np.full((1, 4, 4), 1 / 16, np.float32))
