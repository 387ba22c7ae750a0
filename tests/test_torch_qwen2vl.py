"""The port's Qwen2-VL (vision tower, M-RoPE, prefill and decode, the generate
loop, the backend and the two-pass pipeline) against the JAX package on the
same weights.

A tiny Qwen2-VL gets random numpy weights, given to JAX as arrays and to the
port through ``params_from_jax``. The text decoder keeps head_dim 128 and
``mrope_section`` (16, 24, 24), so flash engages at T = 256 and GQA runs
(4 query heads over 2 kv heads); the vision tower is as small as
``tests/test_qwen2vl_backend.py``'s. Everything runs in f32 on both sides:
1e-5 covers f32 summation order, greedy tokens must be identical. JAX's
flash prefill runs in interpret mode, one jitted dispatch blocked inside
``force_tpu_interpret_mode`` (see ``tests/test_flash_prefill.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from attwarp_tpu.extract.qwen2vl_backend import Qwen2VLBackend as JBackend
from attwarp_tpu.models import qwen2vl as jq
from attwarp_tpu.pipeline import AttWarpPipeline as JPipeline

from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.models import qwen2vl as tq
from attwarp_tpu_torch.models.llama import LlamaKVCache, QuantKVCache
from attwarp_tpu_torch.models.llava import params_from_jax
from attwarp_tpu_torch.pipeline import AttWarpPipeline

IMG, VSTART, VEND, PAD, EOS = 97, 96, 95, 1, 2
VISION = dict(depth=2, embed_dim=32, hidden_size=512, num_heads=2, patch_size=14,
              spatial_merge_size=2, temporal_patch_size=2, mlp_ratio=2)
TEXT = dict(vocab_size=128, hidden_size=512, intermediate_size=256,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            rope_theta=10000.0, mrope_section=(16, 24, 24))
IDS = dict(image_token_id=IMG, vision_start_token_id=VSTART,
           vision_end_token_id=VEND, pad_token_id=PAD, eos_token_id=EOS)


def tiny_configs():
    jcfg = jq.Qwen2VLConfig(vision=jq.Qwen2VLVisionConfig(**VISION),
                            text=jq.Qwen2VLTextConfig(**TEXT), **IDS)
    tcfg = tq.Qwen2VLConfig(vision=tq.Qwen2VLVisionConfig(**VISION),
                            text=tq.Qwen2VLTextConfig(**TEXT), **IDS)
    return jcfg, tcfg


def numpy_params(cfg, seed=0):
    """Random f32 weights in the JAX tree layout: normal / sqrt(fan_in)
    matrices, small random biases and norms near 1."""
    rng = np.random.default_rng(seed)
    v, t = cfg.vision, cfg.text

    def mat(o, i):
        return (rng.standard_normal((o, i)) / np.sqrt(i)).astype(np.float32)

    def vec(n, mean=0.0):
        return (mean + 0.02 * rng.standard_normal(n)).astype(np.float32)

    def lin(o, i):
        return {"weight": mat(o, i), "bias": vec(o)}

    def ln(n):
        return {"weight": vec(n, 1.0), "bias": vec(n)}

    E, D = v.embed_dim, t.hidden_size
    Em = E * v.spatial_merge_size ** 2
    kvd = t.kv_heads * t.head_dim
    return {
        "vision": {
            "patch_weight": mat(E, 3 * v.temporal_patch_size * v.patch_size ** 2),
            "blocks": [{"norm1": ln(E), "norm2": ln(E), "qkv": lin(3 * E, E),
                        "proj": lin(E, E), "fc1": lin(E * v.mlp_ratio, E),
                        "fc2": lin(E, E * v.mlp_ratio)} for _ in range(v.depth)],
            "merger": {"ln_q": ln(E), "fc1": lin(Em, Em), "fc2": lin(D, Em)},
        },
        "text": {
            "embed_tokens": rng.standard_normal((t.vocab_size, D)).astype(np.float32),
            "lm_head": mat(t.vocab_size, D),
            "norm": vec(D, 1.0),
            "layers": [{"input_layernorm": vec(D, 1.0),
                        "post_attention_layernorm": vec(D, 1.0),
                        "q_proj": lin(D, D), "k_proj": lin(kvd, D),
                        "v_proj": lin(kvd, D), "o_proj": mat(D, D),
                        "gate_proj": mat(t.intermediate_size, D),
                        "up_proj": mat(t.intermediate_size, D),
                        "down_proj": mat(D, t.intermediate_size)}
                       for _ in range(t.num_hidden_layers)],
        },
    }


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_configs()
    tree = numpy_params(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jq.Qwen2VLModel(jcfg, jparams), tq.Qwen2VLModel(tcfg, params_from_jax(tree))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _interpret(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.block_until_ready(jax.jit(fn)(*args))


def _prompt(T, rng, pad=(7, 0), n_img=4):
    """Left-padded ids (B, T) with a vision block of ``n_img`` tokens."""
    B = len(pad)
    ids = rng.integers(3, 90, size=(B, T)).astype(np.int64)
    mask = np.ones((B, T), bool)
    for b, p in enumerate(pad):
        ids[b, :p] = PAD
        mask[b, :p] = False
        ids[b, p + 3] = VSTART
        ids[b, p + 4:p + 4 + n_img] = IMG
        ids[b, p + 4 + n_img] = VEND
    return ids, mask


def test_copies_match_jax(rng):
    """Configs, ``patchify_image``, ``_vision_rot_pos`` and
    ``get_mrope_positions`` equal the originals; ``patchify_batch`` equals
    ``patchify_image`` image by image."""
    jcfg, tcfg = tiny_configs()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert dataclasses.asdict(jq.Qwen2VLConfig()) == dataclasses.asdict(tq.Qwen2VLConfig())
    imgs = rng.standard_normal((3, 56, 84, 3)).astype(np.float32)
    for v in (jcfg.vision, jq.Qwen2VLVisionConfig()):
        for im in imgs:
            (pj, gj), (pt, gt) = jq.patchify_image(im, v), tq.patchify_image(im, v)
            np.testing.assert_array_equal(pt, pj)
            assert gt == gj
        pb, gb = tq.patchify_batch(_t(imgs), v)
        assert gb == (1, 4, 6)
        for b in range(3):
            np.testing.assert_array_equal(pb[b].numpy(), jq.patchify_image(imgs[b], v)[0])
        np.testing.assert_array_equal(tq._vision_rot_pos((4, 6), v),
                                      jq._vision_rot_pos((4, 6), v))
    ids, mask = _prompt(40, rng, pad=(5, 0, 2))
    ids[2, 30:] = rng.integers(3, 90, 10)   # text after the image, and text only
    ids[1, :] = rng.integers(3, 90, 40)
    for grid in ((1, 4, 4), (1, 2, 2)):
        n = grid[1] * grid[2] // 4
        i2 = ids.copy()
        i2[0, 9:9 + n] = IMG
        pj, dj = jq.get_mrope_positions(i2, mask, grid, IMG, 2)
        pt, dt = tq.get_mrope_positions(i2, mask, grid, IMG, 2)
        np.testing.assert_array_equal(pt, pj)
        np.testing.assert_array_equal(dt, dj)


def test_vision_features_and_mrope_match_jax(models, rng):
    jm, tm = models
    imgs = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    patches = np.stack([jq.patchify_image(im, jm.cfg.vision)[0] for im in imgs])
    ref = np.stack([np.asarray(jq.qwen2vl_vision_features(
        jm.params["vision"], jm.cfg.vision, jnp.asarray(p), (4, 4))) for p in patches])
    got = tq.qwen2vl_vision_features(tm.params["vision"], tm.cfg.vision, _t(patches), (4, 4))
    assert got.shape == (2, 4, 512)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)

    ids, mask = _prompt(30, rng)
    pos, _ = jq.get_mrope_positions(ids, mask, (1, 4, 4), IMG, 2)
    cj, sj = jq.mrope_cos_sin(jnp.asarray(pos), jm.cfg.text)
    ct, st = tq.mrope_cos_sin(_t(pos), tm.cfg.text)
    assert ct.shape == (2, 30, 128)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5)


def _prefill_inputs(models, T, seed):
    jm, tm = models
    rng = np.random.default_rng(seed)
    ids, mask = _prompt(T, rng)
    emb = rng.standard_normal((2, T, 512)).astype(np.float32)
    pos, deltas = jq.get_mrope_positions(ids, mask, (1, 4, 4), IMG, 2)
    cj, sj = jq.mrope_cos_sin(jnp.asarray(pos), jm.cfg.text)
    ct, st = tq.mrope_cos_sin(_t(pos), tm.cfg.text)
    return emb, mask, (cj, sj), (ct, st), deltas


@pytest.mark.parametrize("use_flash", [False, True], ids=["dense", "flash"])
def test_prefill_matches_jax(models, use_flash):
    """Logits within 1e-4 of their range, the extract row within 1e-5; with
    flash, JAX's K2 in interpret mode against K2's plain version."""
    jm, tm = models
    T = 256
    emb, mask, (cj, sj), (ct, st), _ = _prefill_inputs(models, T, seed=1)

    def jfn(p, e, m, c, s):
        return jq.qwen2vl_prefill(p, jm.cfg.text, e, m, c, s, max_seq=T,
                                  extract_layer=1, use_flash=use_flash)

    args = (jm.params["text"], jnp.asarray(emb), jnp.asarray(mask), cj, sj)
    lj, _, rj = _interpret(jfn, *args) if use_flash else jfn(*args)
    lt, _, rt = tq.qwen2vl_prefill(tm.params["text"], tm.cfg.text, _t(emb), _t(mask),
                                   ct, st, max_seq=T, extract_layer=1,
                                   use_flash=use_flash)
    lj, rj = np.asarray(lj), np.asarray(rj)
    assert np.max(np.abs(lt.numpy() - lj)) / np.max(np.abs(lj)) <= 1e-4
    np.testing.assert_allclose(rt.numpy(), rj, atol=1e-5)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["dense", "kv8"])
def test_decode_step_matches_jax(models, kv_quant):
    """One decode step on the same cache (JAX's prefill's, copied): logits
    and the extract row within 1e-5, the new token written at ``cur_len``.
    (Each package's own int8 cache would differ wherever f32 rounding tips
    a value across an int8 rounding boundary.)"""
    jm, tm = models
    T, S = 40, 64
    emb, mask, (cj, sj), _, deltas = _prefill_inputs(models, T, seed=2)
    _, kv_j, _ = jq.qwen2vl_prefill(jm.params["text"], jm.cfg.text, jnp.asarray(emb),
                                    jnp.asarray(mask), cj, sj, max_seq=S,
                                    kv_quant=kv_quant)
    planes = [torch.tensor(np.array(a)) for a in kv_j]
    kv_t = QuantKVCache(*planes) if kv_quant else LlamaKVCache(*planes)
    full = np.zeros((2, S), bool)
    full[:, :T] = mask
    full[:, T] = True
    pos3 = np.broadcast_to((T + deltas)[None, :, None], (3, 2, 1)).copy()
    tok = np.random.default_rng(3).standard_normal((2, 1, 512)).astype(np.float32)
    lj, kv_j, rj = jq.qwen2vl_decode_step(
        jm.params["text"], jm.cfg.text, jnp.asarray(tok), kv_j, T,
        *jq.mrope_cos_sin(jnp.asarray(pos3), jm.cfg.text), jnp.asarray(full),
        extract_layer=1)
    lt, kv_t, rt = tq.qwen2vl_decode_step(
        tm.params["text"], tm.cfg.text, _t(tok), kv_t, T,
        *tq.mrope_cos_sin(_t(pos3), tm.cfg.text), _t(full), extract_layer=1)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    if kv_quant:
        np.testing.assert_allclose(kv_t.k_s[:, :, T].numpy(),
                                   np.asarray(kv_j.k_s[:, :, T]), rtol=1e-5)
    else:
        np.testing.assert_allclose(kv_t.k[:, :, T].numpy(),
                                   np.asarray(kv_j[0][:, :, T]), atol=1e-5)


@pytest.mark.parametrize("kv_quant,use_flash", [(False, False), (True, False), (True, True)],
                         ids=["dense", "kv8", "kv8+flash"])
def test_generate_with_attention_matches_jax(models, kv_quant, use_flash):
    """Greedy tokens identical and maps within 1e-5 at T = 256 (one padded
    row); answer-only generate gives the same tokens."""
    jm, tm = models
    rng = np.random.default_rng(4)
    ids, mask = _prompt(256, rng)
    imgs = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    patches = np.stack([jq.patchify_image(im, jm.cfg.vision)[0] for im in imgs])
    kw = dict(extract_layer=1, max_new_tokens=4, kv_quant=kv_quant, use_flash=use_flash)
    with pltpu.force_tpu_interpret_mode():
        gj, mj = jax.block_until_ready(jm.generate_with_attention(
            ids, patches, (1, 4, 4), mask, **kw))
    gt, mt = tm.generate_with_attention(_t(ids), _t(patches), (1, 4, 4), _t(mask), **kw)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert mt.shape == (2, 2, 2)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    ga, none = tm.generate_with_attention(_t(ids), _t(patches), (1, 4, 4), _t(mask),
                                          **dict(kw, extract_layer=None))
    assert none is None
    np.testing.assert_array_equal(ga.numpy(), gt.numpy())


class _CallTokenizer(DryRunTokenizer):
    """DryRunTokenizer behind the ``__call__`` form JAX's backend uses."""

    def __call__(self, text, add_special_tokens=False):
        return {"input_ids": self.encode(text, add_special_tokens=add_special_tokens)}


def test_build_ids_matches_jax():
    jcfg, tcfg = tiny_configs()
    jbe = JBackend(jq.Qwen2VLModel(jcfg, {}), tokenizer=_CallTokenizer(),
                   extract_layer=1, image_size=84)
    tbe = Qwen2VLBackend(tq.Qwen2VLModel(tcfg, {}), tokenizer=DryRunTokenizer(),
                         extract_layer=1, image_size=84)
    assert tbe.num_patches_side == jbe.num_patches_side == 3
    for q in ("what is the text on the label?", "", "read the code; tag (key-phrase)"):
        assert tbe.build_ids(q) == jbe.build_ids(q)
    with pytest.raises(ValueError):
        Qwen2VLBackend(tq.Qwen2VLModel(tcfg, {}), image_size=100)   # not /28
    with pytest.raises(ValueError):
        Qwen2VLBackend(tq.Qwen2VLModel(tcfg, {}), extract_layer=3)  # 3 layers


def test_pipeline_matches_jax(models, rng):
    """The port's pipeline on a tiny Qwen backend against JAX's pipeline
    (its host path, which JAX takes for Qwen): answers equal, maps 1e-5,
    masks within 1 uint8 LSB, warps within 1e-3 of [0, 1] pixels."""
    jm, tm = models
    jbe = JBackend(jm, tokenizer=_CallTokenizer(), extract_layer=1, image_size=56,
                   kv_quant=True)
    tbe = Qwen2VLBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=1,
                         image_size=56, kv_quant=True)
    images = [
        (rng.random((60, 80, 3)) * 255).astype(np.uint8),
        rng.random((72, 72, 3)).astype(np.float32),
        (rng.random((60, 80, 3)) * 255).astype(np.uint8),
    ]
    questions = ["what is the text?", "read the label", "what is shown here?"]
    kw = dict(warp_size=48, max_new_tokens=3, size_bucket=16, max_side=96)
    ref = JPipeline(jbe, **kw).run(images, questions)
    jax.effects_barrier()
    got = AttWarpPipeline(tbe, **kw).run(images, questions)

    assert got.first_answers == ref.first_answers
    assert got.second_answers == ref.second_answers
    assert got.attention_maps.shape == (3, 2, 2)
    np.testing.assert_allclose(got.attention_maps, ref.attention_maps, atol=1e-5)
    for m_t, m_j in zip(got.mota_masks, ref.mota_masks):
        assert m_t.shape == m_j.shape and m_t.dtype == m_j.dtype == np.uint8
        assert np.abs(m_t.astype(np.int16) - m_j.astype(np.int16)).max() <= 1
    assert got.warped.shape == ref.warped.shape == (3, 48, 48, 3)
    assert np.max(np.abs(got.warped - ref.warped)) <= 1e-3 * 255


def test_random_params_tree_matches_jax_layout():
    """``random_params`` builds the JAX tree: same keys and shapes; unit
    norms, zero biases, 1/sqrt(fan_in) matrices."""
    jcfg, tcfg = tiny_configs()
    ref = jax.tree_util.tree_flatten_with_path(numpy_params(jcfg))[0]
    tree = tq.random_params(tcfg, torch.Generator().manual_seed(0), "cpu", torch.float32)
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), tree))[0]
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(ref, got):
        assert a.shape == b.shape, path
    t = tree["text"]["layers"][0]
    assert torch.all(t["input_layernorm"] == 1) and torch.all(t["q_proj"]["bias"] == 0)
    assert abs(float(t["gate_proj"].std()) * np.sqrt(512) - 1.0) < 0.05
