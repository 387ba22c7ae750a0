"""Multi-layer extraction, the layer sweep and its cubic upscale: the port
against the JAX package on the same weights.

Covers the generate loops at ``max_new_tokens=0`` (the sweep's cadence),
a sequence of extract layers through both families' prefill, decode and
generate (dense, ``+kv8`` and ``+kv8+flash``, flash at T = 256 with JAX's K2
in interpret mode), that the listed layers alone leave K3 for the plain
path, Qwen2-VL's shared-image form, the dataset driver's per-layer
artifacts, ``jax.image.resize``'s cubic weights and ``layer_sweep`` on a
tiny LLaVA (one pass for all layers) and on the mini (a layer at a time).
Everything is f32 on both sides: maps within 1e-5, greedy tokens equal.
"""

import csv
import dataclasses
import glob
import inspect
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as graft
from attwarp_tpu.cli.process_dataset import _extract_with_fallback as j_fallback
from attwarp_tpu.cli.process_dataset import make_backend as j_make_backend
from attwarp_tpu.cli.process_dataset import process_dataset as j_process_dataset
from attwarp_tpu.eval import ablation as jablation
from attwarp_tpu.eval import layer_sweep as jsweep
from attwarp_tpu.extract.extraction import MiniLLaVABackend as JMini
from attwarp_tpu.extract.llava_backend import LlavaBackend as JLlavaBackend
from attwarp_tpu.extract.mini_llava import MiniLLaVAConfig as JMiniCfg
from attwarp_tpu.models import ClipVisionConfig as JClip
from attwarp_tpu.models import LlamaConfig as JLlama
from attwarp_tpu.models import LlavaConfig as JLlava
from attwarp_tpu.models import LlavaModel as JLlavaModel
from attwarp_tpu.models import qwen2vl as jq
from tools.make_random_7b_ckpt import build_dry_run_tokenizer

from attwarp_tpu_torch.cli import process_dataset as pd
from attwarp_tpu_torch.eval import ablation as tablation
from attwarp_tpu_torch.eval import layer_sweep as tsweep
from attwarp_tpu_torch.extract.extraction import MiniLLaVABackend
from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.mini_llava import MiniLLaVAConfig
from attwarp_tpu_torch.extract.mini_llava import params_from_jax as mini_from_jax
from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
from attwarp_tpu_torch.extract.resize import cubic_weight_matrix, resize_cubic
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.models import llama as tllama
from attwarp_tpu_torch.models import qwen2vl as tq
from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
from attwarp_tpu_torch.models.llava import LlavaConfig, LlavaModel, params_from_jax
from attwarp_tpu_torch.testing import reader as treader

import test_torch_llava as llava_t
import test_torch_qwen2vl as qwen_t

MODES = {"dense": dict(kv_quant=False, use_flash=False),
         "kv8": dict(kv_quant=True, use_flash=False),
         "flash": dict(kv_quant=True, use_flash=True)}
CASES = [(f, m) for f in ("llava", "qwen") for m in MODES]
N_LAYERS = 3          # every tiny decoder below has three layers

MINI = dict(vocab=256, d_model=32, n_heads=2, n_layers=3, extract_layer=1,
            num_patches=4, image_size=32, max_seq=96)


def _t(a):
    return torch.as_tensor(np.array(a))


# ── the models: tiny LLaVA (T = 26), a flash-width LLaVA (head_dim 128,
#    T = 256) and tiny Qwen2-VL (T = 256), all three decoder layers ──────

@pytest.fixture(scope="module")
def llava():
    jcfg, tcfg = llava_t.tiny_configs()
    jp = graft._random_llava_params(jcfg, jax.random.PRNGKey(0))
    return JLlavaModel(jcfg, jp), LlavaModel(tcfg, params_from_jax(jax.device_get(jp)))


@pytest.fixture(scope="module")
def llava_flash():
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                  num_attention_heads=2, image_size=28, patch_size=14)
    text = dict(vocab_size=128, hidden_size=256, intermediate_size=256,
                num_hidden_layers=N_LAYERS, num_attention_heads=2, num_key_value_heads=2)
    jcfg = JLlava(vision=JClip(**vision), text=JLlama(**text), image_token_index=99)
    tcfg = LlavaConfig(vision=ClipVisionConfig(**vision), text=tllama.LlamaConfig(**text),
                       image_token_index=99)
    jp = graft._random_llava_params(jcfg, jax.random.PRNGKey(3))
    return JLlavaModel(jcfg, jp), LlavaModel(tcfg, params_from_jax(jax.device_get(jp)))


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = qwen_t.tiny_configs()
    tree = qwen_t.numpy_params(jcfg)
    return (jq.Qwen2VLModel(jcfg, jax.tree_util.tree_map(jnp.asarray, tree)),
            tq.Qwen2VLModel(tcfg, params_from_jax(tree)))


@pytest.fixture(scope="module")
def families(llava, llava_flash, qwen):
    return {"llava": llava, "llava_flash": llava_flash, "qwen": qwen}


def _llava_inputs(flash):
    if not flash:
        return llava_t._inputs(seed=1)
    rng = np.random.default_rng(2)
    ids = rng.integers(3, 90, size=(2, 256)).astype(np.int64)
    ids[:, 2:6] = 99
    mask = np.ones((2, 256), bool)
    mask[0, :1] = False
    pix = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    return ids, mask, pix, np.array([2, 2])


def _qwen_inputs(seed=4):
    rng = np.random.default_rng(seed)
    ids, mask = qwen_t._prompt(256, rng)
    imgs = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    patches = np.stack([jq.patchify_image(im, jq.Qwen2VLVisionConfig(**qwen_t.VISION))[0]
                        for im in imgs])
    return ids, mask, patches


def _generate(families, family, mode, spec, n, with_jax=True):
    """(JAX tokens, JAX maps, port tokens, port maps) of one greedy
    generate; the JAX side in interpret mode (one blocked dispatch) where
    the flash prefill engages."""
    kw = dict(MODES[mode], extract_layer=spec, max_new_tokens=n)
    if family == "llava":
        flash = mode == "flash"
        jm, tm = families["llava_flash" if flash else "llava"]
        ids, mask, pix, st = _llava_inputs(flash)
        jargs = (jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(mask),
                 jnp.asarray(st, jnp.int32))
        targs = (_t(ids), _t(pix), _t(mask), _t(st))
    else:
        jm, tm = families["qwen"]
        ids, mask, patches = _qwen_inputs()
        jargs = (ids, patches, (1, 4, 4), mask)
        targs = (_t(ids), _t(patches), (1, 4, 4), _t(mask))
    gt, mt = tm.generate_with_attention(*targs, **kw)
    if not with_jax:
        return None, None, gt, mt
    with pltpu.force_tpu_interpret_mode():
        gj, mj = jax.block_until_ready(jm.generate_with_attention(*jargs, **kw))
    return np.asarray(gj), np.asarray(mj), gt, mt


class _CountK3:
    """Counts calls of K3's wrapper from the decode step (on the CPU its
    plain version)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        inner = tllama.decode_attn_int8

        def counted(*a, **k):
            self.calls += 1
            return inner(*a, **k)
        monkeypatch.setattr(tllama, "decode_attn_int8", counted)


# ── the repair: max_new_tokens=0 ────────────────────────────────────────

@pytest.mark.parametrize("family,mode", CASES, ids=[f"{f}-{m}" for f, m in CASES])
def test_zero_new_tokens_matches_jax(families, family, mode, monkeypatch):
    """One prefill and no decode step: tokens (B, 0) of the loop's dtype,
    the prefill row's maps within 1e-5 of JAX's, and K3 never called."""
    k3 = _CountK3(monkeypatch)
    gj, mj, gt, mt = _generate(families, family, mode, 1, 0)
    assert gj.shape == (2, 0) and tuple(gt.shape) == (2, 0) and gt.dtype == torch.int64
    assert mt.shape == mj.shape and mt.ndim == 3
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-5)
    assert k3.calls == 0
    _, mj2, gt2, mt2 = _generate(families, family, mode, (2, 0), 0)
    assert tuple(gt2.shape) == (2, 0) and mt2.shape[0] == 2 and mt2.shape == mj2.shape
    np.testing.assert_allclose(mt2.numpy(), mj2, atol=1e-5)


# ── a sequence of extract layers ────────────────────────────────────────

@pytest.mark.parametrize("family,mode", CASES, ids=[f"{f}-{m}" for f, m in CASES])
def test_layers_match_jax(families, family, mode, monkeypatch):
    """An unsorted sequence of two layers: maps (L, B, n, n) within 1e-5 of
    JAX's, greedy tokens equal, each listed layer's map within 1e-5 of a
    single-layer run at that layer, and on the int8 cache K3 called by the
    unlisted layer only: (layers - L) calls a decode step. The spec is
    (2, 0), and (2, 1) for Qwen2-VL's int8 cache: there the two packages'
    prefill caches hold a few int8 values 1 LSB apart (their vision towers'
    features differ by ~2e-6), which moves layer 0's decode rows by up to
    ~1e-4; ``test_qwen_int8_rows_match_jax_on_one_cache`` holds layer 0
    there on one cache."""
    n = 2 if mode == "flash" else 3
    spec = (2, 1) if family == "qwen" and MODES[mode]["kv_quant"] else (2, 0)
    k3 = _CountK3(monkeypatch)
    gj, mj, gt, mt = _generate(families, family, mode, spec, n)
    assert k3.calls == ((N_LAYERS - 2) * n if MODES[mode]["kv_quant"] else 0)
    np.testing.assert_array_equal(gt.numpy(), gj)
    assert mt.ndim == 4 and mt.shape[:2] == (2, 2) and mt.shape == mj.shape
    np.testing.assert_allclose(mt.numpy(), mj, atol=1e-5)
    for j, layer in enumerate(spec):
        _, _, g1, m1 = _generate(families, family, mode, layer, n, with_jax=False)
        np.testing.assert_array_equal(g1.numpy(), gt.numpy())
        np.testing.assert_allclose(mt[j].numpy(), m1.numpy(), atol=1e-5)


@pytest.mark.parametrize("family", ["llava", "qwen"])
def test_layer_order_and_range(families, family, monkeypatch):
    """An unsorted spec keeps its order, K3 runs on no layer when all are
    listed, and a layer past the decoder (or negative) raises, as JAX's
    ``_stack_rows`` does; an int spec keeps (B, n, n)."""
    k3 = _CountK3(monkeypatch)
    _, _, _, m3 = _generate(families, family, "kv8", (1, 2, 0), 2, with_jax=False)
    assert k3.calls == 0
    singles = [_generate(families, family, "kv8", layer, 2, with_jax=False)[3]
               for layer in (1, 2, 0)]
    assert k3.calls == 3 * (N_LAYERS - 1) * 2
    np.testing.assert_allclose(m3.numpy(), torch.stack(singles).numpy(), atol=1e-5)
    assert singles[0].ndim == 3
    for bad in ((0, 3), (-1,), 3):
        with pytest.raises(ValueError, match="out of range"):
            _generate(families, family, "dense", bad, 1, with_jax=False)
    with pytest.raises(ValueError, match="out of range"):
        _generate(families, family, "dense", (0, 3), 1)


def test_prefill_and_decode_rows_match_jax(llava):
    """``llama_prefill`` and ``llama_decode_step`` with a sequence: rows
    (L, B, H, T) in the spec's order, each equal to JAX's."""
    from attwarp_tpu.models import llama as jllama

    jm, tm = llava
    ids, mask, _, _ = llava_t._inputs()
    emb = np.asarray(tm.params["llama"]["embed_tokens"])[np.clip(ids, 0, 127)]
    emb_j, emb_t = jnp.asarray(emb), _t(emb)
    T = ids.shape[1]
    lj, kvj, rj = jllama.llama_prefill(jm.params["llama"], jm.cfg.text, emb_j,
                                      jnp.asarray(mask), max_seq=T + 2, extract_layer=(2, 0))
    lt, kvt, rt = tllama.llama_prefill(tm.params["llama"], tm.cfg.text, emb_t, _t(mask),
                                       max_seq=T + 2, extract_layer=(2, 0))
    assert tuple(rt.shape) == (2, 2, 4, T)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    full = np.pad(mask, ((0, 0), (0, 2)))
    full[:, T] = True
    pos = mask.sum(axis=1)
    e1 = np.asarray(tm.params["llama"]["embed_tokens"])[np.array([5, 7])][:, None]
    lj2, _, rj2 = jllama.llama_decode_step(jm.params["llama"], jm.cfg.text, jnp.asarray(e1),
                                           kvj, T, jnp.asarray(pos), jnp.asarray(full),
                                           extract_layer=(0, 2))
    lt2, _, rt2 = tllama.llama_decode_step(tm.params["llama"], tm.cfg.text, _t(e1), kvt, T,
                                           _t(pos), _t(full), extract_layer=(0, 2))
    assert tuple(rt2.shape) == (2, 2, 4, T + 2)
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), atol=1e-5)
    np.testing.assert_allclose(rt2.numpy(), np.asarray(rj2), atol=1e-5)


def test_forward_logits_layers_match_jax(llava, qwen):
    """Both families' ``forward_logits`` with a sequence of layers: rows
    (L, B, H, T) equal to JAX's."""
    jm, tm = llava
    ids, mask, pix, _ = llava_t._inputs()
    lj, rj = jm.forward_logits(jnp.asarray(ids), jnp.asarray(pix), jnp.asarray(mask),
                               extract_layer=(2, 0))
    lt, rt = tm.forward_logits(_t(ids), _t(pix), _t(mask), extract_layer=(2, 0))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    jm, tm = qwen
    ids, mask, patches = _qwen_inputs()
    lj, rj = jm.forward_logits(ids, patches[0], (1, 4, 4), mask, extract_layer=(2, 0))
    lt, rt = tm.forward_logits(_t(ids), _t(patches[0]), (1, 4, 4), _t(mask),
                               extract_layer=(2, 0))
    assert rt.shape[:2] == (2, 2)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)


# ── Qwen2-VL: one image shared by the batch ─────────────────────────────

@pytest.mark.parametrize("mode", ["kv8", "flash"])
def test_qwen_shared_image(qwen, mode):
    """(N, D) patches of one image: the same maps and tokens as that image
    repeated per sample (1e-5) and as JAX's shared form; the vision tower
    runs once."""
    jm, tm = qwen
    ids, mask, patches = _qwen_inputs(seed=5)
    one = patches[0]
    kw = dict(MODES[mode], extract_layer=(2, 0), max_new_tokens=3)
    calls = []
    inner = tq.qwen2vl_vision_features

    def counted(p, cfg, x, hw):
        calls.append(tuple(x.shape))
        return inner(p, cfg, x, hw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq, "qwen2vl_vision_features", counted)
        gs, ms = tm.generate_with_attention(_t(ids), _t(one), (1, 4, 4), _t(mask), **kw)
    assert calls == [(1,) + one.shape]
    gr, mr = tm.generate_with_attention(_t(ids), _t(np.stack([one, one])), (1, 4, 4),
                                        _t(mask), **kw)
    np.testing.assert_array_equal(gs.numpy(), gr.numpy())
    np.testing.assert_allclose(ms.numpy(), mr.numpy(), atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        gj, mj = jax.block_until_ready(jm.generate_with_attention(ids, one, (1, 4, 4), mask,
                                                                  **kw))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(gj))
    np.testing.assert_allclose(ms.numpy(), np.asarray(mj), atol=1e-5)


def test_qwen_int8_rows_match_jax_on_one_cache(qwen):
    """Qwen2-VL's decode step on JAX's own int8 prefill cache, copied:
    every listed layer's row, layer 0 included, within 1e-5 of JAX's step
    (JAX's K3 in interpret mode for the unlisted layer); and the port's own
    prefill cache holds every int8 value within 1 LSB of JAX's."""
    from attwarp_tpu_torch.models.llama import QuantKVCache

    jm, tm = qwen
    ids, mask, patches = _qwen_inputs()
    T, S, grid = ids.shape[1], 320, (1, 4, 4)
    pos, deltas = tq.get_mrope_positions(ids, mask, grid, jm.cfg.image_token_id, 2)
    feats = jax.vmap(lambda p: jq.qwen2vl_vision_features(jm.params["vision"], jm.cfg.vision,
                                                          p, grid[1:]))(jnp.asarray(patches))
    emb = np.asarray(jq.embed_and_splice(jm.params, jm.cfg, jnp.asarray(ids), feats))
    jcos, jsin = jq.mrope_cos_sin(jnp.asarray(pos), jm.cfg.text)
    _, kvj, _ = jq.qwen2vl_prefill(jm.params["text"], jm.cfg.text, jnp.asarray(emb),
                                   jnp.asarray(mask), jcos, jsin, max_seq=S, kv_quant=True)
    p3 = np.broadcast_to((T + deltas)[None, :, None], (3, 2, 1)).astype(np.int32)
    full = np.pad(mask, ((0, 0), (0, S - T)))
    full[:, T] = True
    e1 = np.asarray(jm.params["text"]["embed_tokens"])[np.array([5, 9])][:, None]
    c1, s1 = jq.mrope_cos_sin(jnp.asarray(p3), jm.cfg.text)

    def step(kv):
        return jq.qwen2vl_decode_step(jm.params["text"], jm.cfg.text, jnp.asarray(e1), kv, T,
                                      c1, s1, jnp.asarray(full), extract_layer=(2, 0))
    with pltpu.force_tpu_interpret_mode():
        lj, _, rj = jax.block_until_ready(jax.jit(step)(kvj))
    kvt = QuantKVCache(*(_t(np.array(a)) for a in kvj))
    lt, _, rt = tq.qwen2vl_decode_step(tm.params["text"], tm.cfg.text, _t(e1), kvt, T,
                                       _t(np.asarray(c1)), _t(np.asarray(s1)), _t(full),
                                       extract_layer=(2, 0))
    assert tuple(rt.shape) == (2, 2, 4, S)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    cos, sin = tq.mrope_cos_sin(_t(pos), tm.cfg.text)
    emb_t = tq.embed_and_splice(tm.params, tm.cfg, _t(ids), tm.image_features(_t(patches), grid))
    _, own, _ = tq.qwen2vl_prefill(tm.params["text"], tm.cfg.text, emb_t, _t(mask), cos, sin,
                                   max_seq=S, kv_quant=True)
    for mine, theirs in ((own.k_q, kvj.k_q), (own.v_q, kvj.v_q)):
        assert np.abs(mine.numpy().astype(int) - np.asarray(theirs).astype(int)).max() <= 1


def test_qwen_backend_checks_every_layer(qwen):
    _, tm = qwen
    be = Qwen2VLBackend(tm, extract_layer=(2, 0), image_size=56)
    assert be.extract_layer == (2, 0)
    with pytest.raises(ValueError, match="extract_layer 3 out of range"):
        Qwen2VLBackend(tm, extract_layer=(0, 3), image_size=56)


# ── the dataset driver with --layer-index 2,0 ───────────────────────────

def _lsb(a, b):
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _tree(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*"), recursive=True))


def _compare_driver_runs(t_root, j_root, width, height, tmp):
    """Both drivers' trees: the same files and metadata, each listed
    layer's map and the primary map within 1e-5 of JAX's. The mask and the
    warp are held stage by stage, on the port's own map: its mask within 1
    LSB of JAX's ``blend_mask`` of that map, its warp within 1 LSB of JAX's
    ``save_warped_image`` of that mask (a map 1e-6 away can move the
    enhanced, min-max stretched mask by 2 LSB)."""
    from attwarp_tpu.warp.blend import blend_mask as j_blend
    from attwarp_tpu.warp.io import save_warped_image as j_save_warped

    assert _tree(t_root) == _tree(j_root)
    metas = sorted(glob.glob(os.path.join(j_root, "metadata", "*.json")))
    assert metas
    for mj_path in metas:
        mj = json.load(open(mj_path))
        mt = json.load(open(os.path.join(t_root, "metadata", os.path.basename(mj_path))))
        drop = ("saved_paths", "api_model_name")
        assert {k: v for k, v in mt.items() if k not in drop} == \
            {k: v for k, v in mj.items() if k not in drop}
        p_t, p_j = mt["saved_paths"], mj["saved_paths"]
        assert p_t.keys() == p_j.keys()
        flat_t = dict(p_t.pop("raw_attention_maps_per_layer", {}))
        flat_j = dict(p_j.pop("raw_attention_maps_per_layer", {}))
        assert flat_t.keys() == flat_j.keys()
        for key in flat_j:
            assert os.path.relpath(flat_t[key], t_root) == os.path.relpath(flat_j[key], j_root)
            np.testing.assert_allclose(np.load(flat_t[key]), np.load(flat_j[key]), atol=1e-5)
        for key, pj in p_j.items():
            assert pj is not None and os.path.relpath(p_t[key], t_root) == \
                os.path.relpath(pj, j_root), key
        att = np.load(p_t["raw_attention_map_npy"])
        np.testing.assert_allclose(att, np.load(p_j["raw_attention_map_npy"]), atol=1e-5)
        image = _png(p_t["original_image"])
        np.testing.assert_array_equal(image, _png(p_j["original_image"]))
        mota = np.load(p_t["mota_mask_npy"])
        assert _lsb(mota, j_blend(image, jnp.asarray(att[0, 0]), 10.0, 3)[1]) <= 1
        ref = os.path.join(tmp, os.path.basename(p_t["warped_image_identity"]))
        assert j_save_warped(image_path=image, att_map=mota, original_image_save_path=None,
                             masked_overlay_save_path=None, output_path=ref, width=width,
                             height=height, transform="identity")
        assert _lsb(_png(p_t["warped_image_identity"]), _png(ref)) <= 1
    return [json.load(open(p)) for p in sorted(glob.glob(os.path.join(t_root, "metadata",
                                                                          "*.json")))]


def test_driver_layer_list_matches_jax(llava, tmp_path):
    """``process_dataset`` with a LLaVA backend extracting layers (2, 0):
    per-layer raw maps ``{sid}_raw_attn_layer{l}.npy``,
    ``raw_attention_maps_per_layer`` and ``extract_layers`` as JAX writes
    them; the first listed layer drives the raw map, the mask and the warp."""
    jm, tm = llava
    jbe = JLlavaBackend(jm, tokenizer=build_dry_run_tokenizer(), extract_layer=(2, 0),
                        kv_quant=True)
    tbe = LlavaBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=(2, 0), kv_quant=True)
    json_path, image_dir = treader.write_textvqa_dataset(str(tmp_path / "data"), n=3, seed=2,
                                                         src=192)
    kw = dict(batch_size=2, max_new_tokens=3, width=64, height=48)
    j_process_dataset(json_path, image_dir, str(tmp_path / "jax"), jbe, **kw)
    jax.effects_barrier()
    assert pd.process_dataset(json_path, image_dir, str(tmp_path / "torch"), tbe, **kw) == \
        {"processed": 3, "failed": 0}
    metas = _compare_driver_runs(str(tmp_path / "torch"), str(tmp_path / "jax"), 64, 48,
                                 str(tmp_path))
    for m in metas:
        assert m["extract_layers"] == [2, 0]
        per = m["saved_paths"]["raw_attention_maps_per_layer"]
        assert sorted(per) == ["0", "2"] and per["2"].endswith(f"{m['sample_id']}_raw_attn_layer2.npy")
        np.testing.assert_array_equal(np.load(per["2"]),
                                      np.load(m["saved_paths"]["raw_attention_map_npy"]))
        assert np.load(per["0"]).shape == (1, 1, 4, 4)


def test_driver_mini_matches_jax(tmp_path):
    """The driver on the mini backend (one layer), JAX's weights carried
    across: the same files and metadata, maps 1e-5, masks and warps 1 LSB."""
    cfg = MINI
    jbe = JMini(JMiniCfg(**cfg), seed=0)
    tbe = MiniLLaVABackend(MiniLLaVAConfig(**cfg), device="cpu",
                           params=mini_from_jax(jax.device_get(jbe.params)))
    json_path, image_dir = treader.write_textvqa_dataset(str(tmp_path / "data"), n=3, seed=5,
                                                         src=192)
    kw = dict(batch_size=2, max_new_tokens=4, width=48, height=40)
    j_process_dataset(json_path, image_dir, str(tmp_path / "jax"), jbe, **kw)
    jax.effects_barrier()
    assert pd.process_dataset(json_path, image_dir, str(tmp_path / "torch"), tbe, **kw) == \
        {"processed": 3, "failed": 0}
    metas = _compare_driver_runs(str(tmp_path / "torch"), str(tmp_path / "jax"), 48, 40,
                                 str(tmp_path))
    assert all(m["api_model_name"] == "mini-llava" and "extract_layers" not in m
               for m in metas)


class _Failing:
    """A two-layer backend whose every extraction fails."""

    num_patches_side = 4
    image_size = 32
    extract_layer = (2, 0)

    def extract(self, images, questions, max_new_tokens=20):
        raise RuntimeError("injected extraction failure")


def test_driver_layer_fallback_and_mini_specs(rng):
    """The per-layer uniform fallback has JAX's shape (B, L, n, n); the
    mini spec clamps its layer and refuses a layer list, as JAX's."""
    views = rng.random((3, 32, 32, 3)).astype(np.float32)
    mt, tt = pd._extract_with_fallback(_Failing(), views, ["a", "b", "c"], 4)
    mj, tj = j_fallback(_Failing(), views, ["a", "b", "c"], 4)
    assert mt.shape == mj.shape == (3, 2, 4, 4) and tt == tj == ["", "", ""]
    np.testing.assert_array_equal(mt, mj)
    for make in (lambda s, i: pd.make_backend(s, i, "cpu"), j_make_backend):
        with pytest.raises(ValueError, match="extracts one layer"):
            make("mini", "2,0")
        with pytest.raises(ValueError, match="no int8 serving path"):
            make("mini+int8", 1)
    be = pd.make_backend("mini", "20", "cpu")
    assert isinstance(be, MiniLLaVABackend) and be.cfg.extract_layer == 3
    assert be.cfg == dataclasses.replace(MiniLLaVAConfig(), extract_layer=3)
    assert j_make_backend("mini", "20").cfg.extract_layer == 3


def test_driver_layer_list_through_make_backend(llava, tmp_path):
    """``--layer-index 2,0`` reaches a checkpoint's backend as a tuple."""
    LlavaBackend(llava[1], tokenizer=DryRunTokenizer()).save(tmp_path / "ckpt")
    be = pd.make_backend(f"llava-ckpt:{tmp_path / 'ckpt'}+kv8", "2,0", "cpu")
    assert be.extract_layer == (2, 0) and be.kv_quant
    maps, texts = be.extract([np.zeros((40, 30, 3), np.uint8)] * 2, ["q?", "a b"],
                             max_new_tokens=2)
    assert tuple(maps.shape) == (2, 2, 4, 4) and len(texts) == 2


# ── jax.image.resize's cubic weights ────────────────────────────────────

@pytest.mark.parametrize("n_in,n_out", [(24, 24), (24, 32), (24, 336), (24, 500),
                                        (24, 683), (24, 1024), (4, 32)])
def test_cubic_weights_match_jax(n_in, n_out, rng):
    """The port's per-axis cubic weights against ``jax.image.resize(...,
    "cubic")`` along that axis (an identity's rows are the weights), 1e-6;
    ``resize_cubic`` of a map against JAX's on both axes."""
    if n_in != n_out:
        ref = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_in, n_out),
                                          "cubic"))
        np.testing.assert_allclose(cubic_weight_matrix(n_in, n_out), ref, rtol=0, atol=1e-6)
    att = rng.random((n_in, n_in)).astype(np.float32)
    hw = (n_out, max(n_out - 7, 1))
    want = np.asarray(jax.image.resize(jnp.asarray(att), hw, "cubic"))
    np.testing.assert_allclose(resize_cubic(att, hw), want, rtol=0, atol=1e-5)


# ── the layer sweep ─────────────────────────────────────────────────────

def _sweep_samples(seed, size, n=2):
    rng = np.random.default_rng(seed)
    h, w = size
    return [{"image": (rng.random((h, w, 3)) * 255).astype(np.uint8),
             "question": q, "bbox": (w // 4, h // 5, w // 2, h // 3)}
            for q in ("what is written on the tag?", "read the code")[:n]]


def _compare_sweeps(t_dir, j_dir, st, sj):
    assert st.keys() == sj.keys()
    for k in sj:
        assert st[k]["top1"] == sj[k]["top1"] and st[k]["n"] == sj[k]["n"], k
        assert abs(st[k]["am_all"] - sj[k]["am_all"]) <= 1e-5, k
    rt = list(csv.DictReader(open(os.path.join(t_dir, "results.csv"))))
    rj = list(csv.DictReader(open(os.path.join(j_dir, "results.csv"))))
    assert len(rt) == len(rj) > 0
    for a, b in zip(rt, rj):
        assert a.keys() == b.keys()
        assert (a["sample"], a["layer"], a["type"], a["top1"]) == \
            (b["sample"], b["layer"], b["type"], b["top1"])
        assert abs(float(a["am_all"]) - float(b["am_all"])) <= 1e-5
    lt = open(os.path.join(t_dir, "summary.txt")).read().splitlines()
    lj = open(os.path.join(j_dir, "summary.txt")).read().splitlines()
    assert lt[0] == lj[0] and len(lt) == len(lj)
    for a, b in zip(lt[1:], lj[1:]):
        fa, fb = a.split(), b.split()
        assert len(a) == len(b) and fa[:3] + fa[4:] == fb[:3] + fb[4:]
        assert abs(float(fa[3]) - float(fb[3])) <= 1e-4


def test_layer_sweep_llava_matches_jax(llava, tmp_path):
    """One generate per prompt for all layers (the tuple path) on both
    sides: the summary's Top-1 equal and AM@all within 1e-5, the CSV rows
    and the summary text in JAX's format; no fallback."""
    jm, tm = llava
    jbe = JLlavaBackend(jm, tokenizer=build_dry_run_tokenizer(), extract_layer=1)
    tbe = LlavaBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=1)
    samples = _sweep_samples(3, (40, 60))
    calls = []
    inner = tbe.extract

    def counted(images, questions, max_new_tokens=20):
        calls.append((tbe.extract_layer, max_new_tokens))
        return inner(images, questions, max_new_tokens=max_new_tokens)
    tbe.extract = counted
    tsweep._extract_all_layers.fallbacks = 0
    sj = jsweep.layer_sweep(jbe, samples, layers=[2, 0, 1], out_dir=str(tmp_path / "j"))
    st = tsweep.layer_sweep(tbe, samples, layers=[2, 0, 1], out_dir=str(tmp_path / "t"))
    assert calls == [((2, 0, 1), 0)] * 4 and tsweep._extract_all_layers.fallbacks == 0
    assert tbe.extract_layer == 1
    _compare_sweeps(str(tmp_path / "t"), str(tmp_path / "j"), st, sj)
    assert all(0.0 <= v["am_all"] <= 1.0 and v["n"] == 2 for v in st.values())


def test_layer_sweep_mini_matches_jax(tmp_path):
    """The mini's layer comes from its frozen config, overridden a layer
    at a time (``_extract_at_layer``): the same summary, CSV and text as
    JAX's on JAX's weights."""
    jbe = JMini(JMiniCfg(**MINI), seed=0)
    tbe = MiniLLaVABackend(MiniLLaVAConfig(**MINI), device="cpu",
                           params=mini_from_jax(jax.device_get(jbe.params)))
    samples = _sweep_samples(4, (32, 32))
    sj = jsweep.layer_sweep(jbe, samples, layers=[2, 1], out_dir=str(tmp_path / "j"))
    st = tsweep.layer_sweep(tbe, samples, layers=[2, 1], out_dir=str(tmp_path / "t"))
    _compare_sweeps(str(tmp_path / "t"), str(tmp_path / "j"), st, sj)
    assert tbe.cfg.extract_layer == 1
    with pytest.raises(ValueError, match="out of range"):
        tsweep._extract_at_layer(tbe, samples[0]["image"][None], ["q"], 3)
    with pytest.raises(TypeError, match="per-layer"):
        tsweep._extract_at_layer(object(), None, ["q"], 0)


def test_layer_sweep_uses_prefill_only_cadence(rng):
    """The port's counterpart of the JAX test of the same name, on the
    port's own mini: ``_extract_at_layer`` equals ``extract(max_new_tokens=
    0)`` and differs from a prefill + decode average."""
    be = MiniLLaVABackend(MiniLLaVAConfig(**dict(MINI, n_layers=2)), seed=0, device="cpu")
    img = rng.random((1, 32, 32, 3)).astype(np.float32)
    got = tsweep._extract_at_layer(be, img, ["what is here?"], 1)
    want, _ = be.extract(img, ["what is here?"], max_new_tokens=0)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-6)
    with_decode, _ = be.extract(img, ["what is here?"], max_new_tokens=2)
    assert np.abs(got - with_decode.numpy()).max() > 1e-6


# ── copies and imports ──────────────────────────────────────────────────

def test_ablation_and_sweep_copies_match():
    for name in ("interpret_bbox", "top1", "am_all", "relative_attention_map"):
        assert inspect.getsource(getattr(tablation, name)) == \
            inspect.getsource(getattr(jablation, name)), name
    assert tablation.BBOX_METHODS == jablation.BBOX_METHODS
    assert tsweep.GENERIC_PROMPT == jsweep.GENERIC_PROMPT
    assert tsweep.DEFAULT_LAYERS == jsweep.DEFAULT_LAYERS
    assert tsweep._SWEEP_NEW_TOKENS == jsweep._SWEEP_NEW_TOKENS == 0


def test_new_modules_import_no_jax():
    """No port module of this slice, and not ``chip_smoke.py``, pulls
    ``jax`` or ``attwarp_tpu`` into ``sys.modules``."""
    mods = ["attwarp_tpu_torch.eval.layer_sweep", "attwarp_tpu_torch.eval.ablation",
            "attwarp_tpu_torch.extract.mini_llava", "attwarp_tpu_torch.extract.extraction",
            "attwarp_tpu_torch.extract.features", "attwarp_tpu_torch.cli.process_dataset",
            "attwarp_tpu_torch.cli.evaluate", "attwarp_tpu_torch.cli.warp",
            "attwarp_tpu_torch.cli.train", "chip_smoke"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'attwarp_tpu.'))"
            " or m == 'attwarp_tpu']\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env, timeout=300)
