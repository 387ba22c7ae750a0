"""Loading HF checkpoints into the port (``port_hf_llava_weights``,
``port_hf_qwen2vl_weights``, both backends' ``config_from_hf`` and
``from_hf``, the ``llava:``/``qwen2vl:`` specs, ``make_feature_extractor``)
against the JAX package and against transformers, on the CPU.

Tiny random-config HF models (the parity tests' geometry) are written by
``save_pretrained`` into ``tmp_path``: a local HF checkpoint, nothing is
downloaded. The port's trees must equal ``params_from_jax`` of JAX's on
the same directory, and its last-token logits HF's own forward (f32,
eager attention) within the parity tests' bars (LLaVA atol 2e-4 / rtol
1e-3, ``tests/test_llava_parity.py``; Qwen2-VL atol 3e-4 / rtol 1e-3,
``tests/test_qwen2vl_parity.py``).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from attwarp_tpu_torch.models.llava import params_from_jax
from attwarp_tpu_torch.numerics.quant import is_quantized

IMG = 99
Q_IMG, Q_VSTART = 97, 96
BARS = {"llava": dict(atol=2e-4, rtol=1e-3), "qwen2vl": dict(atol=3e-4, rtol=1e-3)}


def _hf_llava():
    from transformers import CLIPVisionConfig, LlamaConfig, LlavaConfig, LlavaForConditionalGeneration

    torch.manual_seed(0)
    return LlavaForConditionalGeneration(LlavaConfig(
        vision_config=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                       num_attention_heads=2, image_size=28, patch_size=14,
                                       projection_dim=32),
        text_config=LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96,
                                num_hidden_layers=3, num_attention_heads=4,
                                num_key_value_heads=2, max_position_embeddings=256,
                                rms_norm_eps=1e-5),
        image_token_index=IMG, vision_feature_layer=-2,
        vision_feature_select_strategy="default")).eval()


def _hf_qwen(layers=2):
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    torch.manual_seed(0)
    return Qwen2VLForConditionalGeneration(Qwen2VLConfig(
        text_config=dict(vocab_size=128, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=layers, num_attention_heads=4, num_key_value_heads=2,
                         rms_norm_eps=1e-6, rope_theta=10000.0,
                         rope_scaling={"type": "mrope", "mrope_section": [2, 2, 2]},
                         max_position_embeddings=512),
        vision_config=dict(depth=2, embed_dim=32, hidden_size=48, num_heads=2, in_channels=3,
                           patch_size=14, spatial_merge_size=2, temporal_patch_size=2,
                           mlp_ratio=2, hidden_act="quick_gelu"),
        image_token_id=Q_IMG, video_token_id=98, vision_start_token_id=Q_VSTART)).eval()


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """family -> (HF model in eval mode, eager attention; its
    ``save_pretrained`` directory)."""
    out = {}
    for family, make in (("llava", _hf_llava), ("qwen2vl", _hf_qwen)):
        hf = make()
        d = tmp_path_factory.mktemp(family)
        hf.save_pretrained(str(d))
        hf.config._attn_implementation = "eager"
        out[family] = (hf, d)
    return out


def _backends(family):
    from attwarp_tpu.extract.llava_backend import LlavaBackend as JL
    from attwarp_tpu.extract.qwen2vl_backend import Qwen2VLBackend as JQ
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend

    return (JL, LlavaBackend) if family == "llava" else (JQ, Qwen2VLBackend)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_keys(v) for v in tree]
    return None


def _equal_trees(a, b):
    assert _keys(a) == _keys(b)
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _jax_params(jmodel):
    return params_from_jax(jax.device_get(jmodel.params))


# ── configs and weights ─────────────────────────────────────────────────


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_config_from_hf_matches_jax(hf_dirs, family):
    hf, _ = hf_dirs[family]
    J, T = _backends(family)
    assert dataclasses.asdict(T.config_from_hf(hf.config)) == \
        dataclasses.asdict(J.config_from_hf(hf.config))


def test_config_from_hf_reads_transformers_5_fields(hf_dirs):
    """transformers 5.x keeps rope_theta and mrope_section in
    ``rope_parameters`` and LLaVA's image token as ``image_token_id``."""
    from types import SimpleNamespace

    from attwarp_tpu_torch.extract.hf import rope_field, scalar_id

    t = SimpleNamespace(rope_parameters={"rope_type": "default", "rope_theta": 5e5,
                                         "mrope_section": [4, 6, 6]})
    assert rope_field(t, "rope_theta", 1.0) == 5e5
    assert rope_field(t, "mrope_section", None) == [4, 6, 6]
    assert rope_field(SimpleNamespace(rope_theta=7.0), "rope_theta", 1.0) == 7.0
    assert rope_field(SimpleNamespace(), "rope_theta", 1.0) == 1.0
    assert scalar_id([2, 32000], 0) == 2 and scalar_id(None, 5) == 5 and scalar_id(0, 5) == 0
    hf, _ = hf_dirs["llava"]
    _, T = _backends("llava")
    cfg = T.config_from_hf(hf.config)
    assert cfg.image_token_index == IMG and cfg.text.rope_theta == 10000.0


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_port_hf_weights_match_jax(hf_dirs, family):
    """The state dict straight into the port's tree equals
    ``params_from_jax`` of JAX's port of it."""
    from attwarp_tpu.models.llava import port_hf_llava_weights as j_llava
    from attwarp_tpu.models.qwen2vl import port_hf_qwen2vl_weights as j_qwen
    from attwarp_tpu_torch.models.llava import port_hf_llava_weights
    from attwarp_tpu_torch.models.qwen2vl import port_hf_qwen2vl_weights

    hf, _ = hf_dirs[family]
    J, T = _backends(family)
    cfg = T.config_from_hf(hf.config)
    jport, tport = (j_llava, port_hf_llava_weights) if family == "llava" else \
        (j_qwen, port_hf_qwen2vl_weights)
    ref = params_from_jax(jax.device_get(jport(hf.state_dict(), J.config_from_hf(hf.config))))
    _equal_trees(tport(hf.state_dict(), cfg, device="cpu"), ref)


def _old_layout(key, family):
    """A post-4.52 key in the pre-4.52 layout."""
    if family == "llava":
        for new, old in (("model.language_model.", "language_model.model."),
                         ("model.vision_tower.", "vision_tower."),
                         ("model.multi_modal_projector.", "multi_modal_projector."),
                         ("lm_head.", "language_model.lm_head.")):
            if key.startswith(new):
                return old + key[len(new):]
        return key
    for new, old in (("model.visual.", "visual."), ("model.language_model.", "model.")):
        if key.startswith(new):
            return old + key[len(new):]
    return key


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_port_hf_weights_take_both_key_layouts(hf_dirs, family):
    from attwarp_tpu_torch.models.llava import port_hf_llava_weights
    from attwarp_tpu_torch.models.qwen2vl import port_hf_qwen2vl_weights

    hf, _ = hf_dirs[family]
    _, T = _backends(family)
    cfg = T.config_from_hf(hf.config)
    port = port_hf_llava_weights if family == "llava" else port_hf_qwen2vl_weights
    sd = hf.state_dict()
    old = {_old_layout(k, family): v for k, v in sd.items()}
    assert set(old) != set(sd)
    _equal_trees(port(old, cfg), port(sd, cfg))


def test_patch_conv_reordered_as_unfold(hf_dirs):
    """LLaVA's patch conv (hidden, 3, P, P) becomes (hidden, P*P*3): the
    conv of a patch equals the matmul of its (P, P, 3) unfold."""
    from attwarp_tpu_torch.models.llava import port_hf_llava_weights

    hf, _ = hf_dirs["llava"]
    _, T = _backends("llava")
    params = port_hf_llava_weights(hf.state_dict(), T.config_from_hf(hf.config))
    conv = hf.state_dict()[next(k for k in hf.state_dict() if "patch_embedding" in k)]
    patch = torch.randn(1, 3, 14, 14, generator=torch.Generator().manual_seed(0))
    ref = torch.nn.functional.conv2d(patch, conv, stride=14).reshape(-1)
    got = params["vision"]["patch_weight"] @ patch[0].permute(1, 2, 0).reshape(-1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


# ── from_hf ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_from_hf_matches_jax_from_hf(hf_dirs, family):
    _, d = hf_dirs[family]
    J, T = _backends(family)
    jb, tb = J.from_hf(str(d), extract_layer=1), T.from_hf(str(d), "cpu", extract_layer=1)
    assert dataclasses.asdict(tb.model.cfg) == dataclasses.asdict(jb.model.cfg)
    _equal_trees(tb.model.params, _jax_params(jb.model))
    assert tb.extract_layer == 1 and tb.device == torch.device("cpu")
    assert tb.tokenizer is None and jb.tokenizer is None    # no processor saved


def test_from_hf_bf16_reads_the_state_dict_directly(hf_dirs):
    """``dtype=bfloat16``: every leaf is HF's own bf16 tensor (no f32 numpy
    round trip)."""
    from attwarp_tpu_torch.models.llava import port_hf_llava_weights

    hf, d = hf_dirs["llava"]
    _, T = _backends("llava")
    be = T.from_hf(str(d), "cpu", dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in _leaves(be.model.params))
    sd16 = {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()}
    _equal_trees(be.model.params, port_hf_llava_weights(sd16, be.model.cfg,
                                                        dtype=torch.bfloat16))


def test_from_hf_defaults_to_cuda_and_never_the_cpu(hf_dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, T = _backends("llava")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.from_hf(str(hf_dirs["llava"][1]))


def _llava_inputs(rng, B=2, n_txt=7):
    pixels = rng.standard_normal((B, 3, 28, 28)).astype(np.float32)
    ids = rng.integers(3, 90, size=(B, 4 + n_txt)).astype(np.int64)
    ids[:, 1:5] = IMG
    return ids, pixels


@pytest.mark.parametrize("padded", [False, True], ids=["full", "left-padded"])
def test_llava_from_hf_logits_match_hf(hf_dirs, rng, padded):
    hf, d = hf_dirs["llava"]
    _, T = _backends("llava")
    model = T.from_hf(str(d), "cpu").model
    ids, pixels = _llava_inputs(rng)
    mask = np.ones_like(ids)
    if padded:
        ids = np.concatenate([np.zeros((2, 3), np.int64), ids], axis=1)
        mask = np.ones_like(ids)
        mask[1, :3] = 0
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), pixel_values=torch.from_numpy(pixels),
                 attention_mask=torch.from_numpy(mask)).logits[:, -1]
        got, _ = model.forward_logits(torch.from_numpy(ids),
                                      torch.from_numpy(pixels).permute(0, 2, 3, 1),
                                      torch.from_numpy(mask).bool())
    torch.testing.assert_close(got, ref, **BARS["llava"])


def test_qwen_from_hf_logits_match_hf(hf_dirs, rng):
    from attwarp_tpu_torch.models.qwen2vl import patchify_image

    hf, d = hf_dirs["qwen2vl"]
    _, T = _backends("qwen2vl")
    model = T.from_hf(str(d), "cpu", extract_layer=1).model
    patches, grid = patchify_image(rng.random((56, 56, 3)).astype(np.float32),
                                   model.cfg.vision)
    ids = rng.integers(3, 90, size=(2, 14)).astype(np.int64)
    ids[:, 2] = Q_VSTART
    ids[:, 3:7] = Q_IMG
    mask = np.ones_like(ids)
    with torch.no_grad():
        ref = hf(input_ids=torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
                 pixel_values=torch.from_numpy(np.concatenate([patches, patches])),
                 image_grid_thw=torch.tensor([list(grid)] * 2)).logits[:, -1]
        got, _ = model.forward_logits(torch.from_numpy(ids),
                                      torch.from_numpy(np.stack([patches, patches])), grid,
                                      torch.from_numpy(mask).bool())
    torch.testing.assert_close(got, ref, **BARS["qwen2vl"])


# ── specs, feature extractors, the 7B checkpoint tool ───────────────────


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
@pytest.mark.parametrize("suffixes", ["", "+int8+kv8+flash", "+lm8+int8"])
def test_hf_specs_match_jax_make_backend(hf_dirs, family, suffixes):
    """``llava:<dir>``/``qwen2vl:<dir>`` with the int8 suffixes load the
    tree JAX's ``make_backend`` loads from the same directory."""
    from attwarp_tpu.cli.process_dataset import make_backend as j_make
    from attwarp_tpu_torch.cli.process_dataset import make_backend

    _, d = hf_dirs[family]
    spec = f"{family}:{d}{suffixes}"
    jb, tb = j_make(spec, 1), make_backend(spec, 1, "cpu")
    _equal_trees(tb.model.params, _jax_params(jb.model))
    text = tb.model.params["llama" if family == "llava" else "text"]
    assert is_quantized(text["layers"][0]["q_proj"]) == ("int8" in suffixes)
    assert tb.kv_quant == jb.kv_quant and tb.use_flash == jb.use_flash


@pytest.mark.parametrize("family", ["llava", "qwen2vl"])
def test_make_feature_extractor_from_hf(hf_dirs, family, rng, tmp_path):
    """``mllm_backend`` llava/qwen2vl read ``mllm_model`` through
    ``from_hf`` as JAX does (same visual tokens), and still read a port
    checkpoint directory. (Both backends check their default extract layer
    20, so the Qwen2-VL decoder here has 21 layers.)"""
    from attwarp_tpu.extract.features import make_feature_extractor as j_make
    from attwarp_tpu.train.config import TrainConfig as JConfig
    from attwarp_tpu_torch.extract.features import make_feature_extractor
    from attwarp_tpu_torch.train.config import TrainConfig

    _, d = hf_dirs[family]
    if family == "qwen2vl":
        d = tmp_path / "hf21"
        _hf_qwen(layers=21).save_pretrained(str(d))
    images = rng.random((2, 56, 56, 3)).astype(np.float32)
    tf = make_feature_extractor(TrainConfig(mllm_backend=family, mllm_model=str(d)), "cpu")
    jf = j_make(JConfig(mllm_backend=family, mllm_model=str(d)))
    ref = np.asarray(jf.visual_tokens(jax.numpy.asarray(images)))
    got = tf.visual_tokens(images)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    tf.backend.save(tmp_path / "ckpt")
    again = make_feature_extractor(
        TrainConfig(mllm_backend=family, mllm_model=str(tmp_path / "ckpt")), "cpu")
    torch.testing.assert_close(again.visual_tokens(images), got, rtol=0, atol=0)


def test_make_random_7b_ckpt_tool(monkeypatch, tmp_path):
    """The tool's ``main`` at a tiny geometry writes a directory that
    ``llava-ckpt:<dir>+int8`` loads, with its dry-run tokenizer."""
    from attwarp_tpu_torch.cli.process_dataset import make_backend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig
    from attwarp_tpu_torch.tools import make_random_7b_ckpt as tool

    assert tool.llava_7b_config().text.vocab_size == 32064
    tiny = LlavaConfig(
        vision=ClipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                                num_attention_heads=2, image_size=28, patch_size=14),
        text=LlamaConfig(vocab_size=128, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4),
        image_token_index=IMG)
    monkeypatch.setattr(tool, "llava_7b_config", lambda: tiny)
    assert tool.main(["--out", str(tmp_path / "c"), "--device", "cpu", "--seed", "3"]) == 0
    be = make_backend(f"llava-ckpt:{tmp_path / 'c'}+int8", 1, "cpu")
    assert be.model.cfg == tiny and isinstance(be.tokenizer, DryRunTokenizer)
    assert is_quantized(be.model.params["llama"]["layers"][1]["gate_proj"])
    assert be.model.params["llama"]["embed_tokens"].dtype == torch.bfloat16
    maps, texts = be.extract(np.zeros((1, 28, 28, 3), np.uint8), ["what is the code?"],
                             max_new_tokens=2)
    assert maps.shape == (1, 2, 2) and len(texts) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--out", str(tmp_path / "d")])


def test_hf_loading_imports_no_jax_and_transformers_lazily():
    code = ("import sys, attwarp_tpu_torch.extract.hf, attwarp_tpu_torch.cli.process_dataset, "
            "attwarp_tpu_torch.tools.make_random_7b_ckpt, attwarp_tpu_torch.extract.features; "
            "assert 'jax' not in sys.modules and 'attwarp_tpu' not in sys.modules; "
            "assert 'transformers' not in sys.modules, 'transformers imported'")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stderr
