"""The mini test MLLM (``extract/mini_llava.py``), its backend and API
(``extract/extraction.py``) and ``MiniFeatureExtractor`` against the JAX
package, with JAX's weights carried across by ``params_from_jax``; and the
port's CLIs at JAX's default backend, ``mini``.

The port's own seeded mini draws its weights from a ``torch.Generator``
(JAX's from threefry), so only trees carried across are compared. f32 on
both sides: 1e-5, greedy tokens and texts equal, masks within 1 LSB.
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from attwarp_tpu.extract import extraction as jext
from attwarp_tpu.extract import features as jfeat
from attwarp_tpu.extract import mini_llava as jmini

from attwarp_tpu_torch.extract import extraction as text_
from attwarp_tpu_torch.extract import features as tfeat
from attwarp_tpu_torch.extract import mini_llava as tmini
from attwarp_tpu_torch.testing import reader as treader

from test_torch_train import full_roots  # noqa: F401  (module-scoped fixture)

SMALL = dict(vocab=256, d_model=32, n_heads=2, n_layers=3, extract_layer=1,
             num_patches=4, image_size=32, max_seq=96)
PROMPTS = ["USER: <image>\nwhat is the code on the tag? ASSISTANT:",
           "<image> read it", "no image here at all", "x <image> y z w"]


@pytest.fixture(scope="module")
def pair():
    """JAX's seeded mini and the port's on the same (JAX's) weights."""
    jbe = jext.MiniLLaVABackend(jmini.MiniLLaVAConfig(**SMALL), seed=0)
    tbe = text_.MiniLLaVABackend(tmini.MiniLLaVAConfig(**SMALL), device="cpu",
                                 params=tmini.params_from_jax(jax.device_get(jbe.params)))
    return jbe, tbe


def _images(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    return rng.random((n, size, size, 3)).astype(np.float32)


def test_config_and_tokenizer_copies_match():
    for kw in ({}, SMALL):
        assert dataclasses.asdict(tmini.MiniLLaVAConfig(**kw)) == \
            dataclasses.asdict(jmini.MiniLLaVAConfig(**kw))
    cfg = tmini.MiniLLaVAConfig()
    t, j = tmini.HashTokenizer(cfg), jmini.HashTokenizer(jmini.MiniLLaVAConfig())
    for p in PROMPTS:
        assert t.encode(p) == j.encode(p)
        assert t.decode(t.encode(p)) == j.decode(j.encode(p))
    assert t.decode([0, 1, 2, 4000, 17]) == j.decode([0, 1, 2, 4000, 17])


def test_init_params_tree_matches_jax_layout():
    """``init_params`` builds JAX's tree (names, shapes) with unit scales,
    zero biases and 0.02-scaled normals, from a ``torch.Generator``."""
    cfg = tmini.MiniLLaVAConfig(**SMALL)
    ref = jax.tree_util.tree_flatten_with_path(
        jmini.init_params(jmini.MiniLLaVAConfig(**SMALL), jax.random.PRNGKey(0)))[0]
    got = tmini.init_params(cfg, torch.Generator().manual_seed(0))
    flat = {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(got, is_leaf=torch.is_tensor)[0]}
    assert sorted(flat) == sorted(jax.tree_util.keystr(k) for k, _ in ref)
    for k, v in ref:
        assert tuple(flat[jax.tree_util.keystr(k)].shape) == v.shape
    assert torch.equal(got["ln_f"]["scale"], torch.ones(32))
    assert abs(float(got["tok_emb"].std()) - 0.02) < 2e-3
    again = tmini.init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["layers"][2]["w2"], got["layers"][2]["w2"])


def test_splice_prefill_and_decode_match_jax(pair):
    jbe, tbe = pair
    cfg_j, cfg_t = jbe.cfg, tbe.cfg
    imgs = _images(1)
    ids = np.asarray([[0, 0, 1, 17, -200, 30], [1, 40, 41, -200, 42, 43]], np.int64)
    np.testing.assert_allclose(
        tmini.encode_image(tbe.params, cfg_t, torch.as_tensor(imgs[0])).numpy(),
        np.asarray(jmini.encode_image(jbe.params, cfg_j, jnp.asarray(imgs[0]))), atol=1e-5)
    ej, mj, sj = jmini.build_spliced_embeds(jbe.params, cfg_j, ids, jnp.asarray(imgs))
    et, mt, st = tmini.build_spliced_embeds(tbe.params, cfg_t, ids, torch.as_tensor(imgs))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-6)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    lj, kvj, rj = jmini.prefill(jbe.params, cfg_j, ej, mj)
    lt, kvt, rt = tmini.prefill(tbe.params, cfg_t, et, mt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    T = et.shape[1]
    full = np.pad(np.asarray(mj), ((0, 0), (0, cfg_t.max_seq - T)))
    full[:, T] = True
    tok = np.array([7, 9])
    lj2, _, rj2 = jmini.decode_step(jbe.params, cfg_j, jnp.asarray(tok, jnp.int32), kvj, T,
                                    jnp.asarray(full))
    lt2, _, rt2 = tmini.decode_step(tbe.params, cfg_t, torch.as_tensor(tok), kvt, T,
                                    torch.as_tensor(full))
    np.testing.assert_allclose(lt2.numpy(), np.asarray(lj2), atol=1e-5)
    np.testing.assert_allclose(rt2.numpy(), np.asarray(rj2), atol=1e-5)


def test_generate_matches_jax_through_eos(pair):
    """Greedy tokens identical and maps within 1e-5, with the LM head's
    columns of EOS and of a token row 0 emits swapped (on both sides), so
    that a row reaches EOS mid-way and continues with EOS."""
    jbe, tbe = pair
    imgs = _images(2)
    ids = np.asarray([[0, 1, 17, -200, 30], [1, 40, -200, 42, 43]], np.int64)
    ej, mj, sj = jmini.build_spliced_embeds(jbe.params, jbe.cfg, ids, jnp.asarray(imgs))
    gj, _ = jmini.generate_with_attention(jbe.params, jbe.cfg, ej, mj, sj, max_new_tokens=6)
    x = int(np.asarray(gj)[0, 2])
    eos = jbe.cfg.eos_id
    head = np.array(jbe.params["lm_head"])
    head[:, [x, eos]] = head[:, [eos, x]]
    jp = dict(jbe.params, lm_head=jnp.asarray(head))
    tp = dict(tbe.params, lm_head=torch.as_tensor(head))
    gj, mapj = jmini.generate_with_attention(jp, jbe.cfg, ej, mj, sj, max_new_tokens=6)
    et, mt, st = tmini.build_spliced_embeds(tp, tbe.cfg, ids, torch.as_tensor(imgs))
    gt, mapt = tmini.generate_with_attention(tp, tbe.cfg, et, mt, st, max_new_tokens=6)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    row = gt[0].tolist()
    assert eos in row and all(t == eos for t in row[row.index(eos):])
    assert tuple(mapt.shape) == (2, 4, 4)
    np.testing.assert_allclose(mapt.numpy(), np.asarray(mapj), atol=1e-5)
    g0, m0 = tmini.generate_with_attention(tp, tbe.cfg, et, mt, st, max_new_tokens=0)
    assert tuple(g0.shape) == (2, 0)


def test_backend_extract_matches_jax(pair):
    jbe, tbe = pair
    qs = ["what is the code on the tag?", "read the sign"]
    for imgs in (_images(3), (_images(4) * 255).astype(np.uint8)):
        mj, tj = jbe.extract(imgs, qs, max_new_tokens=5)
        mt, tt = tbe.extract(imgs, qs, max_new_tokens=5)
        assert tt == tj
        assert isinstance(mt, torch.Tensor) and mt.device.type == "cpu"
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    mt, _ = tbe.extract(torch.as_tensor(_images(3)[0]), qs[:1], max_new_tokens=2)
    assert tuple(mt.shape) == (1, 4, 4)
    with pytest.raises(ValueError, match="prompt too long"):
        tbe.extract(_images(3), qs, max_new_tokens=80)
    maps, texts = text_.extract_attention(tbe, _images(3), qs, max_new_tokens=2)
    assert tuple(maps.shape) == (2, 4, 4) and len(texts) == 2


def test_llava_api_matches_jax(pair):
    """Overlays and masks within 1 LSB of JAX's ``llava_api`` on images of
    other sizes (resized to the mini's input), maps within 1e-5."""
    jbe, tbe = pair
    rng = np.random.default_rng(5)
    images = [(rng.random((40, 56, 3)) * 255).astype(np.uint8),
              rng.random((30, 30, 3)).astype(np.float32),
              (rng.random((32, 32, 3)) * 255).astype(np.uint8)]
    qs = ["what is here?", "read it", "the code?"]
    oj, aj, mj = jext.llava_api(images, qs, backend=jbe, batch_size=2, max_new_tokens=3)
    ot, at, mt = text_.llava_api(images, qs, backend=tbe, batch_size=2, max_new_tokens=3)
    assert len(ot) == len(at) == len(mt) == 3
    for a, b in zip(at, aj):
        assert a.shape == (1, 1, 4, 4)
        np.testing.assert_allclose(a, b, atol=1e-5)
    for a, b in zip(mt, mj):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for a, b in zip(ot, oj):
        assert a.shape == b.shape and np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_feature_extractor_matches_jax(pair):
    """``visual_tokens`` (images of another size, resized first) and
    ``text_tokens`` within 1e-5 of JAX's MiniFeatureExtractor."""
    jbe, tbe = pair
    jf, tf = jfeat.MiniFeatureExtractor(jbe), tfeat.MiniFeatureExtractor(tbe)
    imgs = _images(6, n=3, size=48)
    vj = np.asarray(jf.visual_tokens(jnp.asarray(imgs)))
    vt = tf.visual_tokens(imgs)
    assert tuple(vt.shape) == vj.shape == (3, 4, 4, 32)
    np.testing.assert_allclose(vt.numpy(), vj, atol=1e-5)
    np.testing.assert_allclose(tf.visual_tokens(torch.as_tensor(_images(7, size=32))).numpy(),
                               np.asarray(jf.visual_tokens(jnp.asarray(_images(7, size=32)))),
                               atol=1e-5)
    texts = ["what is the code on the tag?", "", " ".join(["w"] * 40)]
    for kw in ({}, {"max_len": 8}):
        ej, mj = jf.text_tokens(texts, **kw)
        et, mt = tf.text_tokens(texts, **kw)
        np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=1e-6)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def test_make_feature_extractor_builds_the_mini():
    from attwarp_tpu_torch.train.config import TrainConfig

    fx = tfeat.make_feature_extractor(TrainConfig(), "cpu")
    assert isinstance(fx, tfeat.MiniFeatureExtractor)
    assert fx.backend.device.type == "cpu" and fx.cfg == tmini.MiniLLaVAConfig()
    same = text_.MiniLLaVABackend(device="cpu", seed=0)
    assert torch.equal(fx.backend.params["tok_emb"], same.params["tok_emb"])
    assert not torch.equal(text_.MiniLLaVABackend(device="cpu", seed=1).params["tok_emb"],
                           same.params["tok_emb"])
    if not torch.cuda.is_available():      # no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            text_.MiniLLaVABackend()


# ── the CLIs at JAX's default backend ──────────────────────────────────

def test_dataset_and_evaluate_clis_default_to_mini(tmp_path, capsys):
    """``cli.process_dataset`` with no ``--backend`` and ``cli.evaluate``
    with no ``--model`` run the mini (on the CPU here), as JAX's do."""
    from attwarp_tpu_torch.cli import evaluate as ev
    from attwarp_tpu_torch.cli import process_dataset as pd

    json_path, image_dir = treader.write_textvqa_dataset(str(tmp_path / "data"), n=2, seed=6)
    out = tmp_path / "out"
    args = ["--textvqa-json", json_path, "--image-dir", image_dir, "--output-dir", str(out),
            "--batch-size", "2", "--width", "64", "--height", "64", "--max-new-tokens", "4"]
    assert pd.build_parser().parse_args(args).backend == "mini"
    assert pd.main(args + ["--device", "cpu"]) == 0
    assert "Done. processed=2 failed=0" in capsys.readouterr().out
    metas = [json.load(open(out / "metadata" / n)) for n in os.listdir(out / "metadata")]
    assert all(m["api_model_name"] == "mini-llava" for m in metas)
    assert np.load(metas[0]["saved_paths"]["raw_attention_map_npy"]).shape == (1, 1, 24, 24)
    ev_args = ["--metadata-dir", str(out / "metadata"), "--output-dir", str(tmp_path / "ev"),
               "--max-new-tokens", "4", "--score-original"]
    assert ev.build_parser().parse_args(ev_args).model == "mini"
    assert ev.main(ev_args + ["--device", "cpu"]) == 0
    assert "(2 samples)" in capsys.readouterr().out


def test_warp_cli_second_pass_defaults_to_mini(tmp_path, capsys):
    from attwarp_tpu_torch.cli import warp as warp_cli

    rng = np.random.default_rng(8)
    img = tmp_path / "in.png"
    Image.fromarray((rng.random((60, 80, 3)) * 255).astype(np.uint8)).save(img)
    att = tmp_path / "att.npy"
    np.save(att, rng.random((24, 24)).astype(np.float32))
    args = ["--image", str(img), "--attention-map", str(att), "--width", "64", "--height", "48",
            "--output-dir", str(tmp_path / "runs"), "--second-pass", "--question", "q?",
            "--max-new-tokens", "3"]
    assert warp_cli.build_parser().parse_args(args).backend == "mini"
    assert warp_cli.main(args + ["--device", "cpu"]) == 0
    assert "Warped image output:" in capsys.readouterr().out


def test_train_cli_defaults_to_mini(full_roots, tmp_path, monkeypatch):  # noqa: F811
    """``cli.train --cpu`` with no ``--mllm-backend`` trains on the mini's
    frozen features (``TrainConfig().mllm_backend``), as JAX's does."""
    from attwarp_tpu_torch.cli import train as train_cli

    monkeypatch.setitem(sys.modules, "wandb", None)
    gqa, tv, dv = full_roots
    assert train_cli.main([
        "--gqa-root-dir", gqa, "--textvqa-root-dir", tv, "--docvqa-root-dir", dv,
        "--num-per-ds", "4", "--image-size", "32", "--epochs", "1", "--batch-size", "4",
        "--hidden", "16", "--experiments-root", str(tmp_path / "exp"), "--vis-every", "100",
        "--cpu", "--data-pipeline", "thread"]) == 0
    run = tmp_path / "exp" / "Experiment_1"
    snap = json.load(open(run / "run_snapshot.json"))["config"]
    assert snap["mllm_backend"] == "mini"
    saved = torch.load(run / "checkpoints" / "marginal_net_epoch_1.pt", weights_only=True)
    assert saved["model"]["proj_v1.weight"].shape[1] == 128   # the mini's width
