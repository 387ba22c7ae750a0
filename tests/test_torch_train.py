"""The port's training system (``data/{manifests,loader}.py``,
``train/*``, ``cli/{train,warp}.py`` and the learned-warp chain tool)
against the JAX package, on the CPU.

Inputs come from a numpy seed. MarginalNet runs in f32 on both sides here
(flax ``compute_dtype=jnp.float32``) on weights carried across by
``params_from_jax``; the loss metrics and gradient norms agree within 1e-5
relative, the parameters after three AdamW steps as each test states.
"""

import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from attwarp_tpu.data import loader as jloader
from attwarp_tpu.data import manifests as jman
from attwarp_tpu.marginalnet.model import MarginalNet as JMarginalNet
from attwarp_tpu.train import config as jconfig
from attwarp_tpu.train import experiment as jexperiment
from attwarp_tpu.train import metrics as jmetrics
from attwarp_tpu.utils import profiling as jprofiling

from attwarp_tpu_torch.data import loader as tloader
from attwarp_tpu_torch.data import manifests as tman
from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID, MarginalNet, params_from_jax
from attwarp_tpu_torch.testing.reader import ReaderFeatureExtractor
from attwarp_tpu_torch.train import checkpoint as tckpt
from attwarp_tpu_torch.train import config as tconfig
from attwarp_tpu_torch.train import experiment as texperiment
from attwarp_tpu_torch.train import metrics as tmetrics
from attwarp_tpu_torch.train import train_step as tts
from attwarp_tpu_torch.train import trainer as ttrainer
from attwarp_tpu_torch.train import viz as tviz
from attwarp_tpu_torch.utils import profiling as tprofiling

# attwarp_tpu.train re-exports the function train_step over its module
jts = importlib.import_module("attwarp_tpu.train.train_step")
ROOT = Path(__file__).resolve().parents[1]


def _make_root(tmp_path, name, n, rng, with_bucket=False, overlay_every=0):
    """A FullDataset tree (logs/metadata.jsonl, images, npy attention);
    every ``overlay_every``-th sample lists only an overlay image."""
    root = tmp_path / name
    for d in ("logs", "npy", "images"):
        (root / d).mkdir(parents=True)
    with open(root / "logs" / "metadata.jsonl", "w") as f:
        for i in range(n):
            img_path = str(root / "images" / f"im{i}.png")
            Image.fromarray((rng.random((32, 40, 3)) * 255).astype(np.uint8)).save(img_path)
            npy_path = str(root / "npy" / f"att{i}.npy")
            np.save(npy_path, (rng.random((24, 24)) * 3).astype(np.float32))
            arts = [{"type": "relative", "layer": 16, "npy_path": npy_path},
                    {"type": "absolute", "layer": 20, "npy_path": npy_path}]
            if overlay_every and i % overlay_every == 0:
                ov = str(root / "images" / f"ov{i}.png")
                Image.fromarray((rng.random((24, 24)) * 255).astype(np.uint8)).save(ov)
                arts = [{"type": "relative", "layer": 16, "overlay_path": ov}]
            entry = {"question": f"what is item {i}?", "answer": f"a{i}",
                     "image_path": img_path, "question_id": f"{name}-{i}", "artifacts": arts}
            if with_bucket:
                entry["bucket"] = ["query_rel", "logical_attr", "choose_attr"][i % 3]
            f.write(json.dumps(entry) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def full_roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("roots")
    rng = np.random.default_rng(11)
    return [_make_root(tmp, "gqa", 8, rng, with_bucket=True, overlay_every=3),
            _make_root(tmp, "textvqa", 8, rng), _make_root(tmp, "docvqa", 8, rng)]


def _datasets(full_roots, image_size=48):
    kw = dict(num_samples_per_dataset=6, image_size=image_size, random_seed=13)
    return tman.FullDataset(*full_roots, **kw), jman.FullDataset(*full_roots, **kw)


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def _same_batch(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


# ── copies ──────────────────────────────────────────────────────────────

def test_train_config_copy_matches():
    assert dataclasses.asdict(tconfig.TrainConfig()) == dataclasses.asdict(jconfig.TrainConfig())
    kw = dict(hidden=64, batch_size=8, lr=1e-3, data_pipeline="thread")
    assert dataclasses.asdict(tconfig.TrainConfig(**kw)) == \
        dataclasses.asdict(jconfig.TrainConfig(**kw))


def test_experiment_and_metrics_copies_match(tmp_path, monkeypatch):
    """The same Experiment_N directories, snapshot config and metric lines
    (all but their wall-clock stamps), and the same stage summary."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    cfg = tconfig.TrainConfig(hidden=32)
    out = {}
    for tag, exp, met, prof in (("t", texperiment, tmetrics, tprofiling),
                                ("j", jexperiment, jmetrics, jprofiling)):
        root = tmp_path / tag
        (root / "Experiment_4").mkdir(parents=True)
        d = exp.create_experiment_run_dir(str(root), cfg)
        run = met.init_metrics(run_dir=d, project="p", entity=None, cfg={"lr": 0.1})
        run.log({"loss": 1.5, "name": "x", "skip": [1]}, step=3)
        run.finish()
        timer = prof.StageTimer(d / "stages.jsonl")
        with timer.stage("a"):
            pass
        timer.close()
        lines = [json.loads(x) for x in open(d / "metrics.jsonl")]
        snap = json.load(open(d / "run_snapshot.json"))
        out[tag] = (d.name, sorted(p.name for p in d.iterdir()), snap["config"],
                    [{k: v for k, v in x.items() if k != "_time"} for x in lines],
                    sorted(timer.summary()), run.summary)
    assert out["t"] == out["j"]
    assert out["t"][0] == "Experiment_5"


def test_manifests_copy_matches(full_roots, tmp_path):
    """FullDataset (npy and overlay artifacts, GQA buckets, resizes),
    MetadataDirDataset and MixedMetadataDataset give JAX's items; the
    transform routing and artifact selection are JAX's."""
    t, j = _datasets(full_roots)
    assert len(t) == len(j) == 18
    for i in range(len(t)):
        _same_item(t[i], j[i])
    t2, j2 = _datasets(full_roots, image_size=None)
    _same_item(t2[5], j2[5])
    assert tman.GQA_CATEGORY_TO_TRANSFORM == jman.GQA_CATEGORY_TO_TRANSFORM
    for ds, b in (("gqa", "query_rel"), ("GQA-x", "unknown"), ("textvqa", "query_rel"),
                  (None, None), ("gqa", "logical_attr")):
        m = tman.load_gqa_transform_map()
        assert tman.transform_for_sample(ds, b, m) == jman.transform_for_sample(ds, b, m)
    arts = [{"type": "relative", "layer": 4}, {"type": "Relative", "layer": 9},
            {"type": "absolute", "layer": 16}]
    for layer, typ in ((16, "relative"), (4, "relative"), (16, "absolute"), (1, "none")):
        assert tman.select_artifact(arts, layer, typ) == jman.select_artifact(arts, layer, typ)
    assert tman.select_artifact([], 1, "x") is None

    # a driver-style metadata directory: both datasets over it
    rng = np.random.default_rng(3)
    meta = tmp_path / "meta"
    meta.mkdir()
    for i in range(3):
        img = tmp_path / f"o{i}.png"
        Image.fromarray((rng.random((30, 30, 3)) * 255).astype(np.uint8)).save(img)
        mask = tmp_path / f"m{i}.npy"
        np.save(mask, (rng.random((30, 30)) * 255).astype(np.float32))
        warped = tmp_path / f"w{i}.png"
        Image.fromarray((rng.random((20, 20, 3)) * 255).astype(np.uint8)).save(warped)
        saved = {"original_image": str(img), "mota_mask_npy": str(mask)}
        if i:
            saved["warped_image_identity"] = str(warped)
        with open(meta / f"s{i}_metadata.json", "w") as f:
            json.dump({"sample_id": f"s{i}", "question": "q?", "answer": "a",
                       "answers": ["a", "b"], "saved_paths": saved}, f)
    for kw in ({"image_size": 16}, {}, {"attention_key": "raw"}):
        if kw.get("attention_key") == "raw":
            with pytest.raises(FileNotFoundError):
                tman.MetadataDirDataset(str(meta), **kw)[0]
            continue
        ta, ja = tman.MetadataDirDataset(str(meta), **kw), jman.MetadataDirDataset(str(meta), **kw)
        for i in range(3):
            _same_item(ta[i], ja[i])
    tm = tman.MixedMetadataDataset(str(meta), str(meta), 2, image_size=16, random_seed=1)
    jm = jman.MixedMetadataDataset(str(meta), str(meta), 2, image_size=16, random_seed=1)
    for i in range(4):
        _same_item(tm[i], jm[i])


# ── batching ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_jax_thread_iterator(full_roots, shuffle):
    """``collate`` and ``batch_iterator`` give JAX's thread iterator's
    batches; the DataLoader path (``"grain"``/``"auto"``) gives the same
    batches in the same order."""
    t, j = _datasets(full_roots)
    assert tloader.split_indices(18, 0.1, 13) == jloader.split_indices(18, 0.1, 13)
    idx = list(range(len(t)))
    for drop_last in (True, False):
        jb = list(jloader.batch_iterator(j, idx, 4, shuffle=shuffle, seed=5,
                                         drop_last=drop_last))
        tb = list(tloader.batch_iterator(t, idx, 4, shuffle=shuffle, seed=5,
                                         drop_last=drop_last))
        lb = list(tloader.make_batch_iterator(t, idx, 4, shuffle=shuffle, seed=5,
                                              drop_last=drop_last))
        assert len(jb) == len(tb) == len(lb) == (4 if drop_last else 5)
        for a, b, c in zip(tb, jb, lb):
            _same_batch(a, b)
            _same_batch(c, a)
    assert tb[0]["sqrt_mask"].dtype == np.float32
    with pytest.raises(ValueError, match="pipeline"):
        tloader.make_batch_iterator(t, idx, 4, pipeline="torch")


def test_loader_workers_give_the_same_batches(full_roots):
    """One spawned DataLoader worker reads the samples; the batches equal
    the in-process prefetcher's."""
    t, _ = _datasets(full_roots)
    idx = list(range(len(t)))
    a = list(tloader.make_batch_iterator(t, idx, 6, shuffle=True, seed=2, pipeline="thread"))
    b = list(tloader.make_batch_iterator(t, idx, 6, shuffle=True, seed=2, num_workers=1))
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        _same_batch(x, y)


# ── the train step ──────────────────────────────────────────────────────

def _batch(rng, B=4, img=48, hv=8, Dv=16, Lt=6, Dt=12):
    return {
        "image": rng.random((B, img, img, 3)).astype(np.float32),
        "attention_map": rng.random((B, img, img)).astype(np.float32),
        "sqrt_mask": np.array([1, 0, 1, 0], np.float32)[:B],
        "none_mask": np.array([0, 0, 0, 1], np.float32)[:B],
        "fmap_v": rng.random((B, hv, hv, Dv)).astype(np.float32),
        "ttok": rng.random((B, Lt, Dt)).astype(np.float32),
        "tmask": np.ones((B, Lt, 1), np.float32),
    }


def _states(b, kw):
    """The same f32 MarginalNet and fresh optimizers on both sides."""
    jcfg, tcfg = jconfig.TrainConfig(**kw), tconfig.TrainConfig(**kw)
    jm = JMarginalNet(hidden=jcfg.hidden, compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), b["fmap_v"], ATTENTION_GRID, b["ttok"],
                     b["tmask"])["params"]
    js = jts.TrainState(jnp.zeros((), jnp.int32), params, jts.make_optimizer(jcfg).init(params))
    tm = MarginalNet(b["fmap_v"].shape[-1], b["ttok"].shape[-1], jcfg.hidden,
                     compute_dtype=torch.float32)
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    return jm, js, jcfg, tts.TrainState(0, tm, tts.make_optimizer(tcfg, tm)), tcfg


@pytest.mark.parametrize("clip", [1e-2, 1.0], ids=["clipped", "unclipped"])
def test_train_steps_match_jax(rng, clip):
    """Three steps of forward, backward, global-norm clip and AdamW (lr
    1e-3, the uniform mix decaying from alpha0 0.5; grad_clip 1e-2, where
    the clip acts in every step, and 1.0, where it does not). Every metric,
    ``grad_norm`` and the per-module norms within 1e-5 relative of JAX's,
    and ``eval_step``'s metrics too.

    The parameters after three steps within 1e-5 (lr / 100), except each
    head's last bias: the softmax ignores a constant shift, so its gradient
    is rounding noise (~1e-9) on both sides, and Adam scales that noise's
    sign into steps of up to ~lr, differently in each package. The
    marginals the two trained nets predict still agree within 1e-5."""
    b = _batch(rng)
    kw = dict(hidden=32, lr=1e-3, watch_gradients=True, grad_clip=clip, alpha0=0.5,
              alpha_decay_steps=4)
    jm, js, jcfg, ts, tcfg = _states(b, kw)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    for _ in range(3):
        js, jmx = jts.train_step(js, jb, jm, jcfg)
        ts, tmx = tts.train_step(ts, tb, tcfg)
        assert jmx.keys() == tmx.keys() and len(tmx) == 6 + 9
        for k in jmx:
            np.testing.assert_allclose(float(tmx[k]), float(jmx[k]), rtol=1e-5, atol=1e-12,
                                       err_msg=k)
    assert (float(jmx["grad_norm"]) > clip) == (clip == 1e-2)
    assert float(tmx["alpha"]) == pytest.approx(0.5 * (1 - 2 / 4))
    assert ts.step == int(js.step) == 3
    ref = params_from_jax(jax.device_get(js.params))
    for name, p in ts.model.state_dict().items():
        if name.endswith("_conv2.bias"):
            continue
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)
    px, py = ts.model(tb["fmap_v"], ATTENTION_GRID, tb["ttok"], tb["tmask"])
    jpx, jpy = jm.apply({"params": js.params}, jb["fmap_v"], ATTENTION_GRID, jb["ttok"],
                        jb["tmask"])
    np.testing.assert_allclose(px.detach().numpy(), np.asarray(jpx), atol=1e-5)
    np.testing.assert_allclose(py.detach().numpy(), np.asarray(jpy), atol=1e-5)
    je, te = jts.eval_step(js, jb, jm, jcfg), tts.eval_step(ts, tb, tcfg)
    for k in je:
        np.testing.assert_allclose(float(te[k]), float(je[k]), rtol=1e-5, err_msg=k)


def test_train_step_descends_and_checkpoint_round_trips(rng, tmp_path):
    """The port's own seeded state (bf16 autocast): the loss falls over 12
    steps; a checkpoint restores step, model and optimizer bit for bit."""
    b = {k: torch.as_tensor(v) for k, v in _batch(rng).items()}
    cfg = tconfig.TrainConfig(hidden=32, lr=1e-3)
    model, state = tts.create_train_state(cfg, 3, b)
    assert model.compute_dtype == torch.bfloat16
    losses = [float(tts.train_step(state, b, cfg)[1]["loss/total"]) for _ in range(12)]
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    path = tckpt.save_checkpoint(tmp_path / "ck", 3, state, cfg)
    assert path.name == "marginal_net_epoch_3.pt"
    assert json.load(open(tmp_path / "ck" / "marginal_net_epoch_3.json"))["cfg"]["hidden"] == 32
    tckpt.save_checkpoint(tmp_path / "ck", 12, state)
    ep, found = tckpt.latest_checkpoint(tmp_path / "ck")
    assert ep == 12 and tckpt.latest_checkpoint(tmp_path / "none") is None
    _, fresh = tts.create_train_state(cfg, 4, b)
    restored = tckpt.restore_checkpoint(found, fresh)
    assert restored.step == 12
    for p, q in zip(restored.model.parameters(), state.model.parameters()):
        assert torch.equal(p, q)
    s1, s2 = restored.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    for k in s2:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(s1[k][name], s2[k][name])


# ── the training loop ───────────────────────────────────────────────────

def _loop_cfg(root, **kw):
    base = dict(hidden=16, batch_size=4, image_size=48, epochs=2, vis_every=2, log_every=1,
                experiments_root=str(root), seed=5)
    base.update(kw)
    return tconfig.TrainConfig(**base)


def test_train_loop_resumes_exactly(full_roots, tmp_path, monkeypatch):
    """Two epochs straight equal one epoch and then a resume for one more,
    bit for bit: the parameters, the optimizer state, the step and the
    logged losses (with the debug rounds in between; matplotlib's plots are
    off here, ``test_debug_round_*`` draws them)."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tviz._pyplot.cache_clear()
    ds, _ = _datasets(full_roots)
    feats = ReaderFeatureExtractor()
    straight = ttrainer.train_loop(_loop_cfg(tmp_path / "a"), ds, feats, device="cpu")
    first = ttrainer.train_loop(_loop_cfg(tmp_path / "b", epochs=1), ds, feats, device="cpu")
    resumed = ttrainer.train_loop(_loop_cfg(tmp_path / "b"), ds, feats,
                                  resume_from=str(first / "checkpoints"), device="cpu")
    a = torch.load(straight / "checkpoints" / "marginal_net_epoch_2.pt", weights_only=True)
    b = torch.load(resumed / "checkpoints" / "marginal_net_epoch_2.pt", weights_only=True)
    assert a["step"] == b["step"] == 8
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k, st in a["optimizer"]["state"].items():
        for name, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][k][name])

    def losses(d):
        return [x["loss/train_total"] for x in map(json.loads, open(d / "metrics.jsonl"))
                if "loss/train_total" in x]
    assert losses(straight)[4:] == losses(resumed) and len(losses(straight)) == 8
    assert sorted(p.name for p in (straight / "debug").glob("*.png")) == \
        [f"train_{s:06d}.png" for s in (2, 4, 6, 8)]
    assert len(list((straight / "debug_validation").glob("val_*.png"))) == 2
    assert {json.loads(x)["stage"] for x in open(straight / "stages.jsonl")} == \
        {"features", "train_step"}
    tviz._pyplot.cache_clear()


def test_debug_round_lets_a_warp_failure_end_the_run(full_roots, tmp_path, monkeypatch):
    """A debug round draws JAX's plots (grids, PDF and CDF overlays, the
    loss curve). It guards only its plots: a plot that fails is skipped,
    and without matplotlib every plot is, with one printed line; but a
    failing warp (K1, on the card) ends the run."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    ds, _ = _datasets(full_roots)
    feats = ReaderFeatureExtractor()
    tviz._pyplot.cache_clear()
    run = ttrainer.train_loop(_loop_cfg(tmp_path / "plots", epochs=1, vis_every=4), ds, feats,
                              device="cpu")
    for d, n in (("debug", 1), ("debug/pdfs", 4), ("debug/cdfs", 4), ("debug_validation", 1),
                 ("debug_validation/cdfs", 2), ("curves", 1)):   # 2 validation samples
        assert len(list((run / d).glob("*.png"))) == n, d

    monkeypatch.setattr(tviz, "_norm_pdf", lambda p: 1 / 0)
    run = ttrainer.train_loop(_loop_cfg(tmp_path / "pdf", epochs=1, vis_every=4), ds, feats,
                              device="cpu")
    assert not list((run / "debug" / "pdfs").glob("*.png"))
    assert len(list((run / "debug" / "cdfs").glob("*.png"))) == 4

    tviz._pyplot.cache_clear()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    run = ttrainer.train_loop(_loop_cfg(tmp_path / "ok", epochs=1, vis_every=4), ds, feats,
                              device="cpu")
    assert list((run / "debug").glob("train_*.png"))       # Pillow's grid still written
    assert not (run / "curves").exists() and not (run / "debug" / "cdfs").exists()
    tviz._pyplot.cache_clear()

    def broken(*a, **k):
        raise RuntimeError("K1 failed")
    monkeypatch.setattr(ttrainer, "warp_from_cdf", broken)
    with pytest.raises(RuntimeError, match="K1 failed"):
        ttrainer.train_loop(_loop_cfg(tmp_path / "bad", epochs=1), ds, feats, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    """Without a card, ``cuda`` raises and names ``--device cpu``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from attwarp_tpu_torch.cli import train as train_cli
    from attwarp_tpu_torch.tools import run_marginalnet_chain as chain

    with pytest.raises(RuntimeError, match="device cpu"):
        ttrainer.train_loop(_loop_cfg(tmp_path), dataset=[], feature_extractor=object())
    with pytest.raises(RuntimeError, match="device cpu"):
        train_cli.main(["--experiments-root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device cpu"):
        chain.main([str(tmp_path / "c")])


# ── the CLIs ────────────────────────────────────────────────────────────

def test_train_cli_on_a_llava_checkpoint(full_roots, tmp_path, monkeypatch):
    """``cli.train --cpu`` (the alias of ``--device cpu``) trains on frozen
    features of a tiny LLaVA checkpoint directory (``--mllm-backend llava
    --mllm-model <dir>``), through ``make_feature_extractor``."""
    from attwarp_tpu_torch.cli import train as train_cli
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.llava import LlavaModel, random_params
    from test_torch_llava import tiny_configs

    monkeypatch.setitem(sys.modules, "wandb", None)
    _, tcfg = tiny_configs()
    vocab = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>", "what", "is", "item"])}
    LlavaBackend(LlavaModel(tcfg, random_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                                                torch.float32)),
                 tokenizer=DryRunTokenizer(vocab=vocab)).save(tmp_path / "ckpt")
    gqa, tv, dv = full_roots
    assert train_cli.main([
        "--gqa-root-dir", gqa, "--textvqa-root-dir", tv, "--docvqa-root-dir", dv,
        "--num-per-ds", "4", "--image-size", "32", "--epochs", "1", "--batch-size", "4",
        "--hidden", "16", "--mllm-backend", "llava", "--mllm-model", str(tmp_path / "ckpt"),
        "--experiments-root", str(tmp_path / "exp"), "--vis-every", "100", "--cpu",
        "--log-every", "1",
        "--data-pipeline", "thread", "--watch-gradients"]) == 0
    run = tmp_path / "exp" / "Experiment_1"
    snap = json.load(open(run / "run_snapshot.json"))["config"]
    assert snap["cpu"] is True and snap["mllm_backend"] == "llava"
    logged = [json.loads(x) for x in open(run / "metrics.jsonl")]
    assert any("grad_norm/proj_v1" in x for x in logged)
    saved = torch.load(run / "checkpoints" / "marginal_net_epoch_1.pt", weights_only=True)
    assert saved["model"]["proj_v1.weight"].shape == (16, 32, 1, 1)   # CLIP width 32


def test_warp_cli_matches_jax(tmp_path, monkeypatch):
    """The same ``run_N`` directory and files as JAX's ``cli/warp.py`` on
    the same image and map: the warped image within 1 uint8 LSB, the
    original equal; a backend spec that does not load fails before anything
    is written, and the default mini and the reader answer on the warped
    image."""
    from attwarp_tpu.cli import warp as j_warp_cli

    from attwarp_tpu_torch.cli import warp as t_warp_cli

    monkeypatch.setenv("ATTWARP_COMPILE_CACHE_DIR", "0")
    rng = np.random.default_rng(4)
    img = tmp_path / "in.png"
    Image.fromarray((rng.random((60, 80, 3)) * 255).astype(np.uint8)).save(img)
    att = tmp_path / "att.npy"
    np.save(att, rng.random((24, 24)).astype(np.float32))
    common = ["--image", str(img), "--attention-map", str(att), "--width", "64",
              "--height", "48", "--transform", "sqrt", "--visualization", "vis.png"]
    assert j_warp_cli.main(common + ["--output-dir", str(tmp_path / "j")]) == 0
    assert t_warp_cli.main(common + ["--output-dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    jd, td = tmp_path / "j" / "run_0", tmp_path / "t" / "run_0"
    names = sorted(p.name for p in jd.iterdir())
    assert names == sorted(p.name for p in td.iterdir()) == \
        ["masked_overlay_image.png", "original_image.png", "vis.png", "warped.png"]
    for name in names:
        a = np.asarray(Image.open(td / name)).astype(int)
        b = np.asarray(Image.open(jd / name)).astype(int)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= (0 if name == "original_image.png" else 1), name
    with pytest.raises(ValueError, match="unknown"):
        t_warp_cli.main(common + ["--output-dir", str(tmp_path / "m"), "--device", "cpu",
                                  "--second-pass", "--question", "q?", "--backend", "nonsense"])
    assert not (tmp_path / "m").exists()
    assert t_warp_cli.main(common + ["--output-dir", str(tmp_path / "m"), "--device", "cpu",
                                     "--second-pass", "--question", "q?"]) == 0
    assert (tmp_path / "m" / "run_0" / "warped.png").exists()
    assert t_warp_cli.main(common + ["--output-dir", str(tmp_path / "t"), "--device", "cpu",
                                     "--second-pass", "--question", "q?",
                                     "--backend", "reader"]) == 0
    assert (tmp_path / "t" / "run_1" / "warped.png").exists()


def test_chain_tool_matches_jax_schema_and_oracle(tmp_path, monkeypatch):
    """Both chain tools at a tiny size (16 train and 8 eval scenes, 2 epochs
    of 4 at 128 px) on the CPU: the port writes the JAX tool's JSON keys
    (and its stage walls), and the oracle on the same eval set is JAX's."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setenv("ATTWARP_COMPILE_CACHE_DIR", "0")
    from attwarp_tpu_torch.tools import run_marginalnet_chain as chain

    tiny = ["--n-train", "16", "--n-eval", "8", "--epochs", "2", "--batch-size", "4",
            "--image-size", "128"]
    assert chain.main([str(tmp_path / "t"), "--device", "cpu", "--out-json",
                       str(tmp_path / "t.json")] + tiny) == 0
    res = subprocess.run(
        [sys.executable, "tools/run_marginalnet_chain.py", str(tmp_path / "j"), "--out-json",
         str(tmp_path / "j.json")] + tiny,
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu", "ATTWARP_COMPILE_CACHE_DIR": "0"})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    t, j = json.load(open(tmp_path / "t.json")), json.load(open(tmp_path / "j.json"))
    assert set(t) == set(j) | {"stage_seconds"}
    assert t["oracle_same_eval_set"] == j["oracle_same_eval_set"]
    assert t["total_samples_evaluated"] == j["total_samples_evaluated"] == 8
    assert [r["sample_id"] for r in t["detailed_results"]] == \
        [r["sample_id"] for r in j["detailed_results"]]
    assert set(t["stage_seconds"]) == {"scenes", "driver_train", "training", "prediction",
                                       "harness_learned", "driver_eval", "harness_oracle"}
