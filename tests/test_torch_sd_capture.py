"""The SD-warp ablation's diffusion capture (``attwarp_tpu_torch.warp.
sd_capture``) against the JAX package's, on the JAX tests' stub pipeline
(``tests/test_sd_capture.py``), and the port's stub pipeline at SD 2.1's
cross-attention geometry (``attwarp_tpu_torch/testing/sd_stub.py``).

diffusers and the SD weights are on neither machine, so the pipeline is
duck-typed, as in the JAX package's own tests. Latents within 1e-5 (cv2's
cubic as f32 matmuls in another order), the inversion within rtol 1e-5 of
the reference's formula, warps within 1e-3 on [0, 1] images.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from attwarp_tpu.warp import sd_capture as jsd
from attwarp_tpu.warp.cross_attention import run_cross_attention_warp as j_run

from attwarp_tpu_torch.testing import sd_stub
from attwarp_tpu_torch.warp import sd_capture as tsd
from attwarp_tpu_torch.warp.cross_attention import run_cross_attention_warp

from test_sd_capture import _Sched, _StubPipe


def _source(pipe, module=tsd, **kw):
    """A source over the JAX tests' stub, whose ``__call__`` records through
    ``pipe.recorder``: point it at the one the source installed."""
    if module is tsd:
        kw.setdefault("device", "cpu")
    src = module.DiffusionAttnSource(pipe, **kw)
    pipe.recorder = src.recorder
    return src


def test_ddim_inversion_recurrence_matches_reference_formula():
    """The fold reproduces the reference's per-step algebra, timestep
    clamping included, and JAX's ``invert``."""
    src = _source(_StubPipe(), timesteps=(1200, 800, 400))  # 1200 clamps to 999
    z0 = np.full((1, 4, 2, 2), 0.5, np.float32)
    emb = np.zeros((1, 7, 16), np.float32)
    inv = src.invert(z0, emb)
    assert list(inv.keys()) == [800, 400]
    j_inv = _source(_StubPipe(), module=jsd, timesteps=(1200, 800, 400)).invert(z0, emb)
    ac = _Sched.alphas_cumprod
    z = z0
    for prev_t, t in [(999, 800), (800, 400)]:
        eps = 0.1 * z + 0.001 * prev_t
        a_prev, a = float(ac[prev_t]), float(ac[t])
        z = np.sqrt(a) * (z - np.sqrt(1 - a_prev) * eps) / np.sqrt(a_prev) + np.sqrt(1 - a) * eps
        np.testing.assert_allclose(inv[t], z, rtol=1e-5)
        np.testing.assert_array_equal(inv[t], j_inv[t])
    # the recurrence on tensors gives the same numbers
    t_inv = src.invert(torch.as_tensor(z0), torch.as_tensor(emb))
    for t in inv:
        np.testing.assert_allclose(t_inv[t].numpy(), inv[t], rtol=1e-6)


def test_image_latent_matches_jax():
    """uint8 input to [0, 1], cv2's cubic to the latent size, the VAE's
    scaling factor: within 1e-5 of JAX's latent."""
    src = _source(_StubPipe(), latent_size=64)
    rng = np.random.default_rng(0)
    img = (rng.random((100, 120, 3)) * 255).astype(np.uint8)
    z = np.asarray(src.image_latent(img))
    assert z.shape == (1, 4, 8, 8)
    assert np.abs(z).max() < 1.0
    ref = np.asarray(_source(_StubPipe(), module=jsd, latent_size=64).image_latent(img))
    np.testing.assert_allclose(z, ref, atol=1e-5)
    f01 = img.astype(np.float32) / 255.0          # a [0, 1] float image: no rescale
    np.testing.assert_allclose(np.asarray(src.image_latent(f01)), z, atol=1e-6)


def test_recorder_convention_and_square_inference():
    rec = tsd.CrossAttnRecorder()
    rec.timestep = 400
    probs = np.random.default_rng(0).random((1, 2, 16, 5)).astype(np.float32)
    rec.record("k", probs)
    assert isinstance(rec.maps[400]["k"], torch.Tensor)
    assert tuple(rec.maps[400]["k"].shape) == (1, 2, 4, 4, 5)
    with pytest.raises(ValueError, match="non-square"):
        rec.record("bad", probs[:, :, :15, :])
    rec.record("rect", torch.as_tensor(probs[:, :, :15, :]).requires_grad_(), spatial=(3, 5))
    kept = rec.maps[400]["rect"]
    assert tuple(kept.shape) == (1, 2, 3, 5, 5) and not kept.requires_grad
    assert kept.dtype == torch.float32
    n = rec.install(_StubPipe(rec))
    assert n == 1  # only the attn2 processor wrapped


def test_recording_processor_prepares_raw_mask():
    """A raw (B, T) mask goes through ``prepare_attention_mask`` before
    ``get_attention_scores``, as diffusers' default processor does."""
    seen = {}

    class _Attn:
        heads = 2

        def to_q(self, h):
            return h

        def to_k(self, h):
            return h

        def head_to_batch_dim(self, x):
            B, T, D = x.shape
            return np.repeat(x, self.heads, axis=0).reshape(B * self.heads, T, D)

        def prepare_attention_mask(self, mask, target_length, batch_size):
            seen["prepared"] = (mask.shape, target_length, batch_size)
            return np.zeros((batch_size * self.heads, 1, target_length), np.float32)

        def get_attention_scores(self, q, k, mask):
            seen["mask_shape"] = None if mask is None else mask.shape
            return np.full((q.shape[0], q.shape[1], k.shape[1]), 1.0 / k.shape[1], np.float32)

    rec = tsd.CrossAttnRecorder()
    proc = tsd._RecordingProcessor(rec, "x.attn2", lambda *a, **k: "inner")
    out = proc(_Attn(), np.zeros((1, 4, 8), np.float32),
               encoder_hidden_states=np.zeros((1, 5, 8), np.float32),
               attention_mask=np.ones((1, 5), np.float32))
    assert out == "inner"
    assert seen["prepared"] == ((1, 5), 5, 1)
    assert seen["mask_shape"] == (2, 1, 5)
    assert tuple(rec.maps[0]["x.attn2"].shape) == (1, 2, 2, 2, 5)


def test_capture_fn_end_to_end_with_stub_and_warp():
    """``make_sd_capture_fn`` drives encode -> inversion -> forward capture,
    and the capture feeds ``run_cross_attention_warp``: its iterates within
    1e-3 and its map within 1e-5 of JAX's on the same captured maps."""
    pipe = _StubPipe()
    fn = tsd.make_sd_capture_fn(pipe=pipe, timesteps=(999, 700, 300), num_inference_steps=3,
                                device="cpu")
    pipe.recorder = [p for p in pipe._procs.values() if hasattr(p, "recorder")][0].recorder

    rng = np.random.default_rng(1)
    img = rng.random((64, 64, 3)).astype(np.float32)
    captured = fn(img, "a red square")
    assert set(captured.keys()) == {700, 300}
    for layers in captured.values():
        assert set(layers) == {"layer_a", "layer_b"}
        assert layers["layer_a"].ndim == 5

    outs, att = run_cross_attention_warp(img, "a red square", capture_fn=fn, top_k=3,
                                         iterations=1, width=48, height=48, device="cpu")
    assert tuple(outs[-1].shape) == (48, 48, 3)
    assert tuple(att.shape) == (64, 64)
    assert torch.isfinite(outs[-1]).all()
    fixed = {t: {k: v.numpy() for k, v in d.items()} for t, d in captured.items()}
    got, got_att = run_cross_attention_warp(img, "", lambda im, p: fixed, top_k=3, width=48,
                                            height=48, device="cpu")
    ref, ref_att = j_run(img, "", lambda im, p: fixed, top_k=3, width=48, height=48)
    np.testing.assert_allclose(got_att.numpy(), ref_att, atol=1e-5)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(ref[-1]), atol=1e-3)


def test_sd21_stub_geometry():
    """16 attn2 layers a UNet evaluation, named as diffusers names them:
    5 at the latent's grid with 5 heads, 5 at half with 10, 5 at a quarter
    with 20, 1 at an eighth with 20; each 64 wide."""
    layers = sd_stub.attn2_layers()
    assert len(layers) == 16 and len({n for n, *_ in layers}) == 16
    by_level = {}
    for name, level, ch, heads in layers:
        assert "attn2" in name and ch == heads * sd_stub.HEAD_DIM
        by_level.setdefault(level, set()).add((ch, heads))
    counts = [sum(1 for _, lv, _, _ in layers if lv == level) for level in range(4)]
    assert counts == [5, 5, 5, 1]
    assert by_level == {0: {(320, 5)}, 1: {(640, 10)}, 2: {(1280, 20)}, 3: {(1280, 20)}}
    assert sorted(n for n, *_ in layers)[-1].startswith("up_blocks.3.attentions.2")


def test_sd21_stub_capture_and_warp_on_the_cpu():
    """The port's capture through its stub pipeline at SD 2.1's geometry
    (a 128 px latent image, 2 denoise steps): every attn2 layer recorded by
    the port's processor for each inversion snapshot, batch 2 (negative
    prompt and prompt), 77 tokens, softmax rows; the warp finite and in the
    image's range."""
    pipe = sd_stub.SD21StubPipeline(device="cpu", seed=0)
    src = tsd.DiffusionAttnSource(pipe, latent_size=128, num_inference_steps=2, device="cpu")
    img = (np.random.default_rng(2).random((90, 120, 3)) * 255).astype(np.uint8)
    cap = src.capture(img, "a red square on the table")
    assert sorted(cap) == [200, 400, 600, 800]
    for layers in cap.values():
        assert len(layers) == 16
        for name, level, _, heads in sd_stub.attn2_layers():
            side = 16 >> level
            assert tuple(layers[name].shape) == (2, heads, side, side, 77)
            torch.testing.assert_close(layers[name].sum(-1), torch.ones(2, heads, side, side))
    outs, att = run_cross_attention_warp(img, "a red square", src.capture, top_k=20,
                                         iterations=2, width=50, height=40, device="cpu")
    assert [tuple(o.shape) for o in outs] == [(40, 50, 3)] * 2
    assert float(att.min()) == 0.0 and abs(float(att.max()) - 1.0) < 1e-6
    for o in outs:
        assert torch.isfinite(o).all() and float(o.min()) >= 0.0 and float(o.max()) <= 255.0


def test_sd_capture_imports_no_jax():
    """Unlike ``attwarp_tpu.warp.sd_capture``, which loads JAX, the port's
    module imports neither ``jax`` nor ``attwarp_tpu``."""
    code = ("import sys, attwarp_tpu_torch.warp.sd_capture\n"
            "assert 'jax' not in sys.modules and 'attwarp_tpu' not in sys.modules\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env=dict(os.environ, PYTHONPATH=root), timeout=300)
