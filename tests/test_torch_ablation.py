"""The SD-warp ablation's math (cv2's cubic resize, the Gaussian blur, the
map conditioning, the iterative warp and the cross-attention token
selection) in ``attwarp_tpu_torch`` against the JAX package.

Inputs come from a numpy seed and go through both packages on the CPU.
Resizes, blurs and maps within 1e-5 on [0, 1] data (f32 matmuls in another
order); token importance within rtol 1e-10 (float64 sums on both sides);
warps within the repo's warp budget, ``PIX_TOL``, on 0-255 images.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attwarp_tpu.warp import blend as jblend
from attwarp_tpu.warp import cross_attention as jxa
from attwarp_tpu.warp import iterative as jit_
from attwarp_tpu.warp.transforms import Transform as JTransform

from attwarp_tpu_torch.warp import blend as tblend
from attwarp_tpu_torch.warp import cross_attention as txa
from attwarp_tpu_torch.warp import iterative as tit
from attwarp_tpu_torch.warp.transforms import Transform

PIX_TOL = 1e-3 * 255   # the repo's warp budget: 1e-3 on [0, 1] pixels


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, atol, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


# ── cv2's cubic, the blur and the conditioning ──────────────────────────


@pytest.mark.parametrize("shape,out_hw", [
    ((16, 20), (64, 80)),       # up, as the conditioning upsamples a map
    ((64, 80), (24, 30)),       # down, as the aggregation may
    ((3, 12, 9), (5, 31)),      # a leading batch, down one axis and up the other
], ids=["up", "down", "batched"])
def test_resize_cubic_matches_jax(rng, shape, out_hw):
    x = rng.random(shape).astype(np.float32)
    assert tblend._cubic_matrix_np(shape[-1], out_hw[1]).dtype == np.float64
    np.testing.assert_array_equal(tblend._cubic_matrix_np(shape[-1], out_hw[1]),
                                  jblend._cubic_matrix_np(shape[-1], out_hw[1]))
    _close(tblend.resize_cubic(_t(x), out_hw), jblend.resize_cubic(jnp.asarray(x), out_hw),
           atol=1e-5)


def test_gaussian_blur_matches_jax(rng):
    x = rng.random((40, 50)).astype(np.float32)
    np.testing.assert_array_equal(tit._gaussian_matrix_np(40, 5, 1.0),
                                  jit_._gaussian_matrix_np(40, 5, 1.0))
    _close(tit.gaussian_blur(_t(x), 5, 1.0), jit_.gaussian_blur(jnp.asarray(x), 5, 1.0),
           atol=1e-5)


@pytest.mark.parametrize("shape,target", [((16, 20), (64, 80)), ((24, 24), (37, 53))])
def test_condition_attention_map_matches_jax(rng, shape, target):
    """Within 1e-5 of JAX's, spanning [0, 1]; a leading batch conditions
    each map on its own."""
    att = rng.random(shape).astype(np.float32)
    got = tit.condition_attention_map(_t(att), target)
    _close(got, jit_.condition_attention_map(jnp.asarray(att), target), atol=1e-5)
    assert abs(float(got.min())) < 1e-6 and abs(float(got.max()) - 1.0) < 1e-6
    both = tit.condition_attention_map(_t(np.stack([att, 3.0 * att[::-1] + 1.0])), target)
    _close(both[0], got, atol=1e-6)
    _close(both[1], tit.condition_attention_map(_t(3.0 * att[::-1] + 1.0), target), atol=1e-6)


# ── the iterative warp ──────────────────────────────────────────────────


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("transform", ["identity", "exp"])
def test_iterative_warp_matches_jax(rng, iterations, transform):
    """Every iterate within ``PIX_TOL`` of JAX's on a 0-255 image; the map
    is resized to the iterate's size after the first iteration."""
    img = (rng.random((40, 48, 3)) * 255).astype(np.float32)
    att = rng.random((40, 48)).astype(np.float32) ** 4
    kw = dict(exp_scale=3.0, exp_divisor=2.0) if transform == "exp" else {}
    got = tit.iterative_warp(_t(img), _t(att), 36, 30, iterations=iterations,
                             transform=Transform(transform), **kw)
    ref = jit_.iterative_warp(jnp.asarray(img), jnp.asarray(att), 36, 30,
                              iterations=iterations, transform=JTransform(transform), **kw)
    assert len(got) == len(ref) == iterations
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (30, 36, 3)
        _close(g, r, atol=PIX_TOL)


def test_iterative_warp_compounds(rng):
    """JAX's ``test_iterative_warp_compounds`` on the port: with the identity
    transform the first iterate of three equals the single pass, and the
    later ones keep magnifying."""
    img = (rng.random((40, 40, 3)) * 255).astype(np.float32)
    att = np.zeros((40, 40), np.float32)
    att[10:20, 10:20] = 1.0
    one = tit.iterative_warp(_t(img), _t(att), 40, 40, iterations=1)
    three = tit.iterative_warp(_t(img), _t(att), 40, 40, iterations=3)
    assert len(one) == 1 and len(three) == 3
    assert torch.isfinite(three[-1]).all()
    _close(three[0], one[0], atol=1e-4)
    assert float((three[-1] - one[0]).abs().mean()) > 1.0


# ── token importance and aggregation ────────────────────────────────────


def _captured(rng, grids=((8, 8), (4, 4)), steps=(800, 600, 400), tokens=11):
    """A fake capture: per timestep, layers "l0", "l1", ... with the given
    grids, (B=2, heads=3, H, W, tokens) softmax rows."""
    out = {}
    for t in steps:
        layers = {}
        for k, (h, w) in enumerate(grids):
            p = rng.random((2, 3, h, w, tokens)).astype(np.float32) ** 3
            layers[f"l{k}"] = p / p.sum(-1, keepdims=True)
        out[t] = layers
    return out


@pytest.mark.parametrize("kw", [
    {}, {"last_timestep": True}, {"inference_step_selection": [800, 400]}, {"num_layers": 1},
], ids=["all", "last_timestep", "step_selection", "num_layers"])
def test_compute_token_importance_matches_jax(rng, kw):
    """float64 sums on both sides: within rtol 1e-10, the same top-k order,
    on numpy maps and on tensors alike."""
    cap = _captured(rng)
    ref = jxa.compute_token_importance(cap, **kw)
    got = txa.compute_token_importance(cap, **kw)
    assert got.dtype == torch.float64
    _close(got, ref, atol=0.0, rtol=1e-10)
    as_t = {t: {k: _t(v) for k, v in d.items()} for t, d in cap.items()}
    _close(txa.compute_token_importance(as_t, **kw), ref, atol=0.0, rtol=1e-10)
    top = torch.argsort(got, stable=True)[-5:].flip(0).tolist()
    assert top == list(np.argsort(ref)[-5:][::-1])


def test_compute_token_importance_refuses_an_empty_selection(rng):
    with pytest.raises(ValueError, match="No attention maps"):
        txa.compute_token_importance(_captured(rng), inference_step_selection=[1])


@pytest.mark.parametrize("kw,grid", [
    ({}, (4, 4)),                                    # the last key, "l1", alone
    ({"num_last_layers": 2}, (8, 8)),
    ({"num_last_layers": 2, "inference_step_selection": [600]}, (8, 8)),
], ids=["last_layer", "two_grids", "two_grids_one_step"])
def test_aggregate_attention_map_matches_jax(rng, kw, grid):
    """Within 1e-5, maps of two grid sizes resized to the larger by cv2's
    cubic; min-max normalized to [0, 1]."""
    cap = _captured(rng)
    idx = [3, 7, 0]
    ref = jxa.aggregate_attention_map_for_tokens(cap, idx, **kw)
    got = txa.aggregate_attention_map_for_tokens(cap, idx, **kw)
    assert tuple(got.shape) == ref.shape == grid
    _close(got, ref, atol=1e-5)
    assert float(got.min()) == 0.0 and abs(float(got.max()) - 1.0) < 1e-6


@pytest.mark.parametrize("iterations", [1, 3])
def test_run_cross_attention_warp_matches_jax(rng, iterations):
    """With a fixed fake capture: the same top-k tokens, the conditioned map
    within 1e-5, every iterate within ``PIX_TOL`` on a 0-255 image."""
    cap = _captured(rng, grids=((6, 8), (3, 4)), tokens=9)
    img = (rng.random((40, 52, 3)) * 255).astype(np.float32)
    kw = dict(top_k=4, iterations=iterations, width=36, height=30, num_last_layers=2)
    outs, att = txa.run_cross_attention_warp(img, "a sign", lambda im, p: cap, device="cpu", **kw)
    j_outs, j_att = jxa.run_cross_attention_warp(img, "a sign", lambda im, p: cap, **kw)
    scores = txa.compute_token_importance(cap)
    assert (torch.argsort(scores, stable=True)[-4:].flip(0).tolist()
            == list(np.argsort(jxa.compute_token_importance(cap))[-4:][::-1]))
    assert tuple(att.shape) == (40, 52)
    _close(att, j_att, atol=1e-5)
    assert len(outs) == len(j_outs) == iterations
    for g, r in zip(outs, j_outs):
        assert tuple(g.shape) == (30, 36, 3)
        _close(g, r, atol=PIX_TOL)


def test_ablation_modules_import_no_jax():
    """The slice's port modules, the stub pipeline and ``chip_smoke.py``
    pull neither ``jax`` nor ``attwarp_tpu`` into ``sys.modules``."""
    mods = ["attwarp_tpu_torch.warp.iterative", "attwarp_tpu_torch.warp.cross_attention",
            "attwarp_tpu_torch.warp.sd_capture", "attwarp_tpu_torch.testing.sd_stub",
            "attwarp_tpu_torch.kernels.warp_resample", "chip_smoke"]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'attwarp_tpu.'))"
            " or m == 'attwarp_tpu']\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, env=env, timeout=300)
