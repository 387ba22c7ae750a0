"""The port's learned-warp math and model (``numerics/{safe,cdf,losses}.py``,
``warp_from_cdf``, MarginalNet, ``predict_and_warp`` and the frozen-feature
extractors) against the JAX package and the NumPy/cv2 oracle.

Inputs come from a numpy seed and go through both packages, on the CPU: the
K1 wrapper runs its plain version there (its CUDA path is compared with
that plain version on the card, ``tests/test_torch_kernels_cuda.py``).
Tolerances: the numerics 1e-6 (f32 both sides), inverse maps 1e-5 px, the
warp 1e-5 against JAX's exact ``gather`` resample and 1e-3 against its
``mm`` form (matmuls at TPU precision), MarginalNet in f32 rtol 1e-4 /
atol 1e-6 on the same weights.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import __graft_entry__ as graft
from attwarp_tpu.marginalnet.inference import predict_and_warp as j_predict_and_warp
from attwarp_tpu.marginalnet.model import MarginalNet as JMarginalNet
from attwarp_tpu.numerics import cdf as jcdf
from attwarp_tpu.numerics import losses as jlosses
from attwarp_tpu.numerics import safe as jsafe
from attwarp_tpu.testing.oracle import warp_from_cdf_oracle
from attwarp_tpu.warp.grid import inverse_axis_map_from_cdf as j_inverse_from_cdf
from attwarp_tpu.warp.warp import warp_from_cdf as j_warp_from_cdf

from attwarp_tpu_torch.extract.resize import resize_linear
from attwarp_tpu_torch.marginalnet.inference import predict_and_warp
from attwarp_tpu_torch.marginalnet.model import ATTENTION_GRID, MarginalNet, params_from_jax
from attwarp_tpu_torch.numerics import cdf as tcdf
from attwarp_tpu_torch.numerics import losses as tlosses
from attwarp_tpu_torch.numerics import safe as tsafe
from attwarp_tpu_torch.warp.grid import inverse_axis_map_from_cdf
from attwarp_tpu_torch.warp.warp import warp_from_cdf

ROOT = Path(__file__).resolve().parents[1]
PIX_TOL = 1e-3 * 255   # the oracle bar: 1e-3 on [0, 1] pixels


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, atol=1e-6, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _pdfs(rng, B, N, spiky=False):
    p = rng.random((B, N)).astype(np.float32)
    if spiky:   # exact zeros, a NaN and an inf: what the guards scrub
        p[0, : N // 3] = 0.0
        p[1, 2] = np.nan
        p[1, 5] = np.inf
        p[2] = 0.0
    return p


# ── numerics ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("fn", ["safe_softmax", "entropy", "normalize_pdf", "mix_with_uniform"])
def test_safe_matches_jax(rng, fn):
    x = rng.standard_normal((5, 24)).astype(np.float32) * 4
    x[0, 3] = np.nan
    x[1, 7] = np.inf
    if fn == "safe_softmax":
        ref, got = jsafe.safe_softmax(jnp.asarray(x)), tsafe.safe_softmax(_t(x))
    elif fn == "mix_with_uniform":
        p = np.abs(x[2:])
        ref = jsafe.mix_with_uniform(jnp.asarray(p), 0.3)
        got = tsafe.mix_with_uniform(_t(p), torch.tensor(0.3))
        _close(tsafe.mix_with_uniform(_t(p), 1.7), jsafe.mix_with_uniform(jnp.asarray(p), 1.7))
    else:
        p = np.abs(x[2:])
        ref, got = getattr(jsafe, fn)(jnp.asarray(p)), getattr(tsafe, fn)(_t(p))
    _close(got, ref)


@pytest.mark.parametrize("fn", ["cdf_from_density", "gt_marginals", "make_strictly_increasing",
                                "resample_cdf", "normalize_cdf_1d"])
def test_cdf_matches_jax(rng, fn):
    p = _pdfs(rng, 4, 24, spiky=True)
    if fn == "gt_marginals":
        A = rng.random((3, 1, 20, 24)).astype(np.float32) - 0.2
        for (got, ref) in zip(tcdf.gt_marginals(_t(A)), jcdf.gt_marginals(jnp.asarray(A))):
            _close(got, ref)
        for (got, ref) in zip(tcdf.gt_marginals(_t(A[:, 0])), jcdf.gt_marginals(jnp.asarray(A[:, 0]))):
            _close(got, ref)
        return
    if fn == "cdf_from_density":
        _close(tcdf.cdf_from_density(_t(p)), jcdf.cdf_from_density(jnp.asarray(p)))
        return
    F_ = np.cumsum(np.nan_to_num(np.abs(p), posinf=1.0), axis=-1)
    F_ = F_ / np.maximum(F_[:, -1:], 1e-6)
    F_[3, 5:9] = F_[3, 4]          # ties
    F_[0, 10] = np.nan
    if fn == "make_strictly_increasing":
        _close(tcdf.make_strictly_increasing(_t(F_)), jcdf.make_strictly_increasing(jnp.asarray(F_)))
    elif fn == "resample_cdf":
        for L in (1, 24, 97, 512):
            _close(tcdf.resample_cdf(_t(F_), L), jcdf.resample_cdf(jnp.asarray(F_), L))
    else:
        G = F_.copy()
        G[2] = 0.0                 # degenerate: the uniform ramp
        for row in G:
            _close(tcdf.normalize_cdf_1d(_t(row)), jcdf.normalize_cdf_1d(jnp.asarray(row)))


@pytest.mark.parametrize("fn", ["l1_cdf_loss", "sym_kl", "separable_recon_loss", "recon_l1",
                                "build_axis_cdf_targets", "cdf_from_density_downsample"])
def test_losses_match_jax(rng, fn):
    px, py = _pdfs(rng, 3, 24), _pdfs(rng, 3, 20)
    A = rng.random((3, 1, 20, 24)).astype(np.float32)
    if fn in ("l1_cdf_loss", "sym_kl"):
        q = _pdfs(rng, 3, 24)
        ref, got = getattr(jlosses, fn)(jnp.asarray(px), jnp.asarray(q)), \
            getattr(tlosses, fn)(_t(px), _t(q))
    elif fn in ("separable_recon_loss", "recon_l1"):
        ref = getattr(jlosses, fn)(jnp.asarray(px), jnp.asarray(py), jnp.asarray(A))
        got = getattr(tlosses, fn)(_t(px), _t(py), _t(A))
        _close(getattr(tlosses, fn)(_t(px), _t(py), _t(A[:, 0])), ref)
    elif fn == "build_axis_cdf_targets":
        for L in (12, 24, 64):
            for got, ref in zip(tlosses.build_axis_cdf_targets(_t(A), L),
                                jlosses.build_axis_cdf_targets(jnp.asarray(A), L)):
                _close(got, ref)
        return
    else:
        ref = jlosses.cdf_from_density_downsample(jnp.asarray(px), 10)
        got = tlosses.cdf_from_density_downsample(_t(px), 10)
    _close(got, ref)


# ── the CDF warp ────────────────────────────────────────────────────────

def _cdfs(rng, B, N, ties=False):
    F_ = np.cumsum(rng.random((B, N)).astype(np.float32) + 0.05, axis=-1)
    F_ = F_ / F_[:, -1:]
    if ties:                       # flat runs and a zero head: tied knots
        F_[0, 3:8] = F_[0, 2]
        F_[1, :4] = 0.0
    return F_


@pytest.mark.parametrize("tie_jitter", [True, False])
@pytest.mark.parametrize("ties", [False, True], ids=["no_ties", "ties"])
def test_inverse_axis_map_from_cdf_matches_jax(rng, ties, tie_jitter):
    """Batched in the port against JAX one CDF at a time, within 1e-5 px;
    with ties the jitter is chosen per CDF on the device."""
    F_ = _cdfs(rng, 3, 24, ties)
    for out_len in (24, 500):
        got = inverse_axis_map_from_cdf(_t(F_), out_len, tie_jitter=tie_jitter)
        ref = np.stack([np.asarray(j_inverse_from_cdf(jnp.asarray(f), out_len, tie_jitter))
                        for f in F_])
        _close(got, ref, atol=1e-5)


@pytest.mark.parametrize("out_size", [None, (40, 56)])
def test_warp_from_cdf_matches_jax_and_oracle(rng, out_size):
    """JAX's exact ``gather`` resample within 1e-5 of the pixel range (0-255
    here; 3e-5 measured, 1.2e-7 of the range), its ``mm`` form within 1e-3
    of it, and the cv2 oracle within the oracle bar, with tied CDFs."""
    B, H, W = 3, 48, 64
    imgs = (rng.random((B, H, W, 3)) * 255).astype(np.float32)
    Fx, Fy = _cdfs(rng, B, W, ties=True), _cdfs(rng, B, H, ties=True)
    got = warp_from_cdf(_t(imgs), _t(Fx), _t(Fy), out_size).numpy()
    args = (jnp.asarray(imgs), jnp.asarray(Fx), jnp.asarray(Fy), out_size, True)
    _close(got, j_warp_from_cdf(*args, method="gather"), atol=1e-5 * 255)
    _close(got, j_warp_from_cdf(*args, method="mm"), atol=1e-3 * 255)
    _close(got, warp_from_cdf_oracle(imgs, Fx, Fy, out_size), atol=PIX_TOL)


def test_warp_from_cdf_gradient_matches_jax(rng):
    """The setting of ``tests/test_warp_grad.py::test_grad_through_cdf_warp``:
    the gradient with respect to the densities through the CPU path equals
    JAX's through its exact ``gather`` resample within 1e-5."""
    B, S = 2, 16
    imgs = rng.random((B, S, S, 3)).astype(np.float32)
    p = (rng.random((B, S)) + 0.1).astype(np.float32)

    def j_loss(p):
        F_ = jcdf.cdf_from_density(p)
        w = j_warp_from_cdf.__wrapped__(jnp.asarray(imgs), F_, F_, None, False, "gather")
        return jnp.mean((w - jnp.asarray(imgs)) ** 2)

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(p)))
    pt = _t(p).requires_grad_(True)
    F_ = tcdf.cdf_from_density(pt)
    w = warp_from_cdf(_t(imgs), F_, F_, None, tie_jitter=False)
    torch.mean((w - _t(imgs)) ** 2).backward()
    assert np.abs(ref).max() > 0
    _close(pt.grad, ref, atol=1e-5)


# ── MarginalNet ─────────────────────────────────────────────────────────

def _mn_inputs(rng, B=3, hv=8, Dv=16, Lt=6, Dt=12):
    fmap = rng.standard_normal((B, hv, hv, Dv)).astype(np.float32)
    ttok = rng.standard_normal((B, Lt, Dt)).astype(np.float32)
    tmask = np.ones((B, Lt, 1), np.float32)
    tmask[0, :2] = 0.0
    tmask[1] = 0.0               # no text at all: the pooled mean's clamp
    return fmap, ttok, tmask


def _pair(fmap, ttok, tmask, hidden, jdt, tdt):
    jm = JMarginalNet(hidden=hidden, compute_dtype=jdt)
    params = jm.init(jax.random.PRNGKey(0), fmap, ATTENTION_GRID, ttok, tmask)["params"]
    tm = MarginalNet(fmap.shape[-1], ttok.shape[-1], hidden, compute_dtype=tdt)
    tm.load_state_dict(params_from_jax(jax.device_get(params)))
    return jm, params, tm


@pytest.mark.parametrize("hv", [8, 24, 32], ids=["up_8", "same_24", "down_32"])
def test_marginalnet_matches_flax_f32(rng, hv):
    """In f32 (flax ``compute_dtype=jnp.float32``) on the same weights:
    rtol 1e-4, atol 1e-6. Grids of 8 (upsampled to 24), 24 (the identity)
    and 32 (downsampled, antialiased as ``jax.image.resize`` does)."""
    fmap, ttok, tmask = _mn_inputs(rng, hv=hv)
    jm, params, tm = _pair(fmap, ttok, tmask, 32, jnp.float32, torch.float32)
    ref = jm.apply({"params": params}, fmap, ATTENTION_GRID, ttok, tmask)
    got = tm(_t(fmap), ATTENTION_GRID, _t(ttok), _t(tmask))
    for g, r in zip(got, ref):
        assert g.shape == (3, 24) and g.dtype == torch.float32
        _close(g, r, atol=1e-6, rtol=1e-4)


def test_marginalnet_matches_flax_bf16(rng):
    """JAX's default bf16 compute against torch's CPU bf16 autocast on the
    same f32 weights: the two round at different points (XLA fuses; torch
    rounds each op's output, and resizes H then W where XLA contracts
    both at once). Measured here: at most 5e-5 absolute and 1.2e-3
    relative on probabilities of ~1/24; the bar is 2e-4 absolute."""
    fmap, ttok, tmask = _mn_inputs(rng, hv=8)
    jm, params, tm = _pair(fmap, ttok, tmask, 32, jnp.bfloat16, torch.bfloat16)
    ref = jm.apply({"params": params}, fmap, ATTENTION_GRID, ttok, tmask)
    got = tm(_t(fmap), ATTENTION_GRID, _t(ttok), _t(tmask))
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        _close(g, r, atol=2e-4)


def test_marginalnet_init_is_flax_like_and_seeded():
    """Weights lecun_normal (std sqrt(1/fan_in), truncated at two deviations)
    and zero biases, as flax initialises; the same seed gives the same net."""
    a = MarginalNet(16, 12, 64, generator=torch.Generator().manual_seed(3))
    b = MarginalNet(16, 12, 64, generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q)
        if name.endswith("bias"):
            assert not p.any()
    w = a.proj_v2.weight                    # fan_in 64 * 9
    std = (1 / 576) ** 0.5
    assert w.abs().max() <= 2 * std / 0.87962566103423978 + 1e-7
    assert abs(w.std().item() - std) < 0.05 * std


@pytest.mark.parametrize("hw_in", [8, 32], ids=["up", "down"])
def test_resize_matches_jax_image_resize(rng, hw_in):
    """MarginalNet's resize to 24x24 is ``jax.image.resize`` "linear": the
    port's constant-matrix form equals it both ways within 1e-6.
    ``F.interpolate(bilinear, align_corners=False)`` equals it on an
    upsample, but not on a downsample (JAX antialiases), which is why the
    model uses the matrix form."""
    x = rng.standard_normal((2, hw_in, hw_in, 5)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, 24, 24, 5), "linear"))
    _close(resize_linear(_t(x), (24, 24)), ref, atol=1e-6)
    interp = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(24, 24), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    d = np.abs(interp - ref).max()
    assert (d <= 1e-6) if hw_in < 24 else (d > 1e-2)


@pytest.mark.parametrize("out_size", [None, (32, 48)])
def test_predict_and_warp_matches_jax(rng, out_size):
    """f32 model, the right-inverse upsample, the CDFs and the warp: the
    marginals within rtol 1e-4 / atol 1e-6 of JAX's, the warped [0, 1]
    pixels within 1e-4 of JAX's ``predict_and_warp`` through its exact
    ``gather`` resample (the inverse map scales the marginals' last-bit
    differences by the output width; 4.2e-5 measured) and within 1e-3 of
    its default ``mm`` form."""
    fmap, ttok, tmask = _mn_inputs(rng, B=2)
    jm, params, tm = _pair(fmap, ttok, tmask, 32, jnp.float32, torch.float32)
    images = rng.random((2, 64, 64, 3)).astype(np.float32)
    args = (params, jm, jnp.asarray(images), jnp.asarray(fmap), jnp.asarray(ttok),
            jnp.asarray(tmask), out_size)
    wg, pxg, pyg = j_predict_and_warp(*args, method="gather")
    wm, _, _ = j_predict_and_warp(*args)
    w, px, py = predict_and_warp(tm, _t(images), _t(fmap), _t(ttok), _t(tmask), out_size)
    assert not w.requires_grad
    _close(px, pxg, atol=1e-6, rtol=1e-4)
    _close(py, pyg, atol=1e-6, rtol=1e-4)
    _close(w, wg, atol=1e-4)
    _close(w, wm, atol=1e-3)


# ── frozen-feature extractors ───────────────────────────────────────────

# a word-level vocabulary small enough for the tiny models' embeddings
VOCAB = {w: i for i, w in enumerate(["<unk>", "<s>", "</s>", "what", "is", "the", "code",
                                     "on", "tag?", "read", "it"])}
TEXTS = ["what is the code on the tag?", "read it", ""]


class _HFStyle:
    """JAX's extractors call ``tokenizer(text, add_special_tokens=...)
    ["input_ids"]``; the port's call ``encode``. One dry-run tokenizer
    behind both forms."""

    def __init__(self, tok):
        self.tok = tok

    def __call__(self, text, add_special_tokens=True):
        return {"input_ids": self.tok.encode(text, add_special_tokens=add_special_tokens)}


def test_llava_feature_extractor_matches_jax(rng):
    """Visual tokens (CLIP features, resized from 64 px) and text tokens of
    a tiny LLaVA on the same weights, f32, within 1e-5."""
    from attwarp_tpu.extract.features import LlavaFeatureExtractor as JFeats
    from attwarp_tpu.extract.llava_backend import LlavaBackend as JBackend
    from attwarp_tpu.models import LlavaModel as JModel

    from attwarp_tpu_torch.extract.features import LlavaFeatureExtractor
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.llava import LlavaModel, params_from_jax as llava_from_jax
    from test_torch_llava import tiny_configs

    jcfg, tcfg = tiny_configs()
    jparams = graft._random_llava_params(jcfg, jax.random.PRNGKey(0))
    tok = DryRunTokenizer(vocab=VOCAB)
    jf = JFeats(JBackend(JModel(jcfg, jparams), tokenizer=_HFStyle(tok)), max_text_len=8)
    tf = LlavaFeatureExtractor(LlavaBackend(LlavaModel(tcfg, llava_from_jax(jax.device_get(jparams))),
                                            tokenizer=tok), max_text_len=8)
    images = rng.random((2, 64, 64, 3)).astype(np.float32)
    ref = np.asarray(jf.visual_tokens(jnp.asarray(images)))
    got = tf.visual_tokens(images)
    assert got.shape == ref.shape == (2, 4, 4, 32)
    _close(got, ref, atol=1e-5)
    (je, jm), (te, tm) = jf.text_tokens(TEXTS), tf.text_tokens(TEXTS)
    _close(tm, jm)
    _close(te, je)
    assert te.shape == (3, 8, 64)


def test_qwen2vl_feature_extractor_matches_jax(rng):
    """Merged vision features and text tokens of a tiny Qwen2-VL on the same
    weights, f32, within 1e-5."""
    from attwarp_tpu.extract.features import Qwen2VLFeatureExtractor as JFeats
    from attwarp_tpu.extract.qwen2vl_backend import Qwen2VLBackend as JBackend

    from attwarp_tpu_torch.extract.features import Qwen2VLFeatureExtractor
    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu.models import qwen2vl as jq

    from attwarp_tpu_torch.models import qwen2vl as tq
    from attwarp_tpu_torch.models.llava import params_from_jax as tree_from_jax
    from test_torch_qwen2vl import numpy_params, tiny_configs

    jcfg, tcfg = tiny_configs()
    tree = numpy_params(jcfg)
    jmodel = jq.Qwen2VLModel(jcfg, jax.tree_util.tree_map(jnp.asarray, tree))
    tmodel = tq.Qwen2VLModel(tcfg, tree_from_jax(tree))
    tok = DryRunTokenizer(vocab=VOCAB)
    jf = JFeats(JBackend(jmodel, tokenizer=_HFStyle(tok), extract_layer=0, image_size=56),
                max_text_len=8)
    tf = Qwen2VLFeatureExtractor(Qwen2VLBackend(tmodel, tokenizer=tok, extract_layer=0,
                                                image_size=56), max_text_len=8)
    images = rng.random((2, 40, 40, 3)).astype(np.float32)
    ref = np.asarray(jf.visual_tokens(jnp.asarray(images)))
    got = tf.visual_tokens(images)
    assert got.shape == ref.shape
    _close(got, ref, atol=1e-5)
    (je, jmask), (te, tmask) = jf.text_tokens(TEXTS), tf.text_tokens(TEXTS)
    _close(tmask, jmask)
    _close(te, je)


def test_make_feature_extractor_refuses_mini_and_unknown():
    from attwarp_tpu_torch.extract.features import MiniFeatureExtractor, make_feature_extractor
    from attwarp_tpu_torch.train.config import TrainConfig

    # the default, mini, is ported: it builds the mini's extractor
    assert isinstance(make_feature_extractor(TrainConfig(), "cpu"), MiniFeatureExtractor)
    with pytest.raises(ValueError, match="unknown"):
        make_feature_extractor(TrainConfig(mllm_backend="nope"), "cpu")


# ── the package stays free of JAX ───────────────────────────────────────

NEW_MODULES = [
    "attwarp_tpu_torch.numerics.safe", "attwarp_tpu_torch.numerics.cdf",
    "attwarp_tpu_torch.numerics.losses", "attwarp_tpu_torch.marginalnet.model",
    "attwarp_tpu_torch.marginalnet.inference", "attwarp_tpu_torch.data.manifests",
    "attwarp_tpu_torch.data.loader", "attwarp_tpu_torch.train.config",
    "attwarp_tpu_torch.train.experiment", "attwarp_tpu_torch.train.metrics",
    "attwarp_tpu_torch.train.train_step", "attwarp_tpu_torch.train.checkpoint",
    "attwarp_tpu_torch.train.viz", "attwarp_tpu_torch.train.trainer",
    "attwarp_tpu_torch.utils.profiling", "attwarp_tpu_torch.extract.features",
    "attwarp_tpu_torch.cli.warp", "attwarp_tpu_torch.cli.train",
    "attwarp_tpu_torch.tools.run_marginalnet_chain",
]


def test_new_modules_import_without_jax_or_the_jax_package():
    """Every module of this slice imports in a process where ``jax`` and
    ``attwarp_tpu`` cannot be imported."""
    code = ("import sys\n"
            "for name in ('jax', 'attwarp_tpu', 'flax', 'optax'):\n"
            "    sys.modules[name] = None\n"
            f"import importlib\nfor m in {NEW_MODULES!r}:\n    importlib.import_module(m)\n"
            "print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
