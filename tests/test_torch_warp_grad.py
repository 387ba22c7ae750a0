"""The warp's gradients in ``attwarp_tpu_torch`` against ``jax.grad`` of the
JAX package's warp (its exact ``gather`` resample), and the CPU routes of
K1's forward and backward wrappers.

The JAX package's ``tests/test_warp_grad.py`` differentiates the warp end
to end, to the image and to the attention map, and through the CDF warp to
the predicted densities. On the CPU the port's ``warp_resample`` is the
plain version, differentiated by autograd (higher orders too), and
``warp_resample_backward`` is ``warp_resample_backward_plain``; on the
card, K1's autograd Function and its backward kernels
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` step 16).
Gradients within 1e-4 of the reference's largest magnitude (sums in another
order, through the grid maps' inverse CDF); ``gradcheck`` in float64 at its
default tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attwarp_tpu.numerics import cdf_from_density as j_cdf
from attwarp_tpu.warp import WarpParams as JWarpParams
from attwarp_tpu.warp import warp_batch_by_attention as j_warp_batch
from attwarp_tpu.warp.warp import warp_from_cdf as j_warp_from_cdf

from attwarp_tpu_torch.kernels import roofline
from attwarp_tpu_torch.kernels.warp_resample import (
    warp_resample,
    warp_resample_backward,
    warp_resample_backward_plain,
)
from attwarp_tpu_torch.numerics.cdf import cdf_from_density
from attwarp_tpu_torch.warp.resample import _axis_lerp, remap_bilinear_separable
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention, warp_from_cdf


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("shape,out_hw,att_hw", [
    ((2, 24, 32, 3), (24, 32), (8, 8)),       # JAX's setting, at the image's size
    ((2, 24, 32, 3), (20, 40), (24, 32)),     # another output size, image-size maps
])
def test_warp_batch_grad_matches_jax(rng, shape, out_hw, att_hw):
    """d sum(warp(img, att)^2) / d(img, att), JAX's first setting: both
    within 1e-4 relative of ``jax.grad`` through the gather resample."""
    imgs = rng.random(shape).astype(np.float32)
    atts = (rng.random((shape[0], *att_hw)) + 0.1).astype(np.float32)
    H_out, W_out = out_hw

    def j_loss(i, a):
        w = j_warp_batch.__wrapped__(i, a, W_out, H_out, JWarpParams(), "gather")
        return jnp.sum(w ** 2)

    gi, ga = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(imgs), jnp.asarray(atts))
    ti = torch.as_tensor(imgs).requires_grad_(True)
    ta = torch.as_tensor(atts).requires_grad_(True)
    w = warp_batch_by_attention(ti, ta, W_out, H_out)
    torch.sum(w ** 2).backward()
    assert np.abs(np.asarray(ga)).max() > 0 and np.abs(np.asarray(gi)).max() > 0
    assert _rel(ti.grad, gi) <= 1e-4
    assert _rel(ta.grad, ga) <= 1e-4


@pytest.mark.parametrize("out_size", [None, (20, 16)])
def test_warp_from_cdf_grad_matches_jax(rng, out_size):
    """d mean((warp_from_cdf(img, F(p), F(p)) - img)^2) / dp, JAX's second
    setting (without tie jitter): within 1e-4 relative of ``jax.grad``."""
    B, S = 2, 24
    imgs = rng.random((B, S, S, 3)).astype(np.float32)
    p = (rng.random((B, S)) + 0.1).astype(np.float32)
    H_out, W_out = out_size or (S, S)
    target = imgs[:, :H_out, :W_out]           # the image itself at its own size

    def j_loss(p):
        F_ = j_cdf(p)
        w = j_warp_from_cdf.__wrapped__(jnp.asarray(imgs), F_, F_, out_size, False, "gather")
        return jnp.mean((w - jnp.asarray(target)) ** 2)

    ref = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(p)))
    pt = torch.as_tensor(p).requires_grad_(True)
    F_ = cdf_from_density(pt)
    w = warp_from_cdf(torch.as_tensor(imgs), F_, F_, out_size, tie_jitter=False)
    torch.mean((w - torch.as_tensor(target)) ** 2).backward()
    assert np.abs(ref).max() > 0
    assert _rel(pt.grad, ref) <= 1e-4


@pytest.mark.parametrize("hw,out_hw", [((1, 1), (3, 4)), ((5, 7), (6, 9))],
                         ids=["1x1", "5x7"])
def test_plain_warp_gradcheck(hw, out_hw):
    """The plain version's two passes (``remap_bilinear_separable`` without
    its f32 cast, the reference of K1's backward) in float64, maps reaching
    outside the image on both sides (border replicate; clamped taps give
    the maps no gradient), against finite differences."""
    g = np.random.default_rng(5)
    H, W = hw
    img = torch.as_tensor(g.random((2, H, W, 3))).requires_grad_(True)
    mx = torch.as_tensor(g.uniform(-3.0, W + 2.0, (2, out_hw[1]))).requires_grad_(True)
    my = torch.as_tensor(g.uniform(-3.0, H + 2.0, (2, out_hw[0]))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda i, x, y: _axis_lerp(_axis_lerp(i, x, axis=2), y, axis=1), (img, mx, my))


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, True),
                                   (False, False, True), (False, True, False),
                                   (True, True, True)],
                         ids=["image", "maps", "map_y", "map_x", "all"])
def test_k1_cpu_routes_match_plain_autograd(rng, needs):
    """On CPU tensors ``warp_resample`` is the plain version under autograd
    (no K1 Function, a second-order gradient exists), and
    ``warp_resample_backward`` returns exactly the plain version's
    gradients of the inputs asked for, None for the others; under
    ``no_grad`` no graph is built."""
    base = [torch.as_tensor((rng.random((2, 9, 11, 3)) * 255).astype(np.float32)),
            torch.as_tensor(rng.uniform(-2.0, 12.0, (2, 13)).astype(np.float32)),
            torch.as_tensor(rng.uniform(-2.0, 10.0, (2, 7)).astype(np.float32))]
    w = torch.as_tensor(rng.standard_normal((2, 7, 13, 3)).astype(np.float32))

    def grads(fn):
        t = [b.clone().requires_grad_(n) for b, n in zip(base, needs)]
        out = fn(*t)
        wanted = [x for x in t if x.requires_grad]
        got = iter(torch.autograd.grad((out * w).sum(), wanted, create_graph=True))
        return out, [next(got) if x.requires_grad else None for x in t]

    out, got = grads(warp_resample)
    assert "K1Function" not in out.grad_fn.name()
    _, ref = grads(remap_bilinear_separable)
    for n, a, r in zip(needs, got, ref):
        assert (a is None) == (not n)
        if n:
            torch.testing.assert_close(a, r, rtol=0, atol=0)
    if needs[0] and needs[1]:
        # d/d(map_x) of <dL/dimage, v>: a second order the plain route keeps
        t = [b.clone().requires_grad_(True) for b in base]
        gi = torch.autograd.grad((warp_resample(*t) * w).sum(), t[0], create_graph=True)[0]
        v = torch.as_tensor(rng.standard_normal(gi.shape).astype(np.float32))
        assert torch.autograd.grad((gi * v).sum(), t[1])[0].abs().max() > 0
    with torch.no_grad():
        assert warp_resample(*[b.requires_grad_(True) for b in base]).grad_fn is None
    gi, gx, gy = warp_resample_backward(w, *base, *needs)
    plain = warp_resample_backward_plain(w, *base)
    for n, a, r in zip(needs, (gi, gx, gy), plain):
        assert (a is None) == (not n)
        if n:
            torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_k1_backward_work_counts_what_is_asked_for():
    """The bound's bytes at the pipeline's shape, (4, 512, 640, 3) -> 500^2:
    12.0 MB of g, 15.7 MB of image read for the maps, 15.7 MB of image
    gradient written, and the maps."""
    B, H, W, C, S = 4, 512, 640, 3, 500
    g, img, maps = 4 * B * S * S * C, 4 * B * H * W * C, 4 * B * 2 * S
    assert roofline.k1_backward_work(B, H, W, C, S, S, True, True) == (
        g + img + img + 2 * maps, B * S * S * C * 24)
    assert roofline.k1_backward_work(B, H, W, C, S, S, True, False)[0] == g + img + maps
    assert roofline.k1_backward_work(B, H, W, C, S, S, False, True)[0] == g + img + 2 * maps
    assert roofline.bound(*roofline.k1_backward_work(B, H, W, C, S, S, True, True),
                          roofline.F32_FLOPS)["bound_by"] == "bytes"
