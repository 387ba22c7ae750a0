"""The port's warp engine (``attwarp_tpu_torch.warp`` and kernel K1's plain
version) against the JAX package and the NumPy/cv2 oracle.

Inputs come from a numpy seed and go through both packages. On the CPU the
K1 wrapper runs its plain version; the CUDA kernel itself is compared with
that plain version on the card (``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attwarp_tpu.ops.pallas_warp import warp_batch_by_attention_pallas
from attwarp_tpu.testing.oracle import warp_image_by_attention_oracle
from attwarp_tpu.warp import grid as jgrid
from attwarp_tpu.warp import transforms as jtr
from attwarp_tpu.warp.resample import remap_bilinear_separable as j_remap
from attwarp_tpu.warp.warp import warp_batch_by_attention as j_warp_batch

from attwarp_tpu_torch.kernels.warp_resample import (
    BAND_ROWS,
    BLOCK_BUDGET,
    BLOCKS_PER_SM,
    MAX_ROWS,
    MAX_SLOTS,
    SMEM_BLOCK,
    THREADS,
    k1_plan,
    k1_smem,
    warp_resample,
)
from attwarp_tpu_torch.warp import grid as tgrid
from attwarp_tpu_torch.warp import transforms as ttr
from attwarp_tpu_torch.warp.resample import remap_bilinear_separable
from attwarp_tpu_torch.warp.warp import warp_batch_by_attention

PIX_TOL = 1e-3 * 255   # the repo's warp budget: 1e-3 on [0, 1] pixels
TRANSFORMS = list(ttr.Transform)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _params(tr, inverse):
    kw = dict(exp_scale=2.5, exp_divisor=3.0) if tr.value == "exp" else {}
    return (jtr.WarpParams(transform=jtr.Transform(tr.value),
                           apply_inverse_to_marginals=inverse, **kw),
            ttr.WarpParams(transform=tr, apply_inverse_to_marginals=inverse, **kw))


def test_transform_copies_match_jax():
    """The copied enum and dataclass equal the originals."""
    assert [t.value for t in ttr.Transform] == [t.value for t in jtr.Transform]
    for name in ("EXP", "nope", "Sqrt"):
        assert ttr.Transform.from_name(name).value == jtr.Transform.from_name(name).value
    jf = {f.name: f.default for f in dataclasses.fields(jtr.WarpParams)}
    tf = {f.name: f.default for f in dataclasses.fields(ttr.WarpParams)}
    assert {k: getattr(v, "value", v) for k, v in jf.items()} == \
        {k: getattr(v, "value", v) for k, v in tf.items()}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tr", TRANSFORMS, ids=lambda t: t.value)
def test_grid_maps_match_jax(rng, tr, inverse):
    """Profiles, totals and inverse maps for every transform, batched in the
    port against JAX vmapped. f32 on both sides; 2e-5 relative covers
    reduction-order differences of the sums and cumsums.

    The values lie below and above 1, so LOG gives marginals of both signs
    and non-monotone knots: there np.interp is undefined and both packages
    take the mean over the segments that contain a target."""
    jp, tp = _params(tr, inverse)
    att = (rng.random((3, 6, 9)) * 4).astype(np.float32)
    att[1, :, 2] = 0.0      # zero column: near-tied knots
    jout = jax.vmap(lambda a: jgrid.attention_profiles(a, jp))(jnp.asarray(att))
    tout = tgrid.attention_profiles(_t(att), tp)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5, atol=1e-6)
    for axis, n_out in ((0, 40), (1, 33)):
        jm = jax.vmap(lambda p, s: jgrid.inverse_axis_map(p, s, n_out))(
            jout[axis], jout[2 + axis])
        tm = tgrid.inverse_axis_map(tout[axis], tout[2 + axis], n_out)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-4)


def test_degenerate_map_takes_fallback():
    """LOG of an all-zero map gives negative totals: both packages take the
    degenerate fallback (ones profiles, reference totals)."""
    jp, tp = _params(ttr.Transform.LOG, False)
    att = np.zeros((5, 7), np.float32)
    jout = jgrid.attention_profiles(jnp.asarray(att), jp)
    tout = tgrid.attention_profiles(_t(att), tp)
    np.testing.assert_array_equal(tout[0].numpy(), np.ones(7, np.float32))
    np.testing.assert_array_equal(tout[1].numpy(), np.ones(5, np.float32))
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_piecewise_linear_inverse_equals_np_interp_with_ties():
    """== np.interp (and the JAX form) for monotone knots with ties,
    below-range and at-end targets. Exact f32 arithmetic on both sides: 1e-5
    absolute."""
    knots = np.array([0.0, 0.0, 1.5, 1.5, 1.5, 4.25, 7.0, 7.0, 9.0, 12.0],
                     np.float32)
    out_len = 12
    ref = np.interp(np.arange(out_len), knots, np.arange(knots.size))
    got = tgrid.piecewise_linear_inverse(_t(knots), out_len).numpy()
    jx = np.asarray(jgrid.piecewise_linear_inverse(jnp.asarray(knots), out_len))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, jx, atol=1e-5)
    shifted = knots + 0.5                       # t=0 lies below the first knot
    ref2 = np.interp(np.arange(out_len), shifted, np.arange(knots.size))
    got2 = tgrid.piecewise_linear_inverse(_t(shifted), out_len).numpy()
    np.testing.assert_allclose(got2, ref2, atol=1e-5)


def test_plain_resample_matches_jax_gather(rng):
    """K1's plain version, batched, == JAX's gather remap per image, with
    coordinates outside the image (border replicate), on [0, 255] pixels:
    the same f32 ops, so 1e-4 absolute."""
    B, H, W = 2, 20, 30
    img = (rng.random((B, H, W, 3)) * 255).astype(np.float32)
    mx = rng.uniform(-1.5, W + 1.0, (B, 37)).astype(np.float32)
    my = rng.uniform(-1.5, H + 1.0, (B, 23)).astype(np.float32)
    got = remap_bilinear_separable(_t(img), _t(mx), _t(my)).numpy()
    ref = np.stack([np.asarray(j_remap(jnp.asarray(img[b]), jnp.asarray(mx[b]),
                                       jnp.asarray(my[b]))) for b in range(B)])
    assert got.shape == (B, 23, 37, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_warp_resample_wrapper_on_cpu_runs_plain(rng):
    """A CPU tensor takes the plain version and launches nothing."""
    img = _t((rng.random((1, 8, 8, 3)) * 255).astype(np.float32))
    mx = _t(rng.uniform(0, 8, (1, 5)).astype(np.float32))
    my = _t(rng.uniform(0, 8, (1, 6)).astype(np.float32))
    before = warp_resample.launches
    out = warp_resample(img, mx, my)
    assert warp_resample.launches == before
    torch.testing.assert_close(out, remap_bilinear_separable(img, mx, my),
                               rtol=0, atol=0)


def test_c_entry_points_match_their_argtypes():
    """Each ``extern "C"`` entry point in ``csrc/`` takes as many
    parameters, pointers where pointers are declared, as ``_build`` tells
    ``ctypes``: a shorter list would pass the trailing stream pointer as a
    32-bit int."""
    import ctypes
    import re

    from attwarp_tpu_torch.kernels import _build

    found = {}
    for src in _build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [("*" in p) for p in params.split(",")]
    assert found.keys() == _build._SIGNATURES.keys()
    for name, pointers in found.items():
        assert [t is ctypes.c_void_p for t in _build._SIGNATURES[name]] == pointers, name


# (B, H, W, C, H_out, W_out): the timed shapes, rows that are not 16-byte
# multiples (C=1, W=131; a 683-wide RGB photo), single pixels, rows too wide for two staged rows
# (column tiles), a tiny image at large B, a far minified map, a magnified one
K1_SHAPES = {
    "pipeline": (4, 512, 640, 3, 500, 500),
    "driver": (1, 512, 512, 3, 500, 500),
    "warp_only": (128, 336, 336, 3, 336, 336),
    "c1_w131": (3, 97, 131, 1, 64, 200),
    "photo_683w": (1, 1024, 683, 3, 500, 500),
    "pixel": (2, 9, 13, 3, 1, 1),
    "tiled_4k": (1, 4096, 4096, 4, 4096, 4096),
    "tiled_wide": (2, 64, 5000, 3, 64, 4000),
    "tiny_b1000": (1000, 8, 8, 3, 8, 8),
    "minified": (1, 100, 100000, 1, 10, 4),
    "magnified": (8, 256, 256, 1, 2048, 3000),
}


@pytest.mark.parametrize("shape", K1_SHAPES.values(), ids=K1_SHAPES.keys())
def test_k1_plan(shape):
    """The launch plan on the H100's 132 SMs: the shared memory the kernel
    lays out, within the 227 KB a block may use; a grid that covers the
    output; whole staged rows where two fit in half an SM's shared memory,
    column tiles otherwise; about ``BLOCKS_PER_SM`` blocks per SM where the
    output has the rows (the dataset driver's B=1 takes one row a block).
    The plan is immutable: ``k1_plan`` caches it for every later launch."""
    B, H, W, C, H_out, W_out = shape
    p = k1_plan(*shape, 132)
    assert p.smem == k1_smem(p.rows, p.tile, C, p.slots, p.cap) <= SMEM_BLOCK
    assert 1 <= p.rows <= min(BAND_ROWS, MAX_ROWS) and p.threads == THREADS
    assert (p.tiles - 1) * p.tile < W_out <= p.tiles * p.tile
    assert p.blocks == B * -(-H_out // p.rows) * p.tiles
    assert 2 <= p.slots <= min(MAX_SLOTS, 2 * p.rows, 3) and p.cap % 4 == 0
    whole_fits = k1_smem(MAX_ROWS, W_out, C, 2, -(-W * C // 4) * 4) <= BLOCK_BUDGET
    if whole_fits:
        assert p.tiles == 1 and p.cap >= W * C          # whole rows staged
    else:
        assert p.tile % 4 == 0 and p.smem <= BLOCK_BUDGET and p.cap < W * C
    if W * C * 4 > 64 * 1024:                           # two rows above half an SM
        assert not whole_fits and (p.tiles > 1 or W_out <= 4)
    if B * H_out * p.tiles >= BLOCKS_PER_SM * 132:
        assert p.blocks >= 0.75 * BLOCKS_PER_SM * 132 or p.rows == BAND_ROWS
    with pytest.raises(AttributeError):
        p.slots = 0
    assert k1_plan(*shape, 132) is p
    expect = {"pipeline": (4, 2, 500), "driver": (1, 2, 500), "warp_only": (4, 3, 10752),
              "tiled_4k": (4, 2, 5120), "photo_683w": (1, 2, 500)}
    name = next(k for k, v in K1_SHAPES.items() if v == shape)
    if name in expect:
        assert (p.rows, p.slots, p.blocks) == expect[name]


@pytest.mark.parametrize("att_hw", [(64, 80), (8, 10)], ids=["same-res", "low-res"])
def test_warp_batch_matches_jax_gather(rng, att_hw):
    """warp_batch_by_attention == JAX's gather path within the pixel
    budget, for image-resolution and coarser attention."""
    B = 3
    img = (rng.random((B, 64, 80, 3)) * 255).astype(np.float32)
    att = rng.random((B, *att_hw)).astype(np.float32) ** 2
    got = warp_batch_by_attention(_t(img), _t(att), 72, 56).numpy()
    ref = np.asarray(j_warp_batch(jnp.asarray(img), jnp.asarray(att), 72, 56,
                                  method="gather"))
    assert got.shape == ref.shape == (B, 56, 72, 3)
    assert np.max(np.abs(got - ref)) <= PIX_TOL


def test_warp_batch_matches_pallas_interpret(rng):
    """Against the TPU kernel K1 itself in interpret mode, run as one jitted
    dispatch blocked before anything else dispatches (the suite-hang rule of
    tests/test_pallas_warp.py)."""
    B = 2
    img = (rng.random((B, 48, 48, 3)) * 255).astype(np.float32)
    att = rng.random((B, 8, 8)).astype(np.float32)
    fn = jax.jit(lambda i, a: warp_batch_by_attention_pallas(
        i, a, 40, 32, interpret=True))
    ref = np.asarray(jax.block_until_ready(fn(jnp.asarray(img), jnp.asarray(att))))
    got = warp_batch_by_attention(_t(img), _t(att), 40, 32).numpy()
    assert np.max(np.abs(got - ref)) <= PIX_TOL


@pytest.mark.parametrize("transform", ["identity", "sqrt", "exp"])
def test_warp_matches_oracle(rng, transform):
    """Against the NumPy/cv2 oracle (float64 profiles + cv2.remap)."""
    img = (rng.random((40, 48, 3)) * 255).astype(np.float32)
    att = (rng.random((40, 48)) * 3).astype(np.float32)
    tp = ttr.WarpParams(transform=ttr.Transform(transform))
    got = warp_batch_by_attention(_t(img[None]), _t(att[None]), 48, 40, tp)[0]
    ref = warp_image_by_attention_oracle(img, att, 48, 40, transform=transform)
    assert np.max(np.abs(got.numpy() - ref)) <= PIX_TOL


def test_port_never_imports_jax():
    """The port's modules, kernels and pipeline import no JAX."""
    code = ("import attwarp_tpu_torch.pipeline, attwarp_tpu_torch.kernels.decode_attn, "
            "attwarp_tpu_torch.kernels.flash_prefill, attwarp_tpu_torch.extract.tokenizer, "
            "attwarp_tpu_torch.extract.qwen2vl_backend, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
