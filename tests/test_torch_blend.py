"""The port's MOTA mask and device resizes against the JAX package.

- ``mota_mask``: within 1 uint8 LSB. The uint8 mask has two quantization
  points (the truncation before the resize and Pillow's clip between its
  passes), so an f32 difference in the last bit can flip one level.
- ``resize_scale_device``: against ``jax.image.resize(..., "linear")``,
  which antialiases when it downsamples, within 1e-5 on [0, 1] pixels
  (f32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attwarp_tpu.extract.extraction import resize_scale_device as j_resize
from attwarp_tpu.warp import blend as jblend

from attwarp_tpu_torch.extract.resize import resize_scale_device, to01_scale
from attwarp_tpu_torch.warp import blend as tblend


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("quantize", [True, False], ids=["uint8", "float"])
@pytest.mark.parametrize("out_hw", [(64, 80), (56, 48)])
def test_mota_mask_matches_jax(rng, quantize, out_hw):
    att = rng.random((3, 6, 6)).astype(np.float32) ** 3
    att[2] = 0.25                       # constant map: the neutral branch
    ref = np.stack([np.asarray(jblend.mota_mask(
        jnp.asarray(a), out_hw, enhance_coe=10.0, kernel_size=3,
        quantize_like_reference=quantize)) for a in att])
    got = tblend.mota_mask(_t(att), out_hw, enhance_coe=10.0, kernel_size=3,
                           quantize_like_reference=quantize).numpy()
    assert got.shape == ref.shape == (3, *out_hw)
    assert got.dtype == ref.dtype
    diff = np.abs(got.astype(np.float32) - ref.astype(np.float32))
    assert diff.max() <= (1.0 if quantize else 1e-3)


def test_revise_mask_matches_jax(rng):
    """The f32 stage before any quantization: 1e-6 absolute on [0, 1]."""
    att = rng.random((2, 6, 6)).astype(np.float32)
    ref = np.stack([np.asarray(jblend.revise_mask(jnp.asarray(a), 3, 10.0))
                    for a in att])
    got = tblend.revise_mask(_t(att), 3, 10.0).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_matrix_builders_are_copies():
    """The copied numpy matrix builders equal the originals exactly."""
    np.testing.assert_array_equal(tblend._lanczos_matrix_np(24, 77),
                                  jblend._lanczos_matrix_np(24, 77))
    np.testing.assert_array_equal(tblend._box_matrix_np(9, 3),
                                  jblend._box_matrix_np(9, 3))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 96, 80, 3), (56, 56)),     # downsample both axes (antialiased)
    ((2, 60, 56, 3), (64, 56)),     # upsample H, W untouched
    ((1, 72, 64, 3), (96, 48)),     # up in H, down in W
], ids=["down", "up", "mixed"])
def test_resize_matches_jax_image_resize(rng, shape, out_hw):
    img = (rng.random(shape) * 255).astype(np.uint8)
    scale = to01_scale(img)
    ref = np.asarray(j_resize(jnp.asarray(img), jnp.float32(scale), out_hw))
    got = resize_scale_device(_t(img), scale, out_hw).numpy()
    assert got.shape == ref.shape == (shape[0], *out_hw, 3)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_resize_to_same_size_only_scales(rng):
    img = rng.random((1, 20, 30, 3)).astype(np.float32)
    got = resize_scale_device(_t(img), 255.0, (20, 30)).numpy()
    np.testing.assert_array_equal(got, img * np.float32(255.0))


def test_downsample_is_antialiased():
    """A one-pixel checkerboard averages to grey under jax.image.resize's
    antialiasing; plain bilinear interpolation would alias it."""
    board = (np.indices((64, 64)).sum(0) % 2).astype(np.float32)[None, ..., None]
    ref = np.asarray(jax.image.resize(jnp.asarray(board), (1, 16, 16, 1), "linear"))
    got = resize_scale_device(_t(board), 1.0, (16, 16)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.abs(got - 0.5).max() < 0.05
