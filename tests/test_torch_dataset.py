"""The port's dataset driver (``cli.process_dataset``) and the modules under
it against the JAX package, on the same inputs made from numpy seeds.

Tolerances: copied pure-Python modules give equal results; the reader's
maps 1e-5 (f32 resizes in another order) and its answers equal; warps
within the repo's budget 1e-3 on [0, 1] pixels; MOTA masks and warped
uint8 images within 1 LSB (one rounding point apart); JET overlays within
4 LSB (a 1-LSB mask step moves the colormap by up to 4 levels, halved by
the blend, plus the blend's own rounding). On the CPU the K1 wrapper runs
its plain version; the kernel is held against it on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import functools
import glob
import inspect
import json
import os
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from attwarp_tpu.cli.process_dataset import JsonlDataset as JJsonl
from attwarp_tpu.cli.process_dataset import _extract_with_fallback as j_fallback
from attwarp_tpu.cli.process_dataset import process_dataset as j_process_dataset
from attwarp_tpu.data.progress import ProgressManifest as JManifest
from attwarp_tpu.data.textvqa import TextVQADataset as JDataset
from attwarp_tpu.extract.extraction import _resize_for_backend as j_resize_for_backend
from attwarp_tpu.extract.extraction import _to_uint8_rgb as j_to_uint8_rgb
from attwarp_tpu.extract.llava_backend import LlavaBackend as JLlavaBackend
from attwarp_tpu.numerics import pooling as jpool
from attwarp_tpu.testing import reader as jreader
from attwarp_tpu.testing.oracle import warp_image_by_attention_oracle
from attwarp_tpu.utils.colormap import jet_lut_rgb as j_jet
from attwarp_tpu.warp import blend as jblend
from attwarp_tpu.warp import io as jio
from attwarp_tpu.warp.transforms import Transform as JTransform
from attwarp_tpu.warp.transforms import WarpParams as JParams
from attwarp_tpu.warp.warp import warp_image_by_attention as j_warp_image
from tools.make_random_7b_ckpt import build_dry_run_tokenizer

from attwarp_tpu_torch.cli import process_dataset as pd
from attwarp_tpu_torch.data import imageio
from attwarp_tpu_torch.data.progress import ProgressManifest
from attwarp_tpu_torch.data.textvqa import TextVQADataset
from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.resize import resize_for_backend, to_uint8_rgb
from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
from attwarp_tpu_torch.numerics import pooling as tpool
from attwarp_tpu_torch.testing import reader as treader
from attwarp_tpu_torch.utils.colormap import jet_lut_rgb
from attwarp_tpu_torch.warp import blend as tblend
from attwarp_tpu_torch.warp import io as tio
from attwarp_tpu_torch.warp.transforms import Transform, WarpParams
from attwarp_tpu_torch.warp.warp import warp_image_by_attention

from test_torch_llava import models  # noqa: F401  (module-scoped fixture)

PIX_TOL = 1e-3 * 255   # the repo's warp budget: 1e-3 on [0, 1] pixels


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max())


def _pil_png(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im)


# ── the JET table ───────────────────────────────────────────────────────

def test_jet_table_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    gray = np.arange(256, dtype=np.uint8).reshape(256, 1)
    want = cv2.applyColorMap(gray, cv2.COLORMAP_JET).reshape(256, 3)[:, ::-1]
    assert jet_lut_rgb().shape == (256, 3) and jet_lut_rgb().dtype == np.uint8
    np.testing.assert_array_equal(jet_lut_rgb(), want)
    np.testing.assert_array_equal(jet_lut_rgb(), j_jet())


# ── image files through Pillow ──────────────────────────────────────────

SHAPES = [(9, 13), (9, 13, 2), (9, 13, 3), (9, 13, 4)]
COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}     # PNG color type by channel count


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def _filtered_png(px: np.ndarray, filters) -> bytes:
    """A PNG whose rows cycle through ``filters`` (0-4), filtered here from
    the PNG specification's definitions."""
    px = px if px.ndim == 3 else px[..., None]
    h, w, c = px.shape
    x = px.reshape(h, w * c).astype(np.int32)
    prev = np.zeros(w * c, np.int32)
    rows = []
    for y in range(h):
        f = filters[y % len(filters)]
        cur = x[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = 0
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        rows.append(np.concatenate([[f], (cur - pred) % 256]).astype(np.uint8))
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + _chunk(b"IEND", b""))


def _rgb(px: np.ndarray) -> np.ndarray:
    """What ``convert("RGB")`` makes of (H, W) or (H, W, 1-4) pixels: gray
    repeated over three channels, alpha dropped."""
    px = px if px.ndim == 3 else px[..., None]
    return np.repeat(px[..., :1], 3, axis=2) if px.shape[2] < 3 else px[..., :3]


def _read_matches_jax(path, want=None):
    got = imageio.read_rgb(path)
    assert got.dtype == np.uint8 and got.shape[2] == 3
    np.testing.assert_array_equal(got, jio.load_image_rgb(path))
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"c{s[2] if len(s) == 3 else 1}")
def test_png_roundtrip_and_pil_reads_it(shape, rng, tmp_path):
    px = (rng.random(shape) * 256).astype(np.uint8)
    path = str(tmp_path / "x.jpg")           # written as PNG whatever the name
    imageio.write_png(path, px)
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(_pil_png(path), px)
    _read_matches_jax(path, _rgb(px))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"c{s[2] if len(s) == 3 else 1}")
def test_png_decodes_every_row_filter(shape, rng, tmp_path):
    px = (rng.random(shape) * 256).astype(np.uint8)
    path = tmp_path / "filtered.png"
    path.write_bytes(_filtered_png(px, [0, 1, 2, 3, 4, 4, 3, 1]))
    with Image.open(path) as im:                     # the test encoder is right
        np.testing.assert_array_equal(np.asarray(im), px)
    _read_matches_jax(str(path), _rgb(px))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reads_pil_written_files(mode, rng, tmp_path):
    """Pillow picks each row's filter itself; smooth content makes it use
    the predicting ones. The port's ``write_png`` writes the same bytes as
    the JAX driver's ``Image.fromarray(...).save``."""
    n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    yy, xx = np.mgrid[0:31, 0:37]
    smooth = (yy * 3 + xx * 5)[..., None] + 40 * np.arange(n)
    px = np.clip(smooth + rng.integers(0, 3, smooth.shape), 0, 255).astype(np.uint8)
    px = px[..., 0] if n == 1 else px
    path = str(tmp_path / "pil.png")
    Image.fromarray(px, mode).save(path)
    _read_matches_jax(path, _rgb(px))
    imageio.write_png(str(tmp_path / "port.png"), px)
    assert open(tmp_path / "port.png", "rb").read() == open(path, "rb").read()


def test_jpeg_goes_through_pillow_and_raises_without_it(rng, tmp_path, monkeypatch):
    px = (rng.random((20, 24, 3)) * 255).astype(np.uint8)
    path = str(tmp_path / "scene.jpg")
    Image.fromarray(px).save(path, quality=95)
    with Image.open(path) as im:
        _read_matches_jax(path, np.asarray(im.convert("RGB")))
    with open(tmp_path / "d.json", "w") as f:
        json.dump({"data": [{"image_id": "scene", "question": "q"}]}, f)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(imageio.MissingPillowError, match=r"scene\.jpg.*Pillow"):
        imageio.read_rgb(path)
    with pytest.raises(imageio.MissingPillowError, match=r"out\.png.*Pillow"):
        imageio.write_png(str(tmp_path / "out.png"), px)
    assert not os.path.exists(tmp_path / "out.png")
    with pytest.raises(imageio.MissingPillowError):     # not skipped as unreadable
        TextVQADataset(str(tmp_path / "d.json"), str(tmp_path))[0]


# ── copies of pure-Python modules ───────────────────────────────────────

def test_progress_manifest_copy_matches(tmp_path):
    ours, theirs = ProgressManifest(str(tmp_path / "t.json")), JManifest(str(tmp_path / "j.json"))
    for m in (ours, theirs):
        m.mark(3)
        m.mark(1, failed=True)
        m.mark_many([7, 5])
    assert json.load(open(tmp_path / "t.json")) == json.load(open(tmp_path / "j.json"))
    assert ours.remaining(9) == theirs.remaining(9)
    again = ProgressManifest(str(tmp_path / "j.json"))
    assert (again.processed_internal_indices, again.processed_count, again.failed_count) == \
        (theirs.processed_internal_indices, 3, 1)


@pytest.mark.parametrize("geometry,seed", [("center", 0), ("center", 5), ("hard", 2)])
def test_reader_scenes_bit_equal(geometry, seed):
    make_t = {"center": treader.make_scene, "hard": treader.make_scene_hard}[geometry]
    make_j = {"center": jreader.make_scene, "hard": jreader.make_scene_hard}[geometry]
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        (it, at, bt), (ij, aj, bj) = make_t(rt), make_j(rj)
        np.testing.assert_array_equal(it, ij)
        assert (at, bt) == (aj, bj)


def test_reader_maps_and_answers_match():
    """On the same 128 px views, of both scene geometries and of warped
    scenes. (The resize before the reader is held to JAX's in
    ``test_resize_for_backend_and_uint8_match_jax``: a last-bit difference
    there can move a pixel across the reader's contrast threshold.)"""
    rng = np.random.default_rng(3)
    scenes = [jreader.make_scene(rng)[0] for _ in range(3)]
    scenes += [jreader.make_scene_hard(rng)[0] for _ in range(3)]
    views = np.stack([j_resize_for_backend(s, 128) for s in scenes])
    mt, tt = treader.ReaderBackend().extract(views, ["q"] * 6)
    mj, tj = jreader.ReaderBackend().extract(views, ["q"] * 6)
    assert mt.shape == mj.shape == (6, 32, 32)
    np.testing.assert_allclose(mt, mj, atol=1e-5)
    assert tt == tj


def test_reader_feature_extractor_matches():
    rng = np.random.default_rng(4)
    imgs = np.stack([jreader.make_scene(rng, src=256)[0] for _ in range(2)])
    ft, fj = treader.ReaderFeatureExtractor(), jreader.ReaderFeatureExtractor()
    np.testing.assert_allclose(ft.visual_tokens(imgs), fj.visual_tokens(imgs), atol=1e-5)
    texts = ["what is the code on the tag?", "", "a b c " * 8]
    for a, b in zip(ft.text_tokens(texts), fj.text_tokens(texts)):
        np.testing.assert_array_equal(a, b)


def test_textvqa_writer_and_dataset_match_jax(tmp_path):
    """The port writes the same JSON and the same JPEG files (quality 95)
    as JAX; both dataset classes read the same samples from them."""
    jt, dt = treader.write_textvqa_dataset(str(tmp_path / "t"), n=3, seed=1, src=256)
    jj, dj = jreader.write_textvqa_dataset(str(tmp_path / "j"), n=3, seed=1, src=256)
    assert json.load(open(jt)) == json.load(open(jj))
    assert sorted(os.listdir(dt)) == sorted(os.listdir(dj))
    for name in os.listdir(dj):
        raw = open(os.path.join(dt, name), "rb").read()
        assert raw[:2] == b"\xff\xd8" and raw == open(os.path.join(dj, name), "rb").read()
    data = json.load(open(jt))
    data["data"].append({"image_id": "missing", "question": "q"})
    with open(jt, "w") as f:
        json.dump(data, f)
    ours, theirs = TextVQADataset(jt, dt), JDataset(jt, dt)
    assert ours.metadata == theirs.metadata and len(ours) == len(theirs) == 4
    for i in range(4):
        a, b = ours[i], theirs[i]
        assert {k: v for k, v in a.items() if k != "loaded_image"} == \
            {k: v for k, v in b.items() if k != "loaded_image"}
        if b["loaded_image"] is None:
            assert a["loaded_image"] is None
        else:
            np.testing.assert_array_equal(a["loaded_image"], b["loaded_image"])
    assert TextVQADataset(str(tmp_path / "none.json")).samples == []


def test_jsonl_dataset_matches_jax(rng, tmp_path):
    img = (rng.random((20, 30, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "a.png")
    lines = [{"image_path": str(tmp_path / "a.png"), "question": "q1", "answers": ["x"]},
             {"image_path": str(tmp_path / "gone.png"), "question": "q2"},
             {"question": "q3"}]
    path = tmp_path / "in.jsonl"
    path.write_text("\n".join(json.dumps(x) for x in lines) + "\n{broken\n")
    ours, theirs = pd.JsonlDataset(str(path)), JJsonl(str(path))
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert {k: v for k, v in a.items() if k != "loaded_image"} == \
            {k: v for k, v in b.items() if k != "loaded_image"}
        assert (a["loaded_image"] is None) == (b["loaded_image"] is None)
    np.testing.assert_array_equal(ours[0]["loaded_image"], img)


# ── numerics and resizes ────────────────────────────────────────────────

@pytest.mark.parametrize("in_hw,out_hw", [((128, 128), (24, 24)), ((37, 50), (7, 11)),
                                          ((24, 24), (24, 24))])
def test_adaptive_pooling_matches_jax(in_hw, out_hw, rng):
    x = rng.standard_normal((2, 3, *in_hw)).astype(np.float32)
    got = tpool.adaptive_avg_pool2d(torch.as_tensor(x), out_hw).numpy()
    np.testing.assert_allclose(got, np.asarray(jpool.adaptive_avg_pool2d(jnp.asarray(x), out_hw)),
                               atol=1e-5)
    got = tpool.adaptive_avg_pool1d(torch.as_tensor(x), out_hw[1]).numpy()
    np.testing.assert_allclose(got, np.asarray(jpool.adaptive_avg_pool1d(jnp.asarray(x), out_hw[1])),
                               atol=1e-5)
    y = rng.random((3, out_hw[1])).astype(np.float32)
    got = tpool.upsample_pdf_right_inverse(torch.as_tensor(y), in_hw[1]).numpy()
    want = np.asarray(jpool.upsample_pdf_right_inverse(jnp.asarray(y), in_hw[1]))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # the right inverse pools back to its input
    back = tpool.adaptive_avg_pool1d(torch.as_tensor(got), out_hw[1]).numpy()
    np.testing.assert_allclose(back, y, atol=1e-4)


def test_resize_for_backend_and_uint8_match_jax(rng):
    ims = [(rng.random((48, 64, 3)) * 255).astype(np.uint8),
           rng.random((48, 64, 3)).astype(np.float32),
           (rng.random((40, 40, 3)) * 255).astype(np.float32),
           rng.random((28, 28, 3)).astype(np.float32),
           rng.integers(-20, 300, (5, 6, 3))]
    for im in ims:
        got = resize_for_backend(im, 28)
        assert got.dtype == np.float32 and got.shape == (28, 28, 3)
        np.testing.assert_allclose(got, j_resize_for_backend(im, 28), atol=1e-5)
        np.testing.assert_array_equal(to_uint8_rgb(im), j_to_uint8_rgb(im))


# ── the single-image warp, the mask blend and the warp IO ──────────────

@pytest.mark.parametrize("name", ["identity", "sqrt", "exp"])
def test_warp_image_by_attention_matches_jax_and_oracle(name, rng):
    img = (rng.random((40, 52, 3)) * 255).astype(np.float32)
    att = rng.random((40, 52)).astype(np.float32) ** 3
    got = warp_image_by_attention(torch.as_tensor(img), torch.as_tensor(att), 60, 45,
                                  WarpParams(transform=Transform.from_name(name))).numpy()
    want = np.asarray(j_warp_image(jnp.asarray(img), jnp.asarray(att), 60, 45,
                                   JParams(transform=JTransform.from_name(name))))
    oracle = warp_image_by_attention_oracle(img, att, 60, 45, transform=name)
    assert got.shape == want.shape == (45, 60, 3)
    assert np.abs(got - want).max() <= PIX_TOL
    assert np.abs(got - oracle).max() <= PIX_TOL
    gray = warp_image_by_attention(torch.as_tensor(img[..., 0]), torch.as_tensor(att), 60, 45)
    assert gray.shape == (45, 60)
    assert np.abs(gray.numpy() - np.asarray(
        j_warp_image(jnp.asarray(img[..., 0]), jnp.asarray(att), 60, 45))).max() <= PIX_TOL


@pytest.mark.parametrize("grayscale", [0.0, 0.3])
def test_blend_mask_matches_jax(grayscale, rng):
    img = (rng.random((48, 64, 3)) * 255).astype(np.uint8)
    att = rng.random((24, 24)).astype(np.float32)
    ov_t, m_t = tblend.blend_mask(img, att, 10.0, 3, grayscale, device="cpu")
    ov_j, m_j = jblend.blend_mask(img, jnp.asarray(att), 10.0, 3, grayscale)
    m_j = np.asarray(m_j)
    assert m_t.shape == m_j.shape == (48, 64) and m_t.dtype == m_j.dtype == np.uint8
    assert ov_t.shape == ov_j.shape and ov_t.dtype == np.uint8
    assert _lsb(m_t, m_j) <= 1
    assert _lsb(ov_t, ov_j) <= 4
    # a tensor map gives the same result
    ov2, m2 = tblend.blend_mask(img, torch.as_tensor(att), 10.0, 3, grayscale, device="cpu")
    np.testing.assert_array_equal(m2, m_t)
    np.testing.assert_array_equal(ov2, ov_t)
    np.testing.assert_array_equal(tblend.merge_gray(m_t, img), jblend.merge_gray(m_t, img))
    x = rng.random((50,)).astype(np.float32) * 300 - 20
    x[:3] = [2.5, 3.5, -0.5]                      # ties round half to even
    np.testing.assert_array_equal(tblend.quantize_uint8_round(torch.as_tensor(x)).numpy(),
                                  np.asarray(jblend.quantize_uint8_round(jnp.asarray(x))))


def test_warp_io_helpers_match_jax(rng, tmp_path):
    a2 = rng.random((10, 12)).astype(np.float32)
    pil = Image.fromarray((a2 * 255).astype(np.uint8))
    for att in (a2, rng.random((10, 12, 3)).astype(np.float32), pil, [a2], a2[None, None]):
        np.testing.assert_allclose(tio.coerce_att_map(att), jio.coerce_att_map(att), atol=1e-6)
    np.testing.assert_array_equal(tio.coerce_att_map([], (5, 7)), jio.coerce_att_map([], (5, 7)))
    with pytest.raises(ValueError):
        tio.coerce_att_map(rng.random((2, 3, 4, 5)))
    img = (rng.random((30, 40, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tio.load_image_rgb(Image.fromarray(img).convert("L")),
                                  jio.load_image_rgb(Image.fromarray(img).convert("L")))
    np.testing.assert_array_equal(tio.load_image_rgb(img * 1.0), jio.load_image_rgb(img * 1.0))
    att = rng.random((15, 20)).astype(np.float32)
    r_t = tio.resize_image_to_match_attmap(img, att)
    assert r_t.shape == (15, 20, 3) and _lsb(r_t, jio.resize_image_to_match_attmap(img, att)) <= 1
    for a, alpha in ((att, 0.4), (np.ones((30, 40), np.float32), 0.5)):
        assert _lsb(tio.attention_overlay(img, a, alpha), jio.attention_overlay(img, a, alpha)) <= 4
    assert tio.next_run_dir(str(tmp_path / "runs")).endswith("run_0")
    assert tio.next_run_dir(str(tmp_path / "runs")).endswith("run_1")


def test_save_warped_image_matches_jax(rng, tmp_path):
    src = str(tmp_path / "in.png")
    Image.fromarray((rng.random((40, 50, 3)) * 255).astype(np.uint8)).save(src)
    att = rng.random((20, 25)).astype(np.float32)       # the image is resized to it
    outs = {}
    for tag, fn in (("t", functools.partial(tio.save_warped_image, device="cpu")),
                    ("j", jio.save_warped_image)):
        d = tmp_path / tag
        d.mkdir()
        assert fn(image_path=src, att_map=att, original_image_save_path=str(d / "orig.png"),
                  masked_overlay_save_path=str(d / "overlay.png"),
                  output_path=str(d / "warped.png"), vis_path=str(d / "vis.png"),
                  width=60, height=45, transform="sqrt")
        outs[tag] = {f: _pil_png(d / f) for f in ("orig.png", "overlay.png", "warped.png",
                                                   "vis.png")}
    t, j = outs["t"], outs["j"]
    np.testing.assert_array_equal(t["orig.png"], j["orig.png"])
    assert _lsb(t["overlay.png"], j["overlay.png"]) <= 4
    assert t["warped.png"].shape == (45, 60, 3) and _lsb(t["warped.png"], j["warped.png"]) <= 1
    assert t["vis.png"].shape == j["vis.png"].shape
    assert not tio.save_warped_image(image_path=str(tmp_path / "missing.png"), att_map=att,
                                     original_image_save_path=None,
                                     masked_overlay_save_path=None,
                                     output_path=str(tmp_path / "x.png"), device="cpu")


def test_warp_entry_points_default_to_the_card(rng, tmp_path):
    # the mask and the warp run on the card unless the caller asks for the
    # CPU; without a card the default raises, it never falls back
    for fn in (tblend.blend_mask, tio.save_warped_image):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        img = (rng.random((16, 16, 3)) * 255).astype(np.uint8)
        att = rng.random((8, 8)).astype(np.float32)
        with pytest.raises(RuntimeError, match="blend_mask: no CUDA device"):
            tblend.blend_mask(img, att)
        with pytest.raises(RuntimeError, match="save_warped_image: no CUDA device"):
            tio.save_warped_image(img, att, None, None, str(tmp_path / "w.png"))
        assert not os.path.exists(tmp_path / "w.png")

# ── the driver ──────────────────────────────────────────────────────────

class Recording:
    """Delegates to a backend and records the batch size and texts of every
    ``extract`` call."""

    def __init__(self, backend):
        self.backend = backend
        self.calls = []

    def __getattr__(self, name):
        return getattr(self.backend, name)

    def extract(self, images, questions, max_new_tokens=20):
        maps, texts = self.backend.extract(images, questions, max_new_tokens=max_new_tokens)
        self.calls.append((len(questions), list(texts)))
        return maps, texts


def _tree(root):
    return sorted(os.path.relpath(p, root)
                  for p in glob.glob(os.path.join(root, "**", "*"), recursive=True))


def _compare_outputs(t_root, j_root, map_tol=1e-5):
    """The two drivers' artifact trees against each other."""
    assert _tree(t_root) == _tree(j_root)
    metas = sorted(glob.glob(os.path.join(j_root, "metadata", "*.json")))
    assert metas
    for mj_path in metas:
        mj = json.load(open(mj_path))
        mt = json.load(open(os.path.join(t_root, "metadata", os.path.basename(mj_path))))
        assert mt.keys() == mj.keys()
        assert {k: v for k, v in mt.items() if k not in ("saved_paths", "api_model_name")} == \
            {k: v for k, v in mj.items() if k not in ("saved_paths", "api_model_name")}
        assert mt["saved_paths"].keys() == mj["saved_paths"].keys()
        p_t, p_j = mt["saved_paths"], mj["saved_paths"]
        for key, pj in p_j.items():
            assert pj is not None and os.path.relpath(p_t[key], t_root) == \
                os.path.relpath(pj, j_root), key
        np.testing.assert_allclose(np.load(p_t["raw_attention_map_npy"]),
                                   np.load(p_j["raw_attention_map_npy"]), atol=map_tol)
        m_t, m_j = np.load(p_t["mota_mask_npy"]), np.load(p_j["mota_mask_npy"])
        assert m_t.dtype == m_j.dtype == np.uint8 and _lsb(m_t, m_j) <= 1
        np.testing.assert_array_equal(_pil_png(p_t["mota_mask_visualization"]), m_t)
        np.testing.assert_array_equal(_pil_png(p_t["original_image"]),
                                      _pil_png(p_j["original_image"]))
        assert _lsb(_pil_png(p_t["attention_map_image_from_api"]),
                    _pil_png(p_j["attention_map_image_from_api"])) <= 1
        assert _lsb(_pil_png(p_t["masked_image"]), _pil_png(p_j["masked_image"])) <= 4
        w_t, w_j = _pil_png(p_t["warped_image_identity"]), _pil_png(p_j["warped_image_identity"])
        assert w_t.shape == w_j.shape and _lsb(w_t, w_j) <= 1


@pytest.fixture(scope="module")
def reader_runs(tmp_path_factory):
    """Six code-tag scenes (the port's writer) through both drivers with the
    reader, in chunks of 4 (one full, one partial). Both readers get JAX's
    128 px views: the reader's local contrast (a variance by E[x^2] -
    E[x]^2 in f32) turns the last-bit differences of two resizes into map
    differences above 1e-5, and the port's resize is held to JAX's on its
    own (``test_resize_for_backend_and_uint8_match_jax``)."""
    root = tmp_path_factory.mktemp("reader_runs")
    json_path, image_dir = treader.write_textvqa_dataset(str(root / "data"), n=6, seed=3)
    j_process_dataset(json_path, image_dir, str(root / "jax"), jreader.ReaderBackend(),
                      batch_size=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd, "resize_for_backend", j_resize_for_backend)
        stats = pd.process_dataset(json_path, image_dir, str(root / "torch"),
                                   treader.ReaderBackend(), batch_size=4, device="cpu")
    return root, json_path, image_dir, stats


def test_process_dataset_reader_matches_jax(reader_runs):
    root, _, _, stats = reader_runs
    assert stats == {"processed": 6, "failed": 0}
    assert len(os.listdir(root / "torch" / "metadata")) == 6
    assert {d for d in os.listdir(root / "torch")} == set(pd.ARTIFACT_DIRS)
    _compare_outputs(str(root / "torch"), str(root / "jax"))


def test_process_dataset_resumes_with_nothing_left(reader_runs, capsys):
    root, json_path, image_dir, _ = reader_runs
    be = Recording(treader.ReaderBackend())
    stats = pd.process_dataset(json_path, image_dir, str(root / "torch"), be,
                               batch_size=4, device="cpu")
    assert stats == {"processed": 6, "failed": 0} and be.calls == []
    assert "Processing 0 of 6 samples." in capsys.readouterr().out


class Flaky:
    """The reader, failing every batch wider than one and every sample whose
    question says so."""

    num_patches_side = 32
    image_size = 128

    def extract(self, images, questions, max_new_tokens=20):
        if len(questions) > 1 or "fail" in questions[0]:
            raise RuntimeError("injected extraction failure")
        return jreader.ReaderBackend().extract(np.asarray(images), questions)


def test_extract_fallback_ladder_matches_jax(rng):
    views = np.stack([j_resize_for_backend(jreader.make_scene(rng)[0], 128) for _ in range(3)])
    qs = ["q", "fail here", "q"]
    mt, tt = pd._extract_with_fallback(Flaky(), views, qs, 20)
    mj, tj = j_fallback(Flaky(), views, qs, 20)
    np.testing.assert_allclose(mt, mj, atol=1e-5)
    assert tt == tj and tt[1] == ""
    np.testing.assert_array_equal(mt[1], np.full((32, 32), 1 / 32**2, np.float32))


def test_process_dataset_llava_matches_jax(models, tmp_path):  # noqa: F811
    """A tiny LLaVA with the int8 KV cache on both sides (weights through
    ``params_from_jax``): every batch's texts equal, maps within 1e-5."""
    jm, tm = models
    jbe = Recording(JLlavaBackend(jm, tokenizer=build_dry_run_tokenizer(), extract_layer=1,
                                  kv_quant=True))
    tbe = Recording(LlavaBackend(tm, tokenizer=DryRunTokenizer(), extract_layer=1,
                                 kv_quant=True))
    json_path, image_dir = treader.write_textvqa_dataset(str(tmp_path / "data"), n=3,
                                                         seed=2, src=192)
    kw = dict(batch_size=2, max_new_tokens=3, width=64, height=48)
    j_process_dataset(json_path, image_dir, str(tmp_path / "jax"), jbe, **kw)
    jax.effects_barrier()
    stats = pd.process_dataset(json_path, image_dir, str(tmp_path / "torch"), tbe, **kw)
    assert stats == {"processed": 3, "failed": 0}
    assert tbe.calls == jbe.calls and [n for n, _ in tbe.calls] == [2, 1]
    _compare_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    meta = json.load(open(glob.glob(str(tmp_path / "torch" / "metadata" / "*.json"))[0]))
    assert meta["api_model_name"] == "llava-torch"
    assert np.load(meta["saved_paths"]["raw_attention_map_npy"]).shape == (1, 1, 4, 4)


def test_process_dataset_cli_main(tmp_path, capsys):
    json_path, image_dir = treader.write_textvqa_dataset(str(tmp_path / "data"), n=2, seed=4)
    out = str(tmp_path / "out")
    args = ["--textvqa-json", json_path, "--image-dir", image_dir, "--output-dir", out,
            "--batch-size", "2", "--width", "64", "--height", "64"]
    assert pd.main(args + ["--backend", "reader", "--device", "cpu"]) == 0
    assert "Done. processed=2 failed=0" in capsys.readouterr().out
    assert len(os.listdir(os.path.join(out, "warped_images"))) == 2
    assert pd.build_parser().parse_args(args + ["--backend", "reader"]).device == "cuda"
    assert pd.build_parser().parse_args(args).backend == "mini"   # JAX's default
    if not torch.cuda.is_available():                 # no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pd.main(args[:5] + [str(tmp_path / "out2")] + args[6:] + ["--backend", "reader"])
