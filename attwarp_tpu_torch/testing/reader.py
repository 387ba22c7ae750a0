"""Resolution-limited "reader" proxy MLLM + synthetic code-tag VQA scenes
(a copy of ``attwarp_tpu/testing/reader.py``, which the port may not import;
``tests/test_torch_dataset.py`` pins the scenes bit-equal and the maps and
answers to the original's).

One change: resizes and pooling go through the port's
``extract/resize.py`` and ``numerics/pooling.py``.

Closes the accuracy-gain evidence chain (BASELINE target 3) as far as a
zero-egress environment allows: the paper's claim is that warping more
pixels onto the attended region before the MLLM's input downsample improves
VQA accuracy (reference harness ``evaluate_accuracy.py:275-473``). Real
LLaVA weights cannot be fetched here, so this module provides an honest
mechanical stand-in with the SAME failure mode as a real MLLM:

- ``ReaderBackend`` perceives every image only through a fixed low-res
  input (``image_size``, default 128 — the CLIP-336 bottleneck, scaled to
  the synthetic scene), exposes the standard extraction duck-type
  (``image_size``, ``num_patches_side``, ``extract(images, questions) ->
  (maps, texts)``), derives its attention from the image itself (local
  contrast — the code tag is the only high-frequency content), and answers
  by actually *reading* the tag out of its low-res view.
- ``make_scene`` renders a smooth scene with an 8×8-bit code tag (64 bits =
  16 hex chars) somewhere in it; the ground-truth answer is the hex string.

At the reader's native input resolution the tag is too small to resolve
(≈2 px/cell after the downsample), so unwarped accuracy is ≈0; after the
driver's attention-guided warp magnifies the tag, the SAME reader decodes
it. The resulting accuracy gain is produced end-to-end by the real driver +
eval harness pair (``cli/process_dataset.py`` → ``cli/evaluate.py
--score-original``), not by this module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from attwarp_tpu_torch.extract.resize import resize_for_backend

BITS = 8                    # 8x8 code -> 64 bits -> 16 hex chars
RING = 1                    # quiet ring, in cells, around the code
CELLS = BITS + 2 * RING     # total tag side in cells


def bits_to_hex(bits: np.ndarray) -> str:
    """(8, 8) {0,1} -> 16 lowercase hex chars (row-major, MSB first)."""
    flat = bits.reshape(-1).astype(int)
    val = 0
    for b in flat:
        val = (val << 1) | int(b)
    return format(val, "016x")


def make_scene(
    rng: np.random.Generator,
    src: int = 512,
    cell: int = 8,
) -> Tuple[np.ndarray, str, Tuple[int, int, int]]:
    """Render (image uint8 (src, src, 3), answer hex, (y, x, tag_side)).

    Smooth background (low local contrast everywhere) + one code tag: a
    black quiet ring around an 8x8 block code. The tag is the only
    high-frequency region, so contrast-based attention finds it — the
    synthetic analogue of question-conditioned attention landing on the
    text the question asks about.
    """
    side = CELLS * cell
    yy, xx = np.mgrid[0:src, 0:src].astype(np.float32) / src
    base = 90 + 70 * (0.6 * xx + 0.4 * yy)
    # a couple of large soft blobs so the background isn't a pure gradient
    for _ in range(3):
        cy, cx = rng.uniform(0, src, 2)
        r = rng.uniform(src * 0.2, src * 0.5)
        d2 = ((np.mgrid[0:src] - cy)[:, None] ** 2 + (np.mgrid[0:src] - cx)[None, :] ** 2)
        base += rng.uniform(-18, 18) * np.exp(-d2 / (2 * r * r))
    img = np.repeat(np.clip(base, 40, 215)[..., None], 3, axis=2)

    bits = rng.integers(0, 2, size=(BITS, BITS))
    tag = np.zeros((CELLS, CELLS), np.float32)  # ring cells stay black
    tag[RING:RING + BITS, RING:RING + BITS] = bits * 255.0
    patch = np.kron(tag, np.ones((cell, cell), np.float32))

    margin = side // 2
    y = int(rng.integers(margin, src - side - margin))
    x = int(rng.integers(margin, src - side - margin))
    img[y:y + side, x:x + side] = patch[..., None]
    return img.astype(np.uint8), bits_to_hex(bits), (y, x, side)


def make_scene_hard(
    rng: np.random.Generator,
    src: int = 512,
    n_distractors: int = 3,
) -> Tuple[np.ndarray, str, Tuple[int, int, int]]:
    """The second task geometry (VERDICT r4 item 7): everything the
    centered code-tag scene holds fixed is varied here —

    - the tag sits ANYWHERE (down to an 8 px border margin, so it can hug
      edges/corners where the separable warp's magnification is asymmetric),
    - the tag SCALE varies (cell 5-8 px at src=512: 1.25-2 px/cell in the
      reader's 128px view — all unreadable unwarped, and the warp must
      deliver different magnification factors),
    - 3-4 DISTRACTOR high-contrast patterns attempted per scene
      (``n_distractors`` + a coin flip; a placement that can't find a
      free spot is skipped, so a rare scene carries fewer) — full
      black-white checkerboards / stripes, same size class as the tag —
      pull attention mass away from the tag: the extraction's saliency
      map becomes multi-modal and the marginal CDFs magnify distractor
      bands too.

    The true tag remains identifiable by its black quiet ring (the
    distractor patterns run edge-to-edge) — the reader's prior, standing in
    for a real MLLM knowing what a code tag looks like."""
    cell = int(rng.integers(5, 9))
    side = CELLS * cell
    yy, xx = np.mgrid[0:src, 0:src].astype(np.float32) / src
    base = 90 + 70 * (0.6 * xx + 0.4 * yy)
    for _ in range(3):
        cy, cx = rng.uniform(0, src, 2)
        r = rng.uniform(src * 0.2, src * 0.5)
        d2 = ((np.mgrid[0:src] - cy)[:, None] ** 2
              + (np.mgrid[0:src] - cx)[None, :] ** 2)
        base += rng.uniform(-18, 18) * np.exp(-d2 / (2 * r * r))
    img = np.repeat(np.clip(base, 40, 215)[..., None], 3, axis=2)

    def sample_box(s, placed, margin=8, sep=56):
        for _ in range(200):
            y = int(rng.integers(margin, src - s - margin))
            x = int(rng.integers(margin, src - s - margin))
            ok = all(
                y + s + sep <= py or py + ps + sep <= y
                or x + s + sep <= px or px + ps + sep <= x
                for py, px, ps in placed
            )
            if ok:
                return y, x
        return None

    placed: list = []
    bits = rng.integers(0, 2, size=(BITS, BITS))
    tag = np.zeros((CELLS, CELLS), np.float32)
    tag[RING:RING + BITS, RING:RING + BITS] = bits * 255.0
    patch = np.kron(tag, np.ones((cell, cell), np.float32))
    pos = sample_box(side, placed)
    assert pos is not None, "could not place the tag"
    y, x = pos
    img[y:y + side, x:x + side] = patch[..., None]
    placed.append((y, x, side))

    for _ in range(int(n_distractors) + int(rng.integers(0, 2))):
        dc = int(rng.integers(5, 9))
        ds = int(rng.integers(8, 12)) * dc
        p = sample_box(ds, placed)
        if p is None:
            continue
        dy, dx = p
        kind = rng.integers(0, 3)
        gy, gx = np.mgrid[0:ds, 0:ds]
        if kind == 0:      # checkerboard, full contrast, no quiet ring
            pat = (((gy // dc) + (gx // dc)) % 2) * 255.0
        elif kind == 1:    # vertical stripes
            pat = ((gx // dc) % 2) * 255.0
        else:              # horizontal stripes
            pat = ((gy // dc) % 2) * 255.0
        img[dy:dy + ds, dx:dx + ds] = pat[..., None]
        placed.append((dy, dx, ds))
    return img.astype(np.uint8), bits_to_hex(bits), (y, x, side)


def _components(mask: np.ndarray):
    """8-connected components of a small bool mask -> [(ys, xs), ...]
    (plain BFS — the mask is the reader's ≤128² view, a handful of blobs)."""
    from collections import deque

    H, W = mask.shape
    lab = np.full((H, W), -1, np.int32)
    comps = []
    for sy, sx in zip(*np.nonzero(mask)):
        if lab[sy, sx] >= 0:
            continue
        idx = len(comps)
        lab[sy, sx] = idx
        q = deque([(int(sy), int(sx))])
        pts = []
        while q:
            y, x = q.popleft()
            pts.append((y, x))
            for ny in range(max(0, y - 1), min(H, y + 2)):
                for nx in range(max(0, x - 1), min(W, x + 2)):
                    if mask[ny, nx] and lab[ny, nx] < 0:
                        lab[ny, nx] = idx
                        q.append((ny, nx))
        pts = np.asarray(pts)
        comps.append((pts[:, 0], pts[:, 1]))
    return comps


def _taglike(gray: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> bool:
    """Does this high-contrast component look like a code tag? A tag's
    quiet ring is UNIFORMLY dark: lay the CELLS-grid over the component
    bbox (one bleed shrink) and require the ring cells' 90th percentile to
    sit below the inner cells' binarization threshold. Checkerboards and
    stripes alternate bright cells through the ring band and fail."""
    H, W = gray.shape
    y0, y1 = ys.min() + 2.0, ys.max() - 2.0
    x0, x1 = xs.min() + 2.0, xs.max() - 2.0
    if y1 <= y0 or x1 <= x0:
        return False
    ch = (y1 - y0 + 1) / CELLS
    cw = (x1 - x0 + 1) / CELLS
    ring, inner = [], []
    for i in range(CELLS):
        for j in range(CELLS):
            yi = int(np.clip(round(y0 + (i + 0.5) * ch), 0, H - 1))
            xi = int(np.clip(round(x0 + (j + 0.5) * cw), 0, W - 1))
            v = gray[yi, xi]
            if RING <= i < CELLS - RING and RING <= j < CELLS - RING:
                inner.append(v)
            else:
                ring.append(v)
    thr = (min(inner) + max(inner)) / 2.0
    return float(np.percentile(ring, 90)) <= thr


def _local_std(gray: np.ndarray, win: int) -> np.ndarray:
    """Box-filtered local standard deviation (reflect padding)."""
    pad = win // 2
    g = np.pad(gray, pad, mode="reflect")
    # integral-image box sums
    c = np.cumsum(np.cumsum(g, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]
    g2 = np.pad(gray * gray, pad, mode="reflect")
    c2 = np.cumsum(np.cumsum(g2, axis=0), axis=1)
    c2 = np.pad(c2, ((1, 0), (1, 0)))
    s2 = c2[win:, win:] - c2[:-win, win:] - c2[win:, :-win] + c2[:-win, :-win]
    n = win * win
    var = np.maximum(s2 / n - (s / n) ** 2, 0.0)
    return np.sqrt(var)


@dataclass
class ReaderBackend:
    """Extraction-backend duck-type whose perception is resolution-limited.

    ``extract`` returns (attention maps (B, n, n), decoded answers): the
    maps are contrast saliency pooled to the patch grid (the stand-in for
    hook-captured attention); the answers come from locating the tag in the
    LOW-RES view and thresholding its cells back to bits.
    """

    image_size: int = 128
    num_patches_side: int = 32
    name: str = "reader"

    def extract(
        self, images: np.ndarray, questions: Sequence[str],
        max_new_tokens: int = 20,
    ) -> Tuple[np.ndarray, List[str]]:
        images = np.asarray(images)
        maps, texts = [], []
        for b in range(images.shape[0]):
            view = images[b]
            if view.shape[0] != self.image_size or view.shape[1] != self.image_size:
                view = resize_for_backend(view, self.image_size)
            gray = np.asarray(view, np.float32).mean(axis=-1)
            if gray.max() > 1.5:
                gray = gray / 255.0
            std = _local_std(gray, win=7)
            maps.append(self._pool(self._condition(gray, std)))
            texts.append(self._read(gray, std))
        return np.stack(maps), texts

    def _condition(self, gray: np.ndarray, std: np.ndarray) -> np.ndarray:
        """Question-conditioned saliency: the question asks about THE TAG,
        so components that don't look like one (no uniformly dark quiet
        ring) are down-weighted — the proxy analogue of the reference's
        relative attention (question-conditioned over generic; C27's
        'relative' maps, Ablations/uncertainty_attn_maps_llava.py:59-60).
        Single-region scenes are unchanged (their one component is the
        tag); multi-region scenes (make_scene_hard) stop splitting the
        warp's magnification across distractors."""
        if std.max() <= 0:
            return std
        mask = std > 0.4 * std.max()
        out = std.copy()
        comps = _components(mask)
        if len(comps) <= 1:
            return out
        for ys, xs in comps:
            if len(ys) < 12:
                continue
            if not _taglike(gray, ys, xs):
                out[ys, xs] *= 0.15
        return out

    def _pool(self, std: np.ndarray) -> np.ndarray:
        n = self.num_patches_side
        k = self.image_size // n
        grid = std[: n * k, : n * k].reshape(n, k, n, k).mean(axis=(1, 3))
        total = grid.sum()
        return (grid / total if total > 0 else
                np.full((n, n), 1.0 / (n * n), np.float32)).astype(np.float32)

    def _read(self, gray: np.ndarray, std: np.ndarray) -> str:
        """Locate the high-contrast tag, shrink off the quiet ring, sample
        the 8x8 cell centers, threshold, emit hex. All from the low-res
        view — if the cells aren't resolved there, the answer is wrong.

        Multi-region scenes (``make_scene_hard``): each connected
        high-contrast component is decoded as a candidate, and candidates
        whose quiet ring isn't dark (checkerboard/stripe distractors run
        edge to edge) are gated to near-zero confidence — the proxy's
        analogue of a real MLLM knowing what a code tag looks like. On
        single-tag scenes this reduces to the original behavior (one
        component, ring present).

        The contrast window bleeds the bounding box outward by a couple of
        pixels; rather than assume one shrink, several candidates are
        decoded and the most confident read wins (confidence = the minimum
        cell-value margin from the binarization threshold — no ground truth
        involved)."""
        mask = std > 0.4 * std.max()
        if not mask.any():
            return ""
        H, W = gray.shape
        best, best_conf = "", -1.0
        for ys, xs in _components(mask):
            if len(ys) < 12:
                continue
            for shrink in (1.5, 2.0, 2.5, 3.0):
                y0, y1 = ys.min() + shrink, ys.max() - shrink
                x0, x1 = xs.min() + shrink, xs.max() - shrink
                if y1 <= y0 or x1 <= x0:
                    continue
                # ring + code grid over the FULL box (CELLS x CELLS) ...
                ch = (y1 - y0 + 1) / CELLS
                cw = (x1 - x0 + 1) / CELLS
                ring_vals = []
                for i in range(CELLS):
                    for j in range(CELLS):
                        if RING <= i < CELLS - RING and \
                                RING <= j < CELLS - RING:
                            continue
                        yi = int(np.clip(round(y0 + (i + 0.5) * ch), 0, H - 1))
                        xi = int(np.clip(round(x0 + (j + 0.5) * cw), 0, W - 1))
                        ring_vals.append(gray[yi, xi])
                # ... then strip it: code = the central BITS/CELLS fraction
                fy = (y1 - y0 + 1) * RING / CELLS
                fx = (x1 - x0 + 1) * RING / CELLS
                cy0, cy1 = y0 + fy, y1 + 1 - fy
                cx0, cx1 = x0 + fx, x1 + 1 - fx
                vals = np.empty((BITS, BITS), np.float32)
                for i in range(BITS):
                    yc = cy0 + (i + 0.5) * (cy1 - cy0) / BITS
                    for j in range(BITS):
                        xc = cx0 + (j + 0.5) * (cx1 - cx0) / BITS
                        yi = int(np.clip(round(yc), 1, H - 2))
                        xi = int(np.clip(round(xc), 1, W - 2))
                        vals[i, j] = gray[yi - 1:yi + 2, xi - 1:xi + 2].mean()
                thr = (vals.min() + vals.max()) / 2.0
                spread = max(vals.max() - vals.min(), 1e-6)
                conf = float(np.min(np.abs(vals - thr)) / spread)
                # quiet-ring gate: a real tag's ring is UNIFORMLY dark, so
                # even its 90th-percentile cell sits below the binarization
                # threshold; checkerboard/stripe distractors alternate
                # bright cells through the ring band and fail the
                # percentile even when their ring MEAN straddles thr
                if ring_vals and \
                        float(np.percentile(ring_vals, 90)) > thr:
                    conf *= 0.01
                if conf > best_conf:
                    best_conf = conf
                    best = bits_to_hex((vals > thr).astype(np.int64))
        return best


class ReaderFeatureExtractor:
    """Frozen-feature extractor matching the reader proxy's perception —
    the ``LLaVAFeatHelper`` contract (``extract/features.py``) for the
    learned-warp evidence chain.

    Visual tokens are per-patch statistics of the reader's own LOW-RES view
    (mean intensity + two local-contrast scales — the same signal the
    reader's saliency uses), pooled to the 24×24 MarginalNet grid and
    projected by a FIXED seeded random matrix (frozen weights, like a real
    frozen tower). Text tokens are fixed seeded hash embeddings. Nothing
    here is trained: MarginalNet must learn attention prediction from
    frozen features, exactly as in the reference (trainer.py:103,205-207).
    """

    def __init__(self, view_size: int = 128, dv: int = 32, dt: int = 16,
                 seed: int = 7):
        self.view_size = view_size
        rng = np.random.default_rng(seed)
        self.proj = rng.standard_normal((3, dv)).astype(np.float32) / np.sqrt(3)
        self.txt_table = rng.standard_normal((1024, dt)).astype(np.float32)

    def visual_tokens(self, images) -> np.ndarray:
        """(B, H, W, 3) float [0,1] -> (B, 24, 24, Dv)."""
        import torch

        from attwarp_tpu_torch.numerics.pooling import adaptive_avg_pool2d

        grid = 24
        feats = []
        for b in range(np.asarray(images).shape[0]):
            view = resize_for_backend(np.asarray(images[b]), self.view_size)
            gray = np.asarray(view, np.float32).mean(axis=-1)
            if gray.max() > 1.5:
                gray = gray / 255.0
            chans = np.stack(
                [gray, _local_std(gray, 3), _local_std(gray, 7)], axis=-1
            )  # (S, S, 3)
            pooled = adaptive_avg_pool2d(
                torch.as_tensor(chans.transpose(2, 0, 1))[None], (grid, grid)
            ).numpy()[0].transpose(1, 2, 0)  # (24, 24, 3)
            feats.append(pooled @ self.proj)
        return np.stack(feats).astype(np.float32)

    def text_tokens(self, texts, max_len: int = 16):
        """list[str] -> (ttok (B, Lt, Dt), tmask (B, Lt, 1))."""
        B = len(texts)
        dt = self.txt_table.shape[1]
        ttok = np.zeros((B, max_len, dt), np.float32)
        tmask = np.zeros((B, max_len, 1), np.float32)
        for b, t in enumerate(texts):
            words = str(t).lower().split()[:max_len]
            pad = max_len - len(words)
            for i, w in enumerate(words):
                # stable non-salted hash (zlib.crc32) so features are
                # deterministic across processes
                import zlib

                ttok[b, pad + i] = self.txt_table[
                    zlib.crc32(w.encode()) % len(self.txt_table)
                ]
                tmask[b, pad + i] = 1.0
        return ttok, tmask


def write_textvqa_dataset(
    out_dir: str,
    n: int,
    seed: int = 0,
    src: int = 512,
    question: str = "what is the code on the tag?",
    geometry: str = "center",
) -> Tuple[str, str]:
    """Write a TextVQA_0.5.1-layout dataset (JSON + {image_id}.jpg images)
    of code-tag scenes. ``geometry``: "center" = the original single
    centered-margin tag; "hard" = off-center varying-scale tag among
    high-contrast distractors (``make_scene_hard``). Returns
    (json_path, image_dir)."""
    import json
    import os

    from PIL import Image

    scene = {"center": make_scene, "hard": make_scene_hard}[geometry]
    rng = np.random.default_rng(seed)
    image_dir = os.path.join(out_dir, "images")
    os.makedirs(image_dir, exist_ok=True)
    data = []
    for i in range(n):
        img, answer, _box = scene(rng, src=src)
        cell = _box[2] // CELLS
        image_id = f"codetag_{i:05d}"
        # JPEG like the real TextVQA images (quality high enough to keep
        # the tag cells; the reader still can't resolve them unwarped)
        Image.fromarray(img).save(
            os.path.join(image_dir, f"{image_id}.jpg"), quality=95
        )
        data.append({
            "question": question,
            "image_id": image_id,
            "question_id": i,
            "answers": [answer] * 10,
            # cell_N / tag box: consumed by the by-scale gain analysis on
            # the hard geometry (extra keys are inert to the driver/eval)
            "image_classes": ["tag", f"cell_{cell}"],
            "tag_box_yxs": [int(_box[0]), int(_box[1]), int(_box[2])],
            "image_width": src,
            "image_height": src,
        })
    payload = {
        "dataset_type": "textvqa",
        "dataset_name": "synthetic-codetag",
        "dataset_version": 0.51,
        "data": data,
    }
    json_path = os.path.join(out_dir, "codetag_val.json")
    with open(json_path, "w") as f:
        json.dump(payload, f)
    return json_path, image_dir
