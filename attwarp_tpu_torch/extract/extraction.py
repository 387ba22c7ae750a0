"""User-facing attention-extraction API (counterpart of
``attwarp_tpu/extract/extraction.py``).

- ``MiniLLaVABackend``: the self-contained test MLLM of ``mini_llava.py``,
  the JAX CLIs' default backend (``mini``).
- ``extract_attention``: the ``getmask`` / ``getmask_batch`` equivalent
  (functions.py:46-186, 188-328); one batched call covers both.
- ``llava_api``: the one-call convenience of the reference
  (llava.py:272-331): (images, questions) -> (overlays, attention maps
  (1, 1, n, n), MOTA masks).

Backends are duck-typed: anything with ``image_size`` and
``extract(images, questions, max_new_tokens)`` works. The resizes are
``extract/resize.py``'s.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.mini_llava import (
    HashTokenizer,
    MiniLLaVAConfig,
    build_spliced_embeds,
    generate_with_attention,
    init_params,
)
from attwarp_tpu_torch.extract.offsets import left_pad
from attwarp_tpu_torch.extract.prompts import build_prompt, stop_str_for
from attwarp_tpu_torch.extract.resize import resize_for_backend, to_uint8_rgb
from attwarp_tpu_torch.utils.device import require_device


class MiniLLaVABackend:
    """Self-contained test MLLM (no external weights), on ``device``: the
    card unless the caller asks for the CPU. Its weights come from
    ``init_params`` with a generator seeded by ``seed``, or are ``params``
    (e.g. ``mini_llava.params_from_jax`` of JAX's). The extract layer is
    ``cfg.extract_layer``, read at every call."""

    # extract() takes any (B, H, W, 3) array or tensor, the device's included
    supports_device_pixels = True
    name = "mini-llava"

    def __init__(self, cfg: Optional[MiniLLaVAConfig] = None, seed: int = 0,
                 device="cuda", params=None):
        self.cfg = cfg or MiniLLaVAConfig()
        self.device = require_device(device, "MiniLLaVABackend")
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(self.cfg, gen)
        self.params = params
        self.tokenizer = HashTokenizer(self.cfg)
        self.conv_mode = "llava_v1"

    @property
    def image_size(self) -> int:
        return self.cfg.image_size

    @property
    def num_patches_side(self) -> int:
        return self.cfg.num_patches  # the mini's num_patches is per side

    def extract(self, images, questions: Sequence[str],
                max_new_tokens: int = 20) -> Tuple[torch.Tensor, List[str]]:
        """Images (B, H, W, 3) at ``image_size``, their values as given
        (floats in [0, 1] or integers), -> (attention maps (B, n, n) on the
        device, decoded answers)."""
        prompts = [build_prompt(q, self.conv_mode) for q in questions]
        ids = [self.tokenizer.encode(p) for p in prompts]
        # bucket=8 keeps the test model's shapes small
        padded, _mask = left_pad(ids, pad_id=self.cfg.pad_id, bucket=8)
        padded = np.asarray(padded, np.int64)
        imgs = torch.as_tensor(np.asarray(images) if not isinstance(images, torch.Tensor)
                               else images).to(self.device, torch.float32)
        if imgs.ndim == 3:
            imgs = imgs[None]
        embeds, pos_mask, img_start = build_spliced_embeds(self.params, self.cfg, padded, imgs)
        if embeds.shape[1] + max_new_tokens > self.cfg.max_seq:
            raise ValueError(
                f"prompt too long: expanded length {embeds.shape[1]} + "
                f"{max_new_tokens} new tokens exceeds max_seq={self.cfg.max_seq} "
                "(the KV cache would silently clamp writes)")
        gen, maps = generate_with_attention(self.params, self.cfg, embeds, pos_mask,
                                            img_start, max_new_tokens=max_new_tokens)
        stop = stop_str_for(self.conv_mode)
        texts = []
        for row in gen.cpu().tolist():
            ids_out = []
            for t in row:
                if t == self.cfg.eos_id:
                    break
                ids_out.append(t)
            text = self.tokenizer.decode(ids_out).strip()
            if text.endswith(stop):
                text = text[:-len(stop)].strip()
            texts.append(text)
        return maps, texts


def extract_attention(backend, images, questions: Sequence[str],
                      max_new_tokens: int = 20):
    """getmask/getmask_batch equivalent: returns ((B, n, n) maps, texts)."""
    return backend.extract(images, questions, max_new_tokens=max_new_tokens)


def llava_api(
    images: Sequence[np.ndarray],
    queries: Sequence[str],
    backend=None,
    batch_size: int = 1,
    enhance_coe: float = 10.0,
    kernel_size: int = 3,
    grayscale: float = 0.0,
    max_new_tokens: int = 20,
    device="cuda",
):
    """One-call convenience API (reference llava.py:272-331).

    Returns (masked_images, attention_maps, mota_masks): overlay RGB arrays,
    (1, 1, n, n) float maps and image-size uint8 MOTA masks. Without a
    ``backend`` it builds a ``MiniLLaVABackend`` on ``device``; the masks
    run on the backend's device. A backend with a sequence of extract
    layers gives (L, B, n, n) maps, of which the first layer is primary."""
    from attwarp_tpu_torch.warp.blend import blend_mask

    backend = backend or MiniLLaVABackend(device=device)
    dev = getattr(backend, "device", device)
    masked_images, attention_maps, mota_masks = [], [], []
    n = len(images)
    for i in range(0, n, max(batch_size, 1)):
        chunk_imgs = list(images[i:i + batch_size])
        chunk_qs = list(queries[i:i + batch_size])
        batch = np.stack([resize_for_backend(im, backend.image_size) for im in chunk_imgs])
        maps, _texts = extract_attention(backend, batch, chunk_qs,
                                         max_new_tokens=max_new_tokens)
        if isinstance(maps, torch.Tensor):
            maps = maps.detach().cpu().numpy()
        maps = np.asarray(maps)
        if maps.ndim == 4:
            maps = maps[0]
        for im, m in zip(chunk_imgs, maps):
            overlay, mota = blend_mask(to_uint8_rgb(im), m, enhance_coe, kernel_size,
                                       grayscale, device=dev)
            masked_images.append(overlay)
            attention_maps.append(np.asarray(m)[None, None])
            mota_masks.append(mota)
    return masked_images, attention_maps, mota_masks
