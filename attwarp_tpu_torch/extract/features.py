"""Frozen-MLLM feature extraction for MarginalNet training (counterpart of
``attwarp_tpu/extract/features.py``).

The contract of the reference's ``LLaVAFeatHelper`` (trainer.py:17,
103, 110-112, 206-207), channels last as in JAX:

    visual_tokens(images (B, H, W, 3) in [0, 1]) -> (B, hv, wv, Dv)
    text_tokens(texts) -> (ttok (B, Lt, Dt), tmask (B, Lt, 1))

Every extractor runs on its backend's device and returns tensors there.
Text ids come from ``tokenizer.encode(text, add_special_tokens=...)``,
which the port's ``DryRunTokenizer`` and a ``transformers`` tokenizer both
have; the mini's from its ``HashTokenizer``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.resize import clip_pixels, resize_scale_device


def _text_embeddings(tokenizer, embed: torch.Tensor, texts: Sequence[str], L: int,
                     add_special_tokens: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each text's first ``L`` ids, left-padded with id 0 -> (embeddings
    (B, L, D), mask (B, L, 1) f32)."""
    ids, mask = [], []
    for t in texts:
        toks = list(tokenizer.encode(t, add_special_tokens=add_special_tokens))[:L]
        pad = L - len(toks)
        ids.append([0] * pad + toks)
        mask.append([0.0] * pad + [1.0] * len(toks))
    idx = torch.as_tensor(np.asarray(ids, np.int64).clip(0), device=embed.device)
    return embed[idx], torch.as_tensor(np.asarray(mask, np.float32), device=embed.device)[..., None]


def _device_images(images, device) -> torch.Tensor:
    """Host or device images -> an f32 tensor on ``device``."""
    if isinstance(images, torch.Tensor):
        return images.to(device, torch.float32)
    return torch.as_tensor(np.asarray(images, np.float32), device=device)


class MiniFeatureExtractor:
    """Frozen features from the MiniLLaVA test backend
    (``extract/extraction.py::MiniLLaVABackend``): visual tokens are its
    patch embeddings, text tokens its token embeddings."""

    def __init__(self, backend):
        self.backend = backend
        self.cfg = backend.cfg

    @torch.no_grad()
    def visual_tokens(self, images) -> torch.Tensor:
        """(B, H, W, 3) float -> (B, n, n, D) patch features, resized to
        the mini's input first like ``jax.image.resize`` "linear"."""
        from attwarp_tpu_torch.extract.mini_llava import encode_images

        S, n = self.cfg.image_size, self.cfg.num_patches
        x = resize_scale_device(_device_images(images, self.backend.device), 1.0, (S, S))
        toks = encode_images(self.backend.params, self.cfg, x)
        return toks.reshape(toks.shape[0], n, n, -1)

    def text_tokens(self, texts: Sequence[str],
                    max_len: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
        """Texts -> (ttok (B, max_len, D), tmask (B, max_len, 1)): each
        text's first ``max_len`` ids, left-padded with the pad id to the
        fixed ``max_len``; the mask is 0 wherever the id is the pad id."""
        pad = self.cfg.pad_id
        ids = [self.backend.tokenizer.encode(t)[:max_len] for t in texts]
        ids = [[pad] * (max_len - len(t)) + t for t in ids]
        mask = [[1.0 if tok != pad else 0.0 for tok in t] for t in ids]
        emb = self.backend.params["tok_emb"]
        idx = torch.as_tensor(np.asarray(ids, np.int64).clip(0), device=emb.device)
        return emb[idx], torch.as_tensor(np.asarray(mask, np.float32), device=emb.device)[..., None]


class LlavaFeatureExtractor:
    """Frozen features from a LLaVA backend (``extract/llava_backend.py``):
    visual tokens are the CLIP tower's features at the model's
    ``vision_feature_layer`` without the class token (B, 24, 24, Dv);
    text tokens the LLaMA input embeddings of the question."""

    def __init__(self, backend, max_text_len: int = 32):
        self.backend = backend
        self.max_text_len = max_text_len

    @torch.no_grad()
    def visual_tokens(self, images) -> torch.Tensor:
        """(B, H, W, 3) float [0, 1] -> (B, n, n, Dv), in the weights' dtype."""
        from attwarp_tpu_torch.models.clip_vit import clip_vision_features

        be = self.backend
        cfg = be.model.cfg
        S = be.image_size
        x = resize_scale_device(_device_images(images, be.device), 1.0, (S, S))
        toks = clip_vision_features(be.model.params["vision"], cfg.vision,
                                    clip_pixels(x, S, be.device),
                                    feature_layer=cfg.vision_feature_layer, drop_cls=True)
        n = be.num_patches_side
        return toks.reshape(toks.shape[0], n, n, -1)

    def text_tokens(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.backend.tokenizer is None:
            raise RuntimeError("LlavaFeatureExtractor needs a backend with a tokenizer")
        return _text_embeddings(self.backend.tokenizer,
                                self.backend.model.text_params["embed_tokens"], texts,
                                self.max_text_len, add_special_tokens=True)


class Qwen2VLFeatureExtractor:
    """Frozen features from a Qwen2-VL backend (the reference's training
    artifacts are Qwen-produced: dataset roots ``*_qwen_multilayer``):
    visual tokens are the merged vision features on the merged grid; text
    tokens the Qwen input embeddings."""

    def __init__(self, backend, max_text_len: int = 32):
        self.backend = backend
        self.max_text_len = max_text_len

    @torch.no_grad()
    def visual_tokens(self, images) -> torch.Tensor:
        """(B, H, W, 3) float [0, 1] -> (B, n, n, D) merged vision features,
        one image through the tower at a time, as JAX runs it."""
        from attwarp_tpu_torch.models.qwen2vl import patchify_batch, qwen2vl_vision_features

        be = self.backend
        vcfg = be.model.cfg.vision
        S, n = be.image_size, be.num_patches_side
        x = resize_scale_device(_device_images(images, be.device), 1.0, (S, S))
        patches, grid = patchify_batch(clip_pixels(x, S, be.device), vcfg)
        outs = [qwen2vl_vision_features(be.model.params["vision"], vcfg, patches[b:b + 1],
                                        (grid[1], grid[2])).reshape(n, n, -1)
                for b in range(patches.shape[0])]
        return torch.stack(outs)

    def text_tokens(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.backend.tokenizer is None:
            raise RuntimeError("Qwen2VLFeatureExtractor needs a backend with a tokenizer")
        return _text_embeddings(self.backend.tokenizer,
                                self.backend.model.text_params["embed_tokens"], texts,
                                self.max_text_len, add_special_tokens=False)


def _backend(cls, path, device):
    """``cls`` loaded from ``path``: a port checkpoint directory (one
    holding ``params.pt``, written by the backend's ``save``) through
    ``load``, anything else as an HF checkpoint through ``from_hf``."""
    if (Path(path) / "params.pt").is_file():
        return cls.load(path, device)
    return cls.from_hf(str(path), device)


def make_feature_extractor(cfg, device="cuda"):
    """The frozen-feature extractor named by ``cfg.mllm_backend``: ``mini``
    (the test MLLM, seed 0, the default), or ``llava``/``llava-flax`` or
    ``qwen2vl`` (``qwen2-vl``, ``qwen``) over ``cfg.mllm_model``, an HF
    checkpoint (``from_hf``, as JAX reads it) or a port checkpoint
    directory; its weights on ``device``. Unknown names raise instead of
    silently training against random features."""
    name = str(cfg.mllm_backend).lower()
    if name == "mini":
        from attwarp_tpu_torch.extract.extraction import MiniLLaVABackend

        return MiniFeatureExtractor(MiniLLaVABackend(device=device))
    if name in ("llava", "llava-flax"):
        from attwarp_tpu_torch.extract.llava_backend import LlavaBackend

        return LlavaFeatureExtractor(_backend(LlavaBackend, cfg.mllm_model, device))
    if name in ("qwen2vl", "qwen2-vl", "qwen"):
        from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend

        return Qwen2VLFeatureExtractor(_backend(Qwen2VLBackend, cfg.mllm_model, device))
    raise ValueError(f"unknown mllm_backend {cfg.mllm_backend!r}")
