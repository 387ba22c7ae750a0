"""LLaVA extraction backend (counterpart of
``attwarp_tpu/extract/llava_backend.py``).

``extract(images, questions) -> (maps (B, n, n), texts)`` and the
answer-only ``answer_batch`` over ``models/llava.py``. Images are either a
``(B, S, S, C)`` tensor already resized to the vision tower's input (floats
in [0, 1] or integers in [0, 255]), as the pipeline passes them, or a
sequence of host images, which are resized on the model's device first.
``_preprocess`` gives the serving engines one image's pixels, and
``save``/``load`` keep the checkpoint directory of ``extract/checkpoint.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.checkpoint import load_checkpoint, save_checkpoint
from attwarp_tpu_torch.extract.offsets import left_pad
from attwarp_tpu_torch.extract.prompts import build_prompt
from attwarp_tpu_torch.extract.resize import clip_pixels
from attwarp_tpu_torch.models.llava import LlavaModel, config_from_dict


class LlavaBackend:
    # extract/answer_batch take a (B, S, S, C) tensor on the model's device
    supports_device_pixels = True
    name = "llava-torch"

    def __init__(self, model: LlavaModel, tokenizer=None,
                 extract_layer: int = 20, kv_quant: bool = False,
                 use_flash: bool = False):
        self.model = model
        # anything with encode(text, add_special_tokens) and
        # decode(ids, skip_special_tokens): the port's DryRunTokenizer or a
        # transformers tokenizer
        self.tokenizer = tokenizer
        self.extract_layer = extract_layer
        # int8 KV cache (the '+kv8' suffix): decode attention through K3
        self.kv_quant = kv_quant
        # flash prefill (the '+flash' suffix): prefill attention through K2
        self.use_flash = use_flash

    # ── checkpoints ────────────────────────────────────────────────────
    def save(self, path) -> None:
        """Write ``params.pt``, ``config.json`` and the tokenizer's files
        (where the backend has one) into directory ``path``."""
        save_checkpoint(path, self.model.params, self.model.cfg, self.tokenizer)

    @classmethod
    def load(cls, path, device, extract_layer: int = 20,
             tokenizer=None) -> "LlavaBackend":
        """A backend from a directory written by ``save``, its weights on
        ``device``, with the tokenizer saved beside them unless one is
        passed (None where the directory holds none)."""
        cfg, params, saved = load_checkpoint(path, device, config_from_dict)
        return cls(LlavaModel(cfg, params), tokenizer=saved if tokenizer is None else tokenizer,
                   extract_layer=extract_layer)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def image_size(self) -> int:
        return self.model.cfg.vision.image_size

    @property
    def num_patches_side(self) -> int:
        return self.model.cfg.vision.image_size // self.model.cfg.vision.patch_size

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        """One host image -> CLIP-normalized (S, S, 3) float32 pixels on the
        host, as JAX's ``_preprocess``: to [0, 1] by dtype, resized like
        ``jax.image.resize`` "linear" (on the model's device), normalized."""
        return clip_pixels([image], self.image_size, self.device)[0].cpu().numpy()

    def build_ids(self, question: str) -> List[int]:
        """One question -> unpadded expanded prompt ids (llava_v1 template,
        ``<image>`` expanded to num_image_tokens ids, HF style)."""
        if self.tokenizer is None:
            raise RuntimeError("LlavaBackend needs a tokenizer for text-level calls")
        pre, post = build_prompt(question, "llava_v1").split("<image>")
        cfg = self.model.cfg
        return (self.tokenizer.encode(pre, add_special_tokens=True)
                + [cfg.image_token_index] * cfg.num_image_tokens
                + self.tokenizer.encode(post, add_special_tokens=False))

    def _prepare(self, images, questions):
        """Prompts -> expanded, left-padded ids (B, T), mask (B, T) bool,
        image-span starts (B,) and CLIP-normalized pixels."""
        cfg = self.model.cfg
        padded, mask = left_pad([self.build_ids(q) for q in questions],
                                pad_id=cfg.pad_token_id, bucket=64)
        ids = np.asarray(padded, np.int64)
        img_start = np.argmax(ids == cfg.image_token_index, axis=1)
        dev = self.device
        return (torch.as_tensor(ids, device=dev),
                torch.as_tensor(np.asarray(mask, bool), device=dev),
                torch.as_tensor(img_start, device=dev),
                clip_pixels(images, self.image_size, dev))

    def _decode(self, gen: torch.Tensor) -> List[str]:
        texts = []
        for row in gen.cpu().tolist():
            out = []
            for t in row:
                if t == self.model.cfg.eos_token_id:
                    break
                out.append(t)
            texts.append(self.tokenizer.decode(out, skip_special_tokens=True).strip())
        return texts

    def extract(self, images, questions: Sequence[str],
                max_new_tokens: int = 20) -> Tuple[torch.Tensor, List[str]]:
        ids, mask, img_start, pixels = self._prepare(images, questions)
        gen, maps = self.model.generate_with_attention(
            ids, pixels, mask, img_start, extract_layer=self.extract_layer,
            max_new_tokens=max_new_tokens, kv_quant=self.kv_quant,
            use_flash=self.use_flash,
        )
        return maps, self._decode(gen)

    def answer_batch(self, images, questions: Sequence[str],
                     max_new_tokens: int = 64) -> List[str]:
        """Answer-only greedy generate (``extract_layer=None``): no layer
        builds a probabilities row and nothing is accumulated."""
        ids, mask, img_start, pixels = self._prepare(images, questions)
        gen, _ = self.model.generate_with_attention(
            ids, pixels, mask, img_start, extract_layer=None,
            max_new_tokens=max_new_tokens, kv_quant=self.kv_quant,
            use_flash=self.use_flash,
        )
        return self._decode(gen)

