"""Qwen2-VL extraction backend (counterpart of
``attwarp_tpu/extract/qwen2vl_backend.py``).

The same interface as ``extract/llava_backend.py``: ``device``,
``image_size``, ``extract(images, questions) -> (maps (B, n, n), texts)`` and
the answer-only ``answer_batch``. The map's side follows the image: a
``size x size`` input gives ``size / (patch * merge)`` merged vision tokens a
side (448 px -> 16x16, 672 px -> 24x24); the warp takes any grid.

Images are a ``(B, S, S, C)`` tensor already resized to ``image_size``, as
the pipeline passes them, or host images, which are resized on the model's
device first; then CLIP-normalized (Qwen2-VL's processor uses the OpenAI
CLIP statistics) and patchified on the device. ``_preprocess`` gives the
serving engines one image's pixels, and ``save``/``load`` keep the
checkpoint directory of ``extract/checkpoint.py``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.checkpoint import load_checkpoint, save_checkpoint
from attwarp_tpu_torch.extract.offsets import left_pad
from attwarp_tpu_torch.extract.resize import clip_pixels
from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel, config_from_dict, patchify_batch


class Qwen2VLBackend:
    # extract/answer_batch take a (B, S, S, C) tensor on the model's device
    supports_device_pixels = True
    name = "qwen2vl-torch"

    def __init__(self, model: Qwen2VLModel, tokenizer=None,
                 extract_layer: int = 20, image_size: int = 448,
                 kv_quant: bool = False, use_flash: bool = False):
        self.model = model
        # anything with encode(text, add_special_tokens) and
        # decode(ids, skip_special_tokens): the port's DryRunTokenizer or a
        # transformers tokenizer
        self.tokenizer = tokenizer
        self.extract_layer = extract_layer
        # int8 KV cache (the '+kv8' suffix): decode attention through K3
        self.kv_quant = kv_quant
        # flash prefill (the '+flash' suffix): the same K2 as LLaVA's
        self.use_flash = use_flash
        vcfg = model.cfg.vision
        unit = vcfg.patch_size * vcfg.spatial_merge_size
        if image_size % unit:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch * merge = {unit}")
        n_layers = model.cfg.text.num_hidden_layers
        if not 0 <= extract_layer < n_layers:
            raise ValueError(f"extract_layer {extract_layer} out of range for "
                             f"{n_layers}-layer model")
        self.image_size = image_size

    # ── checkpoints ────────────────────────────────────────────────────
    def save(self, path) -> None:
        """Write ``params.pt``, ``config.json`` and the tokenizer's files
        (where the backend has one) into directory ``path``."""
        save_checkpoint(path, self.model.params, self.model.cfg, self.tokenizer)

    @classmethod
    def load(cls, path, device, extract_layer: int = 20, image_size: int = 448,
             tokenizer=None) -> "Qwen2VLBackend":
        """A backend from a directory written by ``save``, its weights on
        ``device``, with the tokenizer saved beside them unless one is
        passed (None where the directory holds none)."""
        cfg, params, saved = load_checkpoint(path, device, config_from_dict)
        return cls(Qwen2VLModel(cfg, params), tokenizer=saved if tokenizer is None else tokenizer,
                   extract_layer=extract_layer, image_size=image_size)

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        """One host image -> CLIP-normalized (S, S, 3) float32 pixels on the
        host at ``image_size``, as JAX's ``_preprocess`` (the engine
        patchifies them)."""
        return clip_pixels([image], self.image_size, self.device)[0].cpu().numpy()

    @property
    def num_patches_side(self) -> int:
        vcfg = self.model.cfg.vision
        return self.image_size // (vcfg.patch_size * vcfg.spatial_merge_size)

    def build_ids(self, question: str) -> List[int]:
        """One question -> unpadded expanded prompt ids (Qwen chat template:
        system turn, then the vision block inside the user turn bounded by
        <|vision_start|>/<|vision_end|>)."""
        if self.tokenizer is None:
            raise RuntimeError("Qwen2VLBackend needs a tokenizer for text-level calls")
        cfg = self.model.cfg
        prefix = self.tokenizer.encode(
            "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
            "<|im_start|>user\n", add_special_tokens=False)
        suffix = self.tokenizer.encode(
            f"{question}<|im_end|>\n<|im_start|>assistant\n",
            add_special_tokens=False)
        return (prefix + [cfg.vision_start_token_id]
                + [cfg.image_token_id] * self.num_patches_side ** 2
                + [cfg.vision_end_token_id] + suffix)

    def _prepare(self, images, questions):
        """Prompts -> left-padded ids (B, T) and mask (B, T) bool on the
        device; images -> patches (B, N, C*T*P*P) and their grid."""
        padded, mask = left_pad([self.build_ids(q) for q in questions],
                                pad_id=self.model.cfg.pad_token_id, bucket=64)
        dev = self.device
        pix = clip_pixels(images, self.image_size, dev)
        patches, grid = patchify_batch(pix, self.model.cfg.vision)
        return (torch.as_tensor(np.asarray(padded, np.int64), device=dev),
                torch.as_tensor(np.asarray(mask, bool), device=dev),
                patches, grid)

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

    def _generate(self, images, questions, extract_layer, max_new_tokens):
        ids, mask, patches, grid = self._prepare(images, questions)
        return self.model.generate_with_attention(
            ids, patches, grid, mask, extract_layer=extract_layer,
            max_new_tokens=max_new_tokens, kv_quant=self.kv_quant,
            use_flash=self.use_flash,
        )

    def extract(self, images, questions: Sequence[str],
                max_new_tokens: int = 20) -> Tuple[torch.Tensor, List[str]]:
        gen, maps = self._generate(images, questions, self.extract_layer,
                                   max_new_tokens)
        return maps, self._decode(gen)

    def answer_batch(self, images, questions: Sequence[str],
                     max_new_tokens: int = 64) -> List[str]:
        """Answer-only greedy generate (``extract_layer=None``): no layer
        builds a probabilities row and nothing is accumulated."""
        gen, _ = self._generate(images, questions, None, max_new_tokens)
        return self._decode(gen)
