"""LLaVA extraction backend (counterpart of
``attwarp_tpu/extract/llava_backend.py``): ``extract/backend.py``'s
``MLLMBackend`` over ``models/llava.py``, maps (B, n, n).

``extract_from_ids`` is the tokenizer-free API that ``extract`` calls after
its own prompt assembly (``tools/bench_extract.py`` after its own).
``load`` reads the checkpoint directory ``save`` writes, and ``from_hf``
loads an HF checkpoint (a local directory; nothing is downloaded) onto a
device.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from attwarp_tpu_torch.extract.backend import MLLMBackend
from attwarp_tpu_torch.extract.checkpoint import load_checkpoint
from attwarp_tpu_torch.extract.hf import (
    first_defined,
    load_hf_model,
    processor_tokenizer,
    rope_field,
    scalar_id,
)
from attwarp_tpu_torch.extract.prompts import build_prompt
from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
from attwarp_tpu_torch.models.llama import ExtractSpec, LlamaConfig
from attwarp_tpu_torch.models.llava import (
    LlavaConfig,
    LlavaModel,
    config_from_dict,
    port_hf_llava_weights,
)
from attwarp_tpu_torch.utils import profiling
from attwarp_tpu_torch.utils.device import require_device


class LlavaBackend(MLLMBackend):
    name = "llava-torch"

    # ── checkpoints ────────────────────────────────────────────────────
    @classmethod
    def load(cls, path, device, extract_layer: ExtractSpec = 20,
             tokenizer=None) -> "LlavaBackend":
        """A backend from a directory written by ``save``, its weights on
        ``device``, with the tokenizer saved beside them unless one is
        passed (None where the directory holds none)."""
        cfg, params, saved = load_checkpoint(path, device, config_from_dict)
        return cls(LlavaModel(cfg, params), tokenizer=saved if tokenizer is None else tokenizer,
                   extract_layer=extract_layer)

    @classmethod
    def from_hf(cls, model_path: str, device="cuda", extract_layer: ExtractSpec = 20,
                dtype=None) -> "LlavaBackend":
        """A backend from an HF LLaVA checkpoint directory, its weights
        ported onto ``device`` in ``dtype`` (f32 where None), with the
        tokenizer of its processor (None where none loads)."""
        device = require_device(device, "LlavaBackend.from_hf")
        hf = load_hf_model("LlavaForConditionalGeneration", model_path, dtype)
        cfg = cls.config_from_hf(hf.config)
        params = port_hf_llava_weights(hf.state_dict(), cfg, device=device,
                                       dtype=dtype or torch.float32)
        del hf
        return cls(LlavaModel(cfg, params), tokenizer=processor_tokenizer(model_path),
                   extract_layer=extract_layer)

    @staticmethod
    def config_from_hf(hf_cfg) -> LlavaConfig:
        """An HF ``LlavaConfig`` (transformers 4.x or 5.x) -> ``LlavaConfig``."""
        v, t = hf_cfg.vision_config, hf_cfg.text_config
        eos = getattr(t, "eos_token_id", None)
        return LlavaConfig(
            vision=ClipVisionConfig(
                hidden_size=v.hidden_size, intermediate_size=v.intermediate_size,
                num_hidden_layers=v.num_hidden_layers,
                num_attention_heads=v.num_attention_heads, image_size=v.image_size,
                patch_size=v.patch_size,
                hidden_act=getattr(v, "hidden_act", "quick_gelu"),
            ),
            text=LlamaConfig(
                vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                intermediate_size=t.intermediate_size,
                num_hidden_layers=t.num_hidden_layers,
                num_attention_heads=t.num_attention_heads,
                num_key_value_heads=getattr(t, "num_key_value_heads", None),
                rms_norm_eps=getattr(t, "rms_norm_eps", 1e-5),
                rope_theta=float(rope_field(t, "rope_theta", 10000.0)),
            ),
            vision_feature_layer=getattr(hf_cfg, "vision_feature_layer", -2),
            image_token_index=first_defined(getattr(hf_cfg, "image_token_id", None),
                                            getattr(hf_cfg, "image_token_index", None)),
            pad_token_id=scalar_id(first_defined(getattr(hf_cfg, "pad_token_id", None),
                                                 eos, 2), 2),
            eos_token_id=scalar_id(first_defined(eos, 2), 2),
        )

    @property
    def image_size(self) -> int:
        return self.model.cfg.vision.image_size

    @property
    def num_patches_side(self) -> int:
        return self.model.cfg.vision.image_size // self.model.cfg.vision.patch_size

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

    def _img_start(self, ids: torch.Tensor) -> torch.Tensor:
        """(B,) each row's first image token: where its image span starts."""
        return (ids == self.model.cfg.image_token_index).to(torch.int32).argmax(dim=1)

    def _prepare(self, images, questions):
        """Prompts -> expanded, left-padded ids (B, T), mask (B, T) bool,
        image-span starts (B,) and CLIP-normalized pixels, on the model's
        device."""
        with profiling.span("backend.prepare"):
            ids, mask = self._prompt_ids(questions)
            return ids, mask, self._img_start(ids), self._pixels(images)

    def _generate(self, ids, mask, img_start, pixels, extract_layer, max_new_tokens):
        return self.model.generate_with_attention(
            ids, pixels, mask, img_start, extract_layer=extract_layer,
            max_new_tokens=max_new_tokens, kv_quant=self.kv_quant,
            use_flash=self.use_flash,
        )

    def extract_from_ids(self, input_ids, attention_mask, pixel_values,
                         max_new_tokens: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
        """The tokenizer-free extraction: expanded, left-padded
        ``input_ids`` (B, T), ``attention_mask`` (B, T) and CLIP-normalized
        NHWC ``pixel_values`` (B, S, S, 3), each a numpy array or a tensor.
        Returns (generated ids (B, max_new_tokens), maps (B, n, n); (L, B,
        n, n) for a sequence of extract layers) on the model's device."""
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
        mask = torch.as_tensor(attention_mask, device=dev).to(torch.bool)
        pixels = torch.as_tensor(pixel_values, device=dev).to(torch.float32)
        return self._generate(ids, mask, self._img_start(ids), pixels,
                              self.extract_layer, max_new_tokens)
