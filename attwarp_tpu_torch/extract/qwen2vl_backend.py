"""Qwen2-VL extraction backend (counterpart of
``attwarp_tpu/extract/qwen2vl_backend.py``): ``extract/backend.py``'s
``MLLMBackend`` over ``models/qwen2vl.py``, with the tokenizer-free
``extract_from_ids`` that ``extract`` calls. The map's side follows the
image: a ``size x size`` input gives ``size / (patch * merge)`` merged
vision tokens a side (448 px -> 16x16, 672 px -> 24x24); the warp takes
any grid.

Images are CLIP-normalized (Qwen2-VL's processor uses the OpenAI CLIP
statistics) at ``image_size`` and patchified on the device by the model's
``image_input``. ``load`` reads the checkpoint directory ``save`` writes,
and ``from_hf`` loads an HF checkpoint (a local directory) onto a device.
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
from attwarp_tpu_torch.models.llama import ExtractSpec, extract_layers_tuple
from attwarp_tpu_torch.models.qwen2vl import (
    Qwen2VLConfig,
    Qwen2VLModel,
    Qwen2VLTextConfig,
    Qwen2VLVisionConfig,
    config_from_dict,
    port_hf_qwen2vl_weights,
)
from attwarp_tpu_torch.utils import profiling
from attwarp_tpu_torch.utils.device import require_device


class Qwen2VLBackend(MLLMBackend):
    name = "qwen2vl-torch"

    def __init__(self, model: Qwen2VLModel, tokenizer=None,
                 extract_layer: ExtractSpec = 20, image_size: int = 448,
                 kv_quant: bool = False, use_flash: bool = False):
        super().__init__(model, tokenizer, extract_layer, kv_quant, use_flash)
        self._check_image_size(image_size)
        n_layers = model.cfg.text.num_hidden_layers
        for layer in extract_layers_tuple(extract_layer):
            if not 0 <= layer < n_layers:
                raise ValueError(f"extract_layer {layer} out of range for "
                                 f"{n_layers}-layer model")
        self.image_size = image_size

    def _check_image_size(self, image_size: int) -> None:
        vcfg = self.model.cfg.vision
        unit = vcfg.patch_size * vcfg.spatial_merge_size
        if image_size % unit:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"patch * merge = {unit}")

    # ── checkpoints ────────────────────────────────────────────────────
    @classmethod
    def load(cls, path, device, extract_layer: ExtractSpec = 20, image_size: int = 448,
             tokenizer=None) -> "Qwen2VLBackend":
        """A backend from a directory written by ``save``, its weights on
        ``device``, with the tokenizer saved beside them unless one is
        passed (None where the directory holds none)."""
        cfg, params, saved = load_checkpoint(path, device, config_from_dict)
        return cls(Qwen2VLModel(cfg, params), tokenizer=saved if tokenizer is None else tokenizer,
                   extract_layer=extract_layer, image_size=image_size)

    @classmethod
    def from_hf(cls, model_path: str, device="cuda", extract_layer: ExtractSpec = 20,
                image_size: int = 448, dtype=None) -> "Qwen2VLBackend":
        """A backend from an HF Qwen2-VL checkpoint directory, its weights
        ported onto ``device`` in ``dtype`` (f32 where None), with the
        tokenizer of its processor (None where none loads)."""
        device = require_device(device, "Qwen2VLBackend.from_hf")
        hf = load_hf_model("Qwen2VLForConditionalGeneration", model_path, dtype)
        cfg = cls.config_from_hf(hf.config)
        params = port_hf_qwen2vl_weights(hf.state_dict(), cfg, device=device,
                                         dtype=dtype or torch.float32)
        del hf
        return cls(Qwen2VLModel(cfg, params), tokenizer=processor_tokenizer(model_path),
                   extract_layer=extract_layer, image_size=image_size)

    @staticmethod
    def config_from_hf(hf_cfg) -> Qwen2VLConfig:
        """An HF ``Qwen2VLConfig`` (transformers 4.x or 5.x) ->
        ``Qwen2VLConfig``; ``mrope_section`` from wherever the version keeps
        it."""
        v, t = hf_cfg.vision_config, hf_cfg.text_config
        eos = getattr(t, "eos_token_id", None)
        return Qwen2VLConfig(
            vision=Qwen2VLVisionConfig(
                depth=v.depth, embed_dim=v.embed_dim, hidden_size=v.hidden_size,
                num_heads=v.num_heads, in_channels=v.in_channels,
                patch_size=v.patch_size, spatial_merge_size=v.spatial_merge_size,
                temporal_patch_size=v.temporal_patch_size,
                mlp_ratio=v.mlp_ratio, hidden_act=v.hidden_act,
            ),
            text=Qwen2VLTextConfig(
                vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                intermediate_size=t.intermediate_size,
                num_hidden_layers=t.num_hidden_layers,
                num_attention_heads=t.num_attention_heads,
                num_key_value_heads=t.num_key_value_heads,
                rms_norm_eps=t.rms_norm_eps,
                rope_theta=float(rope_field(t, "rope_theta", 1000000.0)),
                mrope_section=tuple(rope_field(t, "mrope_section", [16, 24, 24])),
            ),
            image_token_id=hf_cfg.image_token_id,
            vision_start_token_id=hf_cfg.vision_start_token_id,
            vision_end_token_id=getattr(hf_cfg, "vision_end_token_id", 151653),
            pad_token_id=scalar_id(first_defined(getattr(hf_cfg, "pad_token_id", None),
                                                 eos, 151643), 2),
            eos_token_id=scalar_id(first_defined(eos, 151645), 2),
        )

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
        device; images -> what the model's tower takes (HF-patchified rows
        (B, N, C*T*P*P)) and the image grid (t, h, w)."""
        with profiling.span("backend.prepare"):
            ids, mask = self._prompt_ids(questions)
            return (ids, mask, *self.model.image_input(self._pixels(images)))

    def _generate(self, ids, mask, patches, grid, extract_layer, max_new_tokens):
        return self.model.generate_with_attention(
            ids, patches, grid, mask, extract_layer=extract_layer,
            max_new_tokens=max_new_tokens, kv_quant=self.kv_quant,
            use_flash=self.use_flash,
        )

    def extract_from_ids(self, input_ids, attention_mask, image,
                         max_new_tokens: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
        """The tokenizer-free extraction: expanded, left-padded
        ``input_ids`` (B, T), ``attention_mask`` (B, T) and CLIP-normalized
        pixels, one (S, S, 3) image shared by the batch (its vision tower
        runs once) or one per sample (B, S, S, 3), each a numpy array or a
        tensor; the pixels are patchified on the model's device. Returns
        (generated ids (B, max_new_tokens), maps (B, n, n); (L, B, n, n)
        for a sequence of extract layers) on the model's device."""
        dev = self.device
        ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
        mask = torch.as_tensor(attention_mask, device=dev).to(torch.bool)
        pix = torch.as_tensor(image, device=dev).to(torch.float32)
        shared = pix.ndim == 3
        patches, grid = self.model.image_input(pix[None] if shared else pix)
        return self._generate(ids, mask, patches[0] if shared else patches, grid,
                              self.extract_layer, max_new_tokens)
