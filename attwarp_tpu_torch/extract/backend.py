"""What the extraction backends of every family share
(``extract/llava_backend.py``, ``extract/qwen2vl_backend.py`` and, through
Qwen2-VL's, ``extract/unimoe_backend.py``).

``extract(images, questions) -> (maps, texts)`` and the answer-only
``answer_batch`` over a model of ``models/mllm.py``; a sequence
``extract_layer`` extracts every listed layer in one pass, maps (L, B, h,
w). Images are either a ``(B, S, S, C)`` tensor already resized to
``image_size`` (floats in [0, 1] or integers in [0, 255]), as the pipeline
passes them, or a sequence of host images, which are resized on the
model's device first; then normalized for the tower (``_pixels``).
``_preprocess`` gives the serving engines one image's pixels, ``save``
writes the checkpoint directory of ``extract/checkpoint.py``, and
``quantize_int8`` (``+int8``) and ``quantize_lm_head`` (``+lm8``) turn the
decoder's linears and the LM head into int8 in place
(``numerics/quant.py``).

A family's subclass gives its prompt (``build_ids``), ``_prepare`` and
``_generate`` (the model's ``generate_with_attention`` with its image
arguments), the tokenizer-free ``extract_from_ids``, ``num_patches_side``,
``image_size`` and its loaders.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.checkpoint import save_checkpoint
from attwarp_tpu_torch.extract.offsets import left_pad
from attwarp_tpu_torch.extract.resize import clip_pixels
from attwarp_tpu_torch.models.llama import ExtractSpec
from attwarp_tpu_torch.numerics.quant import quantize_decoder_params, quantize_lm_head
from attwarp_tpu_torch.utils import profiling


class MLLMBackend:
    # extract/answer_batch take a (B, S, S, C) tensor on the model's device
    supports_device_pixels = True

    def __init__(self, model, tokenizer=None, extract_layer: ExtractSpec = 20,
                 kv_quant: bool = False, use_flash: bool = False):
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

    def save(self, path) -> None:
        """Write ``params.pt``, ``config.json`` and the tokenizer's files
        (where the backend has one) into directory ``path``."""
        save_checkpoint(path, self.model.params, self.model.cfg, self.tokenizer)

    # ── int8 weights ───────────────────────────────────────────────────
    def quantize_int8(self):
        """The decoder's seven linears to int8 (w8a8, ``+int8``; biased
        q/k/v keep their bias in f32), in place, one layer at a time on the
        weights' device: each layer's dense weights are freed as its int8
        form is made. Embeddings, LM head, norms and the vision tower keep
        their dtype."""
        quantize_decoder_params(self.model.text_params)
        return self

    def quantize_lm_head(self):
        """The LM head to int8 (``+lm8``), in place, untied from
        ``embed_tokens`` where it was tied."""
        quantize_lm_head(self.model.text_params)
        return self

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _pixels(self, images) -> torch.Tensor:
        """Images -> the tower's CLIP-normalized (B, S, S, 3) f32 pixels at
        ``image_size`` on the model's device."""
        return clip_pixels(images, self.image_size, self.device)

    def _preprocess(self, image: np.ndarray) -> np.ndarray:
        """One host image -> the tower's normalized (S, S, 3) float32
        pixels on the host, as JAX's ``_preprocess``: to [0, 1] by dtype,
        resized like ``jax.image.resize`` "linear" (on the model's device),
        normalized."""
        return self._pixels([image])[0].cpu().numpy()

    def _prompt_ids(self, questions) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompts -> expanded, left-padded ids (B, T) and mask (B, T) bool
        on the device."""
        padded, mask = left_pad([self.build_ids(q) for q in questions],
                                pad_id=self.model.cfg.pad_token_id, bucket=64)
        mask = np.asarray(mask, bool)
        if profiling.recording():
            profiling.count("prefill_tokens", int(mask.sum()))
        dev = self.device
        return (torch.as_tensor(np.asarray(padded, np.int64), device=dev),
                torch.as_tensor(mask, device=dev))

    @profiling.span("backend.detokenize")   # the generated ids' fetch and decode
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
        with profiling.span("backend.extract"):
            with profiling.span("backend.prepare"):
                ids, mask = self._prompt_ids(questions)
                pixels = self._pixels(images)
            gen, maps = self.extract_from_ids(ids, mask, pixels, max_new_tokens)
            return maps, self._decode(gen)

    def answer_batch(self, images, questions: Sequence[str],
                     max_new_tokens: int = 64) -> List[str]:
        """Answer-only greedy generate (``extract_layer=None``): no layer
        builds a probabilities row and nothing is accumulated."""
        with profiling.span("backend.answer"):
            gen, _ = self._generate(*self._prepare(images, questions), extract_layer=None,
                                    max_new_tokens=max_new_tokens)
            return self._decode(gen)
