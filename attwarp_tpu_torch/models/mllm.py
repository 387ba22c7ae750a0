"""What every model family shares: the generate loop and the one-prefill
forward, over a small seam that each family's model class fills in.

A family is three things: how a prompt becomes embeddings, the rotary
position of each token, and the shape of the attention map. ``MLLM``'s
subclasses (``models/llava.py::LlavaModel``, ``models/qwen2vl.py::
Qwen2VLModel``, and ``models/unimoe.py::UniMoEModel`` through Qwen2-VL's)
give them as:

- ``text_params``: the decoder tree that ``models/llama.py`` runs;
- ``prompt(ids, mask, image, host)``: left-padded ids (B, T), their mask
  and the family's image input (or None, a text-only prompt) -> the
  embeddings with the image spliced in (B, T, D), the rotary cos/sin of
  every prompt position (B, T, hd) and a per-row long ``offset`` (B,) such
  that the rotary position of cache slot ``c`` is ``c + offset``. ``host``
  is None, or the same ids and mask as host arrays where the caller holds
  them (the serving engines): the offset is then a host array too, and no
  copy between host and device is added;
- ``decode_rope(positions)``: (B,) rotary positions -> the (B, 1, hd)
  cos/sin of one new token a row;
- ``map_shape(image)``: (rows, columns) of the attention map;
- ``image_input(pixels)``: normalized (B, S, S, 3) pixels on the device ->
  the image input ``prompt`` takes (the serving engines hold pixels).

The generate loop keeps the JAX scan's semantics: the same EOS/PAD rule,
and each extract layer's row accumulated at the prefill and at every
decode step, finished rows included. ``extract_layer`` is None (answer
only), one layer, or a sequence of layers extracted in the same pass
(``models/llama.py::extract_layers_tuple``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from attwarp_tpu_torch.extract.accumulator import accumulate_step, finalize, init_layer_carry
from attwarp_tpu_torch.models.llama import (
    ExtractSpec,
    decoder_decode_step,
    decoder_prefill,
    embed,
    leased_kv_cache,
    local_kv_heads,
)
from attwarp_tpu_torch.utils import profiling


class MLLM:
    """Config plus parameter tree, with the generate loop every family
    shares; a subclass supplies the seam of the module docstring."""

    def __init__(self, cfg, params: Dict[str, Any]):
        self.cfg = cfg
        self.params = params

    @property
    def device(self) -> torch.device:
        return self.text_params["embed_tokens"].device

    def _forward_logits(self, input_ids: torch.Tensor, attention_mask, image,
                        extract_layer: ExtractSpec, use_flash: bool):
        """One prefill: (last-position logits (B, vocab) f32, the extract
        rows: (B, H, T) for a layer, (L, B, H, T) for a sequence, or
        None). A mask of None attends every position."""
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.bool,
                                        device=input_ids.device)
        embeds, cos, sin, _ = self.prompt(input_ids, attention_mask, image, None)
        logits, _, row = decoder_prefill(self.text_params, self.cfg.text, embeds,
                                         attention_mask, cos, sin, input_ids.shape[1],
                                         extract_layer, use_flash)
        return logits, row

    def _generate(self, input_ids: torch.Tensor, attention_mask: torch.Tensor, image,
                  img_start: torch.Tensor, extract_layer: ExtractSpec,
                  max_new_tokens: int, kv_quant: bool, use_flash: bool):
        """Greedy decode of left-padded ``input_ids`` (B, T) with
        ``attention_mask`` (B, T) bool and the image input. Returns
        (generated ids (B, max_new_tokens), maps): (B, h, w) for one
        extract layer, (L, B, h, w) for a sequence of layers (one
        accumulator each, in the spec's order), None when ``extract_layer``
        is None: the answer-only path that builds no probabilities row.
        ``img_start`` (B,) is where each row's image tokens start. At
        ``max_new_tokens=0`` the maps are the prefill's rows alone and no
        decode step runs.

        ``kv_quant`` keeps the cache in int8, rounded up to a multiple of 64
        slots as in JAX (the extra slots stay masked); ``use_flash`` runs
        the prefill through kernel K2."""
        tcfg, text = self.cfg.text, self.text_params
        dev = input_ids.device
        B, T = input_ids.shape
        max_seq = T + max_new_tokens
        if kv_quant:
            max_seq = -(-max_seq // 64) * 64
        side_h, side_w = self.map_shape(image)
        n_img = side_h * side_w
        ones = torch.ones((B,), dtype=torch.float32, device=dev)

        def acc(carry, row):
            if carry is None:
                return None
            return accumulate_step(carry, row, img_start, ones, n_img)

        embeds, cos, sin, offset = self.prompt(input_ids, attention_mask, image, None)
        # the cache comes from the pool, so the decode steps replay CUDA graphs
        with leased_kv_cache(tcfg, B, max_seq, dev, local_kv_heads(text, tcfg),
                             None if kv_quant else embeds.dtype) as kv:
            logits, kv, row0 = decoder_prefill(
                text, tcfg, embeds, attention_mask, cos, sin, max_seq,
                extract_layer, use_flash, kv_quant, cache=kv,
            )
            del embeds, cos, sin
            carry = acc(init_layer_carry(extract_layer, B, n_img, dev), row0)
            tok = torch.argmax(logits, dim=-1)
            finished = tok == self.cfg.eos_token_id
            full_mask = F.pad(attention_mask, (0, max_seq - T))
            toks = [tok.new_empty((B, 0))]
            for step in range(max_new_tokens):
                profiling.count("decode_steps")
                with profiling.span("decode_step"):
                    cur_len = T + step
                    full_mask[:, cur_len] = True
                    cos1, sin1 = self.decode_rope(cur_len + offset)
                    emb = embed(text, tok)[:, None, :]
                    logits, kv, row = decoder_decode_step(
                        text, tcfg, emb, kv, cur_len, cos1, sin1, full_mask,
                        extract_layer=extract_layer,
                    )
                    # every step's row counts, finished rows included (HF generate
                    # keeps forwarding them; llava.py:384-411)
                    carry = acc(carry, row)
                    toks.append(tok[:, None])
                    nxt = torch.argmax(logits, dim=-1)
                    # finished rows continue with PAD, as HF generate does
                    nxt = torch.where(finished, torch.full_like(nxt, self.cfg.pad_token_id), nxt)
                    finished = finished | (nxt == self.cfg.eos_token_id)
                    tok = nxt
        maps = None if carry is None else finalize(carry, side_h, side_w)
        return torch.cat(toks, dim=1), maps
