"""Qwen2-VL (counterpart of ``attwarp_tpu/models/qwen2vl.py``).

HF ``Qwen2VLForConditionalGeneration`` for one image per sample:

- **Vision**: the 3D patch embed (an image is duplicated over the temporal
  pair) as a matmul with the JAX ``patch_weight`` layout, 2-D rotary
  embeddings over merge-ordered (h, w) patch coordinates, pre-LN blocks with
  QuickGELU MLPs and full attention, and the 2x2 PatchMerger into the text
  width. The vision attention is plain einsum + f32 softmax (no TPU kernel
  is behind it), one image at a time: at 672 px one image's probabilities
  are (16, 2304, 2304) f32, 340 MB.
- **Text**: the Qwen2 decoder (LLaMA with q/k/v biases) with M-RoPE. Its
  prefill and decode step are ``models/llama.py``'s ``decoder_prefill`` and
  ``decoder_decode_step`` given M-RoPE's cos/sin, so the flash prefill runs
  kernel K2 and the int8-cache decode kernel K3, GQA by index, exactly as
  LLaVA's do. ``Qwen2VLModel`` fills in the family seam of
  ``models/mllm.py``, whose generate loop it runs.

``patchify_image``, ``_vision_rot_pos`` and ``get_mrope_positions`` are
numpy, copied from the JAX module (its package imports JAX) and pinned equal
to the originals by ``tests/test_torch_qwen2vl.py``. ``patchify_batch`` is
``patchify_image`` for a batch of images on their device. A JAX parameter
tree converts with ``models/llava.py::params_from_jax``, an HF state dict
with ``port_hf_qwen2vl_weights``.

The vision tower computes in the parameters' dtype. (JAX promotes it to f32
because its patches are f32; on a TPU its default matmul precision rounds
the operands to bf16 all the same.) Norms and the rotary products run in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.kernels.attn_softmax import scaled_softmax_
from attwarp_tpu_torch.models.llama import (
    ExtractSpec,
    _rotate_half,
    decoder_decode_step,
    decoder_prefill,
    embed,
    rope_inv_freq,
)
from attwarp_tpu_torch.models.mllm import MLLM
from attwarp_tpu_torch.numerics.quant import row_linear
from attwarp_tpu_torch.parallel.comm import all_gather, split_group
from attwarp_tpu_torch.utils import profiling


# ── configs ─────────────────────────────────────────────────────────────


@dataclass(frozen=True)
class Qwen2VLVisionConfig:
    depth: int = 32
    embed_dim: int = 1280
    hidden_size: int = 3584          # text width the merger projects into
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    spatial_merge_size: int = 2
    temporal_patch_size: int = 2
    mlp_ratio: int = 4
    hidden_act: str = "quick_gelu"

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclass(frozen=True)
class Qwen2VLTextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, ...] = (16, 24, 24)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads


@dataclass(frozen=True)
class Qwen2VLConfig:
    vision: Qwen2VLVisionConfig = field(default_factory=Qwen2VLVisionConfig)
    text: Qwen2VLTextConfig = field(default_factory=Qwen2VLTextConfig)
    image_token_id: int = 151655
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653
    pad_token_id: int = 151643
    eos_token_id: int = 151645


def config_from_dict(d: Dict[str, Any]) -> Qwen2VLConfig:
    """``dataclasses.asdict`` of a Qwen2-VL config (the port's or JAX's)
    -> ``Qwen2VLConfig`` (``mrope_section`` back to a tuple, as JSON gives
    a list)."""
    text = dict(d["text"], mrope_section=tuple(d["text"]["mrope_section"]))
    return Qwen2VLConfig(vision=Qwen2VLVisionConfig(**d["vision"]),
                         text=Qwen2VLTextConfig(**text),
                         **{k: v for k, v in d.items() if k not in ("vision", "text")})


# ── image patchification (HF Qwen2VLImageProcessor layout) ──────────────


def patchify_image(image: np.ndarray, cfg: Qwen2VLVisionConfig) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """(H, W, 3) float (H, W divisible by patch*merge) -> (num_patches,
    C*T*P*P) in HF's spatial-merge-ordered flattened layout + grid (t, h, w).
    """
    P, M, T = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    H, W = image.shape[:2]
    gh, gw = H // P, W // P
    assert gh % M == 0 and gw % M == 0, (H, W)
    x = np.asarray(image, np.float32).transpose(2, 0, 1)          # (C, H, W)
    x = np.broadcast_to(x[None], (T, *x.shape))                   # (T, C, H, W)
    x = x.reshape(1, T, cfg.in_channels, gh // M, M, P, gw // M, M, P)
    # -> (grid_t, gh_block, gw_block, merge_h, merge_w, C, T, P, P)
    x = x.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = x.reshape(gh * gw, cfg.in_channels * T * P * P)
    return np.ascontiguousarray(flat), (1, gh, gw)


def patchify_batch(images: torch.Tensor, cfg: Qwen2VLVisionConfig
                   ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """``patchify_image`` for a batch on its device: (B, H, W, 3) ->
    ((B, num_patches, C*T*P*P), grid (t, h, w))."""
    P, M, T = cfg.patch_size, cfg.spatial_merge_size, cfg.temporal_patch_size
    B, H, W, C = images.shape
    gh, gw = H // P, W // P
    if gh % M or gw % M or C != cfg.in_channels:
        raise ValueError(f"patchify_batch: images {tuple(images.shape)} do not "
                         f"tile into {P * M}-pixel merge blocks")
    x = images.permute(0, 3, 1, 2)[:, None].expand(B, T, C, H, W)
    x = x.reshape(B, T, C, gh // M, M, P, gw // M, M, P)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(B, gh * gw, C * T * P * P), (1, gh, gw)


# ── vision tower ────────────────────────────────────────────────────────


def _vision_rot_pos(grid_hw: Tuple[int, int], cfg: Qwen2VLVisionConfig) -> np.ndarray:
    """(num_patches, head_dim/2) rotary frequencies over merge-ordered (h, w)."""
    gh, gw = grid_hw
    M = cfg.spatial_merge_size
    h = np.arange(gh)[:, None].repeat(gw, 1)
    w = np.arange(gw)[None, :].repeat(gh, 0)

    def merge_order(a):
        return (
            a.reshape(gh // M, M, gw // M, M).transpose(0, 2, 1, 3).reshape(-1)
        )

    hpos, wpos = merge_order(h), merge_order(w)
    dim = cfg.head_dim // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    fh = hpos[:, None] * inv_freq[None, :]
    fw = wpos[:, None] * inv_freq[None, :]
    return np.concatenate([fh, fw], axis=-1).astype(np.float32)  # (N, hd/2)


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in f32, returned in x's dtype."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps) * p["weight"].to(torch.float32)
    return (y + p["bias"].to(torch.float32)).to(x.dtype)


def _lin(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    return F.linear(x, p["weight"], p["bias"])


def _rope_f32(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    x32 = x.to(torch.float32)
    return (x32 * cos + _rotate_half(x32) * sin).to(x.dtype)


@profiling.span("vision")
def qwen2vl_vision_features(
    params: Dict[str, Any],
    cfg: Qwen2VLVisionConfig,
    patches: torch.Tensor,          # (B, N, C*T*P*P) HF-patchified
    grid_hw: Tuple[int, int],       # (gh, gw), one grid for the batch
) -> torch.Tensor:
    """Vision tower -> merged features (B, N / merge², hidden_size). On a
    tensor-parallel rank (``parallel/llava_sharding.py``) each block holds
    its heads of ``qkv`` and its slice of ``fc1``; ``proj``, ``fc2`` and
    the merger's ``fc2`` sum over the ``model`` axis."""
    dt = params["patch_weight"].dtype
    B, N, _ = patches.shape
    hd = cfg.head_dim
    x = all_gather(patches.to(dt) @ params["patch_weight"].T,      # (B, N, embed)
                   split_group(params, "patch"), -1)
    freqs = torch.as_tensor(_vision_rot_pos(grid_hw, cfg), device=x.device)
    emb = torch.cat([freqs, freqs], dim=-1)                        # (N, hd)
    cos = torch.cos(emb)[:, None, :]
    sin = torch.sin(emb)[:, None, :]
    scale = 1.0 / math.sqrt(hd)
    for blk in params["blocks"]:
        h = _ln(x, blk["norm1"])
        q, k, v = _lin(h, blk["qkv"]).reshape(B, N, 3, -1, hd).unbind(2)
        q = _rope_f32(q, cos, sin)
        k = _rope_f32(k, cos, sin)
        attn = torch.empty_like(q)
        for b in range(B):   # one image's (H, N, N) probabilities at a time
            logits = torch.einsum("qhd,khd->hqk", q[b], k[b])
            probs = scaled_softmax_(logits, scale)      # K4, over the logits
            attn[b] = torch.einsum("hqk,khd->qhd", probs, v[b])
            del logits, probs
        x = x + row_linear(attn.reshape(B, N, -1), blk["proj"], split_group(blk, "attn"))
        m = _lin(_ln(x, blk["norm2"]), blk["fc1"])
        m = m * torch.sigmoid(1.702 * m) if cfg.hidden_act == "quick_gelu" else F.gelu(m)
        x = x + row_linear(m, blk["fc2"], split_group(blk, "mlp"))

    # PatchMerger: LN per patch, group merge² consecutive patches, MLP
    mg = params["merger"]
    y = _ln(x, mg["ln_q"]).reshape(B, -1, cfg.embed_dim * cfg.spatial_merge_size ** 2)
    y = F.gelu(_lin(y, mg["fc1"]), approximate="none")
    return row_linear(y, mg["fc2"], split_group(mg, "mlp"))       # (B, N/4, hidden)


# ── M-RoPE ──────────────────────────────────────────────────────────────


def get_mrope_positions(
    input_ids: np.ndarray,          # (B, T) with expanded image tokens
    attention_mask: np.ndarray,     # (B, T)
    grid_thw: Tuple[int, int, int],
    image_token_id: int,
    spatial_merge_size: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """HF ``get_rope_index`` for one image per sample (or pure text):
    returns (position_ids (3, B, T), rope_deltas (B,))."""
    B, T = input_ids.shape
    t, h, w = grid_thw
    gh, gw = h // spatial_merge_size, w // spatial_merge_size
    pos = np.ones((3, B, T), np.int64)
    deltas = np.zeros((B,), np.int64)
    for b in range(B):
        valid = attention_mask[b] == 1
        ids = input_ids[b][valid]
        parts: List[np.ndarray] = []
        img_idx = np.nonzero(ids == image_token_id)[0]
        if img_idx.size:
            ed = int(img_idx[0])
            parts.append(np.tile(np.arange(ed), (3, 1)))
            st_idx = ed
            t_i = np.repeat(np.arange(t), gh * gw)
            h_i = np.tile(np.repeat(np.arange(gh), gw), t)
            w_i = np.tile(np.arange(gw), t * gh)
            parts.append(np.stack([t_i, h_i, w_i]) + st_idx)
            st = ed + t * gh * gw
            if st < len(ids):
                st_idx = parts[-1].max() + 1
                parts.append(np.tile(np.arange(len(ids) - st), (3, 1)) + st_idx)
            llm = np.concatenate(parts, axis=1)
        else:
            llm = np.tile(np.arange(len(ids)), (3, 1))
        pos[:, b, valid] = llm
        deltas[b] = llm.max() + 1 - T
    return pos, deltas


def mrope_cos_sin(positions: torch.Tensor, cfg: Qwen2VLTextConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-stream positions (3, B, T) -> effective (cos, sin) of shape
    (B, T, head_dim), f32, with channels interleaved per ``mrope_section``
    (HF apply_multimodal_rotary_pos_emb semantics)."""
    inv = rope_inv_freq(cfg.head_dim, cfg.rope_theta, positions.device)
    freqs = positions[..., None].to(torch.float32) * inv          # (3, B, T, hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)                       # (3, B, T, hd)
    cos3, sin3 = torch.cos(emb), torch.sin(emb)
    out_c, out_s = [], []
    offset = 0
    for i, sec in enumerate(list(cfg.mrope_section) * 2):
        out_c.append(cos3[i % 3, :, :, offset:offset + sec])
        out_s.append(sin3[i % 3, :, :, offset:offset + sec])
        offset += sec
    return torch.cat(out_c, dim=-1), torch.cat(out_s, dim=-1)


# ── text decoder ────────────────────────────────────────────────────────


def qwen2vl_prefill(
    params, cfg: Qwen2VLTextConfig, inputs_embeds, attention_mask, cos, sin,
    max_seq: int, extract_layer: ExtractSpec = None, kv_quant: bool = False,
    use_flash: bool = False, cache=None,
):
    """Returns (last logits (B, vocab) f32, the KV cache, the extract rows:
    (B, H, T) for a layer, (L, B, H, T) for a sequence of layers, or None):
    ``decoder_prefill`` at M-RoPE's ``cos``/``sin``, into ``cache`` where
    given.
    M-RoPE only changes the rotary tables applied to q and k before
    attention, so ``use_flash`` runs the same kernel K2 as LLaVA's prefill
    (JAX gate: 256 tokens and up)."""
    return decoder_prefill(params, cfg, inputs_embeds, attention_mask, cos, sin,
                           max_seq, extract_layer, use_flash, kv_quant, cache)


def qwen2vl_decode_step(
    params, cfg: Qwen2VLTextConfig, token_embeds, kv, cur_len, cos, sin,
    kv_mask, extract_layer: ExtractSpec = None,
):
    """One token against a dense or int8 cache (``decoder_decode_step``):
    written in place at ``cur_len`` (an int, or a (B,) tensor of per-slot
    positions); on the int8 cache every layer that ``extract_layer`` does
    not list reads it through kernel K3 by layer index."""
    return decoder_decode_step(params, cfg, token_embeds, kv, cur_len, cos, sin,
                               kv_mask, extract_layer)


# ── combined model ──────────────────────────────────────────────────────


def embed_and_splice(params, cfg: Qwen2VLConfig, input_ids: torch.Tensor,
                     image_features: torch.Tensor) -> torch.Tensor:
    """Replace image-token embeddings with vision features in order.
    ``image_features``: (N_img_tokens, D) for one image shared across the
    batch, or (B, N_img_tokens, D) per sample (same token count)."""
    emb = embed(params["text"], torch.clamp(input_ids, min=0))
    feats = image_features.to(emb.dtype)
    is_img = input_ids == cfg.image_token_id
    order = torch.clamp(torch.cumsum(is_img.to(torch.int64), dim=1) - 1, 0,
                        feats.shape[-2] - 1)
    if feats.ndim == 2:
        img_at = feats[order]
    else:
        img_at = torch.gather(feats, 1, order[..., None].expand(-1, -1, feats.shape[-1]))
    return torch.where(is_img[..., None], img_at, emb)


class Qwen2VLModel(MLLM):
    """Config plus parameter tree: ``models/mllm.py``'s generate loop over
    Qwen2-VL's seam. The image input is (patches, grid (t, h, w)); the
    prompt's positions are M-RoPE's, and after the prompt all three streams
    share the text position, so a row's rotary offset is its M-RoPE delta
    (HF ``get_rope_index``); the map is the merged grid."""

    @property
    def text_params(self) -> Dict[str, Any]:
        return self.params["text"]

    @property
    def merge(self) -> int:
        """Patches merged into one image token, a side (M-RoPE's grid)."""
        return self.cfg.vision.spatial_merge_size

    def image_features(self, patches: torch.Tensor,
                       grid_thw: Tuple[int, int, int]) -> torch.Tensor:
        """The vision tower over ``patches``: (B, N, C*T*P*P) per-sample
        images -> (B, N/M^2, D); (N, C*T*P*P), one image shared by the
        batch, -> (N/M^2, D), the tower run once (the splice takes both)."""
        vis = self.params["vision"]
        hw = (grid_thw[1], grid_thw[2])
        if patches.ndim == 2:
            return qwen2vl_vision_features(vis, self.cfg.vision, patches[None], hw)[0]
        return qwen2vl_vision_features(vis, self.cfg.vision, patches, hw)

    def prompt(self, ids: torch.Tensor, mask: torch.Tensor, image, host):
        """(embeddings, cos, sin, offset) of a left-padded prompt, the
        tower's features of ``image`` ((patches, grid), or None) spliced in
        (``models/mllm.py`` has the contract). The M-RoPE positions are
        worked out on the host: without ``host`` the ids and mask are
        fetched there, under the ``mrope_positions`` span."""
        dev = ids.device
        grid = (1, self.merge, self.merge) if image is None else image[1]
        if host is None:
            with profiling.span("mrope_positions"):   # the prompt's fetch to the host
                pos, deltas = get_mrope_positions(ids.cpu().numpy(), mask.cpu().numpy(), grid,
                                                  self.cfg.image_token_id, self.merge)
            offset = torch.as_tensor(deltas, device=dev)
        else:
            pos, offset = get_mrope_positions(*host, grid, self.cfg.image_token_id, self.merge)
        embeds = (embed_and_splice(self.params, self.cfg, ids, self.image_features(*image))
                  if image is not None else embed(self.text_params, ids))
        cos, sin = mrope_cos_sin(torch.as_tensor(pos, device=dev), self.cfg.text)
        return embeds, cos, sin, offset

    def decode_rope(self, positions: torch.Tensor):
        return mrope_cos_sin(positions[None, :, None].expand(3, -1, 1), self.cfg.text)

    def map_shape(self, image) -> Tuple[int, int]:
        grid = image[1]
        return grid[1] // self.merge, grid[2] // self.merge

    def image_input(self, pixels: torch.Tensor):
        return patchify_batch(pixels, self.cfg.vision)

    def forward_logits(self, input_ids: torch.Tensor, patches: torch.Tensor,
                       grid_thw: Tuple[int, int, int],
                       attention_mask: Optional[torch.Tensor] = None,
                       extract_layer: ExtractSpec = None, use_flash: bool = False):
        """One prefill of ``patches`` (B, N, C*T*P*P), or (N, C*T*P*P) for
        one image shared by the batch: (last-position logits (B, vocab)
        f32, the extract rows: (B, H, T) for a layer, (L, B, H, T) for a
        sequence of layers, or None)."""
        return self._forward_logits(input_ids, attention_mask, (patches, grid_thw),
                                    extract_layer, use_flash)

    def generate_with_attention(
        self,
        input_ids: torch.Tensor,        # (B, T) expanded, left-padded
        patches: torch.Tensor,          # (B, N, C*T*P*P) or one shared (N, C*T*P*P)
        grid_thw: Tuple[int, int, int],
        attention_mask: torch.Tensor,   # (B, T) bool
        extract_layer: ExtractSpec = 20,
        max_new_tokens: int = 20,
        kv_quant: bool = False,
        use_flash: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Greedy decode (``MLLM._generate``). Returns (generated ids (B,
        max_new_tokens), maps): (B, gh/M, gw/M) for one extract layer, (L,
        B, gh/M, gw/M) for a sequence of layers, None when
        ``extract_layer`` is None. ``patches`` of shape (N, C*T*P*P) is one
        image shared by the whole batch: the vision tower runs once. As
        JAX's scan, decode step s is at position ``T + rope_delta + s`` on
        all three M-RoPE streams."""
        img_start = (input_ids == self.cfg.image_token_id).to(torch.int32).argmax(dim=1)
        return self._generate(input_ids, attention_mask, (patches, grid_thw), img_start,
                              extract_layer, max_new_tokens, kv_quant, use_flash)


def port_hf_qwen2vl_weights(state_dict: Dict[str, torch.Tensor], cfg: Qwen2VLConfig,
                            device=None, dtype=torch.float32) -> Dict[str, Any]:
    """An HF ``Qwen2VLForConditionalGeneration`` state dict -> the port's
    parameter tree, every tensor cast to ``dtype`` on ``device`` straight
    from the state dict's tensors. Takes both key layouts: ``visual.*`` /
    ``model.*`` and (transformers >= 4.52) ``model.visual.*`` /
    ``model.language_model.*``. The 3-D patch conv ``(embed, C, T, P, P)``
    flattens as it is (the ``patchify_image`` layout)."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("model.visual."):
            k = "visual." + k[len("model.visual."):]
        elif k.startswith("model.language_model."):
            k = "model." + k[len("model.language_model."):]
        sd[k] = v

    def g(key):
        return sd[key].detach().to(device=device, dtype=dtype)

    def wb(prefix):
        return {"weight": g(prefix + ".weight"), "bias": g(prefix + ".bias")}

    pw = g("visual.patch_embed.proj.weight")
    vision = {
        "patch_weight": pw.reshape(pw.shape[0], -1),
        "blocks": [
            {
                "norm1": wb(f"visual.blocks.{i}.norm1"),
                "norm2": wb(f"visual.blocks.{i}.norm2"),
                "qkv": wb(f"visual.blocks.{i}.attn.qkv"),
                "proj": wb(f"visual.blocks.{i}.attn.proj"),
                "fc1": wb(f"visual.blocks.{i}.mlp.fc1"),
                "fc2": wb(f"visual.blocks.{i}.mlp.fc2"),
            }
            for i in range(cfg.vision.depth)
        ],
        "merger": {"ln_q": wb("visual.merger.ln_q"), "fc1": wb("visual.merger.mlp.0"),
                   "fc2": wb("visual.merger.mlp.2")},
    }
    text = {
        "embed_tokens": g("model.embed_tokens.weight"),
        "norm": g("model.norm.weight"),
        "layers": [
            {
                "input_layernorm": g(f"model.layers.{i}.input_layernorm.weight"),
                "post_attention_layernorm": g(
                    f"model.layers.{i}.post_attention_layernorm.weight"),
                **{k: wb(f"model.layers.{i}.self_attn.{k}")
                   for k in ("q_proj", "k_proj", "v_proj")},
                "o_proj": g(f"model.layers.{i}.self_attn.o_proj.weight"),
                **{k: g(f"model.layers.{i}.mlp.{k}.weight")
                   for k in ("gate_proj", "up_proj", "down_proj")},
            }
            for i in range(cfg.text.num_hidden_layers)
        ],
    }
    if "lm_head.weight" in sd:
        text["lm_head"] = g("lm_head.weight")
    return {"vision": vision, "text": text}


def random_params(cfg: Qwen2VLConfig, generator: torch.Generator, device,
                  dtype=torch.bfloat16) -> Dict[str, Any]:
    """Random Qwen2-VL weights made on ``device`` from ``generator`` (which
    must live on that device), scaled as ``tools/bench_qwen_prefill.py``:
    normal / sqrt(fan_in) matrices, normal * 0.02 embeddings and LM head,
    unit norms, zero biases (q/k/v carry biases, as in HF)."""
    v, t = cfg.vision, cfg.text

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    def mat(n_out, n_in):
        return randn(n_out, n_in).mul_(1.0 / math.sqrt(n_in))

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def lin(n_out, n_in):
        return {"weight": mat(n_out, n_in), "bias": zeros(n_out)}

    def ln(n):
        return {"weight": ones(n), "bias": zeros(n)}

    E, D = v.embed_dim, t.hidden_size
    Em = E * v.spatial_merge_size ** 2
    kvd = t.kv_heads * t.head_dim
    n_patch_in = v.in_channels * v.temporal_patch_size * v.patch_size ** 2
    return {
        "vision": {
            "patch_weight": mat(E, n_patch_in),
            "blocks": [
                {
                    "norm1": ln(E),
                    "norm2": ln(E),
                    "qkv": lin(3 * E, E),
                    "proj": lin(E, E),
                    "fc1": lin(E * v.mlp_ratio, E),
                    "fc2": lin(E, E * v.mlp_ratio),
                }
                for _ in range(v.depth)
            ],
            "merger": {"ln_q": ln(E), "fc1": lin(Em, Em), "fc2": lin(v.hidden_size, Em)},
        },
        "text": {
            "embed_tokens": randn(t.vocab_size, D).mul_(0.02),
            "lm_head": randn(t.vocab_size, D).mul_(0.02),
            "norm": ones(D),
            "layers": [
                {
                    "input_layernorm": ones(D),
                    "post_attention_layernorm": ones(D),
                    "q_proj": lin(D, D),
                    "k_proj": lin(kvd, D),
                    "v_proj": lin(kvd, D),
                    "o_proj": mat(D, D),
                    "gate_proj": mat(t.intermediate_size, D),
                    "up_proj": mat(t.intermediate_size, D),
                    "down_proj": mat(D, t.intermediate_size),
                }
                for _ in range(t.num_hidden_layers)
            ],
        },
    }
