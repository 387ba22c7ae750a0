"""MiniLLaVA, the small self-contained multimodal decoder that is the test
backend of attention extraction (counterpart of
``attwarp_tpu/extract/mini_llava.py``).

LLaVA-1.5's interface at 1/1000 scale: an image is patchified into
``num_patches²`` visual tokens spliced into the token-embedding sequence at
the image placeholder; a causal decoder (learned positions, LayerNorm, GELU
MLP, one head width) generates greedily; the ``extract_layer``'s
post-softmax attention row of the current token is returned by each forward
and accumulated, the hook-free equivalent of ``MaskHookLogger``
(llava.py:37-153).

Plain functions on tensors, on the device the parameters live on.
``init_params`` draws its own weights from a ``torch.Generator``: JAX's
``init_params`` draws from threefry, which the port cannot reproduce, so the
two packages' seeded minis differ; ``params_from_jax`` carries JAX's weights
across. The decode step writes its key and value into the cache in place.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from attwarp_tpu_torch.extract.accumulator import accumulate_step, finalize, init_carry
from attwarp_tpu_torch.extract.offsets import IMAGE_TOKEN_INDEX, bucket_length


@dataclass(frozen=True)
class MiniLLaVAConfig:
    vocab: int = 4096
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 4
    extract_layer: int = 2
    num_patches: int = 24          # 24x24 = 576 image tokens
    image_size: int = 336
    max_seq: int = 704             # >= 576 + prompt + new tokens
    pad_id: int = 0
    bos_id: int = 1
    eos_id: int = 2

    @property
    def num_image_tokens(self) -> int:
        return self.num_patches * self.num_patches

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def patch_size(self) -> int:
        return self.image_size // self.num_patches


class HashTokenizer:
    """Deterministic word-level tokenizer for the test backend (a copy of
    JAX's): stable ids via blake2; remembers id->word for decoding."""

    def __init__(self, cfg: MiniLLaVAConfig):
        self.cfg = cfg
        self._id_to_word: Dict[int, str] = {}

    def encode_word(self, w: str) -> int:
        h = int.from_bytes(hashlib.blake2s(w.encode()).digest()[:4], "little")
        tid = 10 + h % (self.cfg.vocab - 10)
        self._id_to_word.setdefault(tid, w)
        return tid

    def encode(self, text: str, image_token: str = "<image>") -> List[int]:
        """BOS + word ids, with the image token mapped to IMAGE_TOKEN_INDEX."""
        ids = [self.cfg.bos_id]
        for w in text.replace(image_token, f" {image_token} ").split():
            ids.append(IMAGE_TOKEN_INDEX if w == image_token else self.encode_word(w))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        words = []
        for t in ids:
            t = int(t)
            if t in (self.cfg.pad_id, self.cfg.bos_id, self.cfg.eos_id):
                continue
            words.append(self._id_to_word.get(t, f"<{t}>"))
        return " ".join(words)


def init_params(cfg: MiniLLaVAConfig, generator: torch.Generator) -> Dict[str, Any]:
    """The mini's parameter tree (JAX's names and shapes: normal * 0.02
    matrices and embeddings, unit LayerNorm scales, zero biases), drawn from
    ``generator`` on its device."""
    dev = generator.device
    d = cfg.d_model

    def r(*shape):
        return torch.randn(shape, generator=generator, device=dev).mul_(0.02)

    def ln():
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

    return {
        "tok_emb": r(cfg.vocab, d),
        "pos_emb": r(cfg.max_seq, d),
        "patch_proj": r(cfg.patch_size * cfg.patch_size * 3, d),
        "ln_f": ln(),
        "lm_head": r(d, cfg.vocab),
        "layers": [
            {"ln1": ln(), "ln2": ln(), "wq": r(d, d), "wk": r(d, d), "wv": r(d, d),
             "wo": r(d, d), "w1": r(d, 4 * d), "w2": r(4 * d, d)}
            for _ in range(cfg.n_layers)
        ],
    }


def params_from_jax(tree, device=None) -> Dict[str, Any]:
    """A JAX mini parameter tree (dicts and lists of arrays, e.g. after
    ``jax.device_get``) -> the same tree of f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default


def encode_images(params, cfg: MiniLLaVAConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, num_image_tokens, d_model) patch embeddings."""
    P, n = cfg.patch_size, cfg.num_patches
    B = images.shape[0]
    x = images.to(torch.float32).reshape(B, n, P, n, P, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, n * n, P * P * 3) @ params["patch_proj"]


def encode_image(params, cfg: MiniLLaVAConfig, image: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) -> (num_image_tokens, d_model) patch embeddings."""
    return encode_images(params, cfg, image[None])[0]


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, max_seq, H, hd)
    v: torch.Tensor


def _attention(q, k, v, mask, cfg: MiniLLaVAConfig):
    """q (B, Tq, H, hd); k, v (B, Tk, H, hd); mask (B, Tq, Tk) bool.
    Returns (out (B, Tq, D), probs (B, H, Tq, Tk))."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(cfg.head_dim))
    logits = torch.where(mask[:, None, :, :], logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(out.shape[0], out.shape[1], cfg.d_model), probs


def _heads(x: torch.Tensor, cfg: MiniLLaVAConfig) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.head_dim)


def _mlp_residual(lp, x):
    return x + _gelu(_ln(x, lp["ln2"]) @ lp["w1"]) @ lp["w2"]


def prefill(params, cfg: MiniLLaVAConfig, embeds: torch.Tensor, pos_mask: torch.Tensor):
    """The full prompt: embeds (B, T, D), pos_mask (B, T) valid tokens.
    Returns (last logits (B, vocab), the cache allocated to ``max_seq``
    slots, the extract layer's last-row probabilities (B, H, T))."""
    B, T, D = embeds.shape
    dev = embeds.device
    x = embeds + params["pos_emb"][None, :T]
    shape = (cfg.n_layers, B, cfg.max_seq, cfg.n_heads, cfg.head_dim)
    kv = KVCache(torch.zeros(shape, device=dev), torch.zeros(shape, device=dev))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None]
    mask = causal & pos_mask[:, None, :]
    row = None
    for i, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1"])
        q, k, v = (_heads(h @ lp[w], cfg) for w in ("wq", "wk", "wv"))
        attn, probs = _attention(q, k, v, mask, cfg)
        kv.k[i, :, :T] = k
        kv.v[i, :, :T] = v
        x = _mlp_residual(lp, x + attn @ lp["wo"])
        if i == cfg.extract_layer:
            row = probs[:, :, -1, :]
    x = _ln(x, params["ln_f"])
    return x[:, -1] @ params["lm_head"], kv, row


def decode_step(params, cfg: MiniLLaVAConfig, token: torch.Tensor, kv: KVCache,
                cur_len: int, pos_mask: torch.Tensor):
    """One greedy step: token (B,) at cache position ``cur_len`` (shared by
    the left-padded batch), pos_mask (B, max_seq). Writes the token's keys
    and values into ``kv`` in place. Returns (logits (B, vocab), the cache,
    the extract layer's row (B, H, max_seq))."""
    B = token.shape[0]
    x = params["tok_emb"][token][:, None, :] + params["pos_emb"][cur_len][None, None, :]
    kv_pos = torch.arange(cfg.max_seq, device=token.device)[None, :]
    mask = ((kv_pos <= cur_len) & pos_mask)[:, None, :]            # (B, 1, max_seq)
    row = None
    for i, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1"])
        q, k1, v1 = (_heads(h @ lp[w], cfg) for w in ("wq", "wk", "wv"))
        kv.k[i, :, cur_len] = k1[:, 0]
        kv.v[i, :, cur_len] = v1[:, 0]
        attn, probs = _attention(q, kv.k[i], kv.v[i], mask, cfg)
        x = _mlp_residual(lp, x + attn @ lp["wo"])
        if i == cfg.extract_layer:
            row = probs[:, :, 0, :]
    xf = _ln(x, params["ln_f"])
    return xf[:, 0] @ params["lm_head"], kv, row


def generate_with_attention(params, cfg: MiniLLaVAConfig, embeds: torch.Tensor,
                            pos_mask: torch.Tensor, img_start: torch.Tensor,
                            max_new_tokens: int = 20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode; returns (generated ids (B, max_new_tokens), attention
    maps (B, n, n)). The prefill contributes the last prompt position's row,
    then every decode step's row counts, finished rows included
    (llava.py:109-116, 384-411); finished rows continue with ``eos_id``."""
    B, T, _ = embeds.shape
    ones = torch.ones((B,), dtype=torch.float32, device=embeds.device)
    logits, kv, row0 = prefill(params, cfg, embeds, pos_mask)
    carry = accumulate_step(init_carry(B, cfg.num_image_tokens, device=embeds.device),
                            row0, img_start, ones, cfg.num_image_tokens)
    tok = torch.argmax(logits, dim=-1)
    finished = tok == cfg.eos_id
    full_mask = F.pad(pos_mask, (0, cfg.max_seq - T))
    toks = [tok.new_empty((B, 0))]
    for step in range(max_new_tokens):
        cur_len = T + step
        full_mask[:, cur_len] = True
        logits, kv, row = decode_step(params, cfg, tok, kv, cur_len, full_mask)
        carry = accumulate_step(carry, row, img_start, ones, cfg.num_image_tokens)
        toks.append(tok[:, None])
        nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.eos_id), nxt)
        finished = finished | (nxt == cfg.eos_id)
        tok = nxt
    return torch.cat(toks, dim=1), finalize(carry, cfg.num_patches)


def build_spliced_embeds(params, cfg: MiniLLaVAConfig, padded_ids: np.ndarray,
                         images: torch.Tensor):
    """Expand each image placeholder of ``padded_ids`` (B, L) into the
    image's patch embeddings (images (B, H, W, 3)); returns (embeds
    (B, L_exp, D), pos_mask (B, L_exp), img_start (B,)) on the parameters'
    device. The splice map is built on the host, the expanded prompts
    re-left-padded to a bucket of 8 (the reference's
    prepare_inputs_labels_for_multimodal)."""
    B, L = padded_ids.shape
    n_img = cfg.num_image_tokens
    unpadded = (padded_ids != cfg.pad_id).sum(axis=1)
    exp_lens = unpadded - 1 + n_img
    L_exp = bucket_length(int(exp_lens.max()), bucket=8)

    is_img = np.zeros((B, L_exp), np.bool_)
    src_idx = np.zeros((B, L_exp), np.int64)   # text position or patch index
    pos_mask = np.zeros((B, L_exp), np.bool_)
    img_start = np.zeros((B,), np.int64)
    for b in range(B):
        out = L_exp - int(exp_lens[b])
        for j in range(L):
            t = int(padded_ids[b, j])
            if t == cfg.pad_id and j < L - int(unpadded[b]):
                continue  # left padding
            if t == IMAGE_TOKEN_INDEX:
                img_start[b] = out
                is_img[b, out:out + n_img] = True
                src_idx[b, out:out + n_img] = np.arange(n_img)
                pos_mask[b, out:out + n_img] = True
                out += n_img
            else:
                src_idx[b, out] = j
                pos_mask[b, out] = True
                out += 1

    dev = params["tok_emb"].device
    ids = torch.as_tensor(np.clip(padded_ids, 0, cfg.vocab - 1), device=dev)
    txt_emb = params["tok_emb"][ids]                                   # (B, L, D)
    img_emb = encode_images(params, cfg, images.to(dev))               # (B, n_img, D)
    si = torch.as_tensor(src_idx, device=dev)
    D = txt_emb.shape[-1]
    # each gather reads the other's positions too, clamped in range; the
    # where below keeps only its own
    gather_txt = torch.gather(txt_emb, 1,
                              torch.clamp(si, 0, L - 1)[..., None].expand(B, L_exp, D))
    gather_img = torch.gather(img_emb, 1,
                              torch.clamp(si, 0, n_img - 1)[..., None].expand(B, L_exp, D))
    is_img_t = torch.as_tensor(is_img, device=dev)
    pos_mask_t = torch.as_tensor(pos_mask, device=dev)
    embeds = torch.where(is_img_t[..., None], gather_img, gather_txt)
    embeds = torch.where(pos_mask_t[..., None], embeds, torch.zeros_like(embeds))
    return embeds, pos_mask_t, torch.as_tensor(img_start, device=dev)
