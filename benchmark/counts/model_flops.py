"""Model FLOPs a request needs, counted from a configuration's widths and
the request's token counts: the benchmark's yardstick for the ``mfu``
metrics. Each family's module (``benchmark/families/<family>.py``) counts
its own model with these functions in ``image_flops`` and
``request_flops``; a family whose shape they do not describe brings its own
count there.

The count is of the mathematics, whatever implements it: every matrix
product at 2 flops a multiply-add, attention's q.k and p.v over the causal
pairs a token needs, the LM head only where a token is produced. Norms,
activations, rotary embeddings and softmax are left out (they are a few
flops a value against thousands in the products). Padding, tokens computed
and discarded, and any extra work a kernel does are not counted: a count of
what the work needs, so a share of the peak cannot pass 100% unless the time
leaves out part of the work.
"""

from __future__ import annotations

from dataclasses import dataclass

BF16_PEAK_FLOPS = 989e12      # one H100 SXM, dense bf16, 700 W


@dataclass(frozen=True)
class DecoderDims:
    hidden: int
    heads: int
    kv_heads: int
    head_dim: int
    ffn: int
    vocab: int
    layers: int

    def token_layer_flops(self) -> int:
        """The projections and the gated MLP of one token in one layer."""
        D, q, kv = self.hidden, self.heads * self.head_dim, self.kv_heads * self.head_dim
        return 2 * (D * q + 2 * D * kv + q * D + 3 * D * self.ffn)

    def pair_flops(self) -> int:
        """q.k and p.v of one (query, key) pair over every head of a layer."""
        return 4 * self.head_dim * self.heads


def decoder_flops(d: DecoderDims, n_prompt: int, n_fed: int, n_head: int,
                  n_partial: int = 0, partial_layers: int = 0) -> int:
    """One sequence through the decoder: ``n_prompt`` prompt tokens and
    ``n_fed`` generated tokens fed back, through every layer, attending
    causally; ``n_partial`` more tokens fed through the first
    ``partial_layers`` layers only (a token whose only use is the extract
    layer's attention row); the LM head at ``n_head`` positions."""
    n = n_prompt + n_fed
    full = d.layers * (n * d.token_layer_flops() + n * (n + 1) // 2 * d.pair_flops())
    part = 0
    for j in range(n_partial):
        ctx = n + j + 1   # the keys this token attends to, itself included
        part += partial_layers * (d.token_layer_flops() + ctx * d.pair_flops())
    return full + part + n_head * 2 * d.hidden * d.vocab


def clip_tower_flops(hidden: int, ffn: int, image_size: int, patch: int,
                     layers_run: int, text_hidden: int) -> int:
    """One image through CLIP ViT's patch embedding and its first
    ``layers_run`` blocks (class token included), then LLaVA's two-layer
    projector over the patch tokens."""
    n = (image_size // patch) ** 2
    t = n + 1
    embed = 2 * n * (patch * patch * 3) * hidden
    block = 2 * t * (4 * hidden * hidden + 2 * hidden * ffn) + 4 * t * t * hidden
    projector = 2 * n * (hidden * text_hidden + text_hidden * text_hidden)
    return embed + layers_run * block + projector


def qwen2vl_vision_flops(embed_dim: int, mlp_ratio: int, depth: int, image_size: int,
                         patch: int, merge: int, temporal: int, text_hidden: int) -> int:
    """One image through Qwen2-VL's vision tower: the 3-D patch embedding,
    ``depth`` blocks of full attention over every patch, and the patch
    merger into the text width."""
    n = (image_size // patch) ** 2
    E, F = embed_dim, embed_dim * mlp_ratio
    embed = 2 * n * (3 * temporal * patch * patch) * E
    block = 2 * n * (4 * E * E + 2 * E * F) + 4 * n * n * E
    m = E * merge * merge
    merger = 2 * (n // (merge * merge)) * (m * m + m * text_hidden)
    return embed + depth * block + merger


def decoder_dims(c: dict) -> DecoderDims:
    """A dense decoder's widths from a configuration file: multi-head or
    grouped-query attention with ``hidden / heads`` wide heads and one
    gated MLP width in every layer (LLaVA-1.5's Llama, Qwen2-VL's Qwen2)."""
    t = c.get("text_config", c)
    H = t["num_attention_heads"]
    return DecoderDims(hidden=t["hidden_size"], heads=H,
                       kv_heads=t.get("num_key_value_heads") or H,
                       head_dim=t["hidden_size"] // H, ffn=t["intermediate_size"],
                       vocab=t["vocab_size"], layers=t["num_hidden_layers"])

