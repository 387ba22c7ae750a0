"""Tensor-parallel LLaVA-1.5 and Qwen2-VL (counterpart of
``attwarp_tpu/parallel/llava_sharding.py``).

The Megatron layout over the ``model`` axis, as JAX names it:

- attention q/k/v projections and MLP gate/up (CLIP's fc1, the projector's
  ``linear_1``, Qwen's vision ``qkv``/``fc1`` and merger ``fc1``):
  column-parallel, the output axis split, so each rank holds whole heads;
- attention output and MLP down (CLIP's ``out_proj``/``fc2``, the
  projector's ``linear_2``, Qwen's vision ``proj``/``fc2`` and merger
  ``fc2``): row-parallel, the input axis split, one all-reduce each;
- embeddings and LM head: vocabulary-parallel; the patch embeddings'
  output channels split;
- norms, positions and the row-parallel biases: replicated.

``llava_param_specs``/``qwen2vl_param_specs`` return JAX's specs for the
port's tree (a spec is a tuple of axis names or None, JAX's
``PartitionSpec``; ``_quant_aware`` expands them over int8 linears: ``q``
keeps the dense spec, ``s``/``b`` follow the output axis).

``shard_llava_params``/``shard_qwen2vl_params`` return this rank's slice of
a full tree. JAX hands the specs to XLA, which may cut an axis anywhere;
the port computes by hand, so it cuts at whole heads and places the
collectives itself: the sharded tree carries a ``parallel/comm.py::
ModelShard`` under ``"tp"`` (in each tower, decoder and layer), and the
models read it (``numerics/quant.py::row_linear``, ``models/llama.py::
embed`` and ``_stack_rows``, ``lm_logits``). Where the model axis does not
divide an axis the rank keeps it whole, as JAX's ``_divisible`` does (``_split``), and
the function computed is the same: attention stays whole where the query
heads do not divide; kv heads that do not divide are kept per rank as the
rank's query heads read them (every rank's heads must then share one kv
head). Qwen's fused vision ``qkv`` is cut per q, k and v at whole heads.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from attwarp_tpu_torch.models.moe import refuse_experts
from attwarp_tpu_torch.numerics.quant import is_quantized
from attwarp_tpu_torch.parallel.comm import Group, ModelShard
from attwarp_tpu_torch.parallel.mesh import Mesh

COL = ("model", None)
ROW = (None, "model")


def _llama_layer_specs() -> Dict[str, tuple]:
    return {
        "input_layernorm": (),
        "post_attention_layernorm": (),
        # weights are (out_features, in_features); y = x @ W.T
        "q_proj": COL,    # column parallel
        "k_proj": COL,
        "v_proj": COL,
        "o_proj": ROW,    # row parallel -> all-reduce
        "gate_proj": COL,
        "up_proj": COL,
        "down_proj": ROW,
    }


def _vision_layer_specs() -> Dict[str, Any]:
    col = {"weight": COL, "bias": ("model",)}
    row = {"weight": ROW, "bias": ()}
    rep = {"weight": (), "bias": ()}
    return {
        "layer_norm1": rep,
        "layer_norm2": rep,
        "q_proj": col,
        "k_proj": col,
        "v_proj": col,
        "out_proj": row,
        "fc1": col,
        "fc2": row,
    }


def llava_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """The spec tree matching a LLaVA parameter tree (JAX's specs)."""
    specs: Dict[str, Any] = {
        "vision": {
            "patch_weight": COL,
            "class_embedding": (),
            "position_embedding": (),
            "pre_layrnorm": {"weight": (), "bias": ()},
            "layers": [_vision_layer_specs() for _ in params["vision"]["layers"]],
        },
        "projector": {
            "linear_1": {"weight": COL, "bias": ("model",)},
            "linear_2": {"weight": ROW, "bias": ()},
        },
        "llama": {
            "embed_tokens": COL,   # vocab-parallel
            "norm": (),
            "layers": [_llama_layer_specs() for _ in params["llama"]["layers"]],
        },
    }
    if "lm_head" in params["llama"]:
        specs["llama"]["lm_head"] = COL
    return specs


def _quant_aware(params: Any, spec: Any) -> Any:
    """Expand spec leaves into ``{"q", "s"[, "b"]}`` spec dicts wherever the
    matching parameter is an int8 linear (``numerics/quant.py``): the int8
    matrix keeps the dense weight's spec; the per-output-channel scale (and
    bias) follow the output axis."""
    if is_quantized(params):
        base = spec["weight"] if isinstance(spec, dict) else spec
        out_ax = base[0] if len(base) >= 1 else None
        q = {"q": base, "s": (out_ax,) if out_ax is not None else ()}
        if "b" in params:
            q["b"] = q["s"]
        return q
    if isinstance(spec, dict):
        return {k: _quant_aware(params[k], v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_quant_aware(p, s) for p, s in zip(params, spec)]
    return spec


# ── slicing ─────────────────────────────────────────────────────────────


def _cut(x: torch.Tensor, dim: int, start: int, size: int) -> torch.Tensor:
    """A copy of ``x``'s slice (so that the full tensor can be freed)."""
    return x.narrow(dim, start, size).clone(memory_format=torch.contiguous_format)


def _rows(w: Any, start: int, size: int) -> Any:
    """Output rows [start, start + size) of a linear in any weight form:
    the matrix's rows and, where present, its bias, scales."""
    if isinstance(w, torch.Tensor):
        return _cut(w, 0, start, size)
    return {k: _cut(v, 0, start, size) for k, v in w.items()}


def _cols(w: Any, start: int, size: int) -> Any:
    """Input columns [start, start + size) of a linear; its bias and
    per-output scales stay whole."""
    if isinstance(w, torch.Tensor):
        return _cut(w, 1, start, size)
    key = "q" if is_quantized(w) else "weight"
    return {k: (_cut(v, 1, start, size) if k == key else v) for k, v in w.items()}


def _head_plan(H: int, kvH: int, g: Group) -> Optional[Tuple[int, int, int, int]]:
    """(this rank's first query head, its query heads, its first kv head,
    its kv heads) as a 4-tuple, or None where attention stays whole."""
    n = g.size
    if H % n:
        return None
    Hl, n_rep = H // n, H // kvH
    if kvH % n == 0:
        kvl = kvH // n
        return g.rank * Hl, Hl, g.rank * kvl, kvl
    if n_rep % Hl == 0:     # the rank's query heads all read one kv head
        return g.rank * Hl, Hl, (g.rank * Hl) // n_rep, 1
    return None


def _split(width: int, g: Group) -> Optional[Tuple[int, int]]:
    """(start, size) of the rank's slice of an axis of ``width``, or None
    where the model axis does not divide it."""
    if width % g.size:
        return None
    size = width // g.size
    return g.rank * size, size


def _shard_decoder(tree: Dict[str, Any], H: int, kvH: int, hd: int, inter: int,
                   vocab: int, g: Group) -> Dict[str, Any]:
    """A LLaMA/Qwen2 decoder tree -> this rank's (a dense one: a tree with
    routed experts is refused)."""
    refuse_experts(tree, "tensor-parallel sharding")
    heads = _head_plan(H, kvH, g)
    ffn = _split(inter, g)
    voc = _split(vocab, g)
    shard = ModelShard(g, kv_heads=heads[3] if heads else kvH, attn=heads is not None,
                       mlp=ffn is not None, vocab=voc is not None)
    layers = []
    for lp in tree["layers"]:
        out = dict(lp, tp=shard)
        if heads:
            q0, Hl, k0, kvl = heads
            out["q_proj"] = _rows(lp["q_proj"], q0 * hd, Hl * hd)
            out["k_proj"] = _rows(lp["k_proj"], k0 * hd, kvl * hd)
            out["v_proj"] = _rows(lp["v_proj"], k0 * hd, kvl * hd)
            out["o_proj"] = _cols(lp["o_proj"], q0 * hd, Hl * hd)
        if ffn:
            out["gate_proj"] = _rows(lp["gate_proj"], *ffn)
            out["up_proj"] = _rows(lp["up_proj"], *ffn)
            out["down_proj"] = _cols(lp["down_proj"], *ffn)
        layers.append(out)
    new = dict(tree, layers=layers, tp=shard)
    if voc:
        for k in ("embed_tokens", "lm_head"):
            if k in tree:
                new[k] = _rows(tree[k], *voc)
    return new


def _shard_heads_block(lp: Dict[str, Any], heads: int, hd: int, inter: int, g: Group,
                       q: Tuple[str, ...], out: str, fc: Tuple[str, str]) -> Dict[str, Any]:
    """A vision block: its attention split at whole heads (``q`` names the
    q/k/v linears, or the one fused ``qkv``) and its MLP ``fc``."""
    plan = _head_plan(heads, heads, g)
    ffn = _split(inter, g)
    new = dict(lp, tp=ModelShard(g, attn=plan is not None, mlp=ffn is not None))
    if plan:
        h0, hl = plan[0], plan[1]
        if q == ("qkv",):
            E = heads * hd
            parts = [_rows(lp["qkv"], j * E + h0 * hd, hl * hd) for j in range(3)]
            new["qkv"] = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        else:
            for name in q:
                new[name] = _rows(lp[name], h0 * hd, hl * hd)
        new[out] = _cols(lp[out], h0 * hd, hl * hd)
    if ffn:
        new[fc[0]] = _rows(lp[fc[0]], *ffn)
        new[fc[1]] = _cols(lp[fc[1]], *ffn)
    return new


def shard_llava_params(params: Dict[str, Any], mesh: Mesh, cfg) -> Dict[str, Any]:
    """This rank's tensor-parallel slice of a LLaVA parameter tree (``cfg``
    a ``LlavaConfig``: the head counts fix where the cuts fall). With one
    rank on ``model`` the tree is returned as it is."""
    g = mesh.model
    if g.size == 1:
        return params
    v, t = cfg.vision, cfg.text
    vis = params["vision"]
    patch = _split(vis["patch_weight"].shape[0], g)
    vision = dict(vis, tp=ModelShard(g, patch=patch is not None), layers=[
        _shard_heads_block(lp, v.num_attention_heads, v.head_dim, v.intermediate_size, g,
                           ("q_proj", "k_proj", "v_proj"), "out_proj", ("fc1", "fc2"))
        for lp in vis["layers"]])
    if patch:
        vision["patch_weight"] = _rows(vis["patch_weight"], *patch)
    proj = params["projector"]
    mid = _split(proj["linear_1"]["weight"].shape[0], g)
    projector = dict(proj, tp=ModelShard(g, mlp=mid is not None))
    if mid:
        projector["linear_1"] = _rows(proj["linear_1"], *mid)
        projector["linear_2"] = _cols(proj["linear_2"], *mid)
    llama = _shard_decoder(params["llama"], t.num_attention_heads, t.kv_heads, t.head_dim,
                           t.intermediate_size, t.vocab_size, g)
    return {**params, "vision": vision, "projector": projector, "llama": llama}


# ── Qwen2-VL (same Megatron layout; different tree shape) ───────────────


def _qwen_text_layer_specs() -> Dict[str, Any]:
    col = {"weight": COL, "bias": ("model",)}
    return {
        "input_layernorm": (),
        "post_attention_layernorm": (),
        "q_proj": col,
        "k_proj": col,
        "v_proj": col,
        "o_proj": ROW,
        "gate_proj": COL,
        "up_proj": COL,
        "down_proj": ROW,
    }


def _qwen_vision_block_specs() -> Dict[str, Any]:
    rep = {"weight": (), "bias": ()}
    return {
        "norm1": rep,
        "norm2": rep,
        "qkv": {"weight": COL, "bias": ("model",)},
        "proj": {"weight": ROW, "bias": ()},
        "fc1": {"weight": COL, "bias": ("model",)},
        "fc2": {"weight": ROW, "bias": ()},
    }


def qwen2vl_param_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        "vision": {
            "patch_weight": COL,
            "blocks": [_qwen_vision_block_specs() for _ in params["vision"]["blocks"]],
            "merger": {
                "ln_q": {"weight": (), "bias": ()},
                "fc1": {"weight": COL, "bias": ("model",)},
                "fc2": {"weight": ROW, "bias": ()},
            },
        },
        "text": {
            "embed_tokens": COL,
            "norm": (),
            "layers": [_qwen_text_layer_specs() for _ in params["text"]["layers"]],
        },
    }
    if "lm_head" in params["text"]:
        specs["text"]["lm_head"] = COL
    return specs


def shard_qwen2vl_params(params: Dict[str, Any], mesh: Mesh, cfg) -> Dict[str, Any]:
    """This rank's tensor-parallel slice of a Qwen2-VL parameter tree
    (``cfg`` a ``Qwen2VLConfig``)."""
    g = mesh.model
    if g.size == 1:
        return params
    v, t = cfg.vision, cfg.text
    vis = params["vision"]
    patch = _split(vis["patch_weight"].shape[0], g)
    mg = vis["merger"]
    mid = _split(mg["fc1"]["weight"].shape[0], g)
    merger = dict(mg, tp=ModelShard(g, mlp=mid is not None))
    if mid:
        merger["fc1"] = _rows(mg["fc1"], *mid)
        merger["fc2"] = _cols(mg["fc2"], *mid)
    vision = dict(vis, tp=ModelShard(g, patch=patch is not None), merger=merger, blocks=[
        _shard_heads_block(blk, v.num_heads, v.head_dim, v.embed_dim * v.mlp_ratio, g,
                           ("qkv",), "proj", ("fc1", "fc2"))
        for blk in vis["blocks"]])
    if patch:
        vision["patch_weight"] = _rows(vis["patch_weight"], *patch)
    text = _shard_decoder(params["text"], t.num_attention_heads, t.kv_heads, t.head_dim,
                          t.intermediate_size, t.vocab_size, g)
    return {**params, "vision": vision, "text": text}
