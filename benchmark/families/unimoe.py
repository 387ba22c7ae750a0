"""Uni-MoE-2.0-Omni configurations (HF ``grin_qwen2_vl``): the program's
backend over weights the benchmark makes, and what the check needs of the
family (as ``families/qwen2vl.py``).

The decoder is Qwen2-VL's with every FFN a mixture of experts, so the
FLOPs a request needs depend on the routing. ``request_flops`` counts what
the token counts fix: attention, the shared experts (as one SwiGLU of their
summed width), the router and the LM head. The routed experts' FLOPs are
``routed_pair_flops(c)`` a routed (token, layer, expert) pair, counted by
the ``twopass_routed`` kind from the program's own tally of pairs.

The weights are ``families/qwen2vl.py``'s scales, with each block's residual
output (the tower's ``out_proj`` and ``fc2``, the decoder's ``o_proj`` and
the experts' ``down``) drawn a further 1/sqrt(2 x layers) smaller, as
GPT-2's and Megatron's inits do: unscaled, the random SigLIP tower collapses
the image's patches onto one direction, every image token of a layer then
takes the same experts, and how many a token takes swings with the draw.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.counts import model_flops
from benchmark.families.common import Leaf, make_tree


def leaves(c: Dict[str, Any]) -> List[Leaf]:
    v = c["vision_config"]
    E, Fv, D = v["hidden_size"], v["intermediate_size"], c["hidden_size"]
    F, Fs = c["dynamic_intermediate_size"], c["shared_intermediate_size"]
    R, Z, S = (c["mlp_dynamic_expert_num"], c["mlp_dynamic_null_expert_num"],
               c["mlp_fixed_expert_num"])
    kvd = c["num_key_value_heads"] * (D // c["num_attention_heads"])
    emb = float(c["init"]["embeddings_std"])

    def mat(path, shape, bias=False, layers=0):
        """normal / sqrt(fan_in), and / sqrt(2 x layers) on a block's
        residual output (``init``)."""
        std = 1.0 / math.sqrt(shape[-1] * (2 * layers if layers else 1))
        out = [(path + ("weight",) if bias else path, shape, std)]
        return out + ([(path + ("bias",), shape[:1], "zeros")] if bias else [])

    Lv, L = v["num_hidden_layers"], c["num_hidden_layers"]

    def ln(path, n):
        return [(path + ("weight",), (n,), "ones"), (path + ("bias",), (n,), "zeros")]

    n_patch = (v["image_size"] // v["patch_size"]) ** 2
    out: List[Leaf] = (mat(("vision", "patch_weight"), (E, v["patch_size"] ** 2 * 3))
                       + [(("vision", "patch_bias"), (E,), "zeros"),
                          (("vision", "position_embedding"), (n_patch, E), emb)])
    for i in range(v["num_hidden_layers"]):
        p = ("vision", "layers", i)
        out += ln(p + ("layer_norm1",), E) + ln(p + ("layer_norm2",), E)
        for name in ("q_proj", "k_proj", "v_proj"):
            out += mat(p + (name,), (E, E), True)
        out += mat(p + ("out_proj",), (E, E), True, Lv)
        out += mat(p + ("fc1",), (Fv, E), True) + mat(p + ("fc2",), (E, Fv), True, Lv)
    out += mat(("aligner",), (D, E), True)
    out += [(("text", "embed_tokens"), (c["vocab_size"], D), emb),
            (("text", "lm_head"), (c["vocab_size"], D), emb),
            (("text", "norm"), (D,), "ones")]
    for i in range(c["num_hidden_layers"]):
        p = ("text", "layers", i)
        m = p + ("moe",)
        out += [(p + ("input_layernorm",), (D,), "ones"),
                (p + ("post_attention_layernorm",), (D,), "ones")]
        out += mat(p + ("q_proj",), (D, D), True) + mat(p + ("k_proj",), (kvd, D), True)
        out += mat(p + ("v_proj",), (kvd, D), True) + mat(p + ("o_proj",), (D, D), layers=L)
        out += (mat(m + ("router",), (R + Z, D)) + mat(m + ("gate_up",), (R, 2 * F, D))
                + mat(m + ("down",), (R, D, F), layers=L)
                + mat(m + ("shared_gate_up",), (S, 2 * Fs, D))
                + mat(m + ("shared_down",), (S, D, Fs), layers=L))
    return out


def make_params(c: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    return make_tree(leaves(c), seed, device, torch.bfloat16)


def program_config(c: Dict[str, Any]):
    from attwarp_tpu_torch.models.clip_vit import SiglipVisionConfig
    from attwarp_tpu_torch.models.moe import MoEConfig
    from attwarp_tpu_torch.models.unimoe import UniMoEConfig, UniMoETextConfig

    v = c["vision_config"]
    return UniMoEConfig(
        vision=SiglipVisionConfig(
            hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
            num_hidden_layers=v["num_hidden_layers"],
            num_attention_heads=v["num_attention_heads"], image_size=v["image_size"],
            patch_size=v["patch_size"], layer_norm_eps=v["layer_norm_eps"],
            hidden_act=v["hidden_act"]),
        text=UniMoETextConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"], rms_norm_eps=c["rms_norm_eps"],
            rope_theta=float(c["rope_theta"]),
            mrope_section=tuple(c["rope_scaling"]["mrope_section"]),
            moe=MoEConfig(routed=c["mlp_dynamic_expert_num"],
                          null=c["mlp_dynamic_null_expert_num"],
                          shared=c["mlp_fixed_expert_num"],
                          routed_width=c["dynamic_intermediate_size"],
                          shared_width=c["shared_intermediate_size"],
                          top_p=c["mlp_dynamic_top_p"], top_k=c["mlp_dynamic_top_k"])),
        vision_feature_layer=c["vision_feature_layer"],
        image_token_id=c["image_token_id"], vision_start_token_id=c["vision_start_token_id"],
        vision_end_token_id=c["vision_end_token_id"], pad_token_id=c["pad_token_id"],
        eos_token_id=c["eos_token_id"])


def make_backend(c: Dict[str, Any], params: Dict[str, Any]):
    """The program's ``UniMoEBackend`` in the configuration's mode."""
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.extract.unimoe_backend import UniMoEBackend
    from attwarp_tpu_torch.models.unimoe import UniMoEModel

    return UniMoEBackend(UniMoEModel(program_config(c), params), tokenizer=DryRunTokenizer(),
                         extract_layer=c["extract_layer"], image_size=c["image_size"],
                         kv_quant="+kv8" in c["mode"], use_flash="+flash" in c["mode"])


def image_size(c: Dict[str, Any]) -> int:
    return c["image_size"]


def map_side(c: Dict[str, Any]) -> int:
    return c["image_size"] // c["vision_config"]["patch_size"]


def eos_token(c: Dict[str, Any]) -> int:
    return c["eos_token_id"]


def image_token(c: Dict[str, Any]) -> int:
    return c["image_token_id"]


def reference(c: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
    from benchmark.reference.unimoe import UniMoEReference

    return UniMoEReference(c, params, precision)


def image_flops(c: Dict[str, Any]) -> int:
    """One image through the SigLIP tower (the patch embedding and the
    blocks that run, full attention over the patches) and the aligner."""
    v = c["vision_config"]
    n = (c["image_size"] // v["patch_size"]) ** 2
    E, Fv = v["hidden_size"], v["intermediate_size"]
    run = c["vision_feature_layer"] % (v["num_hidden_layers"] + 1)
    embed = 2 * n * (3 * v["patch_size"] ** 2) * E
    block = 2 * n * (4 * E * E + 2 * E * Fv) + 4 * n * n * E
    return embed + run * block + 2 * n * E * c["hidden_size"]


def decoder_dims(c: Dict[str, Any]) -> model_flops.DecoderDims:
    """The decoder's widths with the shared experts as the gated MLP (one
    SwiGLU of their summed width)."""
    H = c["num_attention_heads"]
    return model_flops.DecoderDims(
        hidden=c["hidden_size"], heads=H, kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // H,
        ffn=c["mlp_fixed_expert_num"] * c["shared_intermediate_size"],
        vocab=c["vocab_size"], layers=c["num_hidden_layers"])


def request_flops(c: Dict[str, Any], n_prompt: int, n_fed: int, n_head: int,
                  n_partial: int = 0, partial_layers: int = 0) -> int:
    """One sequence through the decoder less its routed experts
    (``counts/model_flops.py::decoder_flops`` with the shared experts as
    the MLP), plus the router's product at every (token, layer)."""
    d = decoder_dims(c)
    router = 2 * d.hidden * (c["mlp_dynamic_expert_num"] + c["mlp_dynamic_null_expert_num"])
    token_layers = d.layers * (n_prompt + n_fed) + partial_layers * n_partial
    return (model_flops.decoder_flops(d, n_prompt, n_fed, n_head, n_partial, partial_layers)
            + router * token_layers)


def routed_pair_flops(c: Dict[str, Any]) -> int:
    """One routed (token, layer, expert) pair: the expert's gate, up and
    down products."""
    return 2 * 3 * c["hidden_size"] * c["dynamic_intermediate_size"]
