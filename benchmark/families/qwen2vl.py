"""Qwen2-VL configurations: the program's backend over weights the benchmark
makes, and what the check needs of the family (as ``families/llava.py``)."""

from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from benchmark.counts import model_flops
from benchmark.families.common import Leaf, make_tree, request_flops  # noqa: F401


def leaves(c: Dict[str, Any]) -> List[Leaf]:
    v = c["vision_config"]
    E, D, F = v["embed_dim"], c["hidden_size"], c["intermediate_size"]
    Fv, Em = E * v["mlp_ratio"], E * v["spatial_merge_size"] ** 2
    kvd = c["num_key_value_heads"] * (D // c["num_attention_heads"])
    emb = float(c["init"]["embeddings_std"])

    def mat(path, n_out, n_in, bias):
        out = [(path + ("weight",) if bias else path, (n_out, n_in), 1.0 / math.sqrt(n_in))]
        return out + ([(path + ("bias",), (n_out,), "zeros")] if bias else [])

    def ln(path, n):
        return [(path + ("weight",), (n,), "ones"), (path + ("bias",), (n,), "zeros")]

    n_in = v["in_chans"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    out: List[Leaf] = [(("vision", "patch_weight"), (E, n_in), 1.0 / math.sqrt(n_in))]
    for i in range(v["depth"]):
        p = ("vision", "blocks", i)
        out += ln(p + ("norm1",), E) + ln(p + ("norm2",), E)
        out += mat(p + ("qkv",), 3 * E, E, True) + mat(p + ("proj",), E, E, True)
        out += mat(p + ("fc1",), Fv, E, True) + mat(p + ("fc2",), E, Fv, True)
    out += ln(("vision", "merger", "ln_q"), E)
    out += mat(("vision", "merger", "fc1"), Em, Em, True)
    out += mat(("vision", "merger", "fc2"), v["hidden_size"], Em, True)
    out += [(("text", "embed_tokens"), (c["vocab_size"], D), emb),
            (("text", "lm_head"), (c["vocab_size"], D), emb),
            (("text", "norm"), (D,), "ones")]
    for i in range(c["num_hidden_layers"]):
        p = ("text", "layers", i)
        out += [(p + ("input_layernorm",), (D,), "ones"),
                (p + ("post_attention_layernorm",), (D,), "ones")]
        out += mat(p + ("q_proj",), D, D, True) + mat(p + ("k_proj",), kvd, D, True)
        out += mat(p + ("v_proj",), kvd, D, True) + mat(p + ("o_proj",), D, D, False)
        out += mat(p + ("gate_proj",), F, D, False) + mat(p + ("up_proj",), F, D, False)
        out += mat(p + ("down_proj",), D, F, False)
    return out


def make_params(c: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    return make_tree(leaves(c), seed, device, torch.bfloat16)


def program_config(c: Dict[str, Any]):
    from attwarp_tpu_torch.models.qwen2vl import (
        Qwen2VLConfig,
        Qwen2VLTextConfig,
        Qwen2VLVisionConfig,
    )

    v = c["vision_config"]
    return Qwen2VLConfig(
        vision=Qwen2VLVisionConfig(
            depth=v["depth"], embed_dim=v["embed_dim"], hidden_size=v["hidden_size"],
            num_heads=v["num_heads"], in_channels=v["in_chans"], patch_size=v["patch_size"],
            spatial_merge_size=v["spatial_merge_size"],
            temporal_patch_size=v["temporal_patch_size"], mlp_ratio=v["mlp_ratio"],
            hidden_act=v["hidden_act"]),
        text=Qwen2VLTextConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"], rms_norm_eps=c["rms_norm_eps"],
            rope_theta=c["rope_theta"],
            mrope_section=tuple(c["rope_scaling"]["mrope_section"])),
        image_token_id=c["image_token_id"], vision_start_token_id=c["vision_start_token_id"],
        vision_end_token_id=c["vision_end_token_id"], pad_token_id=c["pad_token_id"],
        eos_token_id=c["eos_token_id"])


def make_backend(c: Dict[str, Any], params: Dict[str, Any]):
    """The program's ``Qwen2VLBackend`` in the configuration's mode."""
    from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.qwen2vl import Qwen2VLModel

    return Qwen2VLBackend(Qwen2VLModel(program_config(c), params), tokenizer=DryRunTokenizer(),
                          extract_layer=c["extract_layer"], image_size=c["image_size"],
                          kv_quant="+kv8" in c["mode"], use_flash="+flash" in c["mode"])


def image_size(c: Dict[str, Any]) -> int:
    return c["image_size"]


def map_side(c: Dict[str, Any]) -> int:
    v = c["vision_config"]
    return c["image_size"] // (v["patch_size"] * v["spatial_merge_size"])


def eos_token(c: Dict[str, Any]) -> int:
    return c["eos_token_id"]


def image_token(c: Dict[str, Any]) -> int:
    return c["image_token_id"]


def reference(c: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
    from benchmark.reference.qwen2vl import Qwen2VLReference

    return Qwen2VLReference(c, params, precision)


def image_flops(c: Dict[str, Any]) -> int:
    """One image through the vision tower and the patch merger
    (``counts/model_flops.py``)."""
    v = c["vision_config"]
    return model_flops.qwen2vl_vision_flops(v["embed_dim"], v["mlp_ratio"], v["depth"],
                                            c["image_size"], v["patch_size"],
                                            v["spatial_merge_size"], v["temporal_patch_size"],
                                            c["hidden_size"])
