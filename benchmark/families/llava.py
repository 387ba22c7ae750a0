"""LLaVA-1.5 configurations: the program's backend over weights the
benchmark makes, and what the check needs of the family.

The program is driven through its public classes (``LlavaConfig``,
``LlavaModel``, ``LlavaBackend`` and the dry-run tokenizer); the weights are
the benchmark's own, drawn by ``families/common.py::make_tree`` in the
program's tree layout, and the same tensors go to the plain reference
(``reference/llava.py``), which imports nothing of the program.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from benchmark.counts import model_flops
from benchmark.families.common import Leaf, make_tree, request_flops  # noqa: F401


def leaves(c: Dict[str, Any]) -> List[Leaf]:
    v, t = c["vision_config"], c["text_config"]
    std = float(c["init"]["matrices_std"])
    Dv, Fv, D, F = v["hidden_size"], v["intermediate_size"], t["hidden_size"], t["intermediate_size"]
    kvd = t["num_key_value_heads"] * (D // t["num_attention_heads"])
    n_patch = (v["image_size"] // v["patch_size"]) ** 2
    out: List[Leaf] = [
        (("vision", "patch_weight"), (Dv, v["patch_size"] ** 2 * 3), std),
        (("vision", "class_embedding"), (Dv,), std),
        (("vision", "position_embedding"), (n_patch + 1, Dv), std),
        (("vision", "pre_layrnorm", "weight"), (Dv,), "ones"),
        (("vision", "pre_layrnorm", "bias"), (Dv,), "zeros"),
    ]
    for i in range(v["num_hidden_layers"]):
        p = ("vision", "layers", i)
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(p + (ln, "weight"), (Dv,), "ones"), (p + (ln, "bias"), (Dv,), "zeros")]
        for name, shape in (("q_proj", (Dv, Dv)), ("k_proj", (Dv, Dv)), ("v_proj", (Dv, Dv)),
                            ("out_proj", (Dv, Dv)), ("fc1", (Fv, Dv)), ("fc2", (Dv, Fv))):
            out += [(p + (name, "weight"), shape, std), (p + (name, "bias"), (shape[0],), "zeros")]
    for name, shape in (("linear_1", (D, Dv)), ("linear_2", (D, D))):
        out += [(("projector", name, "weight"), shape, std),
                (("projector", name, "bias"), (D,), "zeros")]
    out += [(("llama", "embed_tokens"), (t["vocab_size"], D), std),
            (("llama", "norm"), (D,), "ones"),
            (("llama", "lm_head"), (t["vocab_size"], D), std)]
    for i in range(t["num_hidden_layers"]):
        p = ("llama", "layers", i)
        out += [(p + ("input_layernorm",), (D,), "ones"),
                (p + ("post_attention_layernorm",), (D,), "ones")]
        for name, shape in (("q_proj", (D, D)), ("k_proj", (kvd, D)), ("v_proj", (kvd, D)),
                            ("o_proj", (D, D)), ("gate_proj", (F, D)), ("up_proj", (F, D)),
                            ("down_proj", (D, F))):
            out.append((p + (name,), shape, std))
    return out


def make_params(c: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    return make_tree(leaves(c), seed, device, torch.bfloat16)


def program_config(c: Dict[str, Any]):
    from attwarp_tpu_torch.models.clip_vit import ClipVisionConfig
    from attwarp_tpu_torch.models.llama import LlamaConfig
    from attwarp_tpu_torch.models.llava import LlavaConfig

    v, t = c["vision_config"], c["text_config"]
    return LlavaConfig(
        vision=ClipVisionConfig(
            hidden_size=v["hidden_size"], intermediate_size=v["intermediate_size"],
            num_hidden_layers=v["num_hidden_layers"],
            num_attention_heads=v["num_attention_heads"], image_size=v["image_size"],
            patch_size=v["patch_size"], layer_norm_eps=v["layer_norm_eps"],
            hidden_act=v["hidden_act"]),
        text=LlamaConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            intermediate_size=t["intermediate_size"],
            num_hidden_layers=t["num_hidden_layers"],
            num_attention_heads=t["num_attention_heads"],
            num_key_value_heads=t["num_key_value_heads"], rms_norm_eps=t["rms_norm_eps"],
            rope_theta=t["rope_theta"], max_position_embeddings=t["max_position_embeddings"]),
        vision_feature_layer=c["vision_feature_layer"],
        projector_act=c["projector_hidden_act"],
        image_token_index=c["image_token_index"],
        pad_token_id=c["pad_token_id"], eos_token_id=c["eos_token_id"])


def make_backend(c: Dict[str, Any], params: Dict[str, Any]):
    """The program's ``LlavaBackend`` in the configuration's mode."""
    from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
    from attwarp_tpu_torch.extract.tokenizer import DryRunTokenizer
    from attwarp_tpu_torch.models.llava import LlavaModel

    return LlavaBackend(LlavaModel(program_config(c), params), tokenizer=DryRunTokenizer(),
                        extract_layer=c["extract_layer"], kv_quant="+kv8" in c["mode"],
                        use_flash="+flash" in c["mode"])


def image_size(c: Dict[str, Any]) -> int:
    return c["vision_config"]["image_size"]


def map_side(c: Dict[str, Any]) -> int:
    return c["vision_config"]["image_size"] // c["vision_config"]["patch_size"]


def eos_token(c: Dict[str, Any]) -> int:
    return c["eos_token_id"]


def image_token(c: Dict[str, Any]) -> int:
    return c["image_token_index"]


def reference(c: Dict[str, Any], params: Dict[str, Any], precision: str = "f32"):
    from benchmark.reference.llava import LlavaReference

    return LlavaReference(c, params, precision)


def image_flops(c: Dict[str, Any]) -> int:
    """One image through CLIP's layers up to the feature layer and the
    projector (``counts/model_flops.py``)."""
    v = c["vision_config"]
    run = c["vision_feature_layer"] % (v["num_hidden_layers"] + 1)
    return model_flops.clip_tower_flops(v["hidden_size"], v["intermediate_size"],
                                        v["image_size"], v["patch_size"], run,
                                        c["text_config"]["hidden_size"])
