"""Backend specs of the command line (counterpart of
``attwarp_tpu/cli/process_dataset.py``: ``parse_layer_spec`` and
``make_backend``; the dataset driver itself is not ported yet).

A spec is ``llava-ckpt:<dir>`` or ``qwen2vl-ckpt:<dir>`` (a directory
written by the backend's ``save``), with ``+kv8`` (int8 KV cache, decode
attention through kernel K3) and ``+flash`` (prefill attention through
kernel K2) composable in any order: ``llava-ckpt:/ckpt+kv8+flash``.
"""

from __future__ import annotations

# what each part of the JAX grammar that the port cannot load yet waits for
_SUFFIX_NOT_PORTED = {
    "int8": "w8a8 decoder weights ('+int8') wait for ROADMAP Queue 1 item 5",
    "lm8": "the int8 LM head ('+lm8') waits for ROADMAP Queue 1 item 5",
}
_SPEC_NOT_PORTED = {
    "llava": "loading HF checkpoints ('llava:', from_hf) waits for ROADMAP "
             "Queue 1 item 4; use llava-ckpt:<dir>",
    "qwen2vl": "loading HF checkpoints ('qwen2vl:', from_hf) waits for ROADMAP "
               "Queue 1 item 8; use qwen2vl-ckpt:<dir>",
    "mini": "the mini test backend waits for ROADMAP Queue 1 item 3",
    "reader": "the reader proxy backend waits for ROADMAP Queue 1 item 6",
}


def parse_layer_spec(spec) -> "int | tuple":
    """'20' -> 20; '4,8,20' -> (4, 8, 20); ints and tuples pass through."""
    if isinstance(spec, (int, tuple)):
        return spec
    layers = tuple(int(x) for x in str(spec).split(",") if x.strip())
    if not layers:
        raise ValueError(f"empty --layer-index spec {spec!r}")
    return layers[0] if len(layers) == 1 else layers


def make_backend(name: str, layer_index, device):
    """The backend a spec names, its weights loaded onto ``device``."""
    layer_index = parse_layer_spec(layer_index)
    base, sep, suffix = name.rpartition("+")
    if sep and suffix in ("kv8", "flash", "int8", "lm8"):
        if suffix in _SUFFIX_NOT_PORTED:
            raise ValueError(f"{name!r}: {_SUFFIX_NOT_PORTED[suffix]}")
        be = make_backend(base, layer_index, device)
        if suffix == "kv8":
            be.kv_quant = True
        else:
            be.use_flash = True
        return be
    family, _, path = name.partition(":")
    if family in _SPEC_NOT_PORTED:
        raise ValueError(f"{name!r}: {_SPEC_NOT_PORTED[family]}")
    if not isinstance(layer_index, int):
        raise ValueError("multi-layer extraction is not ported yet (ROADMAP "
                         "Queue 1 item 4); give one --layer-index")
    if family == "llava-ckpt" and path:
        from attwarp_tpu_torch.extract.llava_backend import LlavaBackend

        return LlavaBackend.load(path, device, extract_layer=layer_index)
    if family == "qwen2vl-ckpt" and path:
        from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend

        return Qwen2VLBackend.load(path, device, extract_layer=layer_index)
    raise ValueError(f"unknown backend {name}")
