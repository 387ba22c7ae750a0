"""Multi-rank parallelism over ``torch.distributed`` (counterpart of
``attwarp_tpu/parallel``): meshes of ranks, the data-parallel warp, the
MarginalNet and LLaVA/Qwen2-VL shardings and sequence-parallel prefill.

The names are JAX's and load on first use, so that the model modules can
import ``parallel.comm`` without importing the models back.
"""

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "shard_batch": "mesh",
    "shard_params": "mesh",
    "param_sharding_rules": "mesh",
    "make_sharded_warp": "warp_sharded",
    "sp_prefill": "sp_prefill",
    "sp_prefill_qwen": "sp_prefill",
    "llava_param_specs": "llava_sharding",
    "shard_llava_params": "llava_sharding",
    "qwen2vl_param_specs": "llava_sharding",
    "shard_qwen2vl_params": "llava_sharding",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
