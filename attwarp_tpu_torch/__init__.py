"""attwarp_tpu_torch — the PyTorch + CUDA port of ``attwarp_tpu``.

The JAX package stays the reference; this package mirrors its subpackage
and module names (``warp/``, ``extract/``, ``numerics/``, ``models/``,
``serving/``, ``data/``, ``eval/``, ``testing/``, ``utils/``, ``cli/``,
``pipeline.py``) so each counterpart is easy to find, and every module is tested against its JAX original on the CPU
(``tests/test_torch_*.py``).

Every TPU kernel of the JAX package has a hand-written CUDA counterpart
for Hopper (``csrc/*.cu``), built with ``nvcc`` at first use
(``kernels/_build.py``) and launched through the wrappers in ``kernels/``.
A wrapper given a CPU tensor runs the kernel's plain PyTorch version; given
a CUDA tensor it launches the kernel or raises.

Nothing here imports JAX, and nothing is compiled at import time.
"""

__version__ = "0.1.0"

# Lazy top-level exports (``import attwarp_tpu_torch`` stays cheap).
_LAZY = {
    "AttWarpPipeline": ("attwarp_tpu_torch.pipeline", "AttWarpPipeline"),
    "AttWarpResult": ("attwarp_tpu_torch.pipeline", "AttWarpResult"),
    "warp_batch_by_attention": ("attwarp_tpu_torch.warp.warp", "warp_batch_by_attention"),
    "WarpParams": ("attwarp_tpu_torch.warp.transforms", "WarpParams"),
    "Transform": ("attwarp_tpu_torch.warp.transforms", "Transform"),
    "mota_mask": ("attwarp_tpu_torch.warp.blend", "mota_mask"),
    "LlavaBackend": ("attwarp_tpu_torch.extract.llava_backend", "LlavaBackend"),
    "Qwen2VLBackend": ("attwarp_tpu_torch.extract.qwen2vl_backend", "Qwen2VLBackend"),
    "ServeEngine": ("attwarp_tpu_torch.serving.engine", "ServeEngine"),
    "ChunkedPrefillEngine": ("attwarp_tpu_torch.serving.chunked", "ChunkedPrefillEngine"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'attwarp_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
