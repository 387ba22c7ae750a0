"""Hand-written CUDA kernels for Hopper and their wrappers.

- ``warp_resample``: K1, the separable bilinear warp
  (``csrc/warp_resample.cu``; replaces ``attwarp_tpu/ops/pallas_warp.py``).
- ``flash_prefill``: K2, causal prefill attention with left padding
  (``csrc/flash_prefill.cu``; replaces ``attwarp_tpu/models/llama.py::
  _flash_attn``, JAX's Pallas TPU flash attention).
- ``decode_attn``: K3, one-token attention over the int8 KV cache
  (``csrc/decode_attn_int8.cu``; replaces
  ``attwarp_tpu/ops/pallas_decode_attn.py``).
- ``attn_softmax``: K4, the scaled row softmax between a vision tower's two
  attention products, in place (``csrc/attn_softmax.cu``; replaces no TPU
  kernel: the JAX towers' softmax is plain einsum code).
- ``rope_append``: K5, the decode step's new token: the rotary on q and k,
  the int8 quantization of k and v and their cache write
  (``csrc/rope_append_int8.cu``; replaces no TPU kernel: the JAX rotary and
  ``quantize_kv`` are plain jnp code).

Each wrapper runs its kernel's plain PyTorch version on CPU tensors and
launches the kernel (or raises) on CUDA tensors; ``<wrapper>.launches``
counts kernel launches.
"""
