"""Serving: the continuous-batching ``ServeEngine`` and the chunked-prefill
``ChunkedPrefillEngine``, for LLaVA-1.5 and Qwen2-VL on one device."""

from attwarp_tpu_torch.serving.chunked import ChunkedPrefillEngine
from attwarp_tpu_torch.serving.engine import Request, ServeEngine

__all__ = ["ChunkedPrefillEngine", "Request", "ServeEngine"]
