"""Serving: the continuous-batching ``ServeEngine``, the chunked-prefill
``ChunkedPrefillEngine`` and the disaggregated ``DisaggServeEngine``, for
LLaVA-1.5 and Qwen2-VL."""

from attwarp_tpu_torch.serving.chunked import ChunkedPrefillEngine
from attwarp_tpu_torch.serving.disagg import DisaggServeEngine, split_devices
from attwarp_tpu_torch.serving.engine import Request, ServeEngine

__all__ = ["ChunkedPrefillEngine", "DisaggServeEngine", "Request", "ServeEngine",
           "split_devices"]
