"""Chunked-prefill engine throughput at Qwen2-VL-7B shape (counterpart of
``tools/bench_chunked_qwen_serve.py``): ``tools/bench_chunked_serve.py``
over Qwen2-VL-7B.

    python -m attwarp_tpu_torch.tools.bench_chunked_qwen_serve [mode] [slots] [requests] [max_new] [P] [tick] [--device cuda]

Defaults int8+kv8, 64 slots, 3 x slots requests, 128 new tokens, P=320,
tick 16.
"""

from __future__ import annotations

from attwarp_tpu_torch.tools.bench_chunked_serve import parser as _parser
from attwarp_tpu_torch.tools.bench_chunked_serve import qwen_main as main
from attwarp_tpu_torch.tools.bench_chunked_serve import run


def parser():
    return _parser(slots=64, P=320, name="bench_chunked_qwen_serve")


__all__ = ["main", "parser", "run"]

if __name__ == "__main__":
    raise SystemExit(main())
