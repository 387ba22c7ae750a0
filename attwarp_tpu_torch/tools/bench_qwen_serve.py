"""Continuous-batching engine throughput at Qwen2-VL-7B shape (counterpart
of ``tools/bench_qwen_serve.py``): the stream of ``tools/bench_serve.py``
(577-639-token text requests, all submitted at once) through
``ServeEngine`` over Qwen2-VL-7B, whose GQA cache (4 kv heads) lets the
pool go wider.

    python -m attwarp_tpu_torch.tools.bench_qwen_serve [mode] [slots] [requests] [max_new] [chunk_impl] [tick] [admit] [--device cuda]

Defaults int8+kv8, 32 slots, 3 x slots requests, 128 new tokens, chunk
auto (the only value taken), tick 16, admit 4. Warm-up waves up to
``admit``; the stream is run 3 times, each run printed.
"""

from __future__ import annotations

import argparse

from attwarp_tpu_torch.serving import ServeEngine
from attwarp_tpu_torch.tools.bench_serve import (
    check_chunk_impl,
    max_seq_for,
    pow2_waves,
    serve_stream,
)
from attwarp_tpu_torch.tools.bench_utils import make_qwen2vl_7b_backend, parse_mode
from attwarp_tpu_torch.utils.device import require_device


def run(model, slots: int = 32, n_req=None, max_new: int = 128, chunk: str = "auto",
        tick: int = 16, admit: int = 4, kv8: bool = True, flash: bool = False,
        repeats: int = 3, label: str = "") -> dict:
    """The stream through ``ServeEngine`` over a ``Qwen2VLModel``; see
    ``bench_serve.serve_stream``. ``n_req`` None is 3 x ``slots``."""
    check_chunk_impl(chunk)
    n_req = 3 * slots if n_req is None else n_req
    max_seq = max_seq_for(max_new, tick)
    print(f"engine: {label}, slots={slots}, requests={n_req}, max_new={max_new}, "
          f"chunk={chunk}, tick={tick}, admit={admit}, max_seq={max_seq}")

    def make_engine():
        return ServeEngine(model, slots=slots, max_seq=max_seq, bucket=64, kv_quant=kv8,
                           steps_per_tick=tick, use_flash=flash, admit_batch=admit)

    return serve_stream(make_engine, lambda e: pow2_waves(min(admit, slots)), model.cfg,
                        n_req, max_new, slots, repeats, model.device, f"qwen serve {label}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_qwen_serve (PyTorch)")
    p.add_argument("mode", nargs="?", default="int8+kv8")
    p.add_argument("slots", nargs="?", type=int, default=32)
    p.add_argument("requests", nargs="?", type=int, default=None,
                   help="default 3 x slots")
    p.add_argument("max_new", nargs="?", type=int, default=128)
    p.add_argument("chunk_impl", nargs="?", default="auto")
    p.add_argument("tick", nargs="?", type=int, default=16)
    p.add_argument("admit", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    device = require_device(a.device, "bench_qwen_serve")
    check_chunk_impl(a.chunk_impl)
    backend, label = make_qwen2vl_7b_backend(a.mode, device=device)
    _, kv8, flash = parse_mode(a.mode)
    run(backend.model, a.slots, a.requests, a.max_new, a.chunk_impl, a.tick, a.admit,
        kv8, flash, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
