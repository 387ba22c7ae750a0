"""Chunked-prefill engine throughput at LLaVA-1.5-7B shape (counterpart of
``tools/bench_chunked_serve.py``): the stream of ``tools/bench_serve.py``
through ``ChunkedPrefillEngine``, whose admissions ride the decode ticks
in P-token chunks (no dedicated prefill, so no K2; K3 reads the int8 cache
under ``+kv8``).

    python -m attwarp_tpu_torch.tools.bench_chunked_serve [mode] [slots] [requests] [max_new] [P] [tick] [--device cuda]

Defaults int8+kv8, 32 slots, 3 x slots requests, 128 new tokens, P=160,
tick 16. One warm-up run of two requests on an engine that is freed first;
the stream is run 3 times, each run printed. JAX's ``stage_len`` is not an
argument here: the port's staging buffer holds any bucket ``submit``
accepts.
"""

from __future__ import annotations

import argparse

from attwarp_tpu_torch.serving import ChunkedPrefillEngine
from attwarp_tpu_torch.tools.bench_serve import max_seq_for, serve_stream
from attwarp_tpu_torch.tools.bench_utils import (
    make_llava_7b_backend,
    make_qwen2vl_7b_backend,
    parse_mode,
)
from attwarp_tpu_torch.utils.device import require_device


def run(model, slots: int = 32, n_req=None, max_new: int = 128, P: int = 160,
        tick: int = 16, kv8: bool = True, repeats: int = 3, label: str = "") -> dict:
    """The stream through ``ChunkedPrefillEngine`` (prefill chunks of
    ``P``) over a LLaVA or Qwen2-VL model; see ``bench_serve.serve_stream``.
    ``n_req`` None is 3 x ``slots``."""
    n_req = 3 * slots if n_req is None else n_req
    max_seq = max_seq_for(max_new, tick)
    print(f"chunked engine: {label}, slots={slots}, requests={n_req}, max_new={max_new}, "
          f"P={P}, tick={tick}, max_seq={max_seq}")

    def make_engine():
        return ChunkedPrefillEngine(model, slots=slots, prefill_chunk=P, max_seq=max_seq,
                                    bucket=64, kv_quant=kv8, steps_per_tick=tick)

    return serve_stream(make_engine, lambda e: [2], model.cfg, n_req, max_new, slots,
                        repeats, model.device, f"chunked P={P} {label}")


def parser(slots: int = 32, P: int = 160, name: str = "bench_chunked_serve"):
    p = argparse.ArgumentParser(f"{name} (PyTorch)")
    p.add_argument("mode", nargs="?", default="int8+kv8")
    p.add_argument("slots", nargs="?", type=int, default=slots)
    p.add_argument("requests", nargs="?", type=int, default=None,
                   help="default 3 x slots")
    p.add_argument("max_new", nargs="?", type=int, default=128)
    p.add_argument("P", nargs="?", type=int, default=P)
    p.add_argument("tick", nargs="?", type=int, default=16)
    p.add_argument("--device", default="cuda")
    return p


def main_for(argv, make_backend, name: str, **defaults) -> int:
    a = parser(name=name, **defaults).parse_args(argv)
    device = require_device(a.device, name)
    mode, kv8, flash = parse_mode(a.mode)
    if flash:
        raise ValueError(f"{name}: the chunked engine runs no prefill, so no +flash")
    backend, label = make_backend(a.mode, device=device)
    run(backend.model, a.slots, a.requests, a.max_new, a.P, a.tick, kv8, label=label)
    return 0


def main(argv=None) -> int:
    return main_for(argv, make_llava_7b_backend, "bench_chunked_serve")


def qwen_main(argv=None) -> int:
    return main_for(argv, make_qwen2vl_7b_backend, "bench_chunked_qwen_serve",
                    slots=64, P=320)


if __name__ == "__main__":
    raise SystemExit(main())
