"""Continuous-batching engine throughput at LLaVA-1.5-7B shape
(counterpart of ``tools/bench_serve.py``).

A stream of text requests (random prompt lengths 577-639, one 64-token
bucket) through ``ServeEngine`` on one card, all submitted at once:
aggregate generated tok/s and per-request latency (TTFT mean/p50/p95, the
first wave's TTFT, turnaround), with admission included. Every
power-of-two admission group size is warmed first on an engine that is
freed before the measured one is built.

    python -m attwarp_tpu_torch.tools.bench_serve [mode] [slots] [requests] [max_new] [chunk_impl] [tick] [admit] [admit_cold] [--device cuda]

Defaults int8+kv8, 8 slots, 24 requests, 32 new tokens, chunk auto, tick
8, admit 4, admit_cold 0 (the engine's own cap). ``chunk_impl`` selected
JAX's XLA decode loop, a TPU workaround not ported: only ``auto`` is
taken. The stream is run 3 times, each run printed; the figure is the
fastest.
"""

from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

from attwarp_tpu_torch.serving import ServeEngine
from attwarp_tpu_torch.tools.bench_utils import (
    card,
    make_llava_7b_backend,
    parse_mode,
    report,
    sync,
    timing_of,
)
from attwarp_tpu_torch.utils.device import require_device


def check_chunk_impl(chunk: str) -> None:
    if chunk != "auto":
        raise ValueError(f"chunk_impl {chunk!r}: JAX's decode-loop forms are not ported; "
                         f"only 'auto' is taken")


def max_seq_for(max_new: int, tick: int) -> int:
    """The 640-token prompt bucket + the answer + a tick of slack, rounded
    up to 16 (the engine rounds an int8 cache up to 64)."""
    return -(-(640 + max_new + tick) // 16) * 16


def text_id_high(cfg) -> int:
    """Random prompt ids are drawn below this: the JAX tools' bound (31999
    for LLaVA, 150000 for Qwen2-VL) or the first special image id of a
    smaller vocabulary."""
    if hasattr(cfg, "vision_start_token_id"):
        return min(150000, cfg.image_token_id, cfg.vision_start_token_id,
                   cfg.vision_end_token_id)
    return min(31999, cfg.image_token_index)


def _figures(eng, out, wall: float, slots: int) -> dict:
    n_tok = sum(len(v) for v in out.values())
    st = [s for s in eng.request_stats.values() if "done" in s]
    ttft = np.asarray([s["first_token"] - s["submit"] for s in st]) * 1e3
    turn = np.asarray([s["done"] - s["submit"] for s in st]) * 1e3
    # the first ``slots`` requests see no queue: their TTFT is admission alone
    wave = [eng.request_stats[r] for r in sorted(eng.request_stats)[:slots]
            if "first_token" in eng.request_stats[r]]
    wttft = np.asarray([s["first_token"] - s["submit"] for s in wave]) * 1e3
    return {"tokens": n_tok, "wall": wall, "tok_s": n_tok / wall,
            "ttft_mean": float(ttft.mean()), "ttft_p50": float(np.percentile(ttft, 50)),
            "ttft_p95": float(np.percentile(ttft, 95)),
            "wave_p50": float(np.percentile(wttft, 50)),
            "wave_p95": float(np.percentile(wttft, 95)), "wave_n": len(wave),
            "turn_mean": float(turn.mean()), "turn_p50": float(np.percentile(turn, 50)),
            "turn_p95": float(np.percentile(turn, 95))}


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def serve_stream(make_engine, warm_waves, cfg, n_req: int, max_new: int, slots: int,
                 repeats: int, device, label: str, seed: int = 0) -> dict:
    """Warm an engine from ``make_engine()`` with one run per wave size in
    ``warm_waves(engine)`` (600-token prompts, 2 new tokens), free it, then
    ``repeats`` runs of the same ``n_req`` requests on a fresh engine each
    (each freed before the next). Returns the figures of every run, the
    work summed over every engine (decode steps, admission prefill groups),
    the requests and the last run's tokens."""
    rng = np.random.default_rng(seed)
    hi = text_id_high(cfg)
    work = {"decode_steps": 0, "prefill_groups": 0}

    def tally(eng):
        work["decode_steps"] += eng.decode_steps
        work["prefill_groups"] += eng.prefill_groups

    warm = make_engine()
    for size in warm_waves(warm):
        for _ in range(size):
            warm.submit(rng.integers(3, hi, size=(600,)).astype(np.int64), None,
                        max_new_tokens=2)
        warm.run()
    tally(warm)
    del warm
    _free(device)
    requests = []
    for _ in range(n_req):
        T = int(rng.integers(577, 640))   # one 64-token bucket (=> 640)
        requests.append(rng.integers(3, hi, size=(T,)).astype(np.int64))
    runs = []
    for _ in range(repeats):
        eng = make_engine()
        for ids in requests:
            eng.submit(ids, None, max_new_tokens=max_new)
        sync(device)
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = eng.run()
        sync(device)
        f = _figures(eng, out, time.perf_counter() - t0, slots)
        f["peak_gib"] = (torch.cuda.max_memory_allocated(device) / 2**30
                         if torch.device(device).type == "cuda" else None)
        tally(eng)
        runs.append(f)
        tokens = [out[r] for r in sorted(out)]
        peak = "not measured (cpu)" if f["peak_gib"] is None else f"{f['peak_gib']:.2f} GiB"
        print(f"{label}: {n_req} requests, {f['tokens']} tokens in {f['wall']:.3f} s -> "
              f"{f['tok_s']:.1f} tok/s | TTFT ms mean {f['ttft_mean']:.0f} p50 "
              f"{f['ttft_p50']:.0f} p95 {f['ttft_p95']:.0f} | first wave (n={f['wave_n']}) "
              f"p50 {f['wave_p50']:.0f} p95 {f['wave_p95']:.0f} | turn ms mean "
              f"{f['turn_mean']:.0f} p50 {f['turn_p50']:.0f} p95 {f['turn_p95']:.0f} | "
              f"peak memory {peak} | {card(device)}")
        del eng, out
        _free(device)
    timing = timing_of([f["wall"] for f in runs])
    report(f"{label} (wall of the stream)", timing, device)
    best = min(runs, key=lambda f: f["wall"])
    return {"tok_s": best["tok_s"], "timing": timing, "runs": runs, "work": work,
            "requests": requests, "max_new": max_new, "tokens": tokens}


def pow2_waves(cap: int):
    """1, 2, 4, ... up to ``cap``: one warm-up wave per admission group
    size, so that no first-seen group size lands in the measured run."""
    size = 1
    while size <= cap:
        yield size
        size *= 2


def run(model, slots: int = 8, n_req: int = 24, max_new: int = 32, chunk: str = "auto",
        tick: int = 8, admit: int = 4, admit_cold: int = 0, kv8: bool = True,
        flash: bool = False, repeats: int = 3, label: str = "") -> dict:
    """The stream through ``ServeEngine`` over ``model``; see
    ``serve_stream``. Warm-up waves up to the engine's cold admission cap."""
    check_chunk_impl(chunk)
    max_seq = max_seq_for(max_new, tick)
    print(f"engine: {label}, slots={slots}, requests={n_req}, max_new={max_new}, "
          f"chunk={chunk}, tick={tick}, admit={admit}, admit_cold={admit_cold}, "
          f"max_seq={max_seq}")

    def make_engine():
        return ServeEngine(model, slots=slots, max_seq=max_seq, bucket=64, kv_quant=kv8,
                           steps_per_tick=tick, use_flash=flash, admit_batch=admit,
                           admit_batch_cold=admit_cold)

    return serve_stream(make_engine, lambda e: pow2_waves(min(e.admit_batch_cold, slots)),
                        model.cfg, n_req, max_new, slots, repeats, model.device,
                        f"serve {label}")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("bench_serve (PyTorch)")
    p.add_argument("mode", nargs="?", default="int8+kv8")
    p.add_argument("slots", nargs="?", type=int, default=8)
    p.add_argument("requests", nargs="?", type=int, default=24)
    p.add_argument("max_new", nargs="?", type=int, default=32)
    p.add_argument("chunk_impl", nargs="?", default="auto")
    p.add_argument("tick", nargs="?", type=int, default=8)
    p.add_argument("admit", nargs="?", type=int, default=4)
    p.add_argument("admit_cold", nargs="?", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    device = require_device(a.device, "bench_serve")
    check_chunk_impl(a.chunk_impl)
    backend, label = make_llava_7b_backend(a.mode, device=device)
    _, kv8, flash = parse_mode(a.mode)
    run(backend.model, a.slots, a.requests, a.max_new, a.chunk_impl, a.tick, a.admit,
        a.admit_cold, kv8, flash, label=label)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
