"""The device trace of a bounded slice and its reduction.

``traced_slice`` runs a bounded slice of a run under ``torch.profiler``
(CPU and CUDA activity) inside a ``bench_slice`` annotation that starts and
ends with a device synchronisation, and writes the Chrome trace to a fixed directory of the
benchmark (``benchmark/traces/<cell>/``, ignored by git), so each run
overwrites the last. ``reduce_trace`` reads it back: the device's busy time
(the union of kernel, copy and set intervals, so overlapping kernels count
once) inside the slice, the summed time of each device operation, the
longest idle gaps named by the host operation running at their midpoint,
and the device time of each hand-written kernel: the union of its device
kernels' intervals inside the slice, so that a kernel launched as a
programmatic dependent, which starts inside the one it depends on, does not
count their overlap twice.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
SLICE = "bench_slice"


def traced_slice(run_unit: Callable[[Callable, Callable], object], out_dir: Path,
                 on_start: Callable = lambda: None, on_stop: Callable = lambda: None) -> Path:
    """``run_unit(start, stop)``, which calls ``start()`` where the slice
    begins and ``stop()`` where it ends, under a profiler session; returns
    the trace's path. ``on_start``/``on_stop`` run with them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state: dict = {}

    def start():
        torch.cuda.synchronize()
        prof.start()
        state["rf"] = record_function(SLICE)
        state["rf"].__enter__()
        on_start()

    def stop():
        if "rf" in state and "stopped" not in state:
            torch.cuda.synchronize()
            on_stop()
            state["rf"].__exit__(None, None, None)
            prof.stop()
            state["stopped"] = True

    try:
        run_unit(start, stop)
    finally:
        stop()
    if "rf" not in state:
        raise RuntimeError("trace: the slice never started")
    prof.export_chrome_trace(str(path))
    return path


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Sorted, non-overlapping union of (start, end) intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def reduce_trace(events: List[dict], kernel_names: Dict[str, Sequence[str]],
                 top: int = 10) -> Dict[str, object]:
    """Chrome-trace events (times in microseconds) -> ``window_s`` (the
    slice annotation's length), ``busy_s``, ``device_ops`` and
    ``idle_gaps`` (each ``[[name, seconds], ...]``, at most ``top``) and
    ``kernel_s`` (device seconds of each kernel of ``kernel_names``, by
    name substring: the union of its intervals inside the slice)."""
    sl = [e for e in events if e.get("name") == SLICE and e.get("ph") == "X"
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise ValueError("trace: no bench_slice annotation")
    lo = float(sl[0]["ts"])
    hi = lo + float(sl[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    ivals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = merge(clip(ivals, lo, hi))
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    edges = [lo] + [x for s, e in busy for x in (s, e)] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"
            and e.get("name") != SLICE]
    named = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        cover = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        name = (min(cover, key=lambda e: float(e["dur"]))["name"] if cover
                else "host: between operations")
        named.append([name, (b - a) / 1e6])
    kernel_s = {}
    for k, subs in kernel_names.items():
        union = merge(clip([iv for e, iv in zip(dev, ivals) if any(s in e["name"] for s in subs)],
                           lo, hi))
        t = sum(e - s for s, e in union)
        if t > 0:
            kernel_s[k] = t / 1e6
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "device_ops": [[n, t / 1e6] for n, t in ops], "idle_gaps": named,
            "kernel_s": kernel_s, "n_device_ops": len(dev)}


def read_trace(path: Path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def trace_and_reduce(run_unit, out_dir: Path, kernel_names: Dict[str, Sequence[str]],
                     on_start=lambda: None, on_stop=lambda: None) -> Dict[str, object]:
    t0 = time.perf_counter()
    path = traced_slice(run_unit, out_dir, on_start, on_stop)
    t1 = time.perf_counter()
    summary = reduce_trace(read_trace(path), kernel_names)
    summary["trace_bytes"] = path.stat().st_size
    summary["trace_wall_s"] = t1 - t0
    summary["reduce_wall_s"] = time.perf_counter() - t1
    with open(out_dir / "breakdown.json", "w") as f:
        json.dump(summary, f, indent=1)
    return summary
