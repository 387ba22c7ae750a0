"""Tracing and host-side stage timers (counterpart of
``attwarp_tpu/utils/profiling.py``).

``device_trace`` captures a ``torch.profiler`` trace of its body, the
counterpart of JAX's ``jax.profiler`` trace: host ops always, the device's
kernels where a card is present, written as a Chrome trace
(``trace.json``, readable in Perfetto or ``chrome://tracing``). Each
device kernel is an event of category ``kernel`` named by its
``__global__`` function. ``StageTimer`` writes named wall-clock stages to a
JSONL stream beside the training metrics; it is a copy of the JAX class,
pinned equal to it by the tests.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(log_dir) -> Iterator[None]:
    """Trace the body with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write ``log_dir/trace.json`` when
    it ends, also when it raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))


class StageTimer:
    """Named wall-clock stage timing with JSONL output.

    Usage::

        timer = StageTimer(run_dir / "stages.jsonl")
        with timer.stage("extract"):
            ...
        with timer.stage("warp"):
            ...
        timer.summary()  # {'extract': {'total': ..., 'count': ...}, ...}
    """

    def __init__(self, path: Optional[str | Path] = None):
        self.path = Path(path) if path else None
        self.records: Dict[str, list] = {}
        self._f = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            try:
                # one persistent line-buffered handle: no per-stage open()
                # in the hot loop being measured
                self._f = open(self.path, "a", buffering=1)
            except Exception:
                self._f = None

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.records.setdefault(name, []).append(dt)
            if self._f is not None:
                try:
                    self._f.write(
                        json.dumps({"stage": name, "seconds": dt, "t": time.time()})
                        + "\n"
                    )
                except Exception:
                    pass

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total": float(sum(v)),
                "count": len(v),
                "mean": float(sum(v) / len(v)),
            }
            for name, v in self.records.items()
        }

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except Exception:
                pass
            self._f = None
