"""Host-side stage timers whose records land in a JSONL stream beside the
training metrics: ``StageTimer``, a copy of the class in
``attwarp_tpu/utils/profiling.py``, pinned equal to it by the tests. JAX's
``device_trace`` (``jax.profiler``) waits for ``torch.profiler``
(ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, Iterator, Optional


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
