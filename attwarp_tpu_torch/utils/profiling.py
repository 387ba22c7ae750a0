"""Tracing: program spans and counters, the device trace, and host-side
stage timers (counterpart of ``attwarp_tpu/utils/profiling.py``).

``span(name, **attrs)`` marks a part of the program: a context manager
that also works as a decorator. A span has a name, an id, its parent's id
(the span open around it in the same context), a start and an end; the
attributes ``batch`` and ``rid`` pass from a span to the spans inside it,
so every span of one pipeline batch or one served request carries its id.
``count(name, n=1)`` adds to a named counter. Both do something only when
asked:

- while a ``torch.profiler`` session is active (``device_trace``, or any
  other), a span also enters ``record_function(name)``: it shows in the
  Chrome trace as a ``user_annotation`` with the device operations
  launched inside it;
- while ``tracing(path)`` is on, spans and counters are kept in memory and
  written at its end as JSONL: one line a span, ``{"name", "id",
  "parent", "start_ns", "end_ns", ...attrs}``, with start and end on the
  trace's clock (``time.time_ns()``, the clock of an exported Chrome
  trace's ``ts * 1000 + baseTimeNanoseconds``), then one line
  ``{"counters": {...}}``.

With neither on, a span reads one flag and returns a shared no-op: no
``record_function``, no clock, no allocation. No span or counter ever
synchronises the device or reads a device value.

A count kept on the device (``models/moe.py::MoETally``, updated inside
CUDA graphs where a host counter could not be) joins the recorder through
``watch``: a recorder copies each watched tally on the device when it
starts, and reads what each gained once, on the host, when ``tracing``
closes.

``device_trace`` captures a ``torch.profiler`` trace of its body, the
counterpart of JAX's ``jax.profiler`` trace: host ops always, the device's
kernels where a card is present, written as a Chrome trace
(``trace.json``, readable in Perfetto or ``chrome://tracing``). Each
device kernel is an event of category ``kernel`` named by its
``__global__`` function. ``StageTimer`` writes named wall-clock stages to a
JSONL stream beside the training metrics; it is a copy of the JAX class,
pinned equal to it by the tests, and each stage is also a span.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import time
import weakref
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional

import torch
from torch.autograd.profiler import record_function

# the trace's clock: system-clock nanoseconds
clock_ns = time.time_ns
_profiler_on = torch._C._autograd._profiler_enabled
# attributes a span takes from its parent unless given its own
INHERITED = ("batch", "rid")

_recorder: Optional["Recorder"] = None
# device tallies (``snapshot()``, ``counters(since)``), kept while alive
_watched: "weakref.WeakSet" = weakref.WeakSet()
_current: contextvars.ContextVar = contextvars.ContextVar("attwarp_span", default=None)
_ids = itertools.count(1)


def _spanned(name: str, fn: Callable) -> Callable:
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return spanned


class _Off:
    """A span while nothing listens: enters and leaves nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn: Callable) -> Callable:
        return _spanned(self.name, fn)


_off: Dict[str, _Off] = {}


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_rf", "_rec", "_token")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def begin(self, annotate: bool) -> "_Span":
        parent = _current.get()
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        if parent is not None:
            for k in INHERITED:
                if k not in self.attrs and k in parent.attrs:
                    self.attrs[k] = parent.attrs[k]
        self._rf = None
        if annotate and _profiler_on():
            self._rf = record_function(self.name)
            self._rf.__enter__()
        # the clock is read inside the annotation, so the two agree
        self._rec = _recorder
        self.start_ns = clock_ns() if self._rec is not None else 0
        return self

    def end(self) -> None:
        if self._rec is not None:
            self._rec.spans.append({"name": self.name, "id": self.id, "parent": self.parent,
                                    "start_ns": self.start_ns, "end_ns": clock_ns(),
                                    **self.attrs})
        if self._rf is not None:
            self._rf.__exit__(None, None, None)

    def __enter__(self) -> "_Span":
        self.begin(True)
        self._token = _current.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        _current.reset(self._token)
        self.end()
        return False

    def __call__(self, fn: Callable) -> Callable:
        return _spanned(self.name, fn)


def span(name: str, **attrs):
    """A span of ``name`` (see the module's docstring). As a decorator,
    ``@span(name)`` opens a span of that name at each call."""
    if _recorder is None and not _profiler_on():
        off = _off.get(name)
        if off is None:
            off = _off[name] = _Off(name)
        return off
    return _Span(name, attrs)


def begin(name: str, **attrs) -> Optional[_Span]:
    """A span held open across calls (a request's wait in a queue): kept by
    the recorder only, never annotated, and no parent of other spans.
    Returns None when the recorder is off; else call ``.end()`` on it."""
    if _recorder is None:
        return None
    return _Span(name, attrs).begin(False)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    rec = _recorder
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + n


def watch(tally) -> None:
    """Let every later recorder read ``tally``, a count kept on the device
    (``snapshot()`` copies it on the device, ``counters(since)`` reads what
    it gained since a copy as named counts), while the tally lives."""
    _watched.add(tally)


def recording() -> bool:
    """Whether ``tracing`` is on (for a count that costs host work)."""
    return _recorder is not None


def _k1_plan_misses() -> int:
    from attwarp_tpu_torch.kernels.warp_resample import k1_plan

    return k1_plan.cache_info().misses


class Recorder:
    """What ``tracing`` keeps: ``spans`` (dicts, in the order they ended)
    and ``counters``; ``k1.plan_misses`` is read from K1's plan cache at
    the start and the end, and each watched device tally's gain at the
    end."""

    def __init__(self):
        self.spans: List[dict] = []
        self.counters: Dict[str, int] = {}
        self._misses0 = _k1_plan_misses()
        self._tallies = [(t, t.snapshot()) for t in list(_watched)]

    def close(self) -> None:
        self.counters["k1.plan_misses"] = _k1_plan_misses() - self._misses0
        for tally, since in self._tallies:
            for name, n in tally.counters(since).items():
                self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self) -> Dict[str, float]:
        """Summed seconds by span name."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s["name"]] = out.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e9
        return out

    def write(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for s in sorted(self.spans, key=lambda s: s["start_ns"]):
                f.write(json.dumps(s) + "\n")
            f.write(json.dumps({"counters": self.counters}) + "\n")


@contextlib.contextmanager
def tracing(path=None) -> Iterator[Recorder]:
    """Keep the spans and counters of the body in memory; yields the
    ``Recorder`` and writes it to ``path`` (JSONL) at the end, also when the
    body raises."""
    global _recorder
    rec, prev = Recorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = prev
        rec.close()
        if path is not None:
            rec.write(path)


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
            with span(name):
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
