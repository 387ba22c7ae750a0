"""The benchmark's instrumentation of the program, placed from outside: spans
around calls into a layer, and a record of each hand-written kernel's call
shapes at its Python entry, taken by the kernel's own file under
``benchmark/kernels/``. Both are installed only in a traced run
(``--trace 1``) and removed after it; an untraced run measures the program
as it is.

A span synchronises the device at both ends, so its time is the layer's
whole time; the device trace is therefore taken in a slice of its own with
no spans (``trace.py``). A kernel record adds no synchronisation: the
shapes are read at the call, and the valid-position counts that K2's and
K3's work depends on are reduced on the device and read after the slice.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from types import ModuleType
from typing import Callable, Dict, Iterator, List, Tuple

import torch

from benchmark.counts import roofline


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Spans:
    """Durations in seconds by span name, in call order."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    def wrap(self, name: str, fn: Callable) -> Callable:
        def spanned(*args, **kwargs):
            _sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                _sync()
                self.times.setdefault(name, []).append(time.perf_counter() - t0)
        spanned.__wrapped__ = fn
        return spanned


@contextlib.contextmanager
def patched(target, attr: str, wrapper: Callable) -> Iterator[None]:
    """``target.attr`` replaced by ``wrapper(original)`` for the body."""
    orig = getattr(target, attr)
    setattr(target, attr, wrapper(orig))
    try:
        yield
    finally:
        setattr(target, attr, orig)


# ── kernel call records ───────────────────────────────────────────────

class KernelCalls:
    """Each hand-written kernel's calls, as its file records them."""

    def __init__(self, kernels: Dict[str, ModuleType]):
        self.kernels = kernels
        self.calls: Dict[str, List[Tuple]] = {k: [] for k in kernels}
        self._mask_cache: Dict[Tuple[int, int, int], tuple] = {}
        self.active = False   # recording only inside the traced slice

    def start(self) -> None:
        self.active = True

    def stop(self) -> None:
        self.active = False

    def _count(self, mask: torch.Tensor, dim=None) -> torch.Tensor:
        """A device reduction of ``mask``, once per (tensor, version): the
        decode loop passes one mask to every layer and grows it in place."""
        key = (id(mask), mask._version, -1 if dim is None else dim)
        hit = self._mask_cache.get(key)
        if hit is None:
            # the mask is kept alive with its count, so that its id is not
            # reused by a later mask while the cache holds it
            hit = (mask, mask.sum() if dim is None else mask.sum(dim=dim))
            self._mask_cache[key] = hit
        return hit[1]

    def wrapper(self, kernel: str) -> Callable:
        record = self.kernels[kernel].record

        def wrap(fn):
            def recorded(*args, **kwargs):
                if self.active:
                    self.calls[kernel].append(record(args, kwargs, self._count))
                return fn(*args, **kwargs)
            recorded.__wrapped__ = fn
            return recorded
        return wrap

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        with contextlib.ExitStack() as stack:
            for kernel, mod in self.kernels.items():
                for target, attr in mod.ENTRIES:
                    stack.enter_context(patched(importlib.import_module(target), attr,
                                                self.wrapper(kernel)))
            yield

    def trace_names(self) -> Dict[str, Tuple[str, ...]]:
        return {k: tuple(mod.TRACE_NAMES) for k, mod in self.kernels.items()}

    def least_seconds(self) -> Dict[str, float]:
        """Each kernel's summed least time over its recorded calls
        (``counts/roofline.py``: 3.35 TB/s, 989 TFLOP/s bf16)."""
        out: Dict[str, float] = {}
        for kernel, calls in self.calls.items():
            total = 0.0
            for c in calls:
                nb, fl = self.kernels[kernel].work(c)
                total += roofline.bound(nb, fl)["bound_ms"] / 1e3
            if calls:
                out[kernel] = total
        return out
