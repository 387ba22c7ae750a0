"""The benchmark's instrumentation of the program, placed from outside: spans
around calls into a layer, and a record of each hand-written kernel's call
shapes at its Python entry. Both are installed only in a traced run
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

# kernel -> (module, attribute) of each place the program looks it up, and
# the substrings of its device kernels' names in the trace
KERNELS = {
    "k1": {"entries": [("attwarp_tpu_torch.warp.warp", "warp_resample")],
           "trace_names": ("warp_resample_kernel",)},
    "k2": {"entries": [("attwarp_tpu_torch.models.llama", "flash_prefill")],
           "trace_names": ("flash_prefill_kernel",)},
    "k3": {"entries": [("attwarp_tpu_torch.models.llama", "decode_attn_int8")],
           "trace_names": ("decode_attn_mha", "decode_attn_gqa", "decode_merge_kernel")},
}


class KernelCalls:
    """Each hand-written kernel's calls: the shapes, and for K2 and K3 the
    device counts their work depends on."""

    def __init__(self):
        self.calls: Dict[str, List[Tuple]] = {k: [] for k in KERNELS}
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
        def wrap(fn):
            def recorded(*args, **kwargs):
                if not self.active:
                    pass
                elif kernel == "k1":
                    images, map_x, map_y = args[:3]
                    B, H, W, C = images.shape
                    self.calls["k1"].append((B, H, W, C, map_y.shape[1], map_x.shape[1]))
                elif kernel == "k2":
                    q, k, _v, mask = args[:4]
                    B, T, H, _hd = q.shape
                    self.calls["k2"].append((B, T, H, k.shape[2], self._count(mask, 1)))
                else:
                    q, k_q, _ks, _vq, _vs, mask = args[:6]
                    _L, B, S, kvH, _hd = k_q.shape
                    self.calls["k3"].append((B, S, q.shape[1], kvH, self._count(mask)))
                return fn(*args, **kwargs)
            recorded.__wrapped__ = fn
            return recorded
        return wrap

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        with contextlib.ExitStack() as stack:
            for kernel, spec in KERNELS.items():
                for mod, attr in spec["entries"]:
                    stack.enter_context(patched(importlib.import_module(mod), attr,
                                                self.wrapper(kernel)))
            yield

    def least_seconds(self) -> Dict[str, float]:
        """Each kernel's summed least time over its recorded calls
        (``counts/roofline.py``: 3.35 TB/s, 989 TFLOP/s bf16)."""
        out: Dict[str, float] = {}
        for kernel, calls in self.calls.items():
            total = 0.0
            for c in calls:
                if kernel == "k1":
                    nb, fl = roofline.k1_work(*c)
                elif kernel == "k2":
                    B, T, H, kvH, valid = c
                    pads = [T - int(v) for v in valid.tolist()]
                    nb, fl = roofline.k2_work(B, T, H, kvH, pads)
                else:
                    B, S, H, kvH, n_valid = c
                    nb, fl = roofline.k3_work(B, S, H, kvH, int(n_valid))
                total += roofline.bound(nb, fl)["bound_ms"] / 1e3
            if calls:
                out[kernel] = total
        return out
