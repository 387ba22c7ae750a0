"""Disaggregated prefill/decode serving over two device groups
(counterpart of ``attwarp_tpu/serving/disagg.py``).

Admission prefill gets its own device: the decode device holds the slot
pool, its KV cache and one copy of the weights; the prefill device holds a
second copy (the standard disaggregation trade: weights are duplicated,
the cache is not). An admission group is embedded and prefilled on
``prefill_model``'s device (through kernel K2 with ``use_flash``), and the
finished KV block moves to the decode device with one ``.to()``; the first
tokens follow it, to be fetched with the next tick's. Disaggregation
changes where the prefill runs, not its arithmetic: the tokens equal
``ServeEngine``'s.

``split_devices`` is JAX's ``split_meshes`` for a device list: disjoint
prefill and decode groups, half and half by default. The engine itself
also takes two equal devices, as one card runs it; prefill and decode then
run one after the other on that card (JAX overlaps them by asynchronous
dispatch on disjoint devices; overlapping them on one card through CUDA
streams is later work).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from attwarp_tpu_torch.serving.engine import ServeEngine


def split_devices(devices: Optional[Sequence] = None,
                  prefill_devices: int = 0) -> Tuple[List[torch.device], List[torch.device]]:
    """Split ``devices`` (every visible CUDA device by default) into
    disjoint (decode devices, prefill devices); ``prefill_devices``
    defaults to half, taken from the front as in JAX."""
    devs = [torch.device(d) for d in (devices if devices is not None else
                                      [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    n_p = prefill_devices or len(devs) // 2
    if not 0 < n_p < len(devs):
        raise ValueError(f"split_devices: {n_p} prefill devices out of {len(devs)}")
    return devs[n_p:], devs[:n_p]


class DisaggServeEngine(ServeEngine):
    """``ServeEngine`` whose admission prefills run on ``prefill_model``
    (the same weights on the prefill device); ``model``, and the slot
    cache the base class allocates from it, live on the decode device.

    >>> decode, prefill = split_devices()
    >>> eng = DisaggServeEngine(model_on(decode[0]), prefill_model=model_on(prefill[0]),
    ...                         slots=32, max_seq=832, kv_quant=True)
    """

    def __init__(self, model, prefill_model, **kw):
        super().__init__(model, **kw)
        self.prefill_model = prefill_model
