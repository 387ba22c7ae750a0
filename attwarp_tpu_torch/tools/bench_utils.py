"""Shared helpers of the port's bench and profile tools (counterpart of
``tools/bench_utils.py``).

Random weights at the exact LLaVA-1.5-7B and Qwen2-VL-7B geometry: the
throughput is shape-dependent only, so the tools measure the real programs
without downloadable weights. Every figure is taken on the host clock with
a device synchronize before each reading (``repeat``), every repeat is
printed with its min (the figure the JAX tool printed), median and spread,
and every figure line names the card and its power limit (``card``).

Not ported: the JAX module's persistent compile cache (eager PyTorch has
no compile step to cache).
"""

from __future__ import annotations

import functools
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.extract.llava_backend import LlavaBackend
from attwarp_tpu_torch.extract.qwen2vl_backend import Qwen2VLBackend
from attwarp_tpu_torch.models import llava, qwen2vl
from attwarp_tpu_torch.tools.make_random_7b_ckpt import llava_7b_config
from attwarp_tpu_torch.utils.device import require_device


def parse_mode(raw: str):
    """'int8+flash+kv8' -> (base mode, kv8, flash) in any suffix order."""
    flash = "+flash" in raw
    raw = raw.replace("+flash", "")
    kv8 = raw.endswith("+kv8")
    if kv8:
        raw = raw[: -len("+kv8")]
    return raw, kv8, flash


def mode_label(mode: str, kv8: bool, flash: bool = False) -> str:
    return mode + ("+kv8" if kv8 else "") + ("+flash" if flash else "")


@functools.lru_cache(maxsize=None)
def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def card(device) -> str:
    """The card a figure was taken on, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives it; "cpu"
    for a CPU run, whose times are no device figure."""
    return _smi() if torch.device(device).type == "cuda" else "cpu"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def repeat(fn: Callable, repeats: int, device,
           inputs: Callable[[], tuple] = tuple) -> Tuple[Dict, object]:
    """``fn(*inputs())`` ``repeats`` times on the host clock, the device
    synchronized before each clock read; ``inputs`` (fresh images, say) is
    called outside the clock. Returns (``timing_of`` the repeats, the last
    output)."""
    times: List[float] = []
    out = None
    for _ in range(repeats):
        args = inputs()
        sync(device)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(device)
        times.append(time.perf_counter() - t0)
    return timing_of(times), out


def timing_of(times: List[float]) -> Dict:
    """{"seconds": every repeat, "min", "median", "spread": (max - min) /
    median}."""
    med = statistics.median(times)
    return {"seconds": list(times), "min": min(times), "median": med,
            "spread": (max(times) - min(times)) / med}


def report(tag: str, timing: Dict, device, per: int = 1, what: str = "") -> None:
    """One figure line: every repeat in ms (divided by ``per``, the units of
    work a repeat holds), min, median, spread and the card."""
    ms = [t / per * 1e3 for t in timing["seconds"]]
    print(f"{tag}: repeats {', '.join(f'{m:.2f}' for m in ms)} ms{what} | min "
          f"{timing['min'] / per * 1e3:.2f} | median {timing['median'] / per * 1e3:.2f} | "
          f"spread {100 * timing['spread']:.1f}% | {card(device)}")


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_numel(v) for v in tree)
    return tree.numel() if isinstance(tree, torch.Tensor) else 0


def _check_mode(mode: str) -> None:
    if mode not in ("bf16", "int8"):
        raise ValueError(f"mode {mode!r}: expected bf16 or int8[+kv8][+flash]")


def make_llava_7b_backend(mode_spec: str = "bf16", extract_layer=20, tokenizer=None,
                          seed: int = 0, device="cuda"):
    """(LlavaBackend, label) at ``llava-hf/llava-1.5-7b-hf`` geometry with
    random bf16 weights made on ``device`` from ``seed``
    (``models/llava.py::random_params``); ``int8`` quantizes the decoder's
    linears in place (``quantize_int8``). Pass a tokenizer (e.g.
    ``extract/tokenizer.py::DryRunTokenizer``) for the text-level
    extract/answer APIs."""
    mode, kv8, flash = parse_mode(mode_spec)
    _check_mode(mode)
    device = require_device(device, "make_llava_7b_backend")
    cfg = llava_7b_config()
    params = llava.random_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                 device, torch.bfloat16)
    backend = LlavaBackend(llava.LlavaModel(cfg, params), tokenizer=tokenizer,
                           extract_layer=extract_layer, kv_quant=kv8, use_flash=flash)
    if mode == "int8":
        backend.quantize_int8()
    label = mode_label(mode, kv8, flash)
    print(f"params: {tree_bytes(params) / 2**30:.2f} GiB ({label})")
    return backend, label


def make_qwen2vl_7b_backend(mode_spec: str = "bf16", extract_layer=20, tokenizer=None,
                            seed: int = 0, device="cuda", image_size: int = 448):
    """(Qwen2VLBackend, label) at ``Qwen/Qwen2-VL-7B-Instruct`` geometry
    (``Qwen2VLConfig()``) with random bf16 weights made on ``device`` from
    ``seed`` (``models/qwen2vl.py::random_params``); ``int8`` quantizes the
    text decoder's linears in place."""
    mode, kv8, flash = parse_mode(mode_spec)
    _check_mode(mode)
    device = require_device(device, "make_qwen2vl_7b_backend")
    cfg = qwen2vl.Qwen2VLConfig()
    params = qwen2vl.random_params(cfg, torch.Generator(device=device).manual_seed(seed),
                                   device, torch.bfloat16)
    backend = Qwen2VLBackend(qwen2vl.Qwen2VLModel(cfg, params), tokenizer=tokenizer,
                             extract_layer=extract_layer, image_size=image_size,
                             kv_quant=kv8, use_flash=flash)
    if mode == "int8":
        backend.quantize_int8()
    label = mode_label(mode, kv8, flash)
    print(f"params: {tree_bytes(params) / 2**30:.2f} GiB ({label})")
    return backend, label


def random_images(rng: np.random.Generator, n: int) -> List[np.ndarray]:
    """``n`` native-resolution (480x640) uint8 driver inputs, as the JAX
    tools draw them."""
    return [(rng.random((480, 640, 3)) * 255).astype(np.uint8) for _ in range(n)]
