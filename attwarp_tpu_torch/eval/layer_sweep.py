"""Layer-sweep attention ablation (C27; counterpart of
``attwarp_tpu/eval/layer_sweep.py``).

Parity with ``Ablations/uncertainty_attn_maps_llava.py``: for each layer L,
extract the question-conditioned attention map and a generic-description
map, form absolute and relative (= question / generic, :59-60) maps, upscale
to image resolution, and score localization against ground-truth boxes with
Top-1 and AM@all. Writes a per-sample CSV and a summary table, in JAX's
format.

Backends whose ``extract_layer`` takes a sequence (``LlavaBackend``,
``Qwen2VLBackend``) give every layer's map in one generate per prompt; the
mini backend's layer lives in its frozen config and is overridden per
layer. The upscale is ``jax.image.resize(..., "cubic")``'s, on the host
(``extract/resize.py::resize_cubic``).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from attwarp_tpu_torch.eval.ablation import am_all, interpret_bbox, relative_attention_map, top1
from attwarp_tpu_torch.extract.resize import resize_cubic

GENERIC_PROMPT = (
    "Write a general description of the image. "
    "Answer the question using a single word or phrase."
)

DEFAULT_LAYERS = [4, 8, 10, 12, 14, 16, 18, 20, 24]

# Reference cadence (Ablations/uncertainty_attn_maps_llava.py:42): ONE
# forward pass, the single last-token attention row — no decode steps. Our
# backends express that as max_new_tokens=0 (prefill row only).
_SWEEP_NEW_TOKENS = 0


def _host(maps) -> np.ndarray:
    if isinstance(maps, torch.Tensor):
        return maps.detach().cpu().numpy()
    return np.asarray(maps)


def _extract_all_layers(backend, images, questions,
                        layers: Sequence[int]) -> Optional[Dict[int, np.ndarray]]:
    """One-pass multi-layer extraction where the backend takes a sequence
    ``extract_layer`` (LlavaBackend / Qwen2VLBackend): one generate yields
    maps for every layer instead of one generate per layer. Returns None
    for backends without the capability (the sweep then goes per layer);
    each failure that falls back adds one to ``_extract_all_layers.fallbacks``.
    A kernel fault raises again in ``_extract_at_layer``, which catches
    nothing."""
    if not hasattr(backend, "extract_layer"):
        return None
    old = backend.extract_layer
    try:
        backend.extract_layer = tuple(layers)
        maps, _ = backend.extract(images, questions, max_new_tokens=_SWEEP_NEW_TOKENS)
    except Exception as e:
        # any failure (tuple unsupported, layer out of range, ...) routes to
        # the per-layer path rather than aborting the whole sweep
        print(f"[layer_sweep] one-pass multi-layer extraction unavailable "
              f"({type(e).__name__}: {e}); falling back per layer")
        _extract_all_layers.fallbacks += 1
        return None
    finally:
        backend.extract_layer = old
    maps = _host(maps)  # (L, B, n, n)
    return {L: maps[j] for j, L in enumerate(layers)}


_extract_all_layers.fallbacks = 0


def _extract_at_layer(backend, images, questions, layer: int) -> np.ndarray:
    """Extraction with a per-call layer override. Raises for backends whose
    layer cannot be overridden — a sweep that silently reuses one layer
    would fabricate per-layer differences."""
    if hasattr(backend, "extract_layer"):  # LlavaBackend-style
        old = backend.extract_layer
        try:
            backend.extract_layer = layer
            maps, _ = backend.extract(images, questions, max_new_tokens=_SWEEP_NEW_TOKENS)
        finally:
            backend.extract_layer = old
    elif hasattr(backend, "cfg") and hasattr(backend.cfg, "extract_layer"):
        # MiniLLaVABackend: the layer lives in the frozen config
        old_cfg = backend.cfg
        if layer >= old_cfg.n_layers:
            raise ValueError(f"layer {layer} out of range for backend with "
                             f"{old_cfg.n_layers} layers")
        try:
            backend.cfg = dataclasses.replace(old_cfg, extract_layer=layer)
            maps, _ = backend.extract(images, questions, max_new_tokens=_SWEEP_NEW_TOKENS)
        finally:
            backend.cfg = old_cfg
    else:
        raise TypeError(f"backend {type(backend).__name__} does not support per-layer "
                        "extraction")
    return _host(maps)


def _upscale(att: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    return resize_cubic(np.asarray(att, np.float32), hw)


def layer_sweep(
    backend,
    samples: Sequence[Dict],
    layers: Optional[List[int]] = None,
    out_dir: Optional[str] = None,
    bbox_method: str = "xywh",
) -> Dict:
    """samples: dicts with 'image' (H, W, 3), 'question' (str), 'bbox'
    (4-tuple in image coords). Returns per-layer mean metrics for absolute
    and relative maps; optionally writes results.csv + summary.txt."""
    layers = layers or DEFAULT_LAYERS
    rows: List[Dict] = []
    agg: Dict[Tuple[str, int], List[Tuple[float, float]]] = {}

    for si, s in enumerate(samples):
        img = np.asarray(s["image"])
        H, W = img.shape[:2]
        box = interpret_bbox(s["bbox"], bbox_method)
        all_q = _extract_all_layers(backend, img[None], [s["question"]], layers)
        all_g = (
            _extract_all_layers(backend, img[None], [GENERIC_PROMPT], layers)
            if all_q is not None else None
        )
        for L in layers:
            if all_q is not None:
                att_q, att_g = all_q[L][0], all_g[L][0]
            else:
                att_q = _extract_at_layer(backend, img[None], [s["question"]], L)[0]
                att_g = _extract_at_layer(backend, img[None], [GENERIC_PROMPT], L)[0]
            for typ, grid in (
                ("absolute", att_q),
                ("relative", relative_attention_map(att_q, att_g)),
            ):
                full = _upscale(grid, (H, W))
                t1 = top1(full, box)
                am = am_all(full, box)
                rows.append(
                    {"sample": si, "layer": L, "type": typ, "top1": t1, "am_all": am}
                )
                agg.setdefault((typ, L), []).append((t1, am))

    summary = {
        f"{typ}/layer{L}": {
            "top1": float(np.mean([v[0] for v in vals])),
            "am_all": float(np.mean([v[1] for v in vals])),
            "n": len(vals),
        }
        for (typ, L), vals in sorted(agg.items())
    }

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "results.csv"), "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["sample", "layer", "type", "top1", "am_all"])
            w.writeheader()
            w.writerows(rows)
        with open(os.path.join(out_dir, "summary.txt"), "w") as f:
            f.write(f"{'type':>10} {'layer':>6} {'Top-1':>8} {'AM@all':>8} {'n':>5}\n")
            for key, v in summary.items():
                typ, layer = key.split("/layer")
                f.write(
                    f"{typ:>10} {layer:>6} {v['top1']:8.4f} {v['am_all']:8.4f} {v['n']:>5}\n"
                )
    return summary
