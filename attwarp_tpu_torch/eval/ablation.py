"""Ablation metrics: bounding-box attention localization (a copy of
``attwarp_tpu/eval/ablation.py``, which imports no JAX;
``tests/test_torch_layers.py`` pins the copy).

Parity with ``Ablations/attention_redistribution/metrics.py:6-25`` (also
duplicated inline in ``Ablations/uncertainty_attn_maps_llava.py:118-125``):
Top-1 — does the argmax of the attention map land inside the box; AM@all —
fraction of total attention mass inside the box.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

BBOX_METHODS: List[str] = ["xywh", "xyxy"]


def interpret_bbox(b: Sequence[float], method: str) -> Tuple[int, int, int, int]:
    if method == "xywh":
        x, y, w, h = b
        return int(x), int(y), int(w), int(h)
    x1, y1, x2, y2 = b
    return int(x1), int(y1), int(x2 - x1), int(y2 - y1)


def top1(attention_map: np.ndarray, box: Tuple[int, int, int, int]) -> int:
    x0, y0, w, h = box
    r, c = np.unravel_index(np.argmax(attention_map), attention_map.shape)
    return 1 if (x0 <= c < x0 + w and y0 <= r < y0 + h) else 0


def am_all(attention_map: np.ndarray, box: Tuple[int, int, int, int]) -> float:
    x0, y0, w, h = box
    return float(
        attention_map[y0 : y0 + h, x0 : x0 + w].sum()
        / (attention_map.sum() + 1e-12)
    )


def relative_attention_map(
    att_question: np.ndarray, att_generic: np.ndarray, eps: float = 1e-8
) -> np.ndarray:
    """'relative' attention: question-conditioned map divided by the map for
    a generic description prompt (uncertainty_attn_maps_llava.py:59-60)."""
    return att_question / (att_generic + eps)
