"""JET colormap equal to ``cv2.applyColorMap(..., cv2.COLORMAP_JET)``
(counterpart of ``attwarp_tpu/utils/colormap.py``).

Used for the attention overlays (reference llava.py:258,
new_method.py:300,471). The JAX module takes OpenCV's table when ``cv2``
imports and a piecewise-linear formula otherwise; this one carries
OpenCV's 256-entry table as a constant (RGB order), so its overlays equal
OpenCV's without ``cv2`` installed. ``tests/test_torch_dataset.py`` pins
the constant to ``cv2.applyColorMap``.
"""

from __future__ import annotations

import numpy as np

# OpenCV's COLORMAP_JET, gray level 0..255 -> R, G, B, as hex bytes
_JET_RGB_HEX = (
    "00008000008400008800008c00009000009400009800009c0000a00000a40000a80000ac"
    "0000b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc"
    "0000e00000e40000e80000ec0000f00000f40000f80000fc0000ff0004ff0008ff000cff"
    "0010ff0014ff0018ff001cff0020ff0024ff0028ff002cff0030ff0034ff0038ff003cff"
    "0040ff0044ff0048ff004cff0050ff0054ff0058ff005cff0060ff0064ff0068ff006cff"
    "0070ff0074ff0078ff007cff0080ff0084ff0088ff008cff0090ff0094ff0098ff009cff"
    "00a0ff00a4ff00a8ff00acff00b0ff00b4ff00b8ff00bcff00c0ff00c4ff00c8ff00ccff"
    "00d0ff00d4ff00d8ff00dcff00e0ff00e4ff00e8ff00ecff00f0ff00f4ff00f8ff00fcff"
    "02fffe06fffa0afff60efff212ffee16ffea1affe61effe222ffde26ffda2affd62effd2"
    "32ffce36ffca3affc63effc242ffbe46ffba4affb64effb252ffae56ffaa5affa65effa2"
    "62ff9e66ff9a6aff966eff9272ff8e76ff8a7aff867eff8282ff7e86ff7a8aff768eff72"
    "92ff6e96ff6a9aff669eff62a2ff5ea6ff5aaaff56aeff52b2ff4eb6ff4abaff46beff42"
    "c2ff3ec6ff3acaff36ceff32d2ff2ed6ff2adaff26deff22e2ff1ee6ff1aeaff16eeff12"
    "f2ff0ef6ff0afaff06feff01fffc00fff800fff400fff000ffec00ffe800ffe400ffe000"
    "ffdc00ffd800ffd400ffd000ffcc00ffc800ffc400ffc000ffbc00ffb800ffb400ffb000"
    "ffac00ffa800ffa400ffa000ff9c00ff9800ff9400ff9000ff8c00ff8800ff8400ff8000"
    "ff7c00ff7800ff7400ff7000ff6c00ff6800ff6400ff6000ff5c00ff5800ff5400ff5000"
    "ff4c00ff4800ff4400ff4000ff3c00ff3800ff3400ff3000ff2c00ff2800ff2400ff2000"
    "ff1c00ff1800ff1400ff1000ff0c00ff0800ff0400ff0000fc0000f80000f40000f00000"
    "ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c00000"
    "bc0000b80000b40000b00000ac0000a80000a40000a000009c0000980000940000900000"
    "8c0000880000840000800000"
)

JET_LUT_RGB = np.frombuffer(bytes.fromhex(_JET_RGB_HEX), np.uint8).reshape(256, 3)


def jet_lut_rgb() -> np.ndarray:
    """(256, 3) uint8 RGB lookup table."""
    return JET_LUT_RGB


def apply_jet(gray: np.ndarray) -> np.ndarray:
    """uint8 grayscale (H, W) -> RGB heatmap (H, W, 3)."""
    return JET_LUT_RGB[gray]
