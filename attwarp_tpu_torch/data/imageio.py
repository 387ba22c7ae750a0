"""Image files through Pillow, as the JAX package reads and writes them.

``read_rgb`` is ``attwarp_tpu/warp/io.py::load_image_rgb`` on a path
(``Image.open(path).convert("RGB")``); ``write_png`` saves as the JAX
driver saves its artifacts (``Image.fromarray(pixels).save``), as PNG
whatever the name; ``read_gray`` and ``resize_u8`` are the training
datasets' ``convert("L")`` and Pillow resizes (``data/manifests.py``).
Pillow is imported when a file is read or written, so importing this
module needs none; where Pillow is missing each raises
``MissingPillowError``, naming the file and Pillow, which the dataset
readers let through rather than skip the image.
"""

from __future__ import annotations

import numpy as np


class MissingPillowError(RuntimeError):
    """An image file to read or write on a machine without Pillow."""


def _image_module(path: str):
    try:
        from PIL import Image
    except ImportError as exc:
        raise MissingPillowError(
            f"{path}: reading and writing image files needs Pillow, which is not "
            f"installed") from exc
    return Image


def read_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, by Pillow's ``convert("RGB")``:
    gray is repeated over the three channels, alpha is dropped."""
    with _image_module(path).open(path) as im:
        return np.asarray(im.convert("RGB"))


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write uint8 ``pixels`` ((H, W) gray or (H, W, 3/4) RGB/RGBA, by
    Pillow's ``fromarray``) to ``path`` as PNG."""
    _image_module(path).fromarray(np.asarray(pixels)).save(path, format="PNG")


def read_gray(path: str) -> np.ndarray:
    """An image file -> (H, W) uint8 luma, by Pillow's ``convert("L")``."""
    with _image_module(path).open(path) as im:
        return np.asarray(im.convert("L"))


def resize_u8(pixels: np.ndarray, hw, nearest: bool = False) -> np.ndarray:
    """uint8 ``pixels`` ((H, W) or (H, W, 3)) resized to ``hw = (h, w)`` by
    Pillow's ``resize``: BILINEAR, or NEAREST where ``nearest``."""
    Image = _image_module("<array>")
    h, w = hw
    im = Image.fromarray(np.asarray(pixels))
    return np.asarray(im.resize((w, h), Image.NEAREST if nearest else Image.BILINEAR))
