"""Image files without an imaging library (no JAX counterpart).

The JAX driver and harness read and write every image through Pillow. The
port keeps PNG, the format of every artifact the driver writes and the
harness reads, in this module: 8-bit grayscale, gray+alpha, RGB and RGBA,
non-interlaced, decoded with ``zlib`` from the standard library (all five
row filters) and written with filter 0. A file is recognised by its
signature, not by its name, so a ``.jpg`` name over PNG content reads
here. Any other file (JPEG, a palette or 16-bit PNG) is read through
Pillow, imported when such a file arrives; where Pillow is missing that
raises ``MissingPillowError``, naming the file and Pillow, which the
dataset readers let through rather than skip the image.

Speed: rows with filters None, Sub and Up (the files written here use
None) decode as whole numpy rows. Average and Paeth predict each byte from
the one decoded just before it, so they go byte by byte in Python, tens of
times slower than Pillow's C decoder. Pillow picks them for smooth content
(photographs, scans), so a ``--jsonl`` dataset of such PNGs reads slowly;
``chip_smoke.py`` step 1 times one against Pillow.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# PNG color type -> channels, for the 8-bit types decoded here
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}

# zlib level of written files: 6 is zlib's and Pillow's default
COMPRESS_LEVEL = 6


def _chunks(data: bytes):
    """(type, payload) of each chunk after the signature, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(ctype + payload) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before IEND")


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    """Undo the Paeth filter of one row in place."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Filtered scanlines -> (height, width * bpp) uint8."""
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:                                   # None
            cur = line.copy()
        elif ftype == 1:                                 # Sub: running sum per channel
            cur = np.cumsum(line.reshape(width, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ftype == 2:                                 # Up
            cur = line + prev
        elif ftype == 3:                                 # Average
            buf = bytearray(line.tobytes())
            pb = prev.tobytes()
            for i in range(stride):
                left = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((left + pb[i]) >> 1)) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        elif ftype == 4:                                 # Paeth
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {int(ftype)}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> (H, W) or (H, W, channels) uint8, or None for a PNG
    this module does not decode (palette, 16-bit, fewer bits, interlaced)."""
    header, idat = None, []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        return None
    bpp = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width, bpp)
    return pixels.reshape(height, width) if bpp == 1 else pixels.reshape(height, width, bpp)


class MissingPillowError(RuntimeError):
    """A file this module does not decode, on a machine without Pillow."""


def _pil_rgb(path: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as exc:
        raise MissingPillowError(
            f"{path}: not an 8-bit PNG; reading it needs Pillow, which is not "
            f"installed") from exc
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def read_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, as Pillow's ``convert("RGB")``
    gives it: gray is repeated over the three channels, alpha is dropped."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(PNG_SIGNATURE):
        px = decode_png(data)
        if px is not None:
            if px.ndim == 2:
                px = px[..., None]
            if px.shape[2] in (1, 2):                     # gray, gray+alpha
                px = np.repeat(px[..., :1], 3, axis=2)
            return np.ascontiguousarray(px[..., :3])
    return _pil_rgb(path)


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1-4) uint8 -> PNG bytes (gray, gray+alpha, RGB or
    RGBA by the channel count), every row with filter 0."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8:
        raise TypeError(f"PNG pixels must be uint8, got {px.dtype}")
    if px.ndim == 2:
        px = px[..., None]
    if px.ndim != 3 or px.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"PNG pixels must be (H, W) or (H, W, 1-4), got {px.shape}")
    h, w, c = px.shape
    rows = np.zeros((h, w * c + 1), np.uint8)
    rows[:, 1:] = px.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), COMPRESS_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write ``pixels`` (see ``encode_png``) to ``path`` as PNG, whatever
    its extension."""
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)
