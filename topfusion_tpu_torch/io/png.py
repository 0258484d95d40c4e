"""PNG files written with zlib alone: 8-bit grey or RGB images and 16-bit
grey images (the TUM / ICL depth format, 5000 units per metre), so that
the app and the tools need no image library.

A 16-bit PNG stores its samples big-endian; the IHDR chunk gives the bit
depth (8 or 16) and the colour type (0 grey, 2 RGB).  Every row is
written with filter 0 (none).  ``io/datasets._read_png`` reads these
files back through the repository's native decoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 3: 2}  # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))


def write_png(path: str, img: np.ndarray) -> None:
    """``img`` as a PNG file: uint8 [H, W] grey or [H, W, 3] RGB, or
    uint16 [H, W] grey (16-bit samples).  Other dtypes are cast to uint8,
    as the renders are."""
    img = np.asarray(img)
    if img.dtype != np.uint16:
        img = img.astype(np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels not in _COLOR_TYPE or (img.dtype == np.uint16 and channels != 1):
        raise ValueError(f"write_png: unsupported image {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0 per row
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                            _COLOR_TYPE[channels], 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(_chunk(b"IEND", b""))
