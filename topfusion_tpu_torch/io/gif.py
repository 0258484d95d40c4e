"""Animated GIF89a files in the standard library and numpy (the JAX
package's app writes its GIFs through imageio, which the port does not
need).

Each frame carries its own palette:

* a frame of at most 256 distinct colours (a grey frame, a normal-map or
  confidence render with few shades) gets exactly those colours and is
  stored losslessly;
* any other frame (a shaded render over its colour gradient background)
  gets a fixed palette: a 6 x 6 x 6 colour cube (levels 0, 51, ..., 255)
  and 40 more greys, which with the cube's 6 make a ramp of 46 levels
  ``round(i * 255 / 45)``.  A grey pixel (r == g == b) takes the nearest
  grey, so it stays grey and is off by at most MAX_GREY_ERROR = 3; any
  other pixel takes the nearest level in each channel, off by at most
  MAX_COLOR_ERROR = 25 per channel.

The image data is an "uncompressed" LZW stream: literal 9-bit codes
only, with a clear code before every 254 literals, so the decoder's code
table never widens the codes.  It is 9/8 of a byte per pixel, packed with
numpy in milliseconds, and any GIF decoder reads it.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

_CLEAR, _EOI = 256, 257
_LITERALS_PER_CLEAR = 254  # the table reaches 511 entries, never 512
MAX_GREY_ERROR = 3
MAX_COLOR_ERROR = 25


def _fixed_palette() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(palette [256, 3], cube level of each 8-bit value [256], palette
    index of the grey nearest to each 8-bit value [256])."""
    levels = np.arange(6) * 51
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    ramp = np.round(np.arange(46) * 255.0 / 45).astype(np.int64)
    extra = ramp[np.arange(46) % 9 != 0]  # every 9th is a cube grey
    pal = np.concatenate([np.stack([r, g, b], axis=-1).reshape(-1, 3),
                          np.repeat(extra[:, None], 3, axis=1)]).astype(np.uint8)
    values = np.arange(256)
    cube_level = np.abs(values[:, None] - levels[None, :]).argmin(axis=1)
    greys = np.flatnonzero((pal[:, 0] == pal[:, 1]) & (pal[:, 1] == pal[:, 2]))
    nearest_grey = greys[np.abs(values[:, None] - pal[greys, 0][None, :].astype(int)).argmin(axis=1)]
    return pal, cube_level, nearest_grey


_PALETTE, _CUBE_LEVEL, _NEAREST_GREY = _fixed_palette()


def _indexed(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(palette [256, 3], indices [H, W] uint8) of one frame."""
    if frame.ndim == 2:
        frame = np.repeat(frame[..., None], 3, axis=-1)
    r, g, b = (frame[..., c].astype(np.int64) for c in range(3))
    colors, inverse = np.unique(((r << 16) | (g << 8) | b).reshape(-1), return_inverse=True)
    if colors.size <= 256:
        pal = np.zeros((256, 3), np.uint8)
        pal[: colors.size] = np.stack([colors >> 16, (colors >> 8) & 255, colors & 255], axis=-1)
        return pal, inverse.reshape(r.shape).astype(np.uint8)
    cube = (_CUBE_LEVEL[r] * 6 + _CUBE_LEVEL[g]) * 6 + _CUBE_LEVEL[b]
    grey = (r == g) & (g == b)
    return _PALETTE, np.where(grey, _NEAREST_GREY[r], cube).astype(np.uint8)


def _lzw_literal(indices: np.ndarray) -> bytes:
    """The 8-bit indices as GIF LZW data, in sub-blocks of 255 bytes."""
    px = indices.reshape(-1).astype(np.uint16)
    n = px.size
    groups = -(-n // _LITERALS_PER_CLEAR)
    # [groups, 1 + 254]: a clear code, then up to 254 literals; the padding
    # at the end of the last group is cut off and one EOI code follows.
    codes = np.full((groups, _LITERALS_PER_CLEAR + 1), _EOI, np.uint16)
    codes[:, 0] = _CLEAR
    literals = np.full(groups * _LITERALS_PER_CLEAR, _EOI, np.uint16)
    literals[:n] = px
    codes[:, 1:] = literals.reshape(groups, _LITERALS_PER_CLEAR)
    codes = np.concatenate([codes.reshape(-1)[: groups + n], np.array([_EOI], np.uint16)])
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    out = bytearray()
    for i in range(0, len(data), 255):
        block = data[i:i + 255]
        out += bytes([len(block)]) + block
    out += b"\x00"
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float) -> None:
    """Frames of one size, uint8 [H, W, 3] (or grey [H, W]), as an
    animated GIF that loops forever, each frame shown ``round(100 / fps)``
    hundredths of a second (200 ms at fps 5, 100 ms at fps 10: what
    ``imageio.v3.imwrite(..., fps=...)`` writes)."""
    frames = [np.ascontiguousarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("write_gif: no frames")
    h, w = frames[0].shape[:2]
    if any(f.shape[:2] != (h, w) for f in frames):
        raise ValueError("write_gif: frames of different sizes")
    delay = int(round(100.0 / fps))
    out = bytearray(b"GIF89a")
    out += struct.pack("<HHBBB", w, h, 0x70, 0, 0)  # no global colour table
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"
    for f in frames:
        palette, idx = _indexed(f)
        out += b"\x21\xf9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        out += b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87)  # local table, 256 entries
        out += palette.tobytes()
        out += b"\x08" + _lzw_literal(idx)
    out += b"\x3b"
    with open(path, "wb") as fh:
        fh.write(out)


def gif_frames(path: str) -> List[Tuple[int, int, int]]:
    """(width, height, delay in hundredths of a second) of every image in
    a GIF file, from its block structure (the image data is not decoded)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"{path}: not a GIF file")
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)

    def skip_sub_blocks(p: int) -> int:
        while data[p]:
            p += data[p] + 1
        return p + 1

    out, delay = [], 0
    while data[pos] != 0x3B:
        kind = data[pos]
        if kind == 0x21:
            if data[pos + 1] == 0xF9:
                delay = struct.unpack_from("<H", data, pos + 4)[0]
            pos = skip_sub_blocks(pos + 2)
        elif kind == 0x2C:
            w, h, flags = struct.unpack_from("<HHB", data, pos + 5)
            out.append((w, h, delay))
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)  # after the LZW minimum code size
        else:
            raise ValueError(f"{path}: unknown block 0x{kind:02x} at byte {pos}")
    return out
