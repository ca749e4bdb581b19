"""GIF decode as cv2 5.0's imdecode(..., IMREAD_COLOR) returns it, without
cv2: cv2 5.0 reads GIF with its own codec (grfmt_gif.cpp), not giflib, and
this follows that codec as it behaves on the installed build.

GIF87a and GIF89a. The whole block structure is walked to the trailer,
and the file is refused (None, as cv2 refuses it) for a stray byte, a
missing trailer, an image outside the logical screen, a graphic control
block of other than 4 bytes or with a disposal method past 3, or an
application block of 11 bytes that does not name NETSCAPE2.0. Then the
first image is decoded: its LZW codes (csrc/image_host.cpp gif_lzw; a
minimum code size of 2 to 11, codes that fill the image exactly, nothing
after the end code) through cv2's one colour table: the global palette
(without one, cv2's default: index i gray i, index 1 white) with the
local palette over its first entries; an index past both palettes'
sizes refuses the file; interlaced rows are put back in order.
The canvas is the logical screen, filled with the global palette's
background colour (black without a global palette; a background index
past the palette refuses the file), and the image's pixels of the
transparent index of the graphic control extension before it are not
drawn. Out come the canvas's BGR pixels.

cv2 5.0's LZW reader takes an end code as a reset and reads on, and takes
some streams that overfill the image by a code or two; such malformed
streams are refused here.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

from . import png

SIGNATURES = (b"GIF87a", b"GIF89a")
MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20


def _lib():
    lib = png.library()
    if not getattr(lib, "_gif_bound", False):
        lib.gif_lzw.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_int64]
        lib.gif_lzw.restype = ctypes.c_int
        lib._gif_bound = True
    return lib


def _default_palette() -> np.ndarray:
    pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    pal[1] = 255
    return pal


class _Truncated(Exception):
    pass


def _sub_blocks(data: bytes, pos: int, keep: bool):
    """(joined payload or b"", position after the terminator)."""
    parts = []
    while True:
        if pos >= len(data):
            raise _Truncated
        n = data[pos]
        pos += 1
        if n == 0:
            return b"".join(parts), pos
        if pos + n > len(data):
            raise _Truncated
        if keep:
            parts.append(data[pos:pos + n])
        pos += n


def _palette(data: bytes, pos: int, flags: int):
    n = 2 << (flags & 7)
    if pos + 3 * n > len(data):
        raise _Truncated
    return np.frombuffer(data, np.uint8, 3 * n, pos).reshape(n, 3), pos + 3 * n


def decode_gif(data: bytes) -> Optional[np.ndarray]:
    """GIF bytes -> (H, W, 3) u8 BGR of the first frame, or None."""
    if not data.startswith(SIGNATURES) or len(data) < 13:
        return None
    try:
        return _decode(data)
    except _Truncated:
        return None


def _decode(data: bytes) -> Optional[np.ndarray]:
    sw, sh, flags, bg, _ = struct.unpack_from("<HHBBB", data, 6)
    if not (0 < sw <= MAX_SIDE and 0 < sh <= MAX_SIDE and sw * sh <= MAX_PIXELS):
        return None
    pos = 13
    gpal = None
    if flags & 0x80:
        gpal, pos = _palette(data, pos, flags)
        if bg >= len(gpal):
            return None
    canvas = np.zeros((sh, sw, 3), np.uint8)
    if gpal is not None:
        canvas[:] = gpal[bg][::-1]
    first = None
    transparent = None
    while True:
        if pos >= len(data):
            return None
        block = data[pos]
        pos += 1
        if block == 0x3B:
            break
        if block == 0x21:
            if pos >= len(data):
                return None
            label = data[pos]
            head = data[pos + 1] if pos + 1 < len(data) else 0
            body, pos = _sub_blocks(data, pos + 1, label in (0xF9, 0xFF))
            # cv2's checks: a graphic control block of 4 bytes, an
            # application block of 11 that names NETSCAPE2.0
            if label == 0xF9:
                if head != 4 or (body[0] >> 2) & 7 > 3:   # a disposal method past 3
                    return None
                if first is None:
                    transparent = body[3] if body[0] & 1 else None
            elif label == 0xFF and head == 11 and body[:11] != b"NETSCAPE2.0":
                return None
            continue
        if block != 0x2C or pos + 9 > len(data):
            return None
        x, y, w, h, iflags = struct.unpack_from("<HHHHB", data, pos)
        pos += 9
        if x + w > sw or y + h > sh or w == 0 or h == 0:
            return None
        lpal = None
        if iflags & 0x80:
            lpal, pos = _palette(data, pos, iflags)
        if pos >= len(data):
            return None
        min_size = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1, first is None)
        if first is None:
            first = (x, y, w, h, iflags, lpal, min_size, lzw, transparent)
    if first is None:
        return None
    x, y, w, h, iflags, lpal, min_size, lzw, transparent = first
    if not 2 <= min_size <= 11:
        return None
    idx = np.empty(w * h, np.uint8)
    if _lib().gif_lzw(lzw, len(lzw), min_size, idx.ctypes.data, w * h) != 0:
        return None
    # one table: the global palette (or cv2's default), the local one over
    # its first entries; valid up to the larger of the two
    pal = _default_palette() if gpal is None else np.zeros((256, 3), np.uint8)
    size = 256 if gpal is None and lpal is None else 0
    for p in (gpal, lpal):
        if p is not None:
            pal[:len(p)] = p
            size = max(size, len(p))
    if int(idx.max()) >= size:
        return None
    idx = idx.reshape(h, w)
    if iflags & 0x40:
        order = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                                np.arange(1, h, 2)])
        rows = np.empty_like(idx)
        rows[order] = idx
        idx = rows
    region = canvas[y:y + h, x:x + w]
    colors = pal[idx][..., ::-1]
    if transparent is not None:
        keep = idx != transparent
        region[keep] = colors[keep]
    else:
        region[:] = colors
    return canvas
