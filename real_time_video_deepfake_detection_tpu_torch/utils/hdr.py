"""Radiance HDR (RGBE) decode as cv2 5.0's imdecode(..., IMREAD_COLOR)
returns it, without cv2 (its grfmt_hdr.cpp over rgbe.cpp, as they behave
on the installed build).

The file starts "#?RADIANCE" or "#?RGBE" (cv2's signature). The header is
read as rgbe.cpp's RGBE_ReadHeader reads it with no header info: lines (of
at most 127 bytes, as fgets cuts them) until an empty one, one of which
must be exactly "FORMAT=32-bit_rle_rgbe" (an XYZE file, whose line names
32-bit_rle_xyze, is refused as cv2 refuses it); then the size line, which
must read "-Y <height> +X <width>" (other orientations are refused, as by
cv2). The pixels are flat or new-style run-length scanlines
(csrc/image_host.cpp hdr_pixels, rgbe.cpp's RGBE_ReadPixels_RLE); each
(r, g, b, e) becomes r * 2^(e - 136) in float32 (0 where e is 0), and cv2's
conversion to 8 bits multiplies by 255 in float32, rounds to the nearest
even integer and saturates, RGB to BGR. A short or malformed file gives
None, as cv2 5.0's rgbe errors make it return None.
"""

from __future__ import annotations

import ctypes
import re
from typing import Optional

import numpy as np

from . import png

SIGNATURES = (b"#?RADIANCE", b"#?RGBE")
MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20
_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s+\+X\s*([+-]?\d+)")


def _lib():
    lib = png.library()
    if not getattr(lib, "_hdr_bound", False):
        lib.hdr_pixels.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hdr_pixels.restype = ctypes.c_int
        lib._hdr_bound = True
    return lib


def _lines(data: bytes):
    """fgets over the data: (line, position after it), at most 127 bytes a
    line, a line ending at its LF."""
    pos = 0
    while pos < len(data):
        end = data.find(b"\n", pos, pos + 127)
        end = pos + 127 if end < 0 else end + 1
        end = min(end, len(data))
        yield data[pos:end], end
        pos = end


def decode_hdr(data: bytes) -> Optional[np.ndarray]:
    """Radiance HDR bytes -> (H, W, 3) u8 BGR, or None."""
    if not data.startswith(SIGNATURES):
        return None
    lines = _lines(data)
    found = False
    for line, pos in lines:
        if line in (b"", b"\n"):
            break
        found = found or line == b"FORMAT=32-bit_rle_rgbe\n"
    else:
        return None
    if not found or line != b"\n":
        return None
    size = next(lines, None)
    if size is None:
        return None
    m = _SIZE.match(size[0])
    if m is None:
        return None
    h, w = int(m.group(1)), int(m.group(2))
    pos = size[1]
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
        return None
    rgbe = np.empty((h, w, 4), np.uint8)
    if _lib().hdr_pixels(data, len(data), pos, w, h, rgbe.ctypes.data) != 0:
        return None
    e = rgbe[..., 3].astype(np.int32)
    f = np.where(e > 0, np.ldexp(np.float32(1), e - 136).astype(np.float32), np.float32(0))
    rgb = rgbe[..., :3].astype(np.float32) * f[..., None]
    v = np.rint(rgb * np.float32(255))
    out = np.where(np.abs(v) < np.float32(2 ** 31), np.clip(v, 0, 255), 0).astype(np.uint8)
    return np.ascontiguousarray(out[..., ::-1])
