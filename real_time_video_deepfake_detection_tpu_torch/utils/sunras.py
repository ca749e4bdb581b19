"""Sun raster decode as cv2 5.0's imdecode(..., IMREAD_COLOR) returns it,
without cv2 (its grfmt_sunras.cpp, as it behaves on the installed build).

The 32-byte big-endian header: magic 59 a6 6a 95, width, height, depth
(1, 8, 24 or 32), the data length (unused), the type, the colormap type
and its length. cv2 decodes the old (0) and standard (1) types; its check
of the byte-encoded (2, run-length) and RGB (3) types reads a field that
is never set, so it refuses both, and so does this decoder, with every
other type. A colormap (type 1, depths 1 and 8 only) is at most
3 * 2^depth bytes: its length / 3 entries of red, then green, then blue
(entries past them black); without one (type 0, length 0) depth 1 reads 0
black and 1 white and depth 8 is gray. Rows are padded to 16 bits; depth
24 is stored B, G, R and kept so, depth 32 drops each pixel's first byte.
A short or malformed file gives None.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

SIGNATURE = b"\x59\xa6\x6a\x95"
MAX_PIXELS = 1 << 30
MAX_SIDE = 1 << 20


def decode_sunras(data: bytes) -> Optional[np.ndarray]:
    """Sun raster bytes -> (H, W, 3) u8 BGR, or None."""
    if len(data) < 32 or not data.startswith(SIGNATURE):
        return None
    _, w, h, depth, _, kind, maptype, maplength = struct.unpack(">8I", data[:32])
    if depth not in (1, 8, 24, 32) or kind not in (0, 1):
        return None
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
        return None
    entries = 1 << depth if depth <= 8 else 0
    if maptype == 0:
        if maplength:
            return None
        gray = np.array([0, 255] if depth == 1 else np.arange(256), np.uint8)
        palette = np.repeat(gray[:, None], 3, 1) if depth <= 8 else None
    elif maptype == 1 and depth <= 8 and 0 < maplength <= 3 * entries:
        if len(data) < 32 + maplength:
            return None
        n = maplength // 3
        cmap = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n)
        palette = np.zeros((entries, 3), np.uint8)
        palette[:n] = cmap[::-1].T          # (b, g, r) per entry
    else:
        return None
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    at = 32 + maplength
    if len(data) - at < pitch * h:
        return None
    rows = np.frombuffer(data, np.uint8, pitch * h, at).reshape(h, pitch)
    if depth == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :w]]
    if depth == 8:
        return palette[rows[:, :w]]
    nch = depth // 8
    px = rows[:, :w * nch].reshape(h, w, nch)
    return (px if nch == 3 else px[..., 1:]).copy()   # writable, as cv2's
