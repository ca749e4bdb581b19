"""EXIF orientation as cv2 reads and applies it (cv2.imread / cv2.imdecode
with IMREAD_COLOR), without cv2.

cv2 takes the orientation tag (0x0112) from the first APP1 segment of a
JPEG, 6 bytes past its length field whatever they hold, and from a PNG's
eXIf chunk; it reads IFD0 only, keeps the first orientation entry, and
uses the 16-bit value at the entry's value field (OpenCV's exif.cpp
ExifReader). A parse that runs out of data keeps the entries read before
it. `apply_orientation` then transposes and flips as ApplyExifOrientation
does for values 1-8; any other value leaves the image as it is.
"""

from __future__ import annotations

import struct
from typing import Optional

import torch

_ORIENTATION = 0x0112


def tiff_orientation(buf: bytes) -> int:
    """The orientation in a TIFF-structured EXIF block ("II" or "MM"
    first), 0 when it has none."""
    if len(buf) < 8:
        return 0
    order = {b"II": "<", b"MM": ">"}.get(bytes(buf[:2]))
    if order is None:
        return 0

    def u16(at: int) -> Optional[int]:
        return struct.unpack_from(order + "H", buf, at)[0] if 0 <= at and at + 2 <= len(buf) \
            else None

    if u16(2) != 0x2A:
        return 0
    offset = struct.unpack_from(order + "I", buf, 4)[0]
    count = u16(offset)
    if count is None:
        return 0
    at = offset + 2
    for _ in range(count):
        tag = u16(at)
        if tag is None:
            return 0
        if tag == _ORIENTATION:
            value = u16(at + 8)
            return value or 0
        at += 12
    return 0


def jpeg_orientation(data: bytes) -> int:
    """The orientation of a JPEG stream's first APP1 segment (before its
    first scan), 0 when there is none."""
    n, i = len(data), 2
    while i + 4 <= n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xFF:
            i += 1
            continue
        if m in (0x00, 0x01, 0xD8) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m in (0xDA, 0xD9):
            return 0
        length = (data[i + 2] << 8) | data[i + 3]
        if m == 0xE1:
            return tiff_orientation(data[i + 4 + 6:i + 2 + length]) if length > 8 else 0
        if length < 2:
            return 0
        i += 2 + length
    return 0


def apply_orientation(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """cv2's ApplyExifOrientation on (..., H, W, C) images (a batch too)."""
    h, w = img.dim() - 3, img.dim() - 2
    if 5 <= orientation <= 8:
        img = img.transpose(h, w)
    flips = {2: (w,), 3: (h, w), 4: (h,), 6: (w,), 7: (h, w), 8: (h,)}.get(orientation)
    return img.flip(flips) if flips else img.contiguous()
