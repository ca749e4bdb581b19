"""BMP decode as cv2.imdecode(..., IMREAD_COLOR) returns it, without cv2.

Follows OpenCV's grfmt_bmp.cpp BmpDecoder: BITMAPINFOHEADER and its later
versions (header size >= 36) and the OS/2 header (12); 1-, 4- and 8-bit
palettes (clrused entries, or 2^bpp), 16-bit 5:5:5 and, with bitfields,
5:6:5 (each channel's bits shifted up, not replicated), 24-bit, 32-bit
with the fourth byte dropped (bitfields too, as IMREAD_COLOR drops them);
RLE8 and RLE4, where skipped pixels take palette entry 0; bottom-up and
top-down rows. Every read is bounds checked: a file that ends early, an
RLE run past the end of its row or any other layout cv2 refuses gives
None.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

SIGNATURE = b"BM"
MAX_PIXELS = 1 << 30   # cv2's CV_IO_MAX_IMAGE_PIXELS


class _Short(Exception):
    """The file ended, or an RLE code broke its row."""


class _Reader:
    def __init__(self, data: bytes, at: int = 0):
        self.d, self.at = data, at

    def take(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.d):
            raise _Short()
        out = self.d[self.at:self.at + n]
        self.at += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.take(4))[0]


def _unpack(row: bytes, width: int, bpp: int) -> np.ndarray:
    """Palette indices of a row of 1-, 4- or 8-bit pixels, high bits first."""
    a = np.frombuffer(row, np.uint8)
    if bpp == 8:
        return a[:width]
    bits = np.unpackbits(a)
    if bpp == 4:
        bits = bits.reshape(-1, 4) @ np.array([8, 4, 2, 1], np.uint8)
    return bits[:width]


class _Rle:
    """cv2's RLE writer: a cursor over the rows in file order that
    FillUniColor advances across row ends."""

    def __init__(self, width: int, height: int, background: np.ndarray):
        self.w, self.h = width, height
        self.img = np.empty((height, width, 3), np.uint8)
        self.img[:] = background
        self.x = self.y = 0

    def fill(self, count: int, color) -> None:
        while True:
            n = min(count, self.w - self.x)
            if n > 0 and self.y < self.h:
                self.img[self.y, self.x:self.x + n] = color
            self.x += n
            count -= n
            if self.x >= self.w:
                self.x = 0
                self.y += 1
                if self.y >= self.h:
                    return
            if count <= 0:
                return

    def row(self, colors: np.ndarray) -> None:
        if self.x + len(colors) > self.w:
            raise _Short()
        self.img[self.y, self.x:self.x + len(colors)] = colors
        self.x += len(colors)


def _rle(r: _Reader, width: int, height: int, palette: np.ndarray, bpp: int) -> np.ndarray:
    """cv2's RLE8 / RLE4 loops, codes read until the last row is done."""
    out = _Rle(width, height, palette[0])
    line_end_flag = 0
    while True:
        n, code = r.u8(), r.u8()
        if n:   # a run of one index (RLE8) or of two alternating nibbles (RLE4)
            if out.x + n > width:
                raise _Short()
            if bpp == 4:
                out.row(palette[np.where(np.arange(n) % 2 == 0, code >> 4, code & 15)])
                continue
            prev = out.y
            out.fill(n, palette[code])
            line_end_flag = out.y - prev
        elif code > 2:   # absolute pixels, padded to a whole word
            if out.x + code > width:
                raise _Short()
            size = (code + 1) & ~1 if bpp == 8 else (((code + 1) >> 1) + 1) & ~1
            out.row(palette[_unpack(r.take(size), code, bpp)])
            line_end_flag = 0
            continue
        else:   # end of line (0), end of bitmap (1), delta (2)
            skip, rows = width - out.x, height - out.y
            if code == 2:
                skip, rows = r.u8(), r.u8()
            if bpp == 4:
                out.fill(skip, palette[0])
            elif code or not line_end_flag or width - out.x < width:
                if code:
                    skip += rows * width
                if out.y >= height:
                    break
                out.fill(skip, palette[0])
            line_end_flag = 0
        if out.y >= height:
            break
    return out.img


def decode_bmp(data: bytes) -> Optional[np.ndarray]:
    """BMP bytes -> (H, W, 3) u8 BGR; None when cv2 refuses the file."""
    if not data.startswith(SIGNATURE):
        return None
    try:
        return _decode(data)
    except _Short:
        return None


def _decode(data: bytes) -> Optional[np.ndarray]:
    r = _Reader(data, 10)
    offset = r.i32()
    size = r.i32()
    if size <= 0:
        return None
    palette = np.zeros((256, 3), np.uint8)
    if size >= 36:
        width, height = r.i32(), r.i32()
        bpp = (r.i32() >> 16) & 0xFFFF
        compression = r.i32()
        if not 0 <= compression <= 3:
            return None
        r.take(12)
        clrused = r.i32()
        r.take(size - 36)
        ok = width > 0 and height != 0 and (
            (bpp in (1, 4, 8, 24, 32) and compression == 0)
            or (bpp in (16, 32) and compression in (0, 3))
            or (bpp == 4 and compression == 2) or (bpp == 8 and compression == 1))
        if not ok:
            return None
        if bpp <= 8:
            if not 0 <= clrused <= 256:
                return None
            n = clrused or 1 << bpp
            palette[:n] = np.frombuffer(r.take(4 * n), np.uint8).reshape(n, 4)[:, :3]
        elif bpp == 16:
            if compression == 3:
                masks = (r.i32(), r.i32(), r.i32())   # red, green, blue
                if masks == (0x7C00, 0x3E0, 0x1F):
                    bpp = 15
                elif masks != (0xF800, 0x7E0, 0x1F):
                    return None
            else:
                bpp = 15
    elif size == 12:
        width, height = r.u16(), r.u16()
        bpp = (r.i32() >> 16) & 0xFFFF
        compression = 0
        if not (width > 0 and height != 0 and bpp in (1, 4, 8, 24, 32)):
            return None
        if bpp <= 8:
            n = 1 << bpp
            palette[:n] = np.frombuffer(r.take(3 * n), np.uint8).reshape(n, 3)
    else:
        return None
    bottom_up = height > 0
    height = abs(height)
    if width * height > MAX_PIXELS:
        return None
    r = _Reader(data, offset)
    if compression in (1, 2):
        img = _rle(r, width, height, palette, bpp)
    else:
        pitch = ((width * (16 if bpp == 15 else bpp) + 7) // 8 + 3) & ~3
        rows = np.frombuffer(r.take(pitch * height), np.uint8).reshape(height, pitch)
        if bpp <= 8:
            img = np.stack([palette[_unpack(row.tobytes(), width, bpp)] for row in rows])
        elif bpp in (15, 16):
            v = rows[:, :2 * width].copy().view("<u2").astype(np.int32)
            if bpp == 15:
                b, g, rr = (v << 3) & 0xF8, (v >> 2) & 0xF8, (v >> 7) & 0xF8
            else:
                b, g, rr = (v << 3) & 0xF8, (v >> 3) & 0xFC, (v >> 8) & 0xF8
            img = np.stack([b, g, rr], axis=-1).astype(np.uint8)
        else:
            step = bpp // 8
            img = rows[:, :step * width].reshape(height, width, step)[..., :3]
    if bottom_up:
        img = img[::-1]
    return np.ascontiguousarray(img)
