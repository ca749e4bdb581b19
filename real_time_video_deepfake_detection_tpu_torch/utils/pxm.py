"""PBM, PGM, PPM (P1-P6), PAM (P7) and PFM (PF, Pf) decode as cv2 5.0's
imdecode(..., IMREAD_COLOR) returns them, without cv2 (its grfmt_pxm.cpp,
grfmt_pam.cpp and grfmt_pfm.cpp, as they behave on the installed build).

P1-P6: the header's numbers (width, height and, but in P1 / P4, maxval
1-65535) are read as cv2's ReadNumber reads them (whitespace and '#'
comments before a number; the byte that ends it is consumed, so a comment
glued to a number fails), the ASCII samples too (csrc/image_host.cpp).
ASCII samples over maxval are clipped to it, and 8-bit ones rescaled to
i * 255 / maxval; binary 8-bit samples are kept as they are. 16-bit
samples (maxval over 255) keep their high byte, whatever the maxval. P1's
and P4's 1 is black. Gray goes to three channels, P3 / P6 from RGB to BGR.

P7: the header's lines (WIDTH, HEIGHT, DEPTH, MAXVAL, each once, then
ENDHDR; TUPLTYPE BLACKANDWHITE, GRAYSCALE or RGB, or none for a DEPTH of 1
or 3 under a MAXVAL up to 255). Samples are one byte to MAXVAL 255, two
(big-endian, the high byte kept) above; MAXVAL 1 reads each row's bytes as
packed bits, 1 white. RGB tuples are kept in their order (cv2 does not
swap them). The alpha tuple types are refused: cv2 5.0 converts only the
first pixel of each of their rows and leaves the rest of the row as the
allocator gave it.

PF / Pf: "PF" or "Pf", a line feed, then width, height and scale, each
ended by one whitespace byte; float32 rows bottom to top, little-endian
when the scale is negative. Samples are multiplied by 1 / |scale| in
float32 and rounded to the nearest even integer, a value outside int32 or
NaN giving 0, saturated to 0-255; PF's RGB goes to BGR. Pf comes out
(H, W), one channel, as cv2 returns it.

A short or malformed file gives None, as cv2 returns None (or raises, for a
zero size).
"""

from __future__ import annotations

import ctypes
import re
from typing import Optional, Tuple

import numpy as np

from . import png

MAX_PIXELS = 1 << 30   # cv2's CV_IO_MAX_IMAGE_PIXELS
MAX_SIDE = 1 << 20     # CV_IO_MAX_IMAGE_WIDTH / HEIGHT
_SPACE = b" \t\n\v\f\r"


def _lib():
    lib = png.library()
    if not getattr(lib, "_pxm_bound", False):
        lib.pxm_numbers.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
        lib.pxm_numbers.restype = ctypes.c_int64
        lib._pxm_bound = True
    return lib


def _numbers(data: bytes, pos: int, count: int, maxdigits: int = 0
             ) -> Tuple[int, Optional[np.ndarray]]:
    if count > len(data) - pos:   # each number takes a byte at least
        return -1, None
    out = np.empty(max(count, 1), np.int32)
    pos = _lib().pxm_numbers(data, len(data), pos, count, maxdigits, out.ctypes.data)
    return pos, (out[:count] if pos >= 0 else None)


def _size_ok(w: int, h: int) -> bool:
    return 0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS


def is_pxm(data: bytes) -> bool:
    """cv2's PxM signature: P, a digit 1-6, whitespace."""
    return len(data) >= 3 and data[0] == ord("P") and data[1] in b"123456" and \
        data[2] in _SPACE


def is_pam(data: bytes) -> bool:
    return data[:2] == b"P7" and len(data) >= 3 and data[2] in _SPACE


def is_pfm(data: bytes) -> bool:
    return len(data) >= 3 and data[:2] in (b"PF", b"Pf") and data[2] in _SPACE


def decode_pxm(data: bytes) -> Optional[np.ndarray]:
    """P1-P6 bytes -> (H, W, 3) u8 BGR, or None."""
    kind = data[1] - ord("0")
    bpp = {1: 1, 4: 1, 2: 8, 5: 8, 3: 24, 6: 24}[kind]
    binary = kind >= 4
    pos, head = _numbers(data, 2, 2)
    if head is None:
        return None
    w, h = int(head[0]), int(head[1])
    maxval = 1
    if bpp != 1:
        pos, mv = _numbers(data, pos, 1)
        if mv is None:
            return None
        maxval = int(mv[0])
    if not (0 < maxval < 65536) or not _size_ok(w, h):
        return None
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            rows = np.frombuffer(data, np.uint8, h * pitch, pos) if len(data) - pos >= h * pitch \
                else None
            if rows is None:
                return None
            bits = np.unpackbits(rows.reshape(h, pitch), axis=1)[:, :w]
        else:
            pos, bits = _numbers(data, pos, w * h, 1)
            if bits is None:
                return None
            bits = (bits.reshape(h, w) != 0).astype(np.uint8)
        gray = np.where(bits != 0, 0, 255).astype(np.uint8)
        return np.repeat(gray[..., None], 3, 2)
    n = w * h * nch
    wide = maxval > 255
    if binary:
        size = n * (2 if wide else 1)
        if len(data) - pos < size:
            return None
        raw = np.frombuffer(data, np.uint8, size, pos)
        samples = raw[0::2] if wide else raw
    else:
        pos, vals = _numbers(data, pos, n)
        if vals is None:
            return None
        vals = np.minimum(vals.astype(np.int64), maxval)
        samples = (vals >> 8) if wide else vals * 255 // maxval
        samples = samples.astype(np.uint8)
    img = samples.reshape(h, w, nch)
    if nch == 1:
        return np.repeat(img, 3, 2)
    return np.ascontiguousarray(img[..., ::-1])


_PAM_FIELDS = (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL", b"TUPLTYPE", b"ENDHDR")
_PAM_TUPLES = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"RGB": 3}
_PAM_ALPHA = (b"GRAYSCALE_ALPHA", b"RGB_ALPHA")


def _pam_header(data: bytes):
    """(fields, position of the data) or None."""
    pos, fields = 3, {}
    while True:
        while pos < len(data) and data[pos] in _SPACE:
            pos += 1
        if pos >= len(data):
            return None
        if data[pos] == ord("#"):
            while pos < len(data) and data[pos] not in b"\n\r":
                pos += 1
            pos += 1
            continue
        end = pos
        while end < len(data) and data[end] not in _SPACE:
            end += 1
        ident = data[pos:end]
        if ident not in _PAM_FIELDS or ident in fields or end >= len(data):
            return None
        if ident == b"ENDHDR":
            return fields, end + 1
        pos = end
        while pos < len(data) and data[pos] in b" \t\v\f":
            pos += 1
        end = pos
        while end < len(data) and data[end] not in b"\n\r":
            end += 1
        fields[ident] = data[pos:end].strip(_SPACE)
        pos = end


def decode_pam(data: bytes) -> Optional[np.ndarray]:
    """P7 bytes -> (H, W, 3) u8, or None."""
    if data[2:3] not in (b"\n", b"\r"):
        return None
    parsed = _pam_header(data)
    if parsed is None:
        return None
    fields, pos = parsed
    try:
        w, h, depth, maxval = (int(fields[k]) for k in (b"WIDTH", b"HEIGHT", b"DEPTH",
                                                        b"MAXVAL"))
    except (KeyError, ValueError):
        return None
    if not all(re.fullmatch(rb"\d+", fields[k]) for k in (b"WIDTH", b"HEIGHT", b"DEPTH",
                                                          b"MAXVAL")):
        return None
    tupl = fields.get(b"TUPLTYPE")
    if tupl is None:
        if depth not in (1, 3) or maxval > 255:
            return None
    elif tupl in _PAM_ALPHA or _PAM_TUPLES.get(tupl) != depth:
        return None
    if maxval > 65535 or not _size_ok(w, h):
        return None
    wide = maxval > 255
    row = w * depth * (2 if wide else 1)
    if len(data) - pos < row * h:
        return None
    raw = np.frombuffer(data, np.uint8, row * h, pos).reshape(h, row)
    if maxval == 1:
        gray = np.unpackbits(raw, axis=1)[:, :w] * np.uint8(255)
        return np.repeat(gray[..., None], 3, 2)
    samples = raw[:, 0::2] if wide else raw
    img = samples.reshape(h, w, depth)
    return np.repeat(img, 3, 2) if depth == 1 else img.copy()   # writable, as cv2's


_INT = re.compile(rb"[+-]?\d+")
_FLOAT = re.compile(rb"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?")


def _token(data: bytes, pos: int) -> Tuple[int, bytes]:
    """The bytes up to the next whitespace byte (consumed); pos -1 at the
    end of the data or for a byte over 127 in them."""
    end = pos
    while end < len(data) and data[end] not in _SPACE:
        end += 1
    if end >= len(data) or max(data[pos:end], default=0) >= 0x80:   # cv2 refuses those
        return -1, b""
    return end + 1, data[pos:end]


def _prefix(pattern, text: bytes, kind):
    m = pattern.match(text)
    return kind(m.group(0)) if m else kind(0)


def decode_pfm(data: bytes) -> Optional[np.ndarray]:
    """PF / Pf bytes -> (H, W, 3) u8 BGR (PF) or (H, W) u8 (Pf), or None."""
    if data[2:3] != b"\n":
        return None
    pos, tokens = 3, []
    for _ in range(3):
        pos, tok = _token(data, pos)
        if pos < 0:
            return None
        tokens.append(tok)
    w, h = _prefix(_INT, tokens[0], int), _prefix(_INT, tokens[1], int)
    scale = _prefix(_FLOAT, tokens[2], float)
    if scale == 0 or not _size_ok(w, h):
        return None
    nch = 3 if data[1:2] == b"F" else 1
    n = w * h * nch
    if len(data) - pos < 4 * n:
        return None
    img = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, pos).astype(np.float32)
    img = img.reshape(h, w, nch)[::-1]
    img = img * np.float32(np.float32(1) / np.float32(abs(scale)))
    r = np.rint(img)
    bad = ~(np.abs(r) < np.float32(2 ** 31))   # cvRound's INT_MIN: NaN and out of range
    out = np.where(bad, 0, np.clip(r, 0, 255)).astype(np.uint8)
    if nch == 1:
        return np.ascontiguousarray(out[..., 0])
    return np.ascontiguousarray(out[..., ::-1])


def decode(data: bytes) -> Optional[np.ndarray]:
    """Any of the three families by its signature, or None."""
    if is_pxm(data):
        return decode_pxm(data)
    if is_pam(data):
        return decode_pam(data)
    if is_pfm(data):
        return decode_pfm(data)
    return None
