"""PNG decode as cv2.imdecode(..., IMREAD_COLOR) returns it, without cv2.

The chunks are parsed and checked here, the IDAT data is inflated with
Python's zlib only as far as the header's rows reach (libpng ignores what
follows them, and a stream that inflates past them costs no memory), and
the row filters and Adam7 interlacing are undone in C++ (csrc/image_host.cpp,
bound with ctypes and built with g++ at first use by utils/host_build). The conversion follows cv2's libpng settings: 16-bit
samples keep their high byte (png_set_strip_16), 1-, 2- and 4-bit gray is
scaled to 8 bits, a palette is expanded (an index past its end reads as
black, as libpng's zeroed palette gives), gray goes to three channels,
alpha and tRNS are dropped, and no gamma is applied. A CRC error in a
critical chunk, a missing or short IDAT stream, an unknown critical chunk
or a bad header refuses the image (None), as libpng's errors make cv2
return None; an ancillary chunk with a bad CRC is ignored, as libpng
ignores it. The eXIf chunk before the image data gives the EXIF
orientation (utils/exif).
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SRC = csrc("image_host.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
MAX_PIXELS = 1 << 30   # cv2's CV_IO_MAX_IMAGE_PIXELS

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# (x0, y0, dx, dy) of each Adam7 pass, as csrc/image_host.cpp walks them
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded image helper library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "image_host"))
            lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
        return _lib


def _chunks(data: bytes):
    """(type, payload, crc ok) of each chunk, stopping at IEND; raises
    ValueError where the data runs out."""
    at = len(SIGNATURE)
    while True:
        if at + 8 > len(data):
            raise ValueError("PNG ends inside a chunk header")
        length, kind = struct.unpack_from(">I4s", data, at)
        if length > 0x7FFFFFFF or at + 12 + length > len(data):
            raise ValueError("PNG ends inside a chunk")
        payload = data[at + 8:at + 8 + length]
        crc = struct.unpack_from(">I", data, at + 8 + length)[0]
        yield kind, payload, zlib.crc32(kind + payload) == crc
        if kind == b"IEND":
            return
        at += 12 + length


def _inflated_size(w: int, h: int, bits: int, interlace: int) -> int:
    """Bytes of the filtered rows the header implies: a filter byte and
    ceil(width * bits / 8) bytes a row, over Adam7's seven passes when
    interlaced."""
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    total = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-max(w - x0, 0) // dx), -(-max(h - y0, 0) // dy)
        if pw and ph:
            total += ph * ((pw * bits + 7) // 8 + 1)
    return total


def decode_png(data: bytes) -> Optional[Tuple[np.ndarray, bytes]]:
    """PNG bytes -> ((H, W, 3) u8 BGR, the eXIf payload or b""); None when
    cv2 refuses the image."""
    if not data.startswith(SIGNATURE):
        return None
    header = None
    palette, have_palette = np.zeros((256, 3), np.uint8), False
    idat, exif, idat_state = [], b"", 0   # 0 before IDAT, 1 inside the run, 2 after
    try:
        for kind, payload, crc_ok in _chunks(data):
            critical = not (kind[0] & 0x20)
            if not crc_ok:
                if critical:
                    return None
                continue
            if header is None and kind != b"IHDR":
                return None
            if idat_state == 1 and kind != b"IDAT":
                idat_state = 2
            if kind == b"IHDR":
                if header is not None or len(payload) != 13:
                    return None
                header = struct.unpack(">IIBBBBB", payload)
            elif kind == b"PLTE":
                if idat_state or len(payload) % 3 or len(payload) > 768:
                    if header[3] == 3:
                        return None
                    continue
                n = len(payload) // 3
                if header[3] == 3:   # libpng keeps 2^depth entries at most
                    n = min(n, 1 << header[2])
                palette[:n] = np.frombuffer(payload[:3 * n], np.uint8).reshape(n, 3)
                have_palette = True
            elif kind == b"IDAT":
                if idat_state == 0 and header[3] == 3 and not have_palette:
                    return None   # "Missing PLTE before IDAT"
                if idat_state < 2:   # libpng reads the image from the first run
                    idat_state = 1
                    idat.append(payload)
            elif kind == b"eXIf":
                if idat_state == 0 and not exif and len(payload) >= 2:
                    exif = payload
            elif kind == b"IEND":
                break
            elif critical:
                return None   # an unknown critical chunk
    except ValueError:
        return None
    if header is None or not idat:
        return None
    w, h, depth, ctype, compression, filtering, interlace = header
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression or filtering
            or interlace > 1 or w == 0 or h == 0 or w > 0x7FFFFFFF or h > 0x7FFFFFFF
            or w * h > MAX_PIXELS):
        return None
    channels = _CHANNELS[ctype]
    need = _inflated_size(w, h, depth * channels, interlace)
    try:   # no more than the rows hold: libpng ignores what follows them
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error:
        return None
    if len(raw) < need:
        return None
    samples = np.empty((h, w, channels), np.uint8)
    rc = library().png_unfilter(raw, len(raw), w, h, depth, channels, interlace,
                                samples.ctypes.data)
    if rc != 0:
        return None
    if ctype == 3:
        return np.ascontiguousarray(palette[samples[..., 0]][..., ::-1]), exif
    if ctype in (0, 4):
        g = samples[..., 0]
        if depth < 8:
            g = g * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(g[..., None], 3, axis=-1), exif
    return np.ascontiguousarray(samples[..., 2::-1]), exif
