"""Motion-JPEG frames on the host as cv2.VideoCapture's default (FFmpeg)
backend decodes them, without cv2 or FFmpeg: libavcodec's mjpeg decoder
(its DC level shift, its 16-bit dequantisation, its x86-64 simple_idct8)
and libswscale's conversion to BGR24, in csrc/mjpeg.cpp (which #includes
csrc/jpeg_entropy.cpp for the coefficients, csrc/simple_idct.cpp and
csrc/yuv2bgr.cpp). Bound with ctypes, which drops the GIL for each call;
built with g++ at first use into `<repo>/.build/mjpeg_<hash>/`
(utils/host_build; a failed build raises).

`Decoder` holds one stream's state, as libavcodec's decoder context does:
the Huffman and quantisation tables a frame defines stay in force for the
frames after it that define none, and before any DHT the JPEG Annex K
tables are in force (camera Motion-JPEG carries no DHT). It has the
interface utils/video._Mp4Track drives (decode, drain, flush, peek, take):
each frame is a picture at once. Gray, 4:4:4, 4:2:2, 4:2:0, 4:1:1 and
4:4:0 frames are decoded, at any size (the odd heights and 4:1:1 / 4:4:0
through libswscale's scaled path). Refused, naming what: arithmetic coding
(libavcodec refuses it too), lossless frames, precisions other than 8 bits,
RGB, CMYK and YCCK frames, other sampling factors. A frame whose data ends
early or is corrupt raises as damaged (libavcodec conceals it).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc
from .jpeg_encode import standard_dht

SRC = csrc("mjpeg.cpp")
INCLUDES = (csrc("jpeg_entropy.cpp"), csrc("simple_idct.cpp"), csrc("yuv2bgr.cpp"))
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
PROBE_LEN = 13   # mjpeg::kProbeLen
FORMATS = ("gray", "yuvj420p", "yuvj422p", "yuvj444p", "yuvj411p", "yuvj440p")   # mjpeg::Format
SUBSAMPLING = {"gray": (0, 0), "yuvj420p": (1, 1), "yuvj422p": (1, 0), "yuvj444p": (0, 0),
               "yuvj411p": (2, 0), "yuvj440p": (0, 1)}   # (across, down), log2
TRUNCATED, CORRUPT = -2, -3
REFUSALS = {-20: "arithmetic-coded frame (libavcodec's mjpeg decoder refuses it too)",
            -21: "lossless (SOF3) frame", -22: "a precision other than 8 bits",
            -23: "a frame that is not gray or YCbCr (RGB, CMYK, YCCK)",
            -24: "sampling", -4: "an unsupported frame type", -5: "a frame over 2^25 pixels",
            -1: "not a JPEG frame"}

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p


class MjpegError(ValueError):
    """A frame the decoder refuses or a damaged one, with the reason;
    `unsupported` tells the two apart."""

    def __init__(self, reason: str, unsupported: bool):
        super().__init__(reason)
        self.unsupported = unsupported


def library() -> ctypes.CDLL:
    """The loaded decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "mjpeg", INCLUDES))
            lib.mjpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _P]
            lib.mjpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _P, _P, _P, _P]
            lib.yuv_nearest_to_bgr.argtypes = [_P, ctypes.c_int, _P, _P] + [ctypes.c_int] * 3 + [
                _P] + [ctypes.c_int] * 4
            lib.yuv_nearest_to_bgr.restype = None
            lib.yuv444_to_bgr.argtypes = [_P, ctypes.c_int, _P, _P] + [ctypes.c_int] * 3 + [
                _P] + [ctypes.c_int] * 3
            lib.yuv444_to_bgr.restype = None
            lib.yuv_scaled_to_bgr.argtypes = [_P, ctypes.c_int, _P, _P] + [ctypes.c_int] * 5 + [
                _P] + [ctypes.c_int] * 3
            lib.yuv_scaled_to_bgr.restype = None
            _lib = lib
        return _lib


def _sampling(out: np.ndarray) -> str:
    hv = tuple((int(out[4 + 2 * c]), int(out[5 + 2 * c])) for c in range(3))
    return "sampling " + " ".join(f"{h}x{v}" for h, v in hv)


def _reason(status: int, out: np.ndarray) -> Tuple[str, bool]:
    """(reason, unsupported) of a negative status."""
    if status == TRUNCATED:
        return "its data ends early", False
    if status == CORRUPT:
        return "corrupt entropy-coded data or headers", False
    if status == -24:
        return f"{_sampling(out)} chroma is not decoded", True
    return REFUSALS.get(status, f"status {status}"), status != -1


def probe(jpeg: bytes) -> Tuple[int, np.ndarray]:
    """(status, the PROBE_LEN header fields) of one frame."""
    out = np.zeros(PROBE_LEN, np.int32)
    return library().mjpeg_probe(jpeg, len(jpeg), out.ctypes.data), out


def _segments(jpeg: bytes):
    """(marker, payload start, payload end) of the segments before the
    first SOS."""
    i = 2
    while i + 4 <= len(jpeg) and jpeg[i] == 0xFF:
        m = jpeg[i + 1]
        if m == 0xFF:
            i += 1
            continue
        if m == 0xDA or 0xD0 <= m <= 0xD9:
            return
        n = struct.unpack_from(">H", jpeg, i + 2)[0]
        yield m, i + 4, min(i + 2 + n, len(jpeg))
        i += 2 + n


def _split_tables(marker: int, body: bytes) -> List[Tuple[Tuple[int, int], bytes]]:
    """The tables of one DHT or DQT payload, keyed (class, id) / (0, id)."""
    out, i = [], 0
    while i < len(body):
        t = body[i]
        if marker == 0xC4:
            if i + 17 > len(body):
                break
            n = 17 + sum(body[i + 1:i + 17])
            out.append(((t >> 4, t & 15), body[i:i + n]))
        else:
            n = 1 + (128 if t >> 4 else 64)
            out.append(((0, t & 15), body[i:i + n]))
        i += n
    return out


def _segment(marker: int, tables) -> bytes:
    body = b"".join(tables)
    return bytes((0xFF, marker)) + struct.pack(">H", len(body) + 2) + body


class Picture:
    """A decoded frame waiting in the decoder."""

    def __init__(self, pts: int, frame: np.ndarray, planes: List[np.ndarray], fmt: str):
        self.pts, self.frame, self.planes, self.format = pts, frame, planes, fmt


_STANDARD: Dict[int, Dict[Tuple[int, int], bytes]] = {}


def _standard_tables() -> Dict[Tuple[int, int], bytes]:
    if not _STANDARD:
        dht = standard_dht()
        for m, a, b in _segments(b"\xff\xd8" + dht + b"\xff\xda"):
            _STANDARD.update(_split_tables(m, dht[a - 2:b - 2]))
    return _STANDARD


def decode_frame(jpeg: bytes) -> Tuple[np.ndarray, List[np.ndarray], str]:
    """One frame alone (the Annex K tables where it has no DHT): its BGR
    pixels, its planes and its pixel format; raises MjpegError."""
    return Decoder()._decode(jpeg)


class Decoder:
    """One Motion-JPEG stream (see the module's docstring)."""

    def __init__(self):
        self._lib = library()
        self._dht: Dict[Tuple[int, int], bytes] = dict(_standard_tables())
        self._dqt: Dict[Tuple[int, int], bytes] = {}
        self._ready: deque = deque()
        self._refused = ""

    def unsupported(self) -> str:
        """What the last frame refused, or ""."""
        return self._refused

    def _with_tables(self, jpeg: bytes) -> bytes:
        """The frame with the stream's tables in force put after its SOI
        (its own tables come later and win), the tables it defines kept."""
        for m, a, b in _segments(jpeg):
            if m in (0xC4, 0xDB):
                (self._dht if m == 0xC4 else self._dqt).update(_split_tables(m, jpeg[a:b]))
        head = _segment(0xC4, self._dht.values())
        if self._dqt:
            head += _segment(0xDB, self._dqt.values())
        return jpeg[:2] + head + jpeg[2:]

    def _decode(self, jpeg: bytes) -> Tuple[np.ndarray, List[np.ndarray], str]:
        if jpeg[:2] != b"\xff\xd8":
            raise MjpegError("a chunk that is not a JPEG frame", False)
        data = self._with_tables(bytes(jpeg))
        status, out = probe(data)
        if status == 0:
            h, w, fmt = int(out[0]), int(out[1]), int(out[2])
            sx, sy = SUBSAMPLING[FORMATS[fmt]]
            planes = [np.empty((h, w), np.uint8)]
            if fmt:
                planes += [np.empty((-(-h >> sy), -(-w >> sx)), np.uint8) for _ in range(2)]
            frame = np.empty((h, w, 3), np.uint8)
            ptr = [p.ctypes.data for p in planes] + [None] * (3 - len(planes))
            status = self._lib.mjpeg_decode(data, len(data), *ptr, frame.ctypes.data)
            if status == 0:
                return frame, planes, FORMATS[fmt]
        reason, unsupported = _reason(status, out)
        if unsupported:
            self._refused = reason
        raise MjpegError(reason, unsupported)

    def decode(self, sample: bytes, pts: int, discard: bool = False) -> int:
        """Decode one frame (a picture at once); raises MjpegError."""
        frame, planes, fmt = self._decode(sample)
        if not discard:
            self._ready.append(Picture(int(pts), frame, planes, fmt))
        return len(self._ready)

    def drain(self) -> int:
        return len(self._ready)

    def flush(self) -> None:
        """Drop the frames not taken (a seek); the tables stay, as
        avcodec_flush_buffers leaves them."""
        self._ready.clear()

    def peek(self) -> Optional[Picture]:
        return self._ready[0] if self._ready else None

    def take(self, bgr: bool = True, planes: bool = False
             ) -> Tuple[Optional[np.ndarray], Optional[List[np.ndarray]]]:
        """Pop the next frame: (its BGR pixels or None, its planes or None)."""
        if not self._ready:
            raise MjpegError("no picture is ready", False)
        pic = self._ready.popleft()
        return (pic.frame if bgr else None), (pic.planes if planes else None)


def yuv_to_bgr(planes: List[np.ndarray], fmt: str, matrix: int = 5, full_range: int = 1
               ) -> np.ndarray:
    """csrc/yuv2bgr.cpp's conversion of `fmt` (FORMATS) planes, as the
    decoder converts them: (H, W, 3) u8 BGR."""
    lib = library()
    y = np.ascontiguousarray(planes[0], np.uint8)
    h, w = y.shape
    out = np.empty((h, w, 3), np.uint8)
    if fmt == "gray":
        lib.yuv444_to_bgr(y.ctypes.data, w, None, None, 0, w, h, out.ctypes.data, 3 * w,
                          matrix, full_range)
        return out
    u, v = (np.ascontiguousarray(p, np.uint8) for p in planes[1:3])
    if fmt == "yuvj444p":
        lib.yuv444_to_bgr(y.ctypes.data, w, u.ctypes.data, v.ctypes.data, u.shape[1], w, h,
                          out.ctypes.data, 3 * w, matrix, full_range)
    elif fmt in ("yuvj420p", "yuvj422p") and h % 2 == 0:
        lib.yuv_nearest_to_bgr(y.ctypes.data, w, u.ctypes.data, v.ctypes.data, u.shape[1], w, h,
                               out.ctypes.data, 3 * w, matrix, full_range,
                               int(fmt == "yuvj420p"))
    else:
        sx, sy = SUBSAMPLING[fmt]
        lib.yuv_scaled_to_bgr(y.ctypes.data, w, u.ctypes.data, v.ctypes.data, u.shape[1], w, h,
                              sx, sy, out.ctypes.data, 3 * w, matrix, full_range)
    return out
