"""H.264 Constrained Baseline, Main and High decode on the host, without
cv2 or FFmpeg: the frames cv2.VideoCapture's FFmpeg backend decodes from an
mp4's H.264 track, picture for picture (csrc/h264.cpp), converted to BGR as
cv2 5.0's bundled libswscale converts them (csrc/yuv2bgr.cpp). Bound with ctypes,
which drops the GIL for each call; built with g++ at first use into
`<repo>/.build/h264_<hash>/` (utils/host_build; a failed build raises, and
there is no Python decoder below it).

`Decoder` holds one stream's state: feed it the avcC's parameter sets,
then the samples in decode order; pictures come out in FFmpeg's order. It
refuses FMO, field and MBAFF coding, 4:0:0 / 4:2:2 / 4:4:4, high bit depth,
transform bypass, SP / SI slices and redundant pictures with a reason
naming the profile and the feature, and stops at a damaged slice with a
reason that says where (FFmpeg would conceal it). utils/video.VideoReader drives it
as cv2's FFmpeg backend drives libavcodec.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterable, List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

SRC = csrc("h264.cpp")
INCLUDES = (csrc("yuv2bgr.cpp"),)
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)


class H264Error(ValueError):
    """A stream the decoder refuses or a damaged slice, with the reason."""


def library() -> ctypes.CDLL:
    """The loaded decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "h264", INCLUDES))
            lib.h264_new.argtypes = [ctypes.c_int]
            lib.h264_new.restype = _P
            lib.h264_free.argtypes = [_P]
            lib.h264_parameter_set.argtypes = [_P, _P, _I64]
            lib.h264_check.argtypes = [_P]
            lib.h264_check.restype = ctypes.c_char_p
            lib.h264_decode.argtypes = [_P, _P, _I64, _I64, ctypes.c_int]
            lib.h264_drain.argtypes = [_P]
            lib.h264_flush.argtypes = [_P]
            lib.h264_peek.argtypes = [_P, _IP, _IP, ctypes.POINTER(_I64), _IP, _IP]
            lib.h264_take.argtypes = [_P, _P, _P, _P, _P]
            lib.h264_error.argtypes = [_P]
            lib.h264_error.restype = ctypes.c_char_p
            lib.yuv420_to_bgr.argtypes = [_P, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
                                          ctypes.c_int]
            lib.yuv420_to_bgr.restype = None
            _lib = lib
        return _lib


def yuv420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray, matrix: int = 2,
                  full_range: int = 0) -> np.ndarray:
    """(H, W) Y and ((H+1)//2, (W+1)//2) U, V u8 planes -> (H, W, 3) u8 BGR,
    as cv2's libswscale converts a frame with VUI matrix_coefficients
    `matrix` (2: unspecified, BT.601) and video_full_range_flag
    `full_range`."""
    y, u, v = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
    h, w = y.shape
    if u.shape != v.shape or u.shape != ((h + 1) // 2, (w + 1) // 2):
        raise ValueError(f"chroma planes {u.shape}, {v.shape} do not fit a {y.shape} luma plane")
    out = np.empty((h, w, 3), np.uint8)
    library().yuv420_to_bgr(y.ctypes.data, w, u.ctypes.data, v.ctypes.data, u.shape[1], w, h,
                            out.ctypes.data, 3 * w, int(matrix), int(full_range))
    return out


def parameter_sets(sample: bytes, nal_length_size: int) -> List[bytes]:
    """The SPS and PPS NAL units inside a sample of length-prefixed NAL
    units (an avc3 track's parameter sets), in order."""
    out, pos = [], 0
    while pos + nal_length_size <= len(sample):
        n = int.from_bytes(sample[pos:pos + nal_length_size], "big")
        nal = sample[pos + nal_length_size:pos + nal_length_size + n]
        pos += nal_length_size + n
        if nal and nal[0] & 31 in (7, 8):
            out.append(nal)
    return out


class Picture:
    """A decoded picture waiting in the decoder: its pts and size; `take`
    gives its pixels."""

    def __init__(self, pts: int, width: int, height: int, matrix: int, full_range: int):
        self.pts, self.width, self.height = pts, width, height
        self.matrix, self.full_range = matrix, full_range


class Decoder:
    """One H.264 stream: samples of `nal_length_size`-byte length-prefixed
    NAL units after the parameter sets (SPS and PPS NAL units)."""

    def __init__(self, nal_length_size: int, parameter_sets: Iterable[bytes] = ()):
        self._lib = library()
        self._h = self._lib.h264_new(int(nal_length_size))
        for nal in parameter_sets:
            if self._lib.h264_parameter_set(self._h, nal, len(nal)) < 0:
                raise H264Error(self.error)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.h264_free(h)

    @property
    def error(self) -> str:
        return self._lib.h264_error(self._h).decode()

    def unsupported(self) -> str:
        """The profile and feature of the parameter sets seen so far that
        the decoder refuses, or ""."""
        return self._lib.h264_check(self._h).decode()

    def decode(self, sample: bytes, pts: int, discard: bool = False) -> int:
        """Decode one sample; a discarded one is decoded as a reference and
        its picture never output. Returns the pictures ready."""
        n = self._lib.h264_decode(self._h, sample, len(sample), int(pts), int(bool(discard)))
        if n < 0:
            raise H264Error(self.error)
        return n

    def drain(self) -> int:
        """The end of the stream: every picture held back becomes ready."""
        n = self._lib.h264_drain(self._h)
        if n < 0:
            raise H264Error(self.error)
        return n

    def flush(self) -> None:
        """Drop every picture and reference (a seek)."""
        self._lib.h264_flush(self._h)

    def peek(self) -> Optional[Picture]:
        """The next ready picture, or None."""
        w, h, m, f, pts = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), _I64()
        if not self._lib.h264_peek(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(pts),
                                   ctypes.byref(m), ctypes.byref(f)):
            return None
        return Picture(pts.value, w.value, h.value, m.value, f.value)

    def take(self, bgr: bool = True, planes: bool = False
             ) -> Tuple[Optional[np.ndarray], Optional[List[np.ndarray]]]:
        """Pop the next ready picture: (its BGR frame or None, its [Y, U, V]
        planes or None)."""
        pic = self.peek()
        if pic is None:
            raise H264Error("no picture is ready")
        w, h = pic.width, pic.height
        out = np.empty((h, w, 3), np.uint8) if bgr else None
        yuv = ([np.empty((h, w), np.uint8), np.empty((h // 2, w // 2), np.uint8),
                np.empty((h // 2, w // 2), np.uint8)] if planes else None)
        ptr = [p.ctypes.data if p is not None else None
               for p in (yuv if yuv else [None] * 3) + [out]]
        self._lib.h264_take(self._h, *ptr)
        return out, yuv
