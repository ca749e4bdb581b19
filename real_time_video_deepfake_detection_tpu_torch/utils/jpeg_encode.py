"""JPEG encode without cv2 or libjpeg: what cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q]) writes, byte for byte (csrc/jpeg_encode.cpp,
bound with ctypes; built with g++ at first use into
`<repo>/.build/jpeg_encode_<hash>/`, utils/host_build; a failed build
raises).

The JAX package writes its face crops with cv2.imwrite at quality 95
(data_tools/face_extract.py); the port writes them, and the frames of
`cli/analyze.py --output`, with `encode_jpeg`.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .host_build import build_host_library, csrc

SRC = csrc("jpeg_encode.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p


def library() -> ctypes.CDLL:
    """The loaded encoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "jpeg_encode"))
            lib.jpeg_encode_bgr.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                            ctypes.c_int, _P, ctypes.c_int64]
            lib.jpeg_encode_bgr.restype = ctypes.c_int64
            lib.jpeg_std_dht.argtypes = [_P, ctypes.c_int64]
            lib.jpeg_std_dht.restype = ctypes.c_int64
            _lib = lib
        return _lib


def encode_jpeg(bgr_u8: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) u8 BGR -> baseline JFIF bytes, 4:2:0, islow DCT, standard
    Huffman tables: cv2.imencode's stream with its defaults."""
    img = np.asarray(bgr_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) u8 BGR image, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h <= 65535 and 0 < w <= 65535):
        raise ValueError(f"a JPEG frame is 1..65535 pixels a side, got {(h, w)}")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be 1..100, got {quality}")
    if img.strides[1:] != (3, 1):
        img = np.ascontiguousarray(img)
    cap = 4096 + (h + 16) * (w + 16) * 2
    while True:
        out = np.empty(cap, np.uint8)
        n = library().jpeg_encode_bgr(img.ctypes.data, h, w, img.strides[0], int(quality),
                                      out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes()
        cap = -n


def standard_dht() -> bytes:
    """The four DHT segments of JPEG Annex K's tables (DC and AC, luma and
    chroma), which libjpeg's decoder uses when a stream defines none."""
    out = np.empty(1024, np.uint8)
    n = library().jpeg_std_dht(out.ctypes.data, out.size)
    return out[:n].tobytes()
