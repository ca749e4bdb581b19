"""ctypes binding of csrc/prep_host.cpp: the per-request host prep of
host-prep serving (decode, analysis resize, heuristic face detection, Lab +
CLAHE, align resize) in one call that releases the GIL, the port's
counterpart of the JAX package's utils/native_ingest.prep_frame.

Built with g++ and the JAX package's flags at first use (utils/host_build);
a failed build raises. There is no fallback below it: where the JAX package
finds no library it decodes and prepares in Python, the port does not.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc
from .jpeg_ingest import JpegError, log_refusal

SRC = csrc("prep_host.cpp")
INCLUDES = (csrc("jpeg_entropy.cpp"), csrc("lab_host.cpp"))
# the JAX package's flags (its native/ingest.cpp): -ffp-contract=off keeps
# FMA contraction from moving the float steps by one rounding
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

Box = Tuple[int, int, int, int]


def library() -> ctypes.CDLL:
    """The loaded prep library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "prep_host", INCLUDES))
            lib.prep_frame.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p]
            lib.prep_frame.restype = ctypes.c_int
            _lib = lib
        return _lib


def prep_frame(data: bytes, analysis_hw: Tuple[int, int] = (256, 256), align: int = 160
               ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray], Optional[Box]]]:
    """JPEG bytes -> (analysis frame (ah, aw, 3) u8 BGR, aligned face
    (align, align, 3) u8 RGB or None, box (x, y, w, h) on the decoded frame
    or None); None (the reason logged once) when the decoder refuses the
    stream."""
    ah, aw = (int(v) for v in analysis_hw)
    if min(ah, aw, align) <= 0:
        raise ValueError(f"sizes must be positive, got analysis {analysis_hw}, align {align}")
    frame = np.empty((ah, aw, 3), np.uint8)
    aligned = np.empty((align, align, 3), np.uint8)
    box = np.zeros(4, np.int32)
    rc = library().prep_frame(data, len(data), frame.ctypes.data, ah, aw, aligned.ctypes.data,
                              align, box.ctypes.data)
    if rc < 0:
        log_refusal(str(JpegError(rc)))
        return None
    if rc == 0:
        return frame, None, None
    return frame, aligned, tuple(int(v) for v in box)
