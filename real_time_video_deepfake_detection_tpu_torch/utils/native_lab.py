"""ctypes bindings of csrc/lab_host.cpp: the `native` rung of the host-side
face-quality CLAHE, named as in the JAX package
(real_time_video_deepfake_detection_tpu/utils/native_ingest.py).

Built with g++ and the JAX package's flags at first use (utils/host_build);
a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .host_build import build_host_library, csrc

SRC = csrc("lab_host.cpp")
# the JAX package's flags; -ffp-contract=off keeps FMA contraction from
# moving the float formulas by one rounding
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The loaded Lab library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "lab_host"))
            for fn in (lib.lab_bgr2lab, lib.lab_lab2bgr):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
                fn.restype = None
            _lib = lib
        return _lib


def _convert(fn, src: np.ndarray) -> np.ndarray:
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.shape[-1:] != (3,):
        raise ValueError(f"expected (..., 3) u8 pixels, got shape {src.shape}")
    out = np.empty_like(src)
    fn(src.ctypes.data, src.size // 3, out.ctypes.data)
    return out


def bgr2lab_native(bgr: np.ndarray) -> np.ndarray:
    """(..., 3) u8 BGR -> (..., 3) u8 Lab, the JAX package's native rung."""
    return _convert(library().lab_bgr2lab, bgr)


def lab2bgr_native(lab: np.ndarray) -> np.ndarray:
    """(..., 3) u8 Lab -> (..., 3) u8 BGR, the JAX package's native rung."""
    return _convert(library().lab_lab2bgr, lab)
