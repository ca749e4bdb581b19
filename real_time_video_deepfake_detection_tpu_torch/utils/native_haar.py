"""ctypes bindings of csrc/haar.cpp, the native Haar cascade evaluator: the
port's counterpart of real_time_video_deepfake_detection_tpu/utils/
native_haar.py.

The XML is parsed in Python (models/haar_cascade.py); only the packed
stump arrays cross the boundary. Raw windows come back and are grouped by
the Python group_rectangles, so the native and numpy evaluators return the
same boxes. The library is built with g++ at first use (utils/host_build)
and a failed build raises: unlike the JAX package, nothing drops to the
numpy evaluator.

`calls` counts the calls into haar_detect_raw, as the kernel wrappers count
their launches, so a run can show that the native evaluator ran.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

SRC = csrc("haar.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
ABI_VERSION = 1   # haar_abi_version() in csrc/haar.cpp

calls = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The loaded evaluator (built on first use; raises when it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "haar"))
            lib.haar_abi_version.restype = ctypes.c_int
            if lib.haar_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{SRC} reports ABI {lib.haar_abi_version()}, "
                                   f"the bindings expect {ABI_VERSION}")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.haar_create.restype = ctypes.c_void_p
            lib.haar_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p,
                                        f32p, i32p, f32p, f32p, f32p, f32p]
            lib.haar_destroy.restype = None
            lib.haar_destroy.argtypes = [ctypes.c_void_p]
            lib.haar_detect_raw.restype = ctypes.c_int
            lib.haar_detect_raw.argtypes = [
                ctypes.c_void_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int]
            lib.haar_resize_gray.restype = None
            lib.haar_resize_gray.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                             ctypes.c_int, ctypes.c_int]
            _lib = lib
        return _lib


def resize_gray(gray: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The evaluator's pyramid resize of a u8 plane (cv2 INTER_LINEAR)."""
    gray = np.ascontiguousarray(gray, np.uint8)
    out = np.empty((dh, dw), np.uint8)
    library().haar_resize_gray(gray, gray.shape[0], gray.shape[1], out, dh, dw)
    return out


class NativeHaar:
    """Owns the C++ cascade handle for one parsed HaarCascade. The handle is
    immutable, so threads may call detect_raw at once (the GIL is released
    during the call)."""

    _MAX_RAW = 8192   # raw (pre-grouping) window capacity of the first try

    def __init__(self, cascade) -> None:
        lib = library()
        self._lib = lib
        stages = cascade.stages
        ntrees = np.asarray([s.node_thresh.size for s in stages], np.int32)
        st_th = np.asarray([s.threshold for s in stages], np.float32)

        def cat(field, dtype):
            return np.ascontiguousarray(np.concatenate([getattr(s, field) for s in stages]),
                                        dtype)

        self._h = lib.haar_create(
            cascade.win_w, cascade.win_h, len(stages), ntrees, st_th,
            cat("rects", np.int32), cat("weights", np.float32),
            cat("node_thresh", np.float32), cat("leaf0", np.float32),
            cat("leaf1", np.float32))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.haar_destroy(self._h)
            self._h = None

    def detect_raw(self, gray: np.ndarray, scale_factor: float = 1.1,
                   min_size: Tuple[int, int] = (30, 30),
                   max_size: Optional[Tuple[int, int]] = None
                   ) -> List[Tuple[int, int, int, int]]:
        """Every window of the pyramid that passes all stages, (x, y, w, h)
        in the image's coordinates, before grouping."""
        global calls
        gray = np.ascontiguousarray(gray, np.uint8)
        if gray.ndim != 2:
            raise ValueError(f"expected a (H, W) u8 plane, got shape {gray.shape}")
        h, w = gray.shape
        cap = self._MAX_RAW
        while True:
            out = np.zeros(cap * 4, np.int32)
            n = self._lib.haar_detect_raw(
                self._h, gray, h, w, float(scale_factor), int(min_size[0]), int(min_size[1]),
                int(max_size[0]) if max_size else w, int(max_size[1]) if max_size else h,
                out, out.size)
            with _lock:
                calls += 1
            if n <= cap:
                return [tuple(int(v) for v in out[i * 4:i * 4 + 4]) for i in range(n)]
            cap = n   # more windows than the buffer: again, sized to fit
