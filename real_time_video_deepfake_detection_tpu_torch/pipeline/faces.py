"""Face detection frontend with the reference's detector ladder.

Port of real_time_video_deepfake_detection_tpu/pipeline/faces.py. The
ladder keeps its rungs — "ssd" (SSD-Res10), "haar" (cv2), "haar_native"
(the from-scratch cascade) and "heuristic" (models/heuristic_face.py) —
but only the heuristic rung is ported so far: the others report
unavailable, as they do in the JAX package on a host with no SSD weights,
no cv2 cascade and no cascade XML. SSD-Res10 comes with the device-detect
slice. Same contract as the reference: a list of (x, y, w, h) int tuples.
"""

from __future__ import annotations

import warnings
from typing import List, Tuple

import numpy as np

from ..models.heuristic_face import detect_heuristic

Box = Tuple[int, int, int, int]


class FaceDetector:
    """`detect_bounding_box` semantics (face_detection.py:37-68): guards
    tiny or invalid frames; the selected rung's answer is final, and only an
    exception falls through to the next rung.

    `backend`: "auto" takes the first available rung; "ssd" / "haar" /
    "haar_native" / "heuristic" pin a rung (rungs above it are disabled)."""

    _LADDER = ("ssd", "haar", "haar_native", "heuristic")
    _PORTED = ("heuristic",)

    def __init__(self, backend: str = "auto"):
        self._ok = {r: r in self._PORTED for r in self._LADDER}
        if backend != "auto":
            if backend not in self._LADDER:
                raise ValueError(f"unknown face backend {backend!r}")
            for r in self._LADDER[:self._LADDER.index(backend)]:
                self._ok[r] = False
            if not self._ok[backend]:
                warnings.warn(
                    f"requested face backend {backend!r} is unavailable "
                    f"(not ported yet); the ladder degrades to {self.backend!r}",
                    RuntimeWarning, stacklevel=2)

    @property
    def backend(self) -> str:
        for r in self._LADDER:
            if self._ok[r]:
                return r
        return "none"

    def __call__(self, frame_bgr: np.ndarray) -> List[Box]:
        if frame_bgr is None or getattr(frame_bgr, "size", 0) == 0:
            return []
        if frame_bgr.ndim < 2 or frame_bgr.shape[0] < 30 or frame_bgr.shape[1] < 30:
            return []
        for r in self._LADDER:
            if not self._ok[r]:
                continue
            try:
                return detect_heuristic(frame_bgr)
            except Exception:   # reference: a rung's exception falls through
                continue
        return []
