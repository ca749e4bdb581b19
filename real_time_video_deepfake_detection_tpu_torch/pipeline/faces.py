"""Face detection frontend with the reference's detector ladder.

Port of real_time_video_deepfake_detection_tpu/pipeline/faces.py. The
ladder keeps its rungs — "ssd" (SSD-Res10, models/ssd_res10.py), "haar"
(cv2), "haar_native" (the from-scratch cascade) and "heuristic"
(models/heuristic_face.py). The SSD rung is available when the detector is
given a caffemodel (with deploy.prototxt beside it), as in the JAX
package; the two Haar rungs are not ported and report unavailable, as they
do in the JAX package on a host with no cv2 cascade and no cascade XML.
Same contract as the reference: a list of (x, y, w, h) int tuples.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.heuristic_face import detect_heuristic

Box = Tuple[int, int, int, int]


class FaceDetector:
    """`detect_bounding_box` semantics (face_detection.py:37-68): guards
    tiny or invalid frames; the selected rung's answer is final, and only an
    exception falls through to the next rung.

    `backend`: "auto" takes the first available rung; "ssd" / "haar" /
    "haar_native" / "heuristic" pin a rung (rungs above it are disabled).
    `device` places the SSD (None: CUDA, raising without it; "cpu")."""

    _LADDER = ("ssd", "haar", "haar_native", "heuristic")

    def __init__(self, ssd_weights_path: Optional[str] = None,
                 confidence_threshold: float = 0.5, min_face_px: int = 20,
                 backend: str = "auto",
                 device: Optional[Union[str, torch.device]] = None):
        self.confidence_threshold = confidence_threshold
        self.min_face_px = min_face_px
        self._ssd = None
        if ssd_weights_path and os.path.exists(ssd_weights_path):
            from ..models.ssd_res10 import SSDRes10
            self._ssd = SSDRes10.from_caffemodel(ssd_weights_path, device=device)
        self._ok = {"ssd": True, "haar": False, "haar_native": False, "heuristic": True}
        if backend != "auto":
            if backend not in self._LADDER:
                raise ValueError(f"unknown face backend {backend!r}")
            for r in self._LADDER[:self._LADDER.index(backend)]:
                self._ok[r] = False
            if not self._available(backend):
                warnings.warn(
                    f"requested face backend {backend!r} is unavailable (no SSD "
                    f"weights, or not ported); the ladder degrades to {self.backend!r}",
                    RuntimeWarning, stacklevel=2)

    def _available(self, rung: str) -> bool:
        if rung == "ssd":
            return self._ok["ssd"] and self._ssd is not None
        return self._ok[rung]

    @property
    def backend(self) -> str:
        for r in self._LADDER:
            if self._available(r):
                return r
        return "none"

    def __call__(self, frame_bgr: np.ndarray) -> List[Box]:
        if frame_bgr is None or getattr(frame_bgr, "size", 0) == 0:
            return []
        if frame_bgr.ndim < 2 or frame_bgr.shape[0] < 30 or frame_bgr.shape[1] < 30:
            return []
        for r in self._LADDER:
            if not self._available(r):
                continue
            try:
                if r == "ssd":
                    return self._ssd.detect(frame_bgr, self.confidence_threshold,
                                            self.min_face_px)
                return detect_heuristic(frame_bgr)
            except Exception:   # reference: a rung's exception falls through
                continue
        return []
