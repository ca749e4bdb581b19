"""Face detection frontend with the reference's detector ladder.

Port of real_time_video_deepfake_detection_tpu/pipeline/faces.py
(face_detection.py:37-123 in the reference: the OpenCV-DNN SSD when its
caffemodel exists, else the Haar cascade; an exception falls through). The
ladder's rungs, in order:

  1. "ssd": SSD-Res10 (models/ssd_res10.py), available when the detector is
     given a caffemodel (with deploy.prototxt beside it);
  2. "haar": cv2's CascadeClassifier. The port has no cv2, so this rung is
     always unavailable: what the JAX rung reports under cv2 5.0, which
     removed the class. A known difference only on a host whose cv2 still
     has it;
  3. "haar_native": the from-scratch cascade (models/haar_cascade.py, its
     C++ evaluator csrc/haar.cpp), available when find_cascade_xml() finds
     haarcascade_frontalface_default.xml ($HAARCASCADE_DIR or the distro
     paths). With no SSD weights this is the default detector, as in the
     JAX package;
  4. "heuristic": the skin-region proposal (models/heuristic_face.py);
  5. an empty list.

Same contract as the reference: a list of (x, y, w, h) int tuples.

Also the reference's module-level helpers, as in the JAX package:
`detect_bounding_box` (a shared default detector, which runs on the CUDA
card when it holds an SSD), `extract_face_region`, `draw_bounding_boxes`
(ops/draw.py's cv2-exact rectangle) and `detect_and_extract_faces`.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..models import haar_cascade
from ..models.heuristic_face import detect_heuristic
from ..ops import draw

Box = Tuple[int, int, int, int]


class FaceDetector:
    """`detect_bounding_box` semantics (face_detection.py:37-68): guards
    tiny or invalid frames; the selected rung's answer is final (no faces
    included), and only an exception falls through to the next rung, for
    that frame only.

    `backend`: "auto" takes the first available rung; "ssd" / "haar" /
    "haar_native" / "heuristic" pin a rung (rungs above it are disabled).
    `device` places the SSD (None: CUDA, raising without it; "cpu").

    The haar_native rung's cascade and C++ library are loaded at its first
    frame, outside the fall-through: a failed build raises instead of
    turning into the heuristic's answer."""

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
        self._ok = {r: True for r in self._LADDER}
        self._probed: dict = {}
        if backend != "auto":
            if backend not in self._LADDER:
                raise ValueError(f"unknown face backend {backend!r}")
            for r in self._LADDER[:self._LADDER.index(backend)]:
                self._ok[r] = False
            if not self._available(backend):
                warnings.warn(
                    f"requested face backend {backend!r} is unavailable (no SSD "
                    f"weights, no cascade XML, or no cv2); the ladder degrades to "
                    f"{self.backend!r}", RuntimeWarning, stacklevel=2)

    def _available(self, rung: str) -> bool:
        """Availability probes run once and are cached both ways."""
        if not self._ok[rung]:
            return False
        if rung == "ssd":
            return self._ssd is not None
        if rung == "haar":
            return False   # cv2's CascadeClassifier: no cv2 in the port
        if rung == "haar_native":
            if rung not in self._probed:
                self._probed[rung] = haar_cascade.native_haar_available()
            return self._probed[rung]
        return True

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
            if r == "haar_native":
                haar_cascade.default_cascade()   # loads (or raises) outside the try
            try:
                if r == "ssd":
                    return self._ssd.detect(frame_bgr, self.confidence_threshold,
                                            self.min_face_px)
                if r == "haar_native":
                    return haar_cascade.detect_haar_native(frame_bgr)
                return detect_heuristic(frame_bgr)
            except Exception:   # reference: a rung's exception falls through
                continue
        return []


_default_detector: Optional[FaceDetector] = None


def detect_bounding_box(frame: np.ndarray, confidence_threshold: float = 0.5) -> List[Box]:
    """The reference's module-level API (face_detection.py:37-68): faces of
    a shared default detector, built at the first call (and again when the
    threshold changes); a list of (x, y, w, h)."""
    global _default_detector
    if (_default_detector is None
            or _default_detector.confidence_threshold != confidence_threshold):
        _default_detector = FaceDetector(confidence_threshold=confidence_threshold)
    return _default_detector(frame)


def extract_face_region(frame: np.ndarray, box: Box, padding: int = 0) -> np.ndarray:
    """The box grown by `padding` on each side, clipped to the frame
    (face_detection.py:145-168); a view of `frame`."""
    x, y, w, h = box
    x0, y0 = max(0, x - padding), max(0, y - padding)
    x1 = min(frame.shape[1], x + w + padding)
    y1 = min(frame.shape[0], y + h + padding)
    return frame[y0:y1, x0:x1]


def draw_bounding_boxes(frame: np.ndarray, faces: List[Box], color=(0, 255, 0),
                        thickness: int = 2) -> np.ndarray:
    """A copy of the frame with the face boxes drawn as cv2.rectangle draws
    them (face_detection.py:125-143)."""
    out = frame.copy()
    for (x, y, w, h) in faces:
        draw.rectangle(out, (x, y), (x + w, y + h), color, thickness)
    return out


def detect_and_extract_faces(frame: np.ndarray, padding: int = 10,
                             detector: Optional[FaceDetector] = None):
    """(faces, crops): detect, then crop every face with `padding`
    (face_detection.py:170-188)."""
    det = detector or FaceDetector()
    faces = det(frame)
    return faces, [extract_face_region(frame, b, padding) for b in faces]
