"""Last-resort heuristic face detector (skin-region proposal).

A numpy copy of real_time_video_deepfake_detection_tpu/models/
heuristic_face.py, kept in the port so it never imports the JAX package.

Why this exists: cv2 5.0 REMOVED both detector backends the reference
relies on — cv2.dnn.readNetFromCaffe (primary SSD) and
cv2.CascadeClassifier + the bundled haarcascade XMLs (fallback). In an
environment without the user-downloaded SSD caffemodel there is therefore
no runnable cv2 face detector. Where the cascade XML is found, the
from-scratch cascade (models/haar_cascade.py) stands in for the fallback;
this module keeps the face path alive as the bottom rung of the ladder
(SSD -> haar_native -> heuristic):

  YCrCb skin mask -> density gates -> percentile bounding box.

Deliberately conservative: random/noise frames must NOT produce a face
(the forensic-only path is the correct behavior there), so the detector
requires a minimum skin fraction AND a dense, plausibly-shaped region.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Box = Tuple[int, int, int, int]

# Classic YCrCb skin thresholds (Chai & Ngan)
_CR_LO, _CR_HI = 133, 173
_CB_LO, _CB_HI = 77, 127

_MIN_SKIN_FRACTION = 0.04   # of the whole frame
_MIN_DENSITY = 0.45         # skin pixels inside the candidate box
_MIN_SIDE = 40              # px


def _bgr_to_ycrcb(bgr: np.ndarray) -> np.ndarray:
    b = bgr[..., 0].astype(np.float32)
    g = bgr[..., 1].astype(np.float32)
    r = bgr[..., 2].astype(np.float32)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cr = (r - y) * 0.713 + 128.0
    cb = (b - y) * 0.564 + 128.0
    return np.stack([y, cr, cb], axis=-1)


def detect_heuristic(frame_bgr: np.ndarray) -> List[Box]:
    if frame_bgr is None or frame_bgr.ndim != 3:
        return []
    h, w = frame_bgr.shape[:2]
    if h < _MIN_SIDE or w < _MIN_SIDE:
        return []

    ycrcb = _bgr_to_ycrcb(frame_bgr)
    mask = ((ycrcb[..., 1] >= _CR_LO) & (ycrcb[..., 1] <= _CR_HI)
            & (ycrcb[..., 2] >= _CB_LO) & (ycrcb[..., 2] <= _CB_HI))
    frac = mask.mean()
    if frac < _MIN_SKIN_FRACTION:
        return []

    ys, xs = np.where(mask)
    # percentile box is robust against scattered false skin pixels
    x1, x2 = np.percentile(xs, [2, 98]).astype(int)
    y1, y2 = np.percentile(ys, [2, 98]).astype(int)
    bw, bh = x2 - x1, y2 - y1
    if bw < _MIN_SIDE or bh < _MIN_SIDE:
        return []
    density = mask[y1:y2, x1:x2].mean()
    if density < _MIN_DENSITY:
        return []
    # faces are taller than wide-ish; reject extreme aspect ratios
    ar = bw / max(bh, 1)
    if not (0.3 <= ar <= 2.5):
        return []
    return [(int(x1), int(y1), int(bw), int(bh))]
