"""The optional isotonic probability calibrator: loading and applying.

Port of those halves of real_time_video_deepfake_detection_tpu/train/
calibration.py: knots stored as an .npz payload (two float arrays x, y),
applied with np.interp through sklearn's `predict_proba` surface. Pickled
calibrators are never loaded here. Fitting comes with the training slice.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np


class IsotonicCalibrator:
    """Monotone map from raw fake-probabilities to calibrated ones."""

    def __init__(self, x: Optional[np.ndarray] = None, y: Optional[np.ndarray] = None):
        self.x_ = x
        self.y_ = y

    def transform(self, probs) -> np.ndarray:
        if self.x_ is None:
            return np.asarray(probs)
        return np.interp(np.asarray(probs), self.x_, self.y_)

    def predict_proba(self, rows) -> np.ndarray:
        """sklearn's surface, which DeepfakeDetector.apply_calibration
        calls: rows [[p], ...] -> (n, 2) [1 - calibrated, calibrated]."""
        cal = self.transform(np.asarray(rows, np.float64).reshape(-1))
        return np.stack([1 - cal, cal], axis=1)

    @classmethod
    def load(cls, path: str) -> "IsotonicCalibrator":
        """Load the .npz knots; anything else raises ValueError."""
        try:
            with np.load(path, allow_pickle=False) as d:
                return cls(np.array(d["x"]), np.array(d["y"]))
        except (OSError, ValueError, KeyError) as e:
            raise ValueError(f"{path}: not an .npz calibrator payload "
                             f"({type(e).__name__}: {e})") from e


def load_default() -> Optional[IsotonicCalibrator]:
    """weights/calibrator.pkl in the package dir or the working directory,
    or calibrator.pkl in the working directory (the JAX package's search
    order); None when absent or unreadable."""
    base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log = logging.getLogger(__name__)
    for cal in (os.path.join(base, "weights", "calibrator.pkl"),
                os.path.join("weights", "calibrator.pkl"), "calibrator.pkl"):
        if not os.path.exists(cal):
            continue
        try:
            loaded = IsotonicCalibrator.load(cal)
        except ValueError as e:
            log.warning("ignoring calibrator %s: %s", os.path.abspath(cal), e)
            continue
        log.warning("probability calibrator auto-loaded from %s — applied to "
                    "ALL face probabilities", os.path.abspath(cal))
        return loaded
    return None
