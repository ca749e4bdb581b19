"""The optional isotonic probability calibrator: fitting, saving, loading
and applying.

Port of real_time_video_deepfake_detection_tpu/train/calibration.py:
isotonic regression by pool-adjacent-violators, knots stored as an .npz
payload (two float arrays x, y; the file keeps the reference's name
calibrator.pkl), applied with np.interp through sklearn's `predict_proba`
surface. The two packages read each other's files. Pickled calibrators are
never loaded here.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np


class IsotonicCalibrator:
    """Monotone map from raw fake-probabilities to calibrated ones."""

    def __init__(self, x: Optional[np.ndarray] = None, y: Optional[np.ndarray] = None):
        self.x_ = x
        self.y_ = y

    def fit(self, probs: Sequence[float], labels: Sequence[int]) -> "IsotonicCalibrator":
        """Pool adjacent violators over the probabilities sorted (stably)."""
        p = np.asarray(probs, np.float64)
        t = np.asarray(labels, np.float64)
        order = np.argsort(p, kind="stable")
        vals = []    # [level y, weight, lowest x, highest x]
        for xi, yi in zip(p[order], t[order]):
            vals.append([yi, 1.0, xi, xi])
            while len(vals) > 1 and vals[-2][0] >= vals[-1][0]:
                y2, w2, _, hi2 = vals.pop()
                y1, w1, lo1, _ = vals.pop()
                w = w1 + w2
                vals.append([(y1 * w1 + y2 * w2) / w, w, lo1, hi2])
        self.x_ = np.array([v[2] for v in vals] + [vals[-1][3]])
        self.y_ = np.array([v[0] for v in vals] + [vals[-1][0]])
        return self

    def save(self, path: str) -> None:
        """Write the knots as an .npz payload, whatever the file's name."""
        with open(path, "wb") as f:
            np.savez(f, x=np.asarray(self.x_), y=np.asarray(self.y_))

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


def fit_calibrator_from_validation(model, params, loader, out_path: str) -> IsotonicCalibrator:
    """Fit on the fake probabilities of `model` with `params` (the EMA
    state dict) over `loader`'s batches and save to `out_path` (usable as
    the detector's weights/calibrator.pkl)."""
    # the training step stays out of the serving side's import of load_default
    from .augment import eval_preprocess_batch
    from .steps import eval_step
    dev = next(model.parameters()).device
    probs, labels = [], []
    for imgs, lab in loader:
        x = eval_preprocess_batch(imgs.to(dev))
        probs.append(eval_step(model, params, x).cpu().numpy())
        labels.append(lab)
    cal = IsotonicCalibrator().fit(np.concatenate(probs), np.concatenate(labels))
    cal.save(out_path)
    return cal
