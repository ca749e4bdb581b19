"""Host prep of a face crop for the serving tick.

Port of the host-prep parts of real_time_video_deepfake_detection_tpu/
pipeline/detector.py: `preprocess_face_quality` (CLAHE on the Lab L
channel, deepfake_detection.py:357-370) with the Lab conversion of the JAX
package's jnp rung in torch on the CPU and the numpy CLAHE, and the resize
aligner. The single-stream DeepfakeDetector comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.clahe import clahe_u8_numpy
from ..ops.color import lab_to_rgb_u8, rgb_to_lab_u8
from ..utils.host_resize import resize_analysis


def preprocess_face_quality(face_bgr: np.ndarray) -> np.ndarray:
    """BGR u8 crop -> BGR u8 crop with CLAHE(2.0, 8x8) applied to L."""
    rgb = torch.from_numpy(np.ascontiguousarray(face_bgr[..., ::-1]))
    lab = rgb_to_lab_u8(rgb).numpy()
    l_eq = clahe_u8_numpy(lab[..., 0], clip_limit=2.0, tiles=8)
    merged = np.stack([l_eq, lab[..., 1], lab[..., 2]], axis=-1)
    return lab_to_rgb_u8(torch.from_numpy(merged)).numpy()[..., ::-1].copy()


class _ResizeAligner:
    """Aligner used without MTCNN weights: the whole CLAHE'd crop ->
    160x160 RGB float (raw 0-255), the JAX package's fallback aligner. The
    MTCNN aligner comes with a later slice."""

    def __call__(self, face_bgr_clahe: np.ndarray) -> Optional[np.ndarray]:
        rgb = np.ascontiguousarray(face_bgr_clahe[..., ::-1])
        return resize_analysis(rgb, 160, 160).astype(np.float32)
