"""Host-side analysis-frame resize. Port of
real_time_video_deepfake_detection_tpu/utils/host_resize.py: per-request
frames arrive at any resolution, so the resize to the analysis canvas runs
on the host — here always the port's cv2-exact torch resize on CPU tensors
(the JAX package's native C++ and cv2 rungs compute the same bytes)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.resize import resize_bilinear_u8_cv2


def resize_analysis(frame_bgr: np.ndarray, dh: int = 256, dw: int = 256) -> np.ndarray:
    """(H, W, C) u8 -> (dh, dw, C) u8, bit-exact with cv2 INTER_LINEAR for
    downscales."""
    src = torch.from_numpy(np.ascontiguousarray(frame_bgr))
    return resize_bilinear_u8_cv2(src, dh, dw).numpy()
