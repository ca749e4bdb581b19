"""Face-classification preprocessing. Port of
real_time_video_deepfake_detection_tpu/pipeline/classify.py: aligned raw-RGB
faces -> bilinear resize (half-pixel, as F.interpolate) -> /255 -> ImageNet
normalize (deepfake_detection.py:383-389)."""

from __future__ import annotations

import torch

from ..ops.resize import resize_bilinear_f32

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess_aligned(faces_rgb_raw: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) float or uint8 RGB with raw 0-255 values -> (B, size,
    size, 3) normalized f32. uint8 input takes the same float path (the
    JAX u8 fast path is bit-identical to it)."""
    x = resize_bilinear_f32(faces_rgb_raw, size, size, axes=(1, 2))
    x = x / 255.0
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std
