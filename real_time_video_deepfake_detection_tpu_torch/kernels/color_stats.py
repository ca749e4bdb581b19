"""Unique-hue presence count for the forensic color signal.

Port of real_time_video_deepfake_detection_tpu/kernels/color_stats.py.
`unique_hue_count` launches the hand-written kernel in csrc/color_stats.cu
on a CUDA tensor and runs `unique_hue_count_plain` on a CPU tensor; a CUDA
tensor launches the kernel or raises. `color_scores_batch` keeps the HSV
conversion and the std moments in plain torch, as the JAX wrapper keeps
them in XLA.
"""

from __future__ import annotations

import torch

from ..ops.color import bgr_to_hsv_u8
from . import build

# Kernel launches since the last reset (the CPU path never counts).
launches = 0

HUE_BINS = 181   # OpenCV's u8 hue range is 0..179; the kernel counts bins < 181


def unique_hue_count_plain(hue_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) u8 hue planes -> (B,) f32 count of distinct values < 181,
    as a presence set over 256 bins."""
    b = hue_u8.shape[0]
    idx = hue_u8.reshape(b, -1).to(torch.int64)
    present = torch.zeros((b, 256), dtype=torch.int32, device=hue_u8.device)
    present.scatter_(1, idx, 1)
    return present[:, :HUE_BINS].sum(1).to(torch.float32)


def unique_hue_count(hue_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) u8 hue planes (contiguous) -> (B,) distinct-hue counts (f32)."""
    global launches
    if hue_u8.ndim != 3:
        raise ValueError(f"expected (B, H, W) hue planes, got {tuple(hue_u8.shape)}")
    if hue_u8.dtype != torch.uint8:
        raise TypeError(f"hue must be uint8, got {hue_u8.dtype}")
    if hue_u8.device.type == "cpu":
        return unique_hue_count_plain(hue_u8)
    if hue_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {hue_u8.device}")
    if not hue_u8.is_contiguous():
        raise ValueError("hue planes must be contiguous")
    b, h, w = hue_u8.shape
    out = torch.empty((b,), dtype=torch.float32, device=hue_u8.device)
    build.launch("unique_hue_count", hue_u8.device, hue_u8.data_ptr(), out.data_ptr(), b, h * w)
    launches += 1
    return out


def color_scores_batch(frames_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR -> (B,) color scores: bit-exact HSV, the sat/val
    std as sqrt(mean((x-mean)^2)), the unique-hue count from the kernel,
    and the thresholds of frame_analysis.py:311-347."""
    hsv = bgr_to_hsv_u8(frames_u8)
    sat = hsv[..., 1].to(torch.float32)
    val = hsv[..., 2].to(torch.float32)
    sat_mean = sat.mean(dim=(1, 2), keepdim=True)
    val_mean = val.mean(dim=(1, 2), keepdim=True)
    sat_std = torch.sqrt(((sat - sat_mean) ** 2).mean(dim=(1, 2)))
    val_std = torch.sqrt(((val - val_mean) ** 2).mean(dim=(1, 2)))
    unique = unique_hue_count(hsv[..., 0].contiguous())
    return _color_thresholds(sat_std, val_std, unique)


def _color_thresholds(sat_std: torch.Tensor, val_std: torch.Tensor,
                      unique: torch.Tensor) -> torch.Tensor:
    def step(x, lo, hi, a, b):
        return torch.where(x < lo, a, torch.where(x < hi, b, 0.0))
    score = step(sat_std, 15, 25, 0.3, 0.1)
    score = score + step(val_std, 15, 25, 0.25, 0.1)
    score = score + step(unique, 30, 50, 0.25, 0.1)
    return torch.clamp(score, 0.0, 1.0)
