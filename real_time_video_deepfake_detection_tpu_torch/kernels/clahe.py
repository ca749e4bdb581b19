"""CLAHE of the tick's face crops: per-tile LUTs, then their bilinear blend.

Port of real_time_video_deepfake_detection_tpu/kernels/clahe.py
(clahe_luts_pallas, clahe_apply_pallas, clahe_u8_pallas), batched over
faces. On a CUDA tensor `clahe_luts` and `clahe_apply` launch the
hand-written kernels in csrc/clahe.cu; on a CPU tensor they run their plain
versions, ops/clahe.clahe_luts_batch and clahe_apply_batch, which compute
the same function (bit-exact with clahe_u8_numpy). There is no fallback
between the two: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.clahe import clahe_apply_batch, clahe_luts_batch, clip_count
from . import build

TILES = 8

# Kernel launches since the last reset, by kernel (the CPU path never counts).
launches = {"clahe_luts": 0, "clahe_apply": 0}


def _check_planes(imgs: torch.Tensor) -> None:
    if imgs.ndim != 3:
        raise ValueError(f"expected (B, H, W) planes, got {tuple(imgs.shape)}")
    if imgs.dtype != torch.uint8:
        raise TypeError(f"planes must be uint8, got {imgs.dtype}")
    if imgs.shape[1] % TILES or imgs.shape[2] % TILES:
        raise ValueError(f"plane size {tuple(imgs.shape[1:])} is not divisible by "
                         f"the {TILES}x{TILES} tile grid")
    if imgs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {imgs.device}")
    if imgs.device.type == "cuda" and not imgs.is_contiguous():
        raise ValueError("planes must be contiguous")


def clahe_luts(imgs: torch.Tensor, clip_limit: float = 2.0) -> torch.Tensor:
    """(B, H, W) u8 -> (B, 64, 256) f32 per-tile LUTs of the 8x8 grid."""
    _check_planes(imgs)
    if imgs.device.type == "cpu":
        return clahe_luts_batch(imgs, clip_limit, TILES)
    b, h, w = imgs.shape
    area = (h // TILES) * (w // TILES)
    out = torch.empty((b, TILES * TILES, 256), dtype=torch.float32, device=imgs.device)
    build.launch("clahe_luts", imgs.device, imgs.data_ptr(), out.data_ptr(), b, h, w, TILES,
                 clip_count(clip_limit, area), 255.0 / area)
    launches["clahe_luts"] += 1
    return out


def clahe_apply(imgs: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """(B, H, W) u8 + (B, 64, 256) f32 LUTs -> (B, H, W) u8."""
    _check_planes(imgs)
    b, h, w = imgs.shape
    if luts.shape != (b, TILES * TILES, 256) or luts.dtype != torch.float32:
        raise ValueError(f"expected ({b}, {TILES * TILES}, 256) float32 LUTs, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    if luts.device != imgs.device:
        raise ValueError(f"LUTs on {luts.device}, planes on {imgs.device}")
    if imgs.device.type == "cpu":
        return clahe_apply_batch(imgs, luts, TILES)
    if not luts.is_contiguous():
        raise ValueError("LUTs must be contiguous")
    out = torch.empty_like(imgs)
    build.launch("clahe_apply", imgs.device, imgs.data_ptr(), luts.data_ptr(), out.data_ptr(),
                 b, h, w, TILES, float(np.float32(1.0 / (h // TILES))),
                 float(np.float32(1.0 / (w // TILES))))
    launches["clahe_apply"] += 1
    return out


def clahe_u8(imgs: torch.Tensor, clip_limit: float = 2.0) -> torch.Tensor:
    """Batched CLAHE, (B, H, W) u8 -> (B, H, W) u8: both kernels on CUDA."""
    return clahe_apply(imgs, clahe_luts(imgs, clip_limit))
