"""Fused face preprocessing (resize + scale + normalize) for the classifier.

Port of real_time_video_deepfake_detection_tpu/kernels/preproc.py
(preprocess_faces_pallas). On a CUDA tensor `preprocess_faces` launches the
hand-written kernel in csrc/preproc.cu; on a CPU tensor it runs
`preprocess_faces_plain`, the same arithmetic in torch. There is no
fallback between the two: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.resize import _linear_tables_f32, resize_bilinear_f32
from . import build

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Kernel launches since the last reset (the CPU path never counts), in all
# and by entry: u8 faces (the resize aligner's crops) or f32 (MTCNN's)
launches = 0
entry_launches = {"preprocess_faces_u8": 0, "preprocess_faces_f32": 0}

_tables: Dict[Tuple[int, int, int, str], Tuple[torch.Tensor, torch.Tensor]] = {}


def preprocess_faces_plain(faces_raw: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) f32 or u8 raw-RGB faces -> (B, out, out, 3) normalized
    f32: the kernel's arithmetic (two taps per axis with the
    _linear_tables_f32 weights, then *(1/255), -mean, /std) in torch."""
    x = resize_bilinear_f32(faces_raw, out_size, out_size, axes=(1, 2))
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x * (1.0 / 255.0) - mean) / std


def _launch_tables(h: int, w: int, out_size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's two tables for (h, w) -> out_size on `device`, built
    once: int32 [sy | sy1 | sx | sx1] and float32 [wy0 | wy1 | wx0 | wx1 |
    mean | std], from _linear_tables_f32."""
    key = (h, w, out_size, str(device))
    if key not in _tables:
        sy, sy1, wy0, wy1 = _linear_tables_f32(h, out_size)
        sx, sx1, wx0, wx1 = _linear_tables_f32(w, out_size)
        itab = np.concatenate([sy, sy1, sx, sx1]).astype(np.int32)
        ftab = np.concatenate([wy0, wy1, wx0, wx1, np.float32(IMAGENET_MEAN),
                               np.float32(IMAGENET_STD)]).astype(np.float32)
        _tables[key] = (torch.as_tensor(itab, device=device),
                        torch.as_tensor(ftab, device=device))
    return _tables[key]


def preprocess_faces(faces_raw: torch.Tensor, out_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) raw-RGB faces (f32 or u8, contiguous) -> (B, out, out, 3)
    normalized f32."""
    global launches
    if faces_raw.ndim != 4 or faces_raw.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3) faces, got {tuple(faces_raw.shape)}")
    if faces_raw.dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"faces must be float32 or uint8, got {faces_raw.dtype}")
    if faces_raw.device.type == "cpu":
        return preprocess_faces_plain(faces_raw, out_size)
    if faces_raw.device.type != "cuda":
        raise ValueError(f"unsupported device {faces_raw.device}")
    if not faces_raw.is_contiguous():
        raise ValueError("faces must be contiguous (NHWC)")
    b, h, w, _ = faces_raw.shape
    itab, ftab = _launch_tables(h, w, out_size, faces_raw.device)
    out = torch.empty((b, out_size, out_size, 3), dtype=torch.float32,
                      device=faces_raw.device)
    name = "preprocess_faces_f32" if faces_raw.dtype == torch.float32 else "preprocess_faces_u8"
    build.launch(name, faces_raw.device, faces_raw.data_ptr(), out.data_ptr(), b, h, w,
                 out_size, itab.data_ptr(), ftab.data_ptr())
    launches += 1
    entry_launches[name] += 1
    return out
