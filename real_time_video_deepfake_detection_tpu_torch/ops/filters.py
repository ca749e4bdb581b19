"""Spatial filters matched to the OpenCV calls the forensic signals make.

Port of real_time_video_deepfake_detection_tpu/ops/filters.py, over
(B, H, W) batches:

  - cv2.GaussianBlur(gray_f32, (5,5), 0): the fixed [1,4,6,4,1]/16 table,
    border REFLECT_101
  - cv2.Laplacian(gray_u8, CV_64F): 4-neighbour kernel, REFLECT_101,
    computed in float32 as the JAX package does
  - cv2.Canny(gray_u8, 50, 150): Sobel-3 with BORDER_REPLICATE, L1
    magnitude, OpenCV's tan(22.5 deg) fixed-point direction quantization,
    and hysteresis as a masked 8-neighbour dilation iterated to fixpoint
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS5 = (np.array([1, 4, 6, 4, 1], np.float32) / 16.0).tolist()


def _pad_index(n: int, p: int, mode: str, device) -> torch.Tensor:
    i = torch.arange(-p, n + p, device=device)
    if mode == "reflect101":
        i = torch.where(i < 0, -i, i)
        i = torch.where(i >= n, 2 * (n - 1) - i, i)
    else:  # replicate
        i = torch.clamp(i, 0, n - 1)
    return i


def _pad2d(x: torch.Tensor, p: int, mode: str) -> torch.Tensor:
    """Pad the last two axes of any dtype by `p` (reflect101 | replicate)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.index_select(-2, _pad_index(h, p, mode, x.device))
    return x.index_select(-1, _pad_index(w, p, mode, x.device))


def _sep_filter(x: torch.Tensor, k, pad: str) -> torch.Tensor:
    """Separable correlation on (..., H, W) float: horizontal taps, then
    vertical, as shifted adds in the JAX function's order."""
    p = (len(k) - 1) // 2
    xp = _pad2d(x, p, pad)
    h, w = x.shape[-2], x.shape[-1]
    acc = torch.zeros(x.shape[:-2] + (h + 2 * p, w), dtype=x.dtype, device=x.device)
    for i, ki in enumerate(k):
        acc = acc + xp[..., :, i:i + w] * ki
    out = torch.zeros_like(x)
    for j, kj in enumerate(k):
        out = out + acc[..., j:j + h, :] * kj
    return out


def gaussian_blur5_f32(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(x_f32, (5,5), 0) over the last two axes."""
    return _sep_filter(x, _GAUSS5, "reflect101")


def laplacian4(x: torch.Tensor) -> torch.Tensor:
    """cv2.Laplacian(gray, CV_64F) with ksize=1, in float32."""
    xf = x.to(torch.float32)
    p = _pad2d(xf, 1, "reflect101")
    h, w = x.shape[-2], x.shape[-1]
    return (p[..., 0:h, 1:w + 1] + p[..., 2:h + 2, 1:w + 1]
            + p[..., 1:h + 1, 0:w] + p[..., 1:h + 1, 2:w + 2] - 4.0 * xf)


def sobel3_dx_dy(gray: torch.Tensor):
    """Sobel 3x3 dx and dy with BORDER_REPLICATE, int32."""
    g = gray.to(torch.int32)
    p = _pad2d(g, 1, "replicate")
    h, w = gray.shape[-2], gray.shape[-1]
    hdiff = p[..., :, 2:w + 2] - p[..., :, 0:w]              # (h+2, w)
    dx = hdiff[..., 0:h, :] + 2 * hdiff[..., 1:h + 1, :] + hdiff[..., 2:h + 2, :]
    vdiff = p[..., 2:h + 2, :] - p[..., 0:h, :]              # (h, w+2)
    dy = vdiff[..., :, 0:w] + 2 * vdiff[..., :, 1:w + 1] + vdiff[..., :, 2:w + 2]
    return dx, dy


_TG22 = 13573  # round(tan(22.5 deg) * 2^15), OpenCV canny.cpp


def canny_with_iterations(gray_u8: torch.Tensor, low: int = 50,
                          high: int = 150) -> Tuple[torch.Tensor, int]:
    """cv2.Canny(gray, low, high) over a (B, H, W) u8 batch, with the number
    of hysteresis rounds taken. The rounds run over the whole batch until no
    pixel of any frame changes (the fixpoint is per frame, so the batch
    gives the same edges as one frame at a time); each round's test reads
    one flag back to the host."""
    dx, dy = sobel3_dx_dy(gray_u8)
    mag = torch.abs(dx) + torch.abs(dy)   # L1 (L2gradient=False)
    h, w = mag.shape[-2], mag.shape[-1]
    magp = F.pad(mag, (1, 1, 1, 1))

    def nb(dy_, dx_):
        return magp[..., 1 + dy_:1 + dy_ + h, 1 + dx_:1 + dx_ + w]

    m = mag
    x = torch.abs(dx)
    y = torch.abs(dy) << 15
    tg22x = x * _TG22
    tg67x = tg22x + (x << 16)
    horizontal = y < tg22x
    vertical = y > tg67x
    same_sign = (dx ^ dy) >= 0

    keep_h = (m > nb(0, -1)) & (m >= nb(0, 1))
    keep_v = (m > nb(-1, 0)) & (m >= nb(1, 0))
    # diagonals compare STRICTLY on both sides (OpenCV canny.cpp)
    diag1 = (m > nb(-1, -1)) & (m > nb(1, 1))
    diag2 = (m > nb(-1, 1)) & (m > nb(1, -1))
    keep_d = torch.where(same_sign, diag1, diag2)
    keep = torch.where(horizontal, keep_h, torch.where(vertical, keep_v, keep_d))
    cand = keep & (m > low)
    strong = cand & (m > high)
    weak = cand & ~strong

    # hysteresis: grow strong edges into 8-connected weak pixels
    cur = strong
    rounds = 0
    while True:
        rounds += 1
        lead = cur.reshape((-1, 1, h, w)).to(torch.float32)
        dil = F.max_pool2d(lead, 3, stride=1, padding=1).reshape(cur.shape) > 0
        grown = (dil & weak) | cur
        changed = bool(torch.any(grown != cur))
        cur = grown
        if not changed:
            break
    edges = torch.where(cur, 255, 0).to(torch.uint8)
    return edges, rounds


def canny(gray_u8: torch.Tensor, low: int = 50, high: int = 150) -> torch.Tensor:
    """cv2.Canny(gray, low, high) — aperture 3, L1 gradient; uint8 {0,255}."""
    return canny_with_iterations(gray_u8, low, high)[0]
