"""Host-side analysis-frame resize. Port of
real_time_video_deepfake_detection_tpu/utils/host_resize.py: per-request
frames arrive at any resolution, so the resize to the analysis canvas runs
on the host — here always the port's cv2-exact torch resize on CPU tensors
(the JAX package's native C++ and cv2 rungs compute the same bytes)."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.resize import resize_bilinear_u8_cv2


def resize_analysis(frame_bgr: np.ndarray, dh: int = 256, dw: int = 256) -> np.ndarray:
    """(H, W, C) u8 -> (dh, dw, C) u8, bit-exact with cv2 INTER_LINEAR for
    downscales."""
    src = torch.from_numpy(np.ascontiguousarray(frame_bgr))
    return resize_bilinear_u8_cv2(src, dh, dw).numpy()


def _area_linear_tables(src: int, dst: int):
    """cv2's INTER_AREA coefficients where it upscales an axis (resize.cpp
    area_mode of the linear path): sx = floor(dx*scale), the weight of
    sx+1 the fractional part of (dx+1) - (sx+1)/scale in float32, short
    coefficients of 2^11; the last source sample's weight is clamped to
    it."""
    inv = dst / src
    scale = 1.0 / inv   # cv2's scale_x = 1 / inv_scale_x, not src / dst
    sx = np.array([math.floor(dx * scale) for dx in range(dst)], np.int64)
    fx = np.array([np.float32((dx + 1) - (s + 1) * inv) for dx, s in enumerate(sx)], np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    last = sx >= src - 1
    fx = np.where(last, np.float32(0), fx).astype(np.float32)
    sx = np.minimum(sx, src - 1)
    a1 = np.rint(fx * np.float32(2048)).astype(np.int64)
    a0 = np.rint((np.float32(1) - fx) * np.float32(2048)).astype(np.int64)
    return sx, np.minimum(sx + 1, src - 1), a0, a1


def _area_decimate_table(src: int, dst: int):
    """cv2's computeResizeAreaTab: (dst index, src index, float32 weight)
    entries in cv2's order."""
    scale = 1.0 / (dst / src)
    tab = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)))
    return tab


def _by_rank(tab, dst: int):
    """The table's entries grouped by their rank within their destination
    index: list of (dst indices, src indices, weights), so that adding the
    groups in order adds each destination's terms in cv2's order."""
    ranks, seen = [], [0] * dst
    for d, s, a in tab:
        r = seen[d]
        seen[d] += 1
        if r == len(ranks):
            ranks.append(([], [], []))
        ranks[r][0].append(d)
        ranks[r][1].append(s)
        ranks[r][2].append(a)
    return [(np.array(d), np.array(s), np.array(a, np.float32)) for d, s, a in ranks]


def resize_area_u8(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """cv2.resize(img, (dw, dh), interpolation=INTER_AREA) for (H, W, C) or
    (H, W) u8, bit for bit, at any ratio:

      - both axes shrink by whole factors: the mean of each block, 2x2 as
        (sum + 2) >> 2, other blocks as round(float32(sum) / area);
      - both axes shrink otherwise: cv2's fractional-weight decimation in
        float32, each destination's terms added in cv2's order;
      - an axis grows: cv2's linear path with the area coefficients, in
        its fixed point (as resize_bilinear_u8_cv2)."""
    src = np.asarray(img)
    squeeze = src.ndim == 2
    if squeeze:
        src = src[..., None]
    h, w = src.shape[:2]
    if (h, w) == (dh, dw):
        out = src.copy()
    elif h >= dh and w >= dw and h % dh == 0 and w % dw == 0:
        sy, sx = h // dh, w // dw
        s = src.reshape(dh, sy, dw, sx, -1).astype(np.int64).sum(axis=(1, 3))
        if sy == 2 and sx == 2:
            out = ((s + 2) >> 2).astype(np.uint8)
        else:
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / (sx * sy)))
            out = out.clip(0, 255).astype(np.uint8)
    elif h >= dh and w >= dw:
        f32 = np.float32
        x = src.astype(f32)
        buf = np.zeros((h, dw, x.shape[2]), f32)
        for d, s, a in _by_rank(_area_decimate_table(w, dw), dw):
            buf[:, d] = buf[:, d] + x[:, s] * a[None, :, None]
        acc = np.zeros((dh, dw, x.shape[2]), f32)
        for d, s, b in _by_rank(_area_decimate_table(h, dh), dh):
            acc[d] = acc[d] + b[:, None, None] * buf[s]
        out = np.rint(acc).clip(0, 255).astype(np.uint8)
    else:
        sx, sx1, ax0, ax1 = _area_linear_tables(w, dw)
        sy, sy1, ay0, ay1 = _area_linear_tables(h, dh)
        x = src.astype(np.int64)
        hsum = (ax0[:, None] * x[:, sx] + ax1[:, None] * x[:, sx1]) >> 4
        out = (((ay0[:, None, None] * hsum[sy]) >> 16)
               + ((ay1[:, None, None] * hsum[sy1]) >> 16) + 2) >> 2
        out = out.clip(0, 255).astype(np.uint8)
    return out[..., 0] if squeeze else out
