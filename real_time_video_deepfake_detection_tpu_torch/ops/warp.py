"""The geometric and photometric augmentations of test-time augmentation,
on the host in numpy, equal to the cv2 calls the JAX package makes
(pipeline/detector.py `_tta_prediction`: cv2.flip, cv2.convertScaleAbs,
cv2.getRotationMatrix2D and cv2.warpAffine).

`warp_affine_linear` follows OpenCV 5.0's warpAffine for 8-bit, 3-channel
images with INTER_LINEAR and BORDER_CONSTANT 0, which computes in float32
(imgproc's warpAffineLinearInvoker_8UC3), not in 4.x's fixed point:

  - the matrix is inverted in double (imgwarp.cpp, without
    WARP_INVERSE_MAP) and cast to float32;
  - each row runs 16 pixels at a time (two float32 vectors of the AVX2
    dispatch) while 16 remain: the source position is
    fma(M0, x, float(float(y * M1) + M2)), likewise for the row;
    the remaining pixels take the scalar loop, whose product sum the
    compiler contracts to float(fma(x, M0, float(y * M1)) + M2);
  - the four neighbours (0 outside the image) are blended with
    p0 + a * (p1 - p0) as fused multiply-adds, first along x, then along
    y, and rounded half to even with saturation.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_LANES = 16   # pixels per step of the vector loop


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 fma(a, b, c) with one rounding. The product of two float32
    values is exact in float64; the float64 sum's own rounding error (two-sum)
    decides the float32 rounding where the sum lands on a float32 tie."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    up = np.nextafter(r, np.float32(np.inf))
    down = np.nextafter(r, np.float32(-np.inf))
    r = np.where((err > 0) & (r64 < s) & (s == (r64 + up.astype(np.float64)) / 2), up, r)
    r = np.where((err < 0) & (r64 > s) & (s == (r64 + down.astype(np.float64)) / 2), down, r)
    return r.astype(np.float32)


def flip_horizontal(img: np.ndarray) -> np.ndarray:
    """cv2.flip(img, 1)."""
    return np.ascontiguousarray(img[:, ::-1])


def convert_scale_abs(img: np.ndarray, alpha: float) -> np.ndarray:
    """cv2.convertScaleAbs(img, alpha=alpha, beta=0) for uint8: |x * alpha|
    in float32, rounded half to even and saturated."""
    v = np.abs(img.astype(np.float32) * np.float32(alpha))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def rotation_matrix_2d(center: Tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D: (2, 3) float64, the centre taken as float32
    (cv::Point2f) and the angle in degrees."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """warpAffine's inversion of the forward matrix, in imgwarp.cpp's order."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return np.array(m, np.float64)


def warp_affine_linear(img: np.ndarray, m: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """cv2.warpAffine(img, m, dsize) on an (H, W, 3) uint8 image with the
    defaults (INTER_LINEAR, BORDER_CONSTANT 0): dsize is (width, height)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.dtype} {img.shape}")
    w, h = dsize
    src_h, src_w = img.shape[:2]
    m0, m1, m2, m3, m4, m5 = _invert_affine(m).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    vec = np.arange(w)[None, :] < (w // _LANES) * _LANES
    # vector loop: the row's term first, then one fma per pixel
    sx = _fma_f32(m0, xs, (ys * m1) + m2)
    sy = _fma_f32(m3, xs, (ys * m4) + m5)
    # scalar tail: x's product fused into the sum with y's
    tx = _fma_f32(xs, m0, ys * m1) + m2
    ty = _fma_f32(xs, m3, ys * m4) + m5
    sx, sy = np.where(vec, sx, tx), np.where(vec, sy, ty)
    ix, iy = np.floor(sx), np.floor(sy)
    ax = (sx - ix)[..., None]
    ay = (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < src_h) & (xx >= 0) & (xx < src_w)
        v = img[np.clip(yy, 0, src_h - 1), np.clip(xx, 0, src_w - 1)].astype(np.float32)
        return np.where(inside[..., None], v, np.float32(0))

    p00, p01 = tap(iy, ix), tap(iy, ix + 1)
    p10, p11 = tap(iy + 1, ix), tap(iy + 1, ix + 1)
    top = _fma_f32(ax, p01 - p00, p00)
    bottom = _fma_f32(ax, p11 - p10, p10)
    out = _fma_f32(ay, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
