"""cv2's 8-bit Lab pair without cv2: COLOR_BGR2LAB and COLOR_LAB2BGR on
uint8 images, in numpy integer arithmetic.

OpenCV converts 8-bit images to and from Lab through fixed-point tables
(color_lab.cpp, RGB2Lab_b and Lab2RGBinteger), not through its float
formulas rounded to u8. This module rebuilds those tables from their
formulas, once, at first use, and applies them per pixel; the result equals
cv2.cvtColor on all 2^24 inputs in both directions
(tests/test_torch_lab.py). It is the port's `cv2` rung of the host-side
face-quality CLAHE (pipeline/detector.preprocess_face_quality). It runs on
the host only; the device tick keeps ops/color.py, which equals the JAX
package's jnp Lab.

Forward (D65, sRGB), with d(v, s) = (v + 2^(s-1)) >> s:
  G[i]   = rint(2040 * gamma(f32(i) / 255))              i in 0..255
  K[j]   = rint(2^15 * f(f32(1) / 2040 * j)), in float32  j in 0..3071
           f(x) = x * 7.787 + 16/116 below 0.008856, else cbrt(x)
  C[r,c] = rint(2^12 * M[r,c] / white[r])
  fX, fY, fZ = K[d(C . G[rgb], 12)]
  L = d(296 fY - 1336935, 15), a = d(500 (fX - fY) + 128 * 2^15, 15),
  b = d(200 (fY - fZ) + 128 * 2^15, 15), each clipped to [0, 255].
Inverse: L -> (y, f(y)) and f -> X/Z tables in 2^14 fixed point, a/500 and
b/200 by multiply-shift, a fixed-point XYZ -> sRGB matrix, and a 4096-entry
inverse-gamma table.
"""

from __future__ import annotations

import functools

import numpy as np

_F32 = np.float32
_BASE = 1 << 14                 # Lab2RGBinteger's fixed point
_MIN_AB = -8145                 # smallest f(y) + a/500 or f(y) - b/200 it meets
_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                     [-0.969256, 1.875991, 0.041556],
                     [0.055648, -0.204043, 1.057311]])
_WHITE = np.array([0.950456, 1.0, 1.088754])


def _descale(v: np.ndarray, s: int) -> np.ndarray:
    return (v + (1 << (s - 1))) >> s


def _cdiv(a: np.ndarray, b: int) -> np.ndarray:
    """C's integer division, truncating toward zero."""
    q = np.abs(a) // b
    return np.where(a < 0, -q, q)


@functools.lru_cache(maxsize=None)
def _forward_tables():
    x = (np.arange(256, dtype=_F32) / _F32(255)).astype(np.float64)
    gamma = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    g = np.rint(2040 * gamma).astype(np.int32)
    t = (_F32(1) / _F32(2040)) * np.arange(3072, dtype=_F32)
    f = np.where(t < _F32(0.008856), t * _F32(7.787) + _F32(16) / _F32(116), np.cbrt(t))
    k = np.rint(_F32(32768) * f.astype(_F32)).astype(np.int32)
    c = np.rint(4096 * _RGB2XYZ / _WHITE[:, None]).astype(np.int32)
    return g, k, c


@functools.lru_cache(maxsize=None)
def _inverse_tables():
    i = np.arange(256)
    ic = i.astype(_F32)
    # L <= 8 (i <= 20): y = L / 903.3, f(y) = 7.787 y + 16/116; else
    # f(y) = (L + 16) / 116, y = f(y)^3; all in float32, as cv2's softfloat
    lo = i <= 20
    y_lo = np.rint((ic * _F32(_BASE * 20 * 9)) / _F32(17 * 29 * 29 * 29))
    f_lo = np.rint(_F32(_BASE) * (_F32(16) / _F32(116) + (ic * _F32(5)) / _F32(3 * 17 * 29)))
    fy = (np.array(i * 100 * _BASE, dtype=_F32) / _F32(255 * 116)
          + _F32(16 * _BASE) / _F32(116))
    y_hi = np.rint(fy * fy * fy / _F32(_BASE * _BASE))
    l_y = np.where(lo, y_lo, y_hi).astype(np.int64)
    l_f = np.where(lo, f_lo, np.rint(fy)).astype(np.int64)
    v = np.arange(_MIN_AB, _MIN_AB + _BASE * 9 // 4, dtype=np.int64)
    ab = np.where(v <= 3390, _cdiv(v * 108, 841) - (_BASE * 16 // 116 * 108 // 841),
                  v * v // _BASE * v // _BASE)
    c = np.rint(4096 * _XYZ2RGB * _WHITE[None, :]).astype(np.int64)
    x = (np.arange(4096, dtype=_F32) * (_F32(1) / _F32(4096))).astype(np.float64)
    inv_gamma = np.where(x <= 0.0031308, x * 12.92, 1.055 * x ** (1 / 2.4) - 0.055)
    ig = np.rint(_F32(255) * inv_gamma.astype(_F32)).astype(np.uint8)
    return l_y, l_f, ab, c, ig


def bgr_to_lab_u8_cv2(bgr: np.ndarray) -> np.ndarray:
    """(..., 3) u8 BGR -> (..., 3) u8 Lab, equal to cv2.cvtColor(bgr,
    cv2.COLOR_BGR2LAB)."""
    g, k, c = _forward_tables()
    rgb = [g[bgr[..., 2]], g[bgr[..., 1]], g[bgr[..., 0]]]
    fx, fy, fz = (k[_descale(c[r, 0] * rgb[0] + c[r, 1] * rgb[1] + c[r, 2] * rgb[2], 12)]
                  for r in range(3))
    lab = np.stack([_descale(296 * fy - 1336935, 15),
                    _descale(500 * (fx - fy) + (128 << 15), 15),
                    _descale(200 * (fy - fz) + (128 << 15), 15)], axis=-1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def lab_to_bgr_u8_cv2(lab: np.ndarray) -> np.ndarray:
    """(..., 3) u8 Lab -> (..., 3) u8 BGR, equal to cv2.cvtColor(lab,
    cv2.COLOR_LAB2BGR)."""
    l_y, l_f, ab, c, ig = _inverse_tables()
    lum = lab[..., 0]
    a = lab[..., 1].astype(np.int64)
    b = lab[..., 2].astype(np.int64)
    fy = l_f[lum]
    a_div = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * _BASE // 500
    b_div = ((b * 41943 + (1 << 4)) >> 9) - 128 * _BASE // 200 + 1
    xyz = (ab[fy + a_div - _MIN_AB], l_y[lum], ab[fy - b_div - _MIN_AB])
    bgr = [ig[np.clip(_descale(c[r, 0] * xyz[0] + c[r, 1] * xyz[1] + c[r, 2] * xyz[2], 14),
                      0, 4095)] for r in (2, 1, 0)]
    return np.stack(bgr, axis=-1)
