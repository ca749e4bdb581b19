"""Color-space conversions, bit-matched to OpenCV's u8 paths.

Port of real_time_video_deepfake_detection_tpu/ops/color.py. Inputs are
(..., 3) uint8 tensors in OpenCV's BGR order (RGB for the Lab pair); the
integer paths run in int32 and are bit-exact with the JAX functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .powf import powf

# OpenCV BGR2GRAY fixed-point coefficients, scaled by 2^15
_GRAY_SHIFT = 15
_R_COEF, _G_COEF, _B_COEF = 9798, 19235, 3735

_HSV_SHIFT = 12


def _channels(bgr: torch.Tensor):
    x = bgr.to(torch.int32)
    return x[..., 0], x[..., 1], x[..., 2]


def bgr_to_gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(frame, COLOR_BGR2GRAY) for uint8 input, bit-exact."""
    b, g, r = _channels(bgr)
    y = (r * _R_COEF + g * _G_COEF + b * _B_COEF
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return y.to(torch.uint8)


def bgr_to_hsv_u8(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(frame, COLOR_BGR2HSV) for uint8, bit-exact: H in
    [0, 180), S and V in [0, 255]. OpenCV's 12-bit division tables are
    computed per pixel, round((K<<12)/x) == (2*(K<<12)+x)//(2x)."""
    b, g, r = _channels(bgr)
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin
    zero = torch.zeros_like(v)

    half = 1 << (_HSV_SHIFT - 1)
    sdiv_v = torch.where(
        v > 0, torch.div(2 * (255 << _HSV_SHIFT) + v,
                         torch.clamp(2 * v, min=1), rounding_mode="floor"), zero)
    s = (diff * sdiv_v + half) >> _HSV_SHIFT

    # OpenCV's hue branch priority: v==r -> g-b; elif v==g -> b-r+2*diff;
    # else r-g+4*diff
    h_raw = torch.where(v == r, g - b,
                        torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hdiv_d = torch.where(
        diff > 0, torch.div(2 * (180 << _HSV_SHIFT) + 6 * diff,
                            torch.clamp(12 * diff, min=1), rounding_mode="floor"),
        zero)
    h = (h_raw * hdiv_d + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


# ------------------------------------------------------------- CIELAB (u8)
# The float math of the JAX package's jnp Lab rung (D65, sRGB gamma), used
# by CLAHE on face crops, RGB channel order, written out as the JITTED JAX
# function computes it on an x86-64 CPU (the form the serving tick runs):
#   - XLA turns each division by a constant into a product with the f32
#     reciprocal and folds chains of constant products into one f32
#     constant (`_k`);
#   - LLVM contracts a*b + c into a fused multiply-add, the left product
#     first (`_fma`: the f32 product is exact in float64, so a*b + c there
#     rounds once before the f32 rounding);
#   - the powers and the cube root (powf(|t|, f32(1/3)) with t's sign) are
#     calls of glibc's powf, which ops/powf.py computes bit for bit.
# Over all 2^24 inputs both conversions equal the jitted function exactly.

_f32 = np.float32
_LAB_XN = 0.950456
_LAB_ZN = 1.088754
_LAB_EPS = float(_f32(0.008856))
_LAB_K = float(_f32(16.0 / 116.0))


def _k(*factors: float) -> float:
    """The product of `factors`, each rounded to f32 and multiplied in f32
    from the left (XLA's constant folding)."""
    p = _f32(factors[0])
    for f in factors[1:]:
        p = _f32(p * _f32(f))
    return float(p)


def _inv(c: float) -> float:
    return float(_f32(1.0) / _f32(c))


def _fma(a: torch.Tensor, b: float, c) -> torch.Tensor:
    """f32 a*b + c rounded once, as a fused multiply-add."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.copysign(powf(t.abs(), 1.0 / 3.0), t)


def _srgb_to_linear_table() -> torch.Tensor:
    """_srgb_to_linear(u8 / 255) for the 256 u8 values (f32)."""
    c = torch.arange(256, dtype=torch.float32)
    v = c * _inv(255.0)
    return torch.where(v <= _k(0.04045), c * _k(_inv(255.0), _inv(12.92)),
                       powf((v + _k(0.055)) * _inv(1.055), 2.4))


_SRGB_TO_LINEAR = _srgb_to_linear_table()


def _q_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)


def _mix3(a, ka, b, kb, c, kc):
    """a*ka + b*kb + c*kc as LLVM contracts it: fma(c, kc, fma(a, ka, b*kb))."""
    return _fma(c, kc, _fma(a, ka, b * kb))


def rgb_to_lab_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 RGB -> (..., 3) u8 Lab (L scaled *255/100, a/b +128)."""
    lin = _SRGB_TO_LINEAR.to(rgb_u8.device)[rgb_u8.to(torch.int64)]
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    xs = _mix3(r, _k(0.412453), g, _k(0.357580), b, _k(0.180423))
    y = _mix3(r, _k(0.212671), g, _k(0.715160), b, _k(0.072169))
    zs = _mix3(r, _k(0.019334), g, _k(0.119193), b, _k(0.950227))
    # one cube root over the three channels: f(t) of CIELAB for t = X/Xn, Y,
    # Z/Zn, the cube root above the knee, else 7.787*t + 16/116 (7.787/white
    # folded into the slope of X and Z, which enter unscaled)
    t = torch.stack([xs * _inv(_LAB_XN), y, zs * _inv(_LAB_ZN)])
    above = t > _LAB_EPS
    cb = _cbrt(t)
    fx = torch.where(above[0], cb[0], _fma(xs, _k(7.787, _inv(_LAB_XN)), _LAB_K))
    fy = torch.where(above[1], cb[1], _fma(y, _k(7.787), _LAB_K))
    fz = torch.where(above[2], cb[2], _fma(zs, _k(7.787, _inv(_LAB_ZN)), _LAB_K))
    L = torch.where(above[1], _fma(cb[1], 116.0, -16.0), y * _k(903.3))
    a = _fma(fx - fy, 500.0, 128.0)
    bb = _fma(fy - fz, 200.0, 128.0)
    return torch.stack([_q_u8(L * _k(255.0, _inv(100.0))), _q_u8(a), _q_u8(bb)], dim=-1)


def _linear_to_srgb_u8(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    s = torch.where(c <= _k(0.0031308), c * _k(12.92),
                    _fma(powf(c, 1.0 / 2.4), _k(1.055), -_k(0.055)))
    return _q_u8(s * 255.0)


def lab_to_rgb_u8(lab_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 Lab -> (..., 3) u8 RGB."""
    lab = lab_u8.to(torch.float32)
    l8 = lab[..., 0]
    L = l8 * _k(100.0, _inv(255.0))
    fy = (L + 16.0) * _inv(116.0)
    fx = _fma(lab[..., 1] - 128.0, _inv(500.0), fy)
    fz = _fma(-(lab[..., 2] - 128.0), _inv(200.0), fy)

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > _LAB_EPS, t3, (t - _LAB_K) * _inv(7.787))

    # X and Z stay unscaled: the white point folds into their coefficients
    x, z = finv(fx), finv(fz)
    y = torch.where(L > 8.0, fy * fy * fy, l8 * _k(100.0, _inv(255.0), _inv(903.3)))
    ky = (_k(1.537150), _k(1.875991), _k(0.204043))
    r = _fma(-z, _k(0.498535, _LAB_ZN), _fma(x, _k(3.240479, _LAB_XN), -(y * ky[0])))
    # a negative leading constant makes LLVM contract the other product
    g = _fma(z, _k(0.041556, _LAB_ZN), _fma(y, ky[1], x * _k(-0.969256, _LAB_XN)))
    b = _fma(z, _k(1.057311, _LAB_ZN), _fma(x, _k(0.055648, _LAB_XN), -(y * ky[2])))
    return _linear_to_srgb_u8(torch.stack([r, g, b], dim=-1))


# The same jnp Lab pair as the JAX package's host path calls it, outside jit
# (pipeline/detector.preprocess_face_quality's `jnp` rung): every jnp op is a
# computation of its own, so each product, quotient and sum rounds to f32 in
# source order, with no reciprocal, no constant folding and no contraction;
# the powers and cube roots are glibc's powf as above. Both conversions equal
# the JAX functions called eagerly on the CPU (tests/test_torch_lab.py, every
# 17th of the 2^24 inputs).


def _lab_f_op_by_op(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _LAB_EPS, _cbrt(t), t * _k(7.787) + _LAB_K)


def rgb_to_lab_u8_op_by_op(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 RGB -> (..., 3) u8 Lab, the JAX rgb_to_lab_u8 op by op."""
    c = rgb_u8.to(torch.float32) / _k(255.0)
    lin = torch.where(c <= _k(0.04045), c / _k(12.92),
                      powf((c + _k(0.055)) / _k(1.055), 2.4))
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x = (r * _k(0.412453) + g * _k(0.357580) + b * _k(0.180423)) / _k(_LAB_XN)
    y = r * _k(0.212671) + g * _k(0.715160) + b * _k(0.072169)
    z = (r * _k(0.019334) + g * _k(0.119193) + b * _k(0.950227)) / _k(_LAB_ZN)
    fy = _lab_f_op_by_op(y)
    L = torch.where(y > _LAB_EPS, _cbrt(y) * _k(116.0) - _k(16.0), y * _k(903.3))
    a = (_lab_f_op_by_op(x) - fy) * _k(500.0) + _k(128.0)
    bb = (fy - _lab_f_op_by_op(z)) * _k(200.0) + _k(128.0)
    return torch.stack([_q_u8(L * _k(255.0) / _k(100.0)), _q_u8(a), _q_u8(bb)], dim=-1)


def lab_to_rgb_u8_op_by_op(lab_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 Lab -> (..., 3) u8 RGB, the JAX lab_to_rgb_u8 op by op."""
    lab = lab_u8.to(torch.float32)
    L = lab[..., 0] * _k(100.0) / _k(255.0)
    fy = (L + _k(16.0)) / _k(116.0)
    fx = fy + (lab[..., 1] - _k(128.0)) / _k(500.0)
    fz = fy - (lab[..., 2] - _k(128.0)) / _k(200.0)

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > _LAB_EPS, t3, (t - _LAB_K) / _k(7.787))

    y = torch.where(L > 8.0, fy * fy * fy, L / _k(903.3))
    x = finv(fx) * _k(_LAB_XN)
    z = finv(fz) * _k(_LAB_ZN)
    rgb = torch.stack([x * _k(3.240479) - y * _k(1.537150) - z * _k(0.498535),
                       x * _k(-0.969256) + y * _k(1.875991) + z * _k(0.041556),
                       x * _k(0.055648) - y * _k(0.204043) + z * _k(1.057311)], dim=-1)
    c = torch.clamp(rgb, 0.0, 1.0)
    s = torch.where(c <= _k(0.0031308), c * _k(12.92),
                    powf(c, 1.0 / 2.4) * _k(1.055) - _k(0.055))
    return _q_u8(s * _k(255.0))
