"""Color-space conversions, bit-matched to OpenCV's u8 paths.

Port of real_time_video_deepfake_detection_tpu/ops/color.py. Inputs are
(..., 3) uint8 tensors in OpenCV's BGR order (RGB for the Lab pair); the
integer paths run in int32 and are bit-exact with the JAX functions.
"""

from __future__ import annotations

import torch

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
# by host CLAHE on face crops. RGB channel order.

_LAB_XN = 0.950456
_LAB_ZN = 1.088754


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.sign(t) * torch.pow(torch.abs(t), 1.0 / 3.0)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def _q_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)


def rgb_to_lab_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 RGB -> (..., 3) u8 Lab (L scaled *255/100, a/b +128)."""
    lin = _srgb_to_linear(rgb_u8.to(torch.float32) / 255.0)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x = (0.412453 * r + 0.357580 * g + 0.180423 * b) / _LAB_XN
    y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    z = (0.019334 * r + 0.119193 * g + 0.950227 * b) / _LAB_ZN
    fy = _lab_f(y)
    L = torch.where(y > 0.008856, 116.0 * _cbrt(y) - 16.0, 903.3 * y)
    a = 500.0 * (_lab_f(x) - fy) + 128.0
    bb = 200.0 * (fy - _lab_f(z)) + 128.0
    return torch.stack([_q_u8(L * 255.0 / 100.0), _q_u8(a), _q_u8(bb)], dim=-1)


def lab_to_rgb_u8(lab_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) u8 Lab -> (..., 3) u8 RGB."""
    lab = lab_u8.to(torch.float32)
    L = lab[..., 0] * 100.0 / 255.0
    a = lab[..., 1] - 128.0
    bb = lab[..., 2] - 128.0
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - bb / 200.0

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > 0.008856, t3, (t - 16.0 / 116.0) / 7.787)

    y = torch.where(L > 8.0, fy * fy * fy, L / 903.3)
    x = finv(fx) * _LAB_XN
    z = finv(fz) * _LAB_ZN
    r = 3.240479 * x - 1.537150 * y - 0.498535 * z
    g = -0.969256 * x + 1.875991 * y + 0.041556 * z
    b = 0.055648 * x - 0.204043 * y + 1.057311 * z

    def to8(c):
        return _q_u8(_linear_to_srgb(c) * 255.0)
    return torch.stack([to8(r), to8(g), to8(b)], dim=-1)
