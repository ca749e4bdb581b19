"""Image resize, cv2-exact for u8 and half-pixel bilinear for float.

Port of real_time_video_deepfake_detection_tpu/ops/resize.py:

  - resize_bilinear_u8_cv2: cv2.resize(..., INTER_LINEAR) on uint8,
    bit-for-bit for downscale and identity, with OpenCV's fixed-point
    two-pass arithmetic (INTER_RESIZE_COEF_BITS=11, f32 residual positions)
    and its switch to 2x2 area averaging for exact 2x downscales.
  - resize_bilinear_f32: float half-pixel bilinear, matching
    torch.nn.functional.interpolate(mode="bilinear", align_corners=False).

The coefficient tables are the JAX package's numpy builders, copied as they
stand (f32 residuals, as resize.cpp computes them). The JAX package runs
the horizontal taps as one-hot matmuls for its TPU; here they are index
gathers — the same integers either way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # 2048


@functools.lru_cache(maxsize=None)
def _linear_tables(src: int, dst: int, clamp: bool = True):
    """OpenCV's per-axis sample indices and short coefficients.

    The residual is FLOAT32 end-to-end, exactly as resize.cpp computes it:
    `fxx = (float)((dx+0.5)*scale_x - 0.5); sx = cvFloor(fxx); fxx -= sx;`
    — computing it in f64 and casting late changes the rounded coefficient
    on ~3% of columns for e.g. 640->300."""
    scale = src / dst
    x = np.arange(dst, dtype=np.float64)
    fx = np.float32((x + 0.5) * scale - 0.5)   # double product, f32 cast
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(np.float32)).astype(np.float32)
    if clamp:
        fx = np.where(sx < 0, np.float32(0), fx)
        sx = np.maximum(sx, 0)
        fx = np.where(sx >= src - 1, np.float32(0), fx)
    # saturate_cast<short>(f * 2048) with cvRound (half-to-even)
    a1 = np.rint(fx * np.float32(_COEF_SCALE)).astype(np.int32)
    a0 = np.rint((np.float32(1) - fx) * np.float32(_COEF_SCALE)).astype(np.int32)
    sx1 = np.clip(sx + 1, 0, src - 1)
    sx = np.clip(sx, 0, src - 1)
    return sx, sx1, a0, a1


@functools.lru_cache(maxsize=None)
def _linear_tables_f32(src: int, dst: int):
    scale = src / dst
    x = np.arange(dst, dtype=np.float64)
    fx = (x + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx = np.where(sx < 0, 0.0, fx)
    sx = np.maximum(sx, 0)
    fx = np.where(sx >= src - 1, 0.0, fx)
    sx = np.minimum(sx, src - 1)
    sx1 = np.minimum(sx + 1, src - 1)
    return sx, sx1, (1.0 - fx).astype(np.float32), fx.astype(np.float32)


def _t(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(a, device=device, dtype=dtype)


def resize_bilinear_u8_cv2(img: torch.Tensor, dst_h: int, dst_w: int,
                           cv2_rows: bool = False) -> torch.Tensor:
    """cv2.resize(img, (dst_w, dst_h), interpolation=INTER_LINEAR) for uint8
    (..., H, W, C) or (H, W), bit-exact as the JAX package computes it.
    On a vertical upscale that copy zeroes the weights of the first and
    last output rows, where OpenCV keeps them and only clips the source
    rows (resize.cpp clamps the x offsets, not the y ones), which moves
    those rows by one level; `cv2_rows=True` keeps OpenCV's weights and
    equals cv2.resize everywhere (the trainer's loader, which the JAX
    package feeds with cv2 itself)."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    src_h, src_w = img.shape[-3], img.shape[-2]
    dev = img.device

    if src_h == dst_h and src_w == dst_w:
        out = img
    elif src_h == 2 * dst_h and src_w == 2 * dst_w:
        # OpenCV rewrites exact-2x INTER_LINEAR downscale to its INTER_AREA
        # fast path: mean of each 2x2 block with +2 rounding
        i32 = img.to(torch.int32)
        s = (i32[..., 0::2, 0::2, :] + i32[..., 0::2, 1::2, :]
             + i32[..., 1::2, 0::2, :] + i32[..., 1::2, 1::2, :])
        out = ((s + 2) >> 2).to(torch.uint8)
    else:
        sx, sx1, ax0, ax1 = _linear_tables(src_w, dst_w)
        sy, sy1, ay0, ay1 = _linear_tables(src_h, dst_h, not cv2_rows)
        x = img.to(torch.int32)
        P = x.index_select(-2, _t(sx, dev))
        Q = x.index_select(-2, _t(sx1, dev))
        # horizontal pass, scaled by 2^11 and brought down by 4 bits
        h = (_t(ax0, dev)[:, None] * P + _t(ax1, dev)[:, None] * Q) >> 4
        # vertical pass with OpenCV's exact fixed-point cast:
        # uchar(((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2
        s0 = h.index_select(-3, _t(sy, dev))
        s1 = h.index_select(-3, _t(sy1, dev))
        b0 = _t(ay0, dev)[:, None, None]
        b1 = _t(ay1, dev)[:, None, None]
        out = (((b0 * s0) >> 16) + ((b1 * s1) >> 16) + 2) >> 2
        out = torch.clamp(out, 0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out


def resize_bilinear_f32(img: torch.Tensor, dst_h: int, dst_w: int,
                        axes=(0, 1)) -> torch.Tensor:
    """Float bilinear with half-pixel centers, edge-clamped, over the two
    `axes` (rows, columns) of `img`: (H, W, ...) by default, as the JAX
    function; pass axes=(1, 2) for a (B, H, W, C) batch. uint8 input is
    converted to float32 first (the same values the JAX u8 path forms)."""
    ay_ax, ax_ax = axes
    src_h, src_w = img.shape[ay_ax], img.shape[ax_ax]
    dev = img.device
    sx, sx1, ax0, ax1 = _linear_tables_f32(src_w, dst_w)
    sy, sy1, ay0, ay1 = _linear_tables_f32(src_h, dst_h)
    x = img.to(torch.float32)

    def along(a, axis):
        shape = [1] * x.ndim
        shape[axis] = -1
        return _t(a, dev).reshape(shape)

    P = x.index_select(ax_ax, _t(sx, dev))
    Q = x.index_select(ax_ax, _t(sx1, dev))
    h = P * along(ax0, ax_ax) + Q * along(ax1, ax_ax)
    return (h.index_select(ay_ax, _t(sy, dev)) * along(ay0, ay_ax)
            + h.index_select(ay_ax, _t(sy1, dev)) * along(ay1, ay_ax))


@functools.lru_cache(maxsize=None)
def _dyn_f32_tables(dst: int, src_max: int):
    """Stacked per-source-extent tables for a crop whose extent is only
    known on the device: row `src` holds _linear_tables(src, dst), cv2's
    exact f32-residual indices and coefficients for that extent. Row 0
    mirrors row 1 (crop extents are floored at 1)."""
    shape = (src_max + 1, dst)
    sx_t = np.zeros(shape, np.int32)
    sx1_t = np.zeros(shape, np.int32)
    a0_t = np.zeros(shape, np.int32)
    a1_t = np.zeros(shape, np.int32)
    for src in range(1, src_max + 1):
        sx, sx1, a0, a1 = _linear_tables(src, dst)
        sx_t[src], sx1_t[src], a0_t[src], a1_t[src] = sx, sx1, a0, a1
    sx_t[0], sx1_t[0], a0_t[0], a1_t[0] = sx_t[1], sx1_t[1], a0_t[1], a1_t[1]
    return sx_t, sx1_t, a0_t, a1_t


_dyn_device_tables = {}


def _dyn_linear_tables(src_size: torch.Tensor, dst: int, src_max: int):
    """cv2 INTER_LINEAR indices and coefficients for device-side source
    extents (B,): one row of the _dyn_f32_tables per extent, (B, dst) each.
    Extents beyond src_max clamp to it (callers pass the enclosing image
    dimension, which bounds any crop)."""
    key = (dst, src_max, str(src_size.device))
    if key not in _dyn_device_tables:
        _dyn_device_tables[key] = tuple(
            _t(t, src_size.device) for t in _dyn_f32_tables(dst, src_max))
    i = torch.clamp(src_size.to(torch.int64), 0, src_max)
    return tuple(t[i] for t in _dyn_device_tables[key])


def crop_resize_u8_cv2(imgs: torch.Tensor, box_xywh: torch.Tensor,
                       dst_h: int, dst_w: int) -> torch.Tensor:
    """cv2.resize(img[y:y+h, x:x+w], (dst_w, dst_h), INTER_LINEAR) for each
    frame of a batch with its own (x, y, w, h) box, all on the device:
    imgs (B, H, W, C) u8, box_xywh (B, 4) i32 -> (B, dst_h, dst_w, C) u8,
    bit-exact with the static path above, the exact-2x area path included.

    The crop is an index gather of the two source rows and columns of each
    output pixel, then OpenCV's fixed-point arithmetic. The box is assumed
    clamped to the frame (the SSD postprocess guarantees it); w and h are
    floored at 1."""
    b, H, W, C = imgs.shape
    box = box_xywh.to(torch.int64)
    x0, y0 = box[:, 0], box[:, 1]
    w = torch.clamp(box[:, 2], min=1)
    h = torch.clamp(box[:, 3], min=1)
    sx, sx1, ax0, ax1 = _dyn_linear_tables(w, dst_w, W)
    sy, sy1, ay0, ay1 = _dyn_linear_tables(h, dst_h, H)
    gx = torch.clamp(x0[:, None] + sx, 0, W - 1)
    gx1 = torch.clamp(x0[:, None] + sx1, 0, W - 1)
    gy = torch.clamp(y0[:, None] + sy, 0, H - 1)
    gy1 = torch.clamp(y0[:, None] + sy1, 0, H - 1)

    flat = imgs.reshape(b, H * W, C)

    def taps(rows, cols):   # (B, dst_h, dst_w, C) int32
        idx = (rows[:, :, None] * W + cols[:, None, :]).reshape(b, -1, 1)
        return torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(
            b, dst_h, dst_w, C).to(torch.int32)

    p00, p01 = taps(gy, gx), taps(gy, gx1)
    p10, p11 = taps(gy1, gx), taps(gy1, gx1)
    a0, a1 = ax0[:, None, :, None], ax1[:, None, :, None]
    h0 = (a0 * p00 + a1 * p01) >> 4
    h1 = (a0 * p10 + a1 * p11) >> 4
    lin = (((ay0[:, :, None, None] * h0) >> 16)
           + ((ay1[:, :, None, None] * h1) >> 16) + 2) >> 2
    # exact-2x downscale: OpenCV's 2x2 area mean; for src == 2*dst the
    # tables select exactly the four area taps
    area = (p00 + p01 + p10 + p11 + 2) >> 2
    is_2x = ((h == 2 * dst_h) & (w == 2 * dst_w))[:, None, None, None]
    return torch.clamp(torch.where(is_2x, area, lin), 0, 255).to(torch.uint8)
