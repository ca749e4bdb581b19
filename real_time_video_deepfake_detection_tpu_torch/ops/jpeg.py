"""JPEG quality-90 re-compression round trip (for ELA), in int32 torch.

Port of real_time_video_deepfake_detection_tpu/ops/jpeg.py: libjpeg's
integer pipeline bit for bit, over (B, H, W, 3) BGR u8 batches with H and W
divisible by 16:

  BGR -> YCbCr (libjpeg fixed-point, SCALEBITS=16)
  -> 4:2:0 chroma downsample (h2v2, alternating +1/+2 bias)
  -> 8x8 islow forward DCT (jfdctint.c, CONST_BITS=13/PASS1_BITS=2)
  -> quantize with the IJG tables scaled to the quality
  -> dequantize -> islow inverse DCT (jidctint.c)
  -> h2v2 "fancy" (triangular) chroma upsample
  -> YCbCr -> BGR (libjpeg fixed-point) -> clamp u8

Integer semantics as in the JAX functions: `>>` on negative int32 is an
arithmetic shift in both, and quantization divides non-negative values, so
floor division is exact.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_STD_LUM = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.int32)

_STD_CHROM = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99]], np.int32)


@functools.lru_cache(maxsize=None)
def quant_table(quality: int, chroma: bool) -> np.ndarray:
    """jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    base = _STD_CHROM if chroma else _STD_LUM
    t = (base * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


_CONST_BITS = 13
_PASS1_BITS = 2
F_0_298631336 = 2446
F_0_390180644 = 3196
F_0_541196100 = 4433
F_0_765366865 = 6270
F_0_899976223 = 7373
F_1_175875602 = 9633
F_1_501321110 = 12299
F_1_847759065 = 15137
F_1_961570560 = 16069
F_2_053119869 = 16819
F_2_562915447 = 20995
F_3_072711026 = 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, pass1: bool):
    """One islow FDCT pass over 8 int32 lanes."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    tmp0, tmp7 = d0 + d7, d0 - d7
    tmp1, tmp6 = d1 + d6, d1 - d6
    tmp2, tmp5 = d2 + d5, d2 - d5
    tmp3, tmp4 = d3 + d4, d3 - d4
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    if pass1:
        o0 = (tmp10 + tmp11) << _PASS1_BITS
        o4 = (tmp10 - tmp11) << _PASS1_BITS
        dshift = _CONST_BITS - _PASS1_BITS
    else:
        o0 = _descale(tmp10 + tmp11, _PASS1_BITS)
        o4 = _descale(tmp10 - tmp11, _PASS1_BITS)
        dshift = _CONST_BITS + _PASS1_BITS

    z1 = (tmp12 + tmp13) * F_0_541196100
    o2 = _descale(z1 + tmp13 * F_0_765366865, dshift)
    o6 = _descale(z1 - tmp12 * F_1_847759065, dshift)

    z1 = tmp4 + tmp7
    z2 = tmp5 + tmp6
    z3 = tmp4 + tmp6
    z4 = tmp5 + tmp7
    z5 = (z3 + z4) * F_1_175875602
    t4 = tmp4 * F_0_298631336
    t5 = tmp5 * F_2_053119869
    t6 = tmp6 * F_3_072711026
    t7 = tmp7 * F_1_501321110
    z1 = z1 * (-F_0_899976223)
    z2 = z2 * (-F_2_562915447)
    z3 = z3 * (-F_1_961570560) + z5
    z4 = z4 * (-F_0_390180644) + z5

    o7 = _descale(t4 + z1 + z3, dshift)
    o5 = _descale(t5 + z2 + z4, dshift)
    o3 = _descale(t6 + z2 + z3, dshift)
    o1 = _descale(t7 + z1 + z4, dshift)
    return o0, o1, o2, o3, o4, o5, o6, o7


def fdct_islow(blocks: torch.Tensor) -> torch.Tensor:
    """jpeg_fdct_islow over (..., 8, 8) level-shifted int32 samples
    (rows, columns). Output is the DCT scaled by 8 (libjpeg convention)."""
    x = blocks.to(torch.int32)
    x = torch.stack(_fdct_1d([x[..., i] for i in range(8)], True), dim=-1)
    return torch.stack(_fdct_1d([x[..., i, :] for i in range(8)], False), dim=-2)


def _idct_1d(d, pass2: bool):
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    z1 = (d2 + d6) * F_0_541196100
    tmp2 = z1 + d6 * (-F_1_847759065)
    tmp3 = z1 + d2 * F_0_765366865
    tmp0 = (d0 + d4) << _CONST_BITS
    tmp1 = (d0 - d4) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = d7, d5, d3, d1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * F_1_175875602
    t0 = t0 * F_0_298631336
    t1 = t1 * F_2_053119869
    t2 = t2 * F_3_072711026
    t3 = t3 * F_1_501321110
    z1 = z1 * (-F_0_899976223)
    z2 = z2 * (-F_2_562915447)
    z3 = z3 * (-F_1_961570560) + z5
    z4 = z4 * (-F_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    shift = (_CONST_BITS + _PASS1_BITS + 3) if pass2 else (_CONST_BITS - _PASS1_BITS)
    return (_descale(tmp10 + t3, shift), _descale(tmp11 + t2, shift),
            _descale(tmp12 + t1, shift), _descale(tmp13 + t0, shift),
            _descale(tmp13 - t0, shift), _descale(tmp12 - t1, shift),
            _descale(tmp11 - t2, shift), _descale(tmp10 - t3, shift))


def idct_islow(coefs: torch.Tensor) -> torch.Tensor:
    """jpeg_idct_islow over (..., 8, 8) dequantized int32 coefficients:
    columns first, then rows. Returns centered samples."""
    x = coefs.to(torch.int32)
    x = torch.stack(_idct_1d([x[..., i, :] for i in range(8)], False), dim=-2)
    return torch.stack(_idct_1d([x[..., i] for i in range(8)], True), dim=-1)


_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)
_CBCR_OFFSET = 128 << _SCALEBITS


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def bgr_to_ycbcr_jpeg(bgr: torch.Tensor):
    """libjpeg rgb_ycc_convert (jccolor.c), bit-exact; int32 planes."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (_fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b
         + _ONE_HALF) >> _SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    cr = (_fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + _CBCR_OFFSET + _ONE_HALF - 1) >> _SCALEBITS
    return y, cb, cr


def ycbcr_to_bgr_jpeg(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """libjpeg ycc_rgb_convert (jdcolor.c), bit-exact, clamped u8 BGR."""
    yi = y.to(torch.int32)
    cbi = cb.to(torch.int32) - 128
    cri = cr.to(torch.int32) - 128
    r = yi + ((_fix(1.40200) * cri + _ONE_HALF) >> _SCALEBITS)
    b = yi + ((_fix(1.77200) * cbi + _ONE_HALF) >> _SCALEBITS)
    g = yi + ((-_fix(0.34414) * cbi + (-_fix(0.71414)) * cri
               + _ONE_HALF - 1) >> _SCALEBITS)
    return torch.clamp(torch.stack([b, g, r], dim=-1), 0, 255).to(torch.uint8)


def h2v2_downsample(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2_downsample over (..., h, w): 2x2 sum with the
    per-column alternating +1/+2 bias (jcsample.c)."""
    w = c.shape[-1]
    s = (c[..., 0::2, 0::2] + c[..., 0::2, 1::2]
         + c[..., 1::2, 0::2] + c[..., 1::2, 1::2]).to(torch.int32)
    bias = torch.where(torch.arange(w // 2, device=c.device) % 2 == 0, 1, 2)
    return (s + bias.to(torch.int32)) >> 2


def h2v2_fancy_upsample(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v2_fancy_upsample (jdsample.c) over (..., h, w) int32:
    triangular filter, bit-exact; output (..., 2h, 2w)."""
    h, w = c.shape[-2], c.shape[-1]
    ci = c.to(torch.int32)
    up = torch.cat([ci[..., :1, :], ci[..., :-1, :]], dim=-2)     # row above
    down = torch.cat([ci[..., 1:, :], ci[..., -1:, :]], dim=-2)   # row below

    def expand_row(colsum):
        left = torch.cat([colsum[..., :1], colsum[..., :-1]], dim=-1)
        right = torch.cat([colsum[..., 1:], colsum[..., -1:]], dim=-1)
        even = (colsum * 3 + left + 8) >> 4
        odd = (colsum * 3 + right + 7) >> 4
        # first output column (colsum*4 + 8) >> 4; last (colsum*4 + 7) >> 4
        even[..., 0] = (colsum[..., 0] * 4 + 8) >> 4
        odd[..., -1] = (colsum[..., -1] * 4 + 7) >> 4
        return torch.stack([even, odd], dim=-1).reshape(colsum.shape[:-1] + (2 * w,))

    even_rows = expand_row(ci * 3 + up)
    odd_rows = expand_row(ci * 3 + down)
    return torch.stack([even_rows, odd_rows], dim=-2).reshape(
        c.shape[:-2] + (2 * h, 2 * w))


def _neighbours(c: torch.Tensor, dim: int):
    """The previous and next sample along `dim`, the edge sample repeated."""
    n = c.shape[dim]
    first, last = c.narrow(dim, 0, 1), c.narrow(dim, n - 1, 1)
    prev = torch.cat([first, c.narrow(dim, 0, n - 1)], dim=dim)
    nxt = torch.cat([c.narrow(dim, 1, n - 1), last], dim=dim)
    return prev, nxt


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(even.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim=dim + 1 if dim >= 0 else dim).reshape(shape)


def h2v1_fancy_upsample(c: torch.Tensor) -> torch.Tensor:
    """libjpeg h2v1_fancy_upsample (jdsample.c) over (..., h, w): each
    sample gives 3/4 of itself and 1/4 of its left (+1) or right (+2)
    neighbour; the edge outputs equal the edge samples, which repeating the
    edge sample gives. Output (..., h, 2w)."""
    ci = c.to(torch.int32)
    left, right = _neighbours(ci, -1)
    return _interleave((ci * 3 + left + 1) >> 2, (ci * 3 + right + 2) >> 2, -1)


def h1v2_fancy_upsample(c: torch.Tensor) -> torch.Tensor:
    """libjpeg-turbo h1v2_fancy_upsample (jdsample.c) over (..., h, w): the
    same triangle filter down the columns, rows above (+1) and below (+2),
    the edge rows repeated as jdmainct.c's context rows are. Output
    (..., 2h, w)."""
    ci = c.to(torch.int32)
    up, down = _neighbours(ci, -2)
    return _interleave((ci * 3 + up + 1) >> 2, (ci * 3 + down + 2) >> 2, -2)


def _to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(..., h, w) -> (..., h/8, w/8, 8, 8)."""
    h, w = plane.shape[-2], plane.shape[-1]
    lead = plane.shape[:-2]
    x = plane.reshape(lead + (h // 8, 8, w // 8, 8))
    return x.transpose(-3, -2)


def _from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    lead = blocks.shape[:-4]
    hb, wb = blocks.shape[-4], blocks.shape[-3]
    return blocks.transpose(-3, -2).reshape(lead + (hb * 8, wb * 8))


def _roundtrip_plane(plane: torch.Tensor, qtab: np.ndarray) -> torch.Tensor:
    """plane (int32 sample range) -> DCT, quantize, dequantize, IDCT."""
    dct = fdct_islow(_to_blocks(plane.to(torch.int32) - 128))
    qt = torch.as_tensor(qtab, device=plane.device)
    q = qt << 3          # divisors are qval*8 (jcdctmgr.c)
    # quantize: round-half-away division
    a = torch.abs(dct)
    quant = torch.sign(dct) * torch.div(a + (q >> 1), q, rounding_mode="floor")
    spatial = torch.clamp(idct_islow(quant * qt) + 128, 0, 255)
    return _from_blocks(spatial)


def jpeg_roundtrip_bgr(bgr: torch.Tensor, quality: int = 90) -> torch.Tensor:
    """Encode+decode BGR u8 (..., H, W, 3) at the given JPEG quality (4:2:0,
    baseline, libjpeg defaults) — cv2.imdecode(cv2.imencode('.jpg', img,
    [IMWRITE_JPEG_QUALITY, q])[1]). H and W must be divisible by 16."""
    qlum, qchr = quant_table(quality, False), quant_table(quality, True)
    y, cb, cr = bgr_to_ycbcr_jpeg(bgr)
    y2 = _roundtrip_plane(y, qlum)
    cb2 = _roundtrip_plane(h2v2_downsample(cb), qchr)
    cr2 = _roundtrip_plane(h2v2_downsample(cr), qchr)
    return ycbcr_to_bgr_jpeg(y2, h2v2_fancy_upsample(cb2), h2v2_fancy_upsample(cr2))
