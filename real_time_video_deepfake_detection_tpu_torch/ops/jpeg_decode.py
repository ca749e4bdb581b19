"""JPEG reconstruction from quantised DCT coefficients, in int32 torch.

Port of real_time_video_deepfake_detection_tpu/ops/jpeg_decode.py
(`samples_from_coefs`, `bgr_from_ycbcr420`, `bgr_from_coefs_420`),
generalised by `bgr_from_components` to every stream the port's entropy
decoder accepts (csrc/jpeg_entropy.cpp): 1, 3 or 4 components, sampling
factors 1-4 in whole ratios, any image size, sequential or progressive.
The steps are libjpeg-turbo 2.1.5's default decode, bit for bit:

  dequantise -> jpeg_idct_islow + 128, clamped to [0, 255], as its x86
     SIMD routine computes it (`samples_islow_simd`: the same as the C
     routine for the coefficients of any real encoder, and for the
     out-of-range ones a damaged or cut arithmetic stream decodes to)
  -> each component cropped to its true size ceil(W*h/hmax) x
     ceil(H*v/vmax): libjpeg upsamples from the last real row and column
     (jdmainct.c set_bottom_pointers, jdsample.c), not the padded blocks
  -> upsampling as jdsample.c jinit_upsampler picks it: h2v2 and h2v1
     fancy when the component is wider than 2 samples, else replication;
     h1v2 fancy; any other whole ratio (4:1:1's h4v1, 4:1:0's h4v2) by
     replication (int_upsample)
  -> colour: ycc_rgb_convert for YCbCr, a channel swap for RGB, grayscale
     replicated to three channels (as IMREAD_COLOR returns it); CMYK as
     cv2.imdecode converts libjpeg's CMYK output to BGR, and YCCK through
     libjpeg's ycck_cmyk_convert first -> crop to H x W.

`scale=M` below 8 is libjpeg-turbo's DCT-scaled decode at M/8
(ops/jpeg_scaled.py): each component's scaled IDCT size, the output
ceil(H*M/8) x ceil(W*M/8), and no fancy filter when M is 1.

Runs on whatever device its tensors are on.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .jpeg import (
    F_0_298631336, F_0_390180644, F_0_541196100, F_0_765366865, F_0_899976223,
    F_1_175875602, F_1_501321110, F_1_847759065, F_1_961570560, F_2_053119869,
    F_2_562915447, F_3_072711026, h1v2_fancy_upsample, h2v1_fancy_upsample,
    h2v2_fancy_upsample, idct_islow, ycbcr_to_bgr_jpeg,
)
from .jpeg_scaled import component_sizes, idct_scaled, samples_reduced_simd, scaled_dims


def _blocks_to_plane_batch(samples: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, n_blocks, 64) spatial samples in block raster order -> (B, h, w)."""
    b = samples.shape[0]
    x = samples.reshape(b, h // 8, w // 8, 8, 8)
    return x.transpose(2, 3).reshape(b, h, w)


def samples_from_coefs(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """Dequantise and inverse-DCT one component's blocks: coef (B, nb, 64)
    int16 in natural order, qtab (B, 64) -> (B, nb, 64) int32 samples in
    [0, 255] (jpeg_idct_islow; the clamp equals libjpeg's range limit for
    the coefficients of any real encoder)."""
    deq = coef.to(torch.int32) * qtab.to(torch.int32)[:, None, :]
    b, nb, _ = deq.shape
    spatial = idct_islow(deq.reshape(b, nb, 8, 8)) + 128
    return torch.clamp(spatial, 0, 255).reshape(b, nb, 64)


def _wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + 32768) & 0xFFFF) - 32768


def _islow_simd_pass(d, shift: int):
    """One pass of libjpeg-turbo's SIMD islow (jidctint-avx2.asm and
    -sse2.asm, dodct) over 8 lanes of int16 values held in int32: the sums
    in0 +- in4, in7 + in3 and in5 + in1 wrap to 16 bits, the rotations are
    exact 32-bit pmaddwd pairs, each output saturates to 16 bits."""
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    tmp0 = _wrap16(d0 + d4) << 13
    tmp1 = _wrap16(d0 - d4) << 13
    tmp2 = d2 * F_0_541196100 + d6 * (F_0_541196100 - F_1_847759065)
    tmp3 = d2 * (F_0_541196100 + F_0_765366865) + d6 * F_0_541196100
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z3 = _wrap16(d7 + d3)
    z4 = _wrap16(d5 + d1)
    z3, z4 = (z3 * (F_1_175875602 - F_1_961570560) + z4 * F_1_175875602,
              z3 * F_1_175875602 + z4 * (F_1_175875602 - F_0_390180644))
    t0 = d7 * (F_0_298631336 - F_0_899976223) + d1 * -F_0_899976223 + z3
    t1 = d5 * (F_2_053119869 - F_2_562915447) + d3 * -F_2_562915447 + z4
    t2 = d5 * -F_2_562915447 + d3 * (F_3_072711026 - F_2_562915447) + z3
    t3 = d7 * -F_0_899976223 + d1 * (F_1_501321110 - F_0_899976223) + z4
    r = 1 << (shift - 1)
    return [torch.clamp((x + r) >> shift, -32768, 32767) for x in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1,
        tmp11 - t2, tmp10 - t3)]


def samples_islow_simd(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """jpeg_idct_islow as libjpeg-turbo's x86 SIMD routines compute it
    (the routine its decoder runs at full scale on an x86-64 host): coef
    (B, nb, 64) int16 in natural order, qtab (B, 64) -> (B, nb, 64) int32
    samples in [0, 255]. The dequantisation wraps to 16 bits; a block whose
    coefficient rows 1-7 are all zero takes the column pass's DC shortcut
    (its 16-bit shift wraps); the row pass saturates to 8 bits. CPU tensors
    take the C twin (utils/jpeg_ingest.idct_islow_host), the same bytes at a
    fraction of the time."""
    if coef.device.type == "cpu":
        from ..utils.jpeg_ingest import idct_islow_host
        return idct_islow_host(coef, qtab)
    return _samples_islow_simd_torch(coef, qtab)


def _samples_islow_simd_torch(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    c = coef.to(torch.int32)
    b, nb, _ = c.shape
    x = _wrap16(c * qtab.to(torch.int32)[:, None, :]).reshape(b, nb, 8, 8)
    ws = torch.stack(_islow_simd_pass([x[..., k, :] for k in range(8)], 11), dim=-2)
    dc_only = (c.reshape(b, nb, 8, 8)[..., 1:, :] == 0).all(-1).all(-1)
    ws = torch.where(dc_only[..., None, None], _wrap16(x[..., :1, :] << 2), ws)
    out = torch.stack(_islow_simd_pass([ws[..., k] for k in range(8)], 18), dim=-1)
    return (torch.clamp(out, -128, 127) + 128).reshape(b, nb, 64)


def bgr_from_ycbcr420(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Raw 4:2:0 planes -> (B, h, w, 3) u8 BGR. y (B, h, w); c (B, 2, h/2,
    w/2), Cb then Cr."""
    return ycbcr_to_bgr_jpeg(y, h2v2_fancy_upsample(c[:, 0]), h2v2_fancy_upsample(c[:, 1]))


def bgr_from_coefs_420(coef_y: torch.Tensor, coef_c: torch.Tensor,
                       qtab: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Quantised 4:2:0 coefficients -> (B, h, w, 3) u8 BGR; h, w % 16 == 0.
    coef_y (B, (h/8)(w/8), 64); coef_c (B, 2, (h/16)(w/16), 64); qtab
    (B, 2, 64) luma then chroma, natural order."""
    y = _blocks_to_plane_batch(samples_from_coefs(coef_y, qtab[:, 0]), h, w)
    c = torch.stack([_blocks_to_plane_batch(samples_from_coefs(coef_c[:, i], qtab[:, 1]),
                                            h // 2, w // 2) for i in range(2)], dim=1)
    return bgr_from_ycbcr420(y, c)


def _upsample(plane: torch.Tensor, sx: int, sy: int, fancy: bool = True) -> torch.Tensor:
    """(B, ch, cw) component at its true size, up by whole factors (sx,
    sy), as jdsample.c picks the method: h2v1 and h2v2 filter only when
    `fancy` (the smallest IDCT size is above 1) and the component is wider
    than 2 samples, h1v2 when `fancy`; everything else replicates."""
    small = not fancy or plane.shape[-1] <= 2
    if (sx, sy) == (2, 2) and not small:
        return h2v2_fancy_upsample(plane)
    if (sx, sy) == (2, 1) and not small:
        return h2v1_fancy_upsample(plane)
    if (sx, sy) == (1, 2) and fancy:
        return h1v2_fancy_upsample(plane)
    if sx > 1:
        plane = plane.repeat_interleave(sx, dim=-1)
    if sy > 1:
        plane = plane.repeat_interleave(sy, dim=-2)
    return plane


def _bgr_from_cmyk(c, m, y, k) -> torch.Tensor:
    """cv2's conversion of libjpeg's CMYK output (icvCvt_CMYK2BGR_8u_C4C3R):
    each of C, M, Y becomes k - ((255 - x) * k >> 8)."""
    k = k.to(torch.int32)
    out = [k - (((255 - x.to(torch.int32)) * k) >> 8) for x in (y, m, c)]
    return torch.stack(out, dim=-1).to(torch.uint8)


def planes_to_bgr(planes: Sequence[torch.Tensor], color: str) -> torch.Tensor:
    """Full-size component planes (B, H, W) -> (B, H, W, 3) u8 BGR for the
    colour space `color` ("gray", "ycbcr", "rgb", "cmyk" or "ycck")."""
    if color == "gray":
        return planes[0].to(torch.uint8)[..., None].expand(-1, -1, -1, 3).contiguous()
    if color == "ycbcr":
        return ycbcr_to_bgr_jpeg(*planes)
    if color == "rgb":
        return torch.stack([planes[2], planes[1], planes[0]], dim=-1).to(torch.uint8)
    if color == "cmyk":
        return _bgr_from_cmyk(*planes)
    if color == "ycck":   # jdcolor.c ycck_cmyk_convert: C, M, Y = 255 - R, G, B
        bgr = ycbcr_to_bgr_jpeg(*planes[:3]).to(torch.int32)
        return _bgr_from_cmyk(255 - bgr[..., 2], 255 - bgr[..., 1], 255 - bgr[..., 0],
                              planes[3])
    raise ValueError(f"unknown JPEG colour space {color!r}")


def bgr_from_components(coefs: Sequence[torch.Tensor], qtabs: torch.Tensor,
                        factors: Sequence[Tuple[int, int]], height: int,
                        width: int, scale: int = 8, color: str = "") -> torch.Tensor:
    """A batch of same-layout streams -> (B, ceil(height*scale/8),
    ceil(width*scale/8), 3) u8 BGR.

    coefs[c]: (B, bh_c, bw_c, 64) int16, component c's padded block grid in
    natural order; qtabs (B, n_components, 64); factors[c] = (h_c, v_c).
    `color` names the colour space (planes_to_bgr); by default one
    component is grayscale and three are YCbCr. `scale` in 1..8 is
    libjpeg's scale_num over a scale_denom of 8."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    sizes = component_sizes(factors, scale)
    out_h, out_w = scaled_dims(height, width, scale)
    planes = []
    for c, (coef, (h, v)) in enumerate(zip(coefs, factors)):
        b, bh, bw, _ = coef.shape
        k = sizes[c]
        if k in (2, 4, 8):   # the sizes libjpeg-turbo runs as SIMD routines
            flat = coef.reshape(b, bh * bw, 64)
            s = samples_islow_simd(flat, qtabs[:, c]) if k == 8 else (
                samples_reduced_simd(flat, qtabs[:, c], k))
            plane = s.reshape(b, bh, bw, k, k).transpose(2, 3).reshape(b, bh * k, bw * k)
        else:
            deq = coef.to(torch.int32) * qtabs[:, c].to(torch.int32)[:, None, None, :]
            blocks = idct_scaled(deq.reshape(b, bh, bw, 8, 8), k)
            plane = blocks.transpose(2, 3).reshape(b, bh * k, bw * k)
        ch = -(-height * v * k // (vmax * 8))
        cw = -(-width * h * k // (hmax * 8))
        up = _upsample(plane[:, :ch, :cw], hmax * scale // (h * k),
                       vmax * scale // (v * k), fancy=scale > 1)
        planes.append(up[:, :out_h, :out_w])
    return planes_to_bgr(planes, color or ("gray" if len(planes) == 1 else "ycbcr"))
