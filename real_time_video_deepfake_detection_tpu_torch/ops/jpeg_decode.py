"""JPEG reconstruction from quantised DCT coefficients, in int32 torch.

Port of real_time_video_deepfake_detection_tpu/ops/jpeg_decode.py
(`samples_from_coefs`, `bgr_from_ycbcr420`, `bgr_from_coefs_420`),
generalised by `bgr_from_components` to every stream the port's entropy
decoder accepts (csrc/jpeg_entropy.cpp): 1 or 3 components, sampling
factors 1-2, any image size. The steps are libjpeg's default decode, bit for
bit:

  dequantise -> jpeg_idct_islow + 128, clamped to [0, 255]
  -> each component cropped to its true size ceil(W*h/hmax) x
     ceil(H*v/vmax): libjpeg upsamples from the last real row and column
     (jdmainct.c set_bottom_pointers, jdsample.c), not the padded blocks
  -> upsampling as jdsample.c picks it: h2v2 and h2v1 fancy when the
     component is wider than 2 samples, else replication; h1v2 fancy
  -> ycc_rgb_convert (grayscale replicated to three channels, as
     IMREAD_COLOR returns it) -> crop to H x W.

Runs on whatever device its tensors are on.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .jpeg import (
    h1v2_fancy_upsample, h2v1_fancy_upsample, h2v2_fancy_upsample, idct_islow,
    ycbcr_to_bgr_jpeg,
)


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


def _upsample(plane: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """(B, ch, cw) component at its true size, up by (sx, sy) in {1, 2}."""
    small = plane.shape[-1] <= 2   # jdsample.c: no fancy h2 filter this narrow
    if (sx, sy) == (2, 2):
        if small:
            return plane.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
        return h2v2_fancy_upsample(plane)
    if (sx, sy) == (2, 1):
        return plane.repeat_interleave(2, dim=-1) if small else h2v1_fancy_upsample(plane)
    if (sx, sy) == (1, 2):
        return h1v2_fancy_upsample(plane)
    return plane


def bgr_from_components(coefs: Sequence[torch.Tensor], qtabs: torch.Tensor,
                        factors: Sequence[Tuple[int, int]], height: int,
                        width: int) -> torch.Tensor:
    """A batch of same-layout streams -> (B, height, width, 3) u8 BGR.

    coefs[c]: (B, bh_c, bw_c, 64) int16, component c's padded block grid in
    natural order; qtabs (B, n_components, 64); factors[c] = (h_c, v_c).
    One component is grayscale, three are YCbCr."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    planes = []
    for c, (coef, (h, v)) in enumerate(zip(coefs, factors)):
        b, bh, bw, _ = coef.shape
        s = samples_from_coefs(coef.reshape(b, bh * bw, 64), qtabs[:, c])
        plane = _blocks_to_plane_batch(s, bh * 8, bw * 8)
        ch, cw = -(-height * v // vmax), -(-width * h // hmax)
        up = _upsample(plane[:, :ch, :cw], hmax // h, vmax // v)
        planes.append(up[:, :height, :width])
    if len(planes) == 1:
        return planes[0].to(torch.uint8)[..., None].expand(-1, -1, -1, 3).contiguous()
    return ycbcr_to_bgr_jpeg(*planes)
