"""CLAHE (contrast-limited adaptive histogram equalization) on the host.

The reference preprocesses every face crop with cv2.createCLAHE(
clipLimit=2.0, tileGridSize=(8,8)) on the LAB L channel
(deepfake_detection.py:357-370). This is the numpy implementation of the
JAX package's ops/clahe.py (`clahe_u8_numpy`), copied as it stands:
OpenCV's histogram clip with uniform redistribution and residual stepping,
rounded CDF LUTs, bilinear LUT interpolation in float32, and cv2 5.0's
literal padding rule for non-divisible sizes. The batched device CLAHE is
not part of this package yet.
"""

from __future__ import annotations

import numpy as np


def _lut_for_tile(hist: np.ndarray, clip_limit: int, tile_area: int) -> np.ndarray:
    """Classic CLAHE LUT: clip, redistribute excess as uniform integer batch
    + residual stepped every (256//residual) bins starting at bin 0, then the
    rounded-CDF LUT. Verified bit-exact vs cv2 5.0 for tile-divisible images
    across areas 48..4096 (controlled-histogram probes; see tests).

    Non-divisible geometry: cv2 5.0 pads with its LITERAL rule (see
    _cv2_pad_amounts — a divisible dim gets a FULL extra tile when the
    other dim triggers padding); with that reproduced, non-divisible
    outputs match cv2 exactly up to the residual below.

    RESIDUAL DEVIATION (divisible sizes included): at certain tile sizes
    (empirically 10/18/20/22-px tiles) a <0.5% subset of pixels differs by
    +-1 from cv2 — f32 lerp values landing on rounding boundaries, where
    cv2's own result depends on its build's fma contraction (probes: exact
    two-step f32, fma-coordinate, fma-accumulation, f64, and fixed-point
    reconstructions each match a different subset). Bit-parity there is
    ill-defined against cv2-as-a-family; this implementation keeps numpy's
    two-step f32 arithmetic."""
    if clip_limit > 0:
        clipped = np.minimum(hist, clip_limit)
        excess = int(hist.sum() - clipped.sum())
        redist_batch = excess // 256
        residual = excess - redist_batch * 256
        clipped = clipped + redist_batch
        if residual:
            step = max(256 // residual, 1)
            idx = np.arange(0, 256, step)[:residual]
            clipped[idx] += 1
        hist = clipped
    scale = 255.0 / tile_area
    cdf = np.cumsum(hist)
    # cvRound: round-half-to-even
    return np.clip(np.rint(cdf * scale), 0, 255).astype(np.uint8)


def _cv2_pad_amounts(h: int, w: int, tiles: int):
    """cv2 5.0's LITERAL padding rule (clahe.cpp): when EITHER dimension is
    not tile-divisible, BOTH are padded by `tiles - dim % tiles` — which is
    a FULL EXTRA TILE for a dimension that was already divisible. Empirical
    discovery (this repo, vs cv2 5.0.0): a modulo pad (`(-dim) % tiles`)
    matches cv2 only when both dims are non-divisible; with exactly one
    divisible dim the tile geometry diverges and outputs differ by up to
    tens of grey levels. With this rule the non-divisible geometry matches
    cv2 exactly."""
    if h % tiles or w % tiles:
        return tiles - (h % tiles), tiles - (w % tiles)
    return 0, 0


def clahe_u8_numpy(src: np.ndarray, clip_limit: float = 2.0,
                   tiles: int = 8) -> np.ndarray:
    """cv2.createCLAHE(clip_limit, (tiles,tiles)).apply(src), bit-exact up
    to cv2's own build-dependent f32 lerp ties (see module docstring)."""
    h, w = src.shape
    ph, pw = _cv2_pad_amounts(h, w, tiles)
    tile_h = (h + ph) // tiles
    tile_w = (w + pw) // tiles
    img = np.pad(src, ((0, ph), (0, pw)), mode="reflect") if (ph or pw) else src
    H, W = img.shape

    tile_area = tile_h * tile_w
    if clip_limit > 0.0:
        clip = max(int(clip_limit * tile_area / 256), 1)
    else:
        clip = 0

    # Per-tile LUTs
    luts = np.empty((tiles, tiles, 256), np.uint8)
    for ty in range(tiles):
        for tx in range(tiles):
            tile = img[ty * tile_h:(ty + 1) * tile_h, tx * tile_w:(tx + 1) * tile_w]
            hist = np.bincount(tile.reshape(-1), minlength=256).astype(np.int64)
            luts[ty, tx] = _lut_for_tile(hist, clip, tile_area)

    # Bilinear interpolation between the 4 surrounding tile LUTs
    # (OpenCV CLAHE_Interpolation_Body): txf = x/tile_w - 0.5, etc.
    # Interpolation in float32 to match OpenCV's arithmetic (float64 here
    # flips occasional .5 ties).
    ys = np.arange(H, dtype=np.float32)
    xs = np.arange(W, dtype=np.float32)
    tyf = (ys * np.float32(1.0 / tile_h) - np.float32(0.5)).astype(np.float32)
    txf = (xs * np.float32(1.0 / tile_w) - np.float32(0.5)).astype(np.float32)
    ty1 = np.floor(tyf).astype(np.int64)
    tx1 = np.floor(txf).astype(np.int64)
    ya = (tyf - ty1).astype(np.float32)
    xa = (txf - tx1).astype(np.float32)
    ty1c = np.clip(ty1, 0, tiles - 1)
    ty2c = np.clip(ty1 + 1, 0, tiles - 1)
    tx1c = np.clip(tx1, 0, tiles - 1)
    tx2c = np.clip(tx1 + 1, 0, tiles - 1)

    v = img.astype(np.int64)
    lut_tl = luts[ty1c[:, None], tx1c[None, :], v].astype(np.float32)
    lut_tr = luts[ty1c[:, None], tx2c[None, :], v].astype(np.float32)
    lut_bl = luts[ty2c[:, None], tx1c[None, :], v].astype(np.float32)
    lut_br = luts[ty2c[:, None], tx2c[None, :], v].astype(np.float32)

    ixa = (np.float32(1.0) - xa)[None, :]
    iya = (np.float32(1.0) - ya)[:, None]
    top = lut_tl * ixa + lut_tr * xa[None, :]
    bot = lut_bl * ixa + lut_br * xa[None, :]
    out = top * iya + bot * ya[:, None]
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out[:h, :w]
