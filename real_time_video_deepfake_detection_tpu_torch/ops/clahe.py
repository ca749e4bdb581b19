"""CLAHE (contrast-limited adaptive histogram equalization).

The reference preprocesses every face crop with cv2.createCLAHE(
clipLimit=2.0, tileGridSize=(8,8)) on the LAB L channel
(deepfake_detection.py:357-370). Port of the JAX package's ops/clahe.py:

  - clahe_u8_numpy: the host implementation, copied as it stands:
    OpenCV's histogram clip with uniform redistribution and residual
    stepping, rounded CDF LUTs, bilinear LUT interpolation in float32, and
    cv2 5.0's literal padding rule for non-divisible sizes.
  - clahe_u8_batch = clahe_apply_batch(imgs, clahe_luts_batch(imgs)): the
    batched tick form in plain torch, bit-exact with clahe_u8_numpy for
    sizes divisible by the tile grid. It is the plain version of the two
    CUDA kernels in csrc/clahe.cu (kernels/clahe.py), which compute the
    same function.
"""

from __future__ import annotations

import numpy as np
import torch


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


# ------------------------------------------------------- batched (the tick)

def clip_count(clip_limit: float, area: int) -> int:
    """The per-bin histogram clip of a tile of `area` pixels (0: no clip)."""
    return max(int(clip_limit * area / 256), 1) if clip_limit > 0 else 0


def axis_fracs(n: int, t: int) -> np.ndarray:
    """Interpolation fraction toward the next tile of each of n coordinates
    (tile size t), in clahe_u8_numpy's global-coordinate f32 arithmetic:
    v * f32(1/t) - 0.5 minus its floor. The JAX package's _quadrant_fracs
    tables are these, rearranged by tile quadrant."""
    v = np.arange(n, dtype=np.float32)
    f = (v * np.float32(1.0 / t) - np.float32(0.5)).astype(np.float32)
    return (f - np.floor(f)).astype(np.float32)


def _grid(h: int, w: int, tiles: int):
    if h % tiles or w % tiles:
        raise ValueError(f"image size {(h, w)} is not divisible by the {tiles}x{tiles} grid")
    return h // tiles, w // tiles


def clahe_luts_batch(imgs: torch.Tensor, clip_limit: float = 2.0,
                     tiles: int = 8) -> torch.Tensor:
    """(B, H, W) u8 -> (B, tiles², 256) f32 per-tile LUTs, row-major over
    the tile grid: histogram, clip, OpenCV's batch and residual
    redistribution, CDF, and the LUT rint(cdf * fl64(255/area)) with the
    oracle's float64 product (bit-exact with _lut_for_tile).

    The JAX package's clahe_u8_batch instead divides cdf*255 by the area in
    integers and breaks exact .5 ties one fixed way; that misses the cases
    where the f64 product itself rounds onto .5 (at 20x20 tiles, cdf = 40
    gives 25.5 and 26), so its LUTs differ from the oracle on some entries."""
    b = imgs.shape[0]
    th, tw = _grid(imgs.shape[1], imgs.shape[2], tiles)
    area = th * tw
    t = imgs.reshape(b, tiles, th, tiles, tw).permute(0, 1, 3, 2, 4)
    t = t.reshape(b, tiles * tiles, area).to(torch.int64)
    hist = torch.zeros((b, tiles * tiles, 256), dtype=torch.int64, device=imgs.device)
    hist.scatter_add_(2, t, torch.ones_like(t))
    clip = clip_count(clip_limit, area)
    if clip > 0:
        clipped = torch.clamp(hist, max=clip)
        excess = (hist - clipped).sum(-1, keepdim=True)
        redist = excess // 256
        residual = excess - redist * 256
        step = torch.clamp(256 // torch.clamp(residual, min=1), min=1)
        idx = torch.arange(256, device=imgs.device)
        bump = (idx % step == 0) & (idx // step < residual)
        hist = clipped + redist + bump.to(torch.int64)
    lut = torch.round(torch.cumsum(hist, -1).to(torch.float64) * (255.0 / area))
    return torch.clamp(lut, 0, 255).to(torch.float32)


def clahe_apply_batch(imgs: torch.Tensor, luts: torch.Tensor,
                      tiles: int = 8) -> torch.Tensor:
    """(B, H, W) u8 + (B, tiles², 256) LUTs -> (B, H, W) u8: each pixel's
    four surrounding tile LUTs (clamped at the borders), blended with
    clahe_u8_numpy's f32 two-step lerp, rounded half to even."""
    b, h, w = imgs.shape
    th, tw = _grid(h, w, tiles)
    dev = imgs.device

    def axis(n, t):
        lo = np.floor(np.arange(n, dtype=np.float32) * np.float32(1.0 / t)
                      - np.float32(0.5)).astype(np.int64)
        a = torch.from_numpy(axis_fracs(n, t)).to(dev)
        return (torch.from_numpy(np.clip(lo, 0, tiles - 1)).to(dev),
                torch.from_numpy(np.clip(lo + 1, 0, tiles - 1)).to(dev), a)

    y1, y2, ya = axis(h, th)
    x1, x2, xa = axis(w, tw)
    v = imgs.to(torch.int64)
    flat = luts.reshape(b, -1)

    def look(ty, tx):
        cell = (ty[:, None] * tiles + tx[None, :]) * 256
        return torch.gather(flat, 1, (cell + v).reshape(b, -1)).reshape(b, h, w)

    ixa, iya = (1.0 - xa)[None, None, :], (1.0 - ya)[None, :, None]
    top = look(y1, x1) * ixa + look(y1, x2) * xa[None, None, :]
    bot = look(y2, x1) * ixa + look(y2, x2) * xa[None, None, :]
    out = top * iya + bot * ya[None, :, None]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def clahe_u8_batch(imgs: torch.Tensor, clip_limit: float = 2.0,
                   tiles: int = 8) -> torch.Tensor:
    """Batched CLAHE of the serving tick: (B, H, W) u8 -> (B, H, W) u8, H
    and W divisible by `tiles`; equals clahe_u8_numpy on every image."""
    return clahe_apply_batch(imgs, clahe_luts_batch(imgs, clip_limit, tiles), tiles)
