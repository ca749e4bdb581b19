"""Batched training augmentation on the device.

Port of real_time_video_deepfake_detection_tpu/train/augment.py (the
reference's per-sample CPU transform stack, train.py:442-513 + 282-309,
redesigned to run batched on the accelerator): the host only decodes and
resizes to (image_size + 20); random crop, hflip, colour jitter,
grayscale, one rotation/affine/perspective homography warp, gaussian blur,
normalize, random erasing, the JPEG-compression arm (the integer-exact
libjpeg round trip of ops/jpeg.py with one quality's tables per sample) and
gaussian noise run here, then mixup / cutmix (train.py:315-354).

Each transform is split into a draw and an apply. `draw_augment` takes
explicit generators and returns one tensor per name of `AUG_KEYS` (the
jitter's four factors as one (B, 4) entry, the homography as (B, 3, 3));
`apply_augment` is deterministic given them. `draw_mixup` draws the
per-batch scalars from a numpy Generator; `apply_mixup` is deterministic.
The JAX package draws from jax.random keys, which no torch generator
reproduces, so the applies are what is held to JAX: its draws can be fed
in.

Quirks kept from the JAX package: the JPEG arm reflect-pads the canvas to
a multiple of 16 and codes in BGR order; `erase_x` is drawn from
[1, size); the noise is added after normalization and clamped to [0, 1]
(the reference's train.py:302-309, 508-511); the jitter runs in a fixed
order; the homography's x and y translations come from one uniform draw.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.jpeg import jpeg_roundtrip_bgr_tables, quality_table_stack

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)

JPEG_QLO, JPEG_QHI = 20, 75
_QLUM, _QCHR = quality_table_stack(JPEG_QLO, JPEG_QHI)

# one named draw per random decision of the JAX package's augment_one
AUG_KEYS = ("jpeg_q", "jpeg_gate", "crop", "flip", "jitter", "gray",
            "homography", "blur_gate", "blur_sigma", "erase_gate",
            "erase_area", "erase_aspect", "erase_y", "erase_x",
            "noise_gate", "noise_std", "noise_vals")


def _uniform(n, lo, hi, g, shape=()) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand((n,) + shape, generator=g)


def _coin(n, p, g) -> torch.Tensor:
    return torch.rand(n, generator=g) < p


def solve_homography(dst_pts: torch.Tensor, src_pts: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) H with src = H @ dst (homogeneous), from (B, 4, 2)
    correspondences."""
    x, y = dst_pts[..., 0], dst_pts[..., 1]
    u, v = src_pts[..., 0], src_pts[..., 1]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([r1, r2], 2).reshape(x.shape[0], 8, 8)
    b = torch.stack([u, v], 2).reshape(x.shape[0], 8)
    h = torch.linalg.solve(a, b)
    return torch.cat([h, torch.ones_like(h[:, :1])], 1).reshape(-1, 3, 3)


def sample_homography(n: int, h: int, w: int, g: torch.Generator) -> torch.Tensor:
    """(n, 3, 3) output->input maps: rotation (±15°) + translation (8%) +
    scale (0.9-1.1) about the centre, then with p=0.3 a perspective that
    moves each corner by up to 15%."""
    angle = _uniform(n, -15.0, 15.0, g) * math.pi / 180
    shift = _uniform(n, -0.08, 0.08, g)     # the JAX package's one key for x and y
    tx, ty = shift * w, shift * h
    scale = _uniform(n, 0.9, 1.1, g)
    apply_p = _coin(n, 0.3, g)
    d = _uniform(n, 0.0, 0.15, g, (4, 2))

    cx, cy = w / 2.0, h / 2.0
    ca, sa, inv_s = torch.cos(angle), torch.sin(angle), 1.0 / scale
    a = torch.stack([torch.stack([ca * inv_s, sa * inv_s], -1),
                     torch.stack([-sa * inv_s, ca * inv_s], -1)], 1)   # (n, 2, 2)
    t = a @ torch.stack([-(cx + tx), -(cy + ty)], -1)[..., None]
    hm = torch.eye(3).repeat(n, 1, 1)
    hm[:, :2, :2] = a
    hm[:, :2, 2] = t[..., 0] + torch.tensor([cx, cy])
    src = torch.tensor([[0.0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]])
    dst = src + d * torch.tensor([[w, h], [-w, h], [-w, -h], [w, -h]], dtype=torch.float32)
    p = solve_homography(src.expand(n, 4, 2),
                         torch.where(apply_p[:, None, None], dst, src))
    return p @ hm


def draw_augment(n: int, big: int, size: int, generator: torch.Generator,
                 noise_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Every random decision of a batch of n samples (canvas big x big,
    output size x size): the per-sample scalars from `generator` (a CPU
    generator), the per-pixel noise from `noise_generator` (on the device
    the batch goes to; `generator` when None). All entries are returned on
    the noise generator's device."""
    g = generator
    ng = noise_generator or generator
    d = {
        "jpeg_q": torch.randint(0, JPEG_QHI - JPEG_QLO + 1, (n,), generator=g),
        "jpeg_gate": _coin(n, 0.5, g),
        "crop": torch.randint(0, big - size + 1, (n, 2), generator=g),
        "flip": _coin(n, 0.5, g),
        "jitter": torch.stack([_uniform(n, 0.7, 1.3, g), _uniform(n, 0.7, 1.3, g),
                               _uniform(n, 0.75, 1.25, g), _uniform(n, -0.08, 0.08, g)], 1),
        "gray": _coin(n, 0.08, g),
        "homography": sample_homography(n, size, size, g),
        "blur_gate": _coin(n, 0.2, g),
        "blur_sigma": _uniform(n, 0.1, 1.5, g),
        "erase_gate": _coin(n, 0.25, g),
        "erase_area": _uniform(n, 0.02, 0.2, g),
        "erase_aspect": _uniform(n, 0.3, 3.3, g),
        "erase_y": torch.randint(0, size, (n,), generator=g),
        "erase_x": torch.randint(1, size, (n,), generator=g),
        "noise_gate": _coin(n, 0.3, g),
        "noise_std": _uniform(n, 0.01, 0.04, g),
    }
    dev = ng.device
    d = {k: v.to(dev, non_blocking=True) for k, v in d.items()}
    d["noise_vals"] = torch.randn((n, size, size, 3), generator=ng, device=dev)
    return d


def _reflect_index(n: int, pad_lo: int, pad_hi: int, device) -> torch.Tensor:
    """Indices of numpy's "reflect" pad (the edge sample not repeated)."""
    idx = torch.arange(-pad_lo, n + pad_hi, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _reflect_pad_hw(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """(B, H, W, C) reflect-padded on H and W by lo before and hi after."""
    x = x.index_select(1, _reflect_index(x.shape[1], lo, hi, x.device))
    return x.index_select(2, _reflect_index(x.shape[2], lo, hi, x.device))


def _bcast(v: torch.Tensor) -> torch.Tensor:
    return v.view(-1, 1, 1, 1)


def color_jitter(x01: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, saturation and a YIQ-space hue rotation, in
    that fixed order; f (B, 4) holds the four factors."""
    b, c, s, hshift = (f[:, i] for i in range(4))
    x = torch.clamp(x01 * _bcast(b), 0, 1)
    gray = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    gm = _bcast(gray.mean(dim=(1, 2)))
    x = torch.clamp((x - gm) * _bcast(c) + gm, 0, 1)
    x = torch.clamp(gray[..., None] + (x - gray[..., None]) * _bcast(s), 0, 1)
    theta = hshift * 2 * math.pi
    ch, sh = torch.cos(theta), torch.sin(theta)
    t = torch.stack([
        torch.stack([0.299 + 0.701 * ch + 0.168 * sh, 0.587 - 0.587 * ch + 0.330 * sh,
                     0.114 - 0.114 * ch - 0.497 * sh], -1),
        torch.stack([0.299 - 0.299 * ch - 0.328 * sh, 0.587 + 0.413 * ch + 0.035 * sh,
                     0.114 - 0.114 * ch + 0.292 * sh], -1),
        torch.stack([0.299 - 0.300 * ch + 1.250 * sh, 0.587 - 0.588 * ch - 1.050 * sh,
                     0.114 + 0.886 * ch - 0.203 * sh], -1)], 1)   # (B, 3, 3)
    return torch.clamp(torch.einsum("bhwc,bdc->bhwd", x, t), 0, 1)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    den = torch.where(den.abs() < 1e-8, torch.where(den < 0, -1e-8, 1e-8), den)
    return num / den


def _coefs(hm: torch.Tensor):
    return [hm[:, i, j].view(-1, 1, 1) for i in range(3) for j in range(3)]


def warp_bilinear(img: torch.Tensor, hm: torch.Tensor) -> torch.Tensor:
    """img (B, h, w, C) f32, hm (B, 3, 3) output->input maps; zero fill
    outside the source. The JAX package's two-pass (Catmull-Smith)
    resampling: pass 1 resamples each column u at rows V2(y, u), pass 2
    each row y at columns U(y, x), each a 2-tap gather (the JAX package
    contracts (h, h, w) weight tensors on the MXU instead; the taps and
    weights are the same)."""
    n, h, w, ch = img.shape
    a, b, c, d, e, f, g, p, q = _coefs(hm)
    ys = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    den = g * xs + p * ys + q
    u = _safe_div(a * xs + b * ys + c, den)
    v = _safe_div(d * xs + e * ys + f, den)
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    # pass-1 rows: X(y, u) solves U(y, X) = u, then V2 = V(y, X)
    xx = _safe_div(b * ys + c - xs * (p * ys + q), xs * g - a)
    v2 = _safe_div(d * xx + e * ys + f, g * xx + p * ys + q)

    v2c = torch.clamp(v2, 0, h - 1)
    r0f = torch.floor(v2c)
    fv = (v2c - r0f)[..., None]
    r0 = r0f.long()
    r1 = torch.clamp(r0 + 1, max=h - 1)
    t = ((1 - fv) * torch.gather(img, 1, r0[..., None].expand(n, h, w, ch))
         + fv * torch.gather(img, 1, r1[..., None].expand(n, h, w, ch)))

    uc = torch.clamp(u, 0, w - 1)
    u0f = torch.floor(uc)
    fu = (uc - u0f)[..., None]
    u0 = u0f.long()
    u1 = torch.clamp(u0 + 1, max=w - 1)
    out = ((1 - fu) * torch.gather(t, 2, u0[..., None].expand(n, h, w, ch))
           + fu * torch.gather(t, 2, u1[..., None].expand(n, h, w, ch)))
    return torch.where(inb[..., None], out, 0.0)


def warp_bilinear_gather(img: torch.Tensor, hm: torch.Tensor) -> torch.Tensor:
    """The direct 2-D gather bilinear warp (the textbook form), the
    numeric reference of warp_bilinear's two passes."""
    n, h, w, ch = img.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device), indexing="ij")
    pts = torch.stack([xs, ys, torch.ones_like(xs)], -1).to(torch.float32)
    pts = torch.einsum("hwk,bjk->bhwj", pts, hm)
    u = pts[..., 0] / torch.clamp(pts[..., 2], min=1e-8)
    v = pts[..., 1] / torch.clamp(pts[..., 2], min=1e-8)
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    u, v = torch.clamp(u, 0, w - 1), torch.clamp(v, 0, h - 1)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    u1, v1 = torch.clamp(u0 + 1, max=w - 1), torch.clamp(v0 + 1, max=h - 1)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    bi = torch.arange(n, device=img.device).view(n, 1, 1)
    out = (img[bi, v0, u0] * (1 - fu) * (1 - fv) + img[bi, v0, u1] * fu * (1 - fv)
           + img[bi, v1, u0] * (1 - fu) * fv + img[bi, v1, u1] * fu * fv)
    return torch.where(inb[..., None], out, 0.0)


def gaussian_blur3(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """3x3 separable gaussian of per-sample sigma, reflect-padded."""
    taps = torch.tensor([-1.0, 0.0, 1.0], device=img.device)
    k = torch.exp(-(taps ** 2) / (2 * sigma.view(-1, 1) ** 2))
    k = k / k.sum(1, keepdim=True)
    h, w = img.shape[1], img.shape[2]
    p = _reflect_pad_hw(img, 1, 1)
    acc = sum(p[:, :, i:i + w] * _bcast(k[:, i]) for i in range(3))
    return sum(acc[:, j:j + h] * _bcast(k[:, j]) for j in range(3))


def apply_augment(imgs_u8: torch.Tensor, d: Dict[str, torch.Tensor], size: int) -> torch.Tensor:
    """(B, size+20, size+20, 3) RGB u8 and draw_augment's draws ->
    (B, size, size, 3) normalized float32."""
    n, big = imgs_u8.shape[0], imgs_u8.shape[1]
    dev = imgs_u8.device

    # JPEG compression arm, p=0.5, quality U{20..75}, in BGR order on a
    # canvas reflect-padded to a multiple of 16 (train.py:282-296)
    pad = (-big) % 16
    padded = _reflect_pad_hw(imgs_u8, 0, pad) if pad else imgs_u8
    q = d["jpeg_q"]
    qlum = torch.from_numpy(_QLUM).to(dev)[q]
    qchr = torch.from_numpy(_QCHR).to(dev)[q]
    jpeg = jpeg_roundtrip_bgr_tables(padded.flip(-1), qlum, qchr).flip(-1)[:, :big, :big]
    x = torch.where(_bcast(d["jpeg_gate"]), jpeg, imgs_u8).to(torch.float32)

    # random crop, hflip
    ar = torch.arange(size, device=dev)
    rows = d["crop"][:, 0, None] + ar
    cols = d["crop"][:, 1, None] + ar
    bi = torch.arange(n, device=dev).view(n, 1, 1)
    x = x[bi, rows[:, :, None], cols[:, None, :]]
    x = torch.where(_bcast(d["flip"]), x.flip(2), x)

    x01 = color_jitter(x / 255.0, d["jitter"])
    g = 0.299 * x01[..., 0] + 0.587 * x01[..., 1] + 0.114 * x01[..., 2]
    x01 = torch.where(_bcast(d["gray"]), g[..., None].expand_as(x01), x01)
    x01 = warp_bilinear(x01, d["homography"])
    x01 = torch.where(_bcast(d["blur_gate"]), gaussian_blur3(x01, d["blur_sigma"]), x01)

    mean = torch.tensor(_MEAN, device=dev)
    std = torch.tensor(_STD, device=dev)
    xn = (x01 - mean) / std

    # random erasing p=0.25, area .02-.2 of the image, aspect .3-3.3
    area = d["erase_area"] * size * size
    asp = d["erase_aspect"]
    eh = torch.clamp(torch.sqrt(area * asp), 1, size - 1).to(torch.int32)
    ew = torch.clamp(torch.sqrt(area / asp), 1, size - 1).to(torch.int32)
    ey, ex = d["erase_y"].view(-1, 1), d["erase_x"].view(-1, 1)
    in_y = (ar >= ey) & (ar < ey + eh.view(-1, 1))
    in_x = (ar >= ex) & (ar < ex + ew.view(-1, 1))
    emask = in_y[:, :, None, None] & in_x[:, None, :, None]
    xn = torch.where(_bcast(d["erase_gate"]) & emask, 0.0, xn)

    # gaussian noise p=0.3, std .01-.04, after normalization
    noised = torch.clamp(xn + d["noise_vals"] * _bcast(d["noise_std"]), 0.0, 1.0)
    return torch.where(_bcast(d["noise_gate"]), noised, xn)


def eval_preprocess_batch(imgs_u8: torch.Tensor) -> torch.Tensor:
    """Validation path: normalize only (images already at the size)."""
    x = imgs_u8.to(torch.float32) / 255.0
    mean = torch.tensor(_MEAN, device=x.device)
    std = torch.tensor(_STD, device=x.device)
    return (x - mean) / std


def draw_mixup(rng: np.random.Generator, n: int, h: int, w: int,
               mixup_alpha: float = 0.2, cutmix_alpha: float = 1.0) -> Optional[dict]:
    """The per-batch scalars of mixup_cutmix from a numpy Generator; None
    when both arms are disabled (an alpha <= 0 statically disables its arm,
    like the reference's `args.mixup_alpha > 0` gates, train.py:566-570)."""
    has_mix, has_cut = mixup_alpha > 0, cutmix_alpha > 0
    if not has_mix and not has_cut:
        return None
    return {
        "perm": rng.permutation(n),
        "lam_m": np.float32(rng.beta(mixup_alpha, mixup_alpha) if has_mix else 1.0),
        "lam_c0": np.float32(rng.beta(cutmix_alpha, cutmix_alpha) if has_cut else 1.0),
        "cy": int(rng.integers(0, h + 1)),
        "cx": int(rng.integers(0, w + 1)),
        "use_mix": bool(rng.random() < 0.5),
        # with one arm disabled, the coin always lands on the other
        "use_mixup": bool(rng.random() < 0.5) if (has_mix and has_cut) else has_mix,
    }


def apply_mixup(x: torch.Tensor, y: torch.Tensor, d: Optional[dict]):
    """50%-of-batches mixup-or-cutmix (train.py:563-577) given draw_mixup's
    draws. Returns (x, y_a, y_b, lam) with lam a float32 scalar tensor."""
    one = torch.ones((), dtype=torch.float32, device=x.device)
    if d is None or not d["use_mix"]:
        return x, y, y, one
    h, w = x.shape[1], x.shape[2]
    perm = torch.tensor(d["perm"], device=x.device)
    if d["use_mixup"]:
        lam = np.maximum(d["lam_m"], np.float32(1) - d["lam_m"])
        x_out = float(lam) * x + float(np.float32(1) - lam) * x[perm]
    else:
        cut = np.sqrt(np.float32(1) - d["lam_c0"])
        ch, cw = int(np.float32(h) * cut), int(np.float32(w) * cut)
        y1, y2 = max(0, d["cy"] - ch // 2), min(h, d["cy"] + ch // 2)
        x1, x2 = max(0, d["cx"] - cw // 2), min(w, d["cx"] + cw // 2)
        x_out = x.clone()
        x_out[:, y1:y2, x1:x2] = x[perm][:, y1:y2, x1:x2]
        lam = np.float32(1) - np.float32((y2 - y1) * (x2 - x1)) / np.float32(h * w)
    return x_out, y, y[perm], one * float(lam)
