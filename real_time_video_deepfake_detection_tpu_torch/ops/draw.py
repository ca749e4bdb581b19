"""cv2's drawing routines on BGR u8 frames, in integer numpy, without cv2.

The overlay of the JAX package's `DeepfakeDetector.predict` and the
`--gradcam` blend of its `cli/analyze.py` draw with cv2 (`rectangle`,
`getTextSize`, `putText` in FONT_HERSHEY_SIMPLEX, `addWeighted`,
`applyColorMap(COLORMAP_JET)`); these are cv2 5.0's results bit for bit
for what those callers draw: 8-connected (LINE_8) shapes in one solid
colour, so a shape is the set of pixels it paints, clipped to the frame.

The routines follow cv2's imgproc/drawing.cpp: points in 16-bit fixed
point (XY_SHIFT), a thick segment as a filled quadrilateral
(`_fill_convex_poly`) with filled circles at its joints (`_circle`), a
thin one as cv2's fixed-point DDA (`_line2`) after Cohen-Sutherland
clipping in the fixed-point frame (`_clip_line`). The font and the Jet
colormap are cv2's own data (ops/hershey.py).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

from . import hershey

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _cdiv(a: int, b: int) -> int:
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _cv_round(x: float) -> int:
    """cvRound: round half to even, as the FPU's default mode."""
    return int(round(x))


class _Painter:
    """Paints pixels of one colour into a (H, W, C) u8 frame, clipped."""

    def __init__(self, img: np.ndarray, color):
        self.img = img
        self.h, self.w = img.shape[:2]
        self.color = np.asarray(color, np.float64)[:img.shape[2]].round().clip(0, 255).astype(
            np.uint8)

    def hline(self, y: int, x1: int, x2: int) -> None:
        """Row y, columns x1..x2 inclusive (clipped by the caller)."""
        self.img[y, x1:x2 + 1] = self.color

    def points(self, xs: np.ndarray, ys: np.ndarray) -> None:
        keep = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        self.img[ys[keep], xs[keep]] = self.color


def _clip_line(w: int, h: int, p1, p2):
    """cv2's clipLine on a frame of w x h (in any fixed-point unit):
    (ok, p1, p2) with the ends moved onto the frame's border."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line(p: _Painter, p0, p1) -> None:
    """cv2's Line (LineIterator, 8-connected) between integer points; the
    rectangle's edges, the only caller, are horizontal or vertical."""
    (x0, y0), (x1, y1) = p0, p1
    if x0 != x1 and y0 != y1:
        raise ValueError("_line draws horizontal and vertical segments only")
    xs = np.arange(min(x0, x1), max(x0, x1) + 1)
    ys = np.arange(min(y0, y1), max(y0, y1) + 1)
    if x0 == x1:
        xs = np.full(len(ys), x0)
    else:
        ys = np.full(len(xs), y0)
    p.points(xs, ys)


def _line2(p: _Painter, pt1, pt2) -> None:
    """cv2's Line2: the 8-connected DDA between two XY_SHIFT points."""
    ok, pt1, pt2 = _clip_line(p.w << XY_SHIFT, p.h << XY_SHIFT, pt1, pt2)
    if not ok:
        return
    (x1, y1), (x2, y2) = pt1, pt2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, x2, y1, y2 = x2, x1, y2, y1
        step = _cdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    half = XY_ONE >> 1
    p.points(np.array([(x2 + half) >> XY_SHIFT]), np.array([(y2 + half) >> XY_SHIFT]))
    if ecount < 0:
        return
    k = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        p.points((x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT)
    else:
        p.points((x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k)


def _fill_convex_poly(p: _Painter, v: Sequence[Tuple[int, int]], shift: int) -> None:
    """cv2's FillConvexPoly (LINE_8): the edges, then the scan-line fill;
    `v` in `shift`-bit fixed point."""
    npts = len(v)
    delta = (1 << shift) >> 1
    half = XY_ONE >> 1
    up = XY_SHIFT - shift
    p0 = (v[-1][0] << up, v[-1][1] << up)
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i, (x, y) in enumerate(v):
        if y < ymin:
            ymin, imin = y, i
        ymax, xmax, xmin = max(ymax, y), max(xmax, x), min(xmin, x)
        q = (x << up, y << up)
        if shift == 0:
            _line(p, (p0[0] >> XY_SHIFT, p0[1] >> XY_SHIFT), (q[0] >> XY_SHIFT, q[1] >> XY_SHIFT))
        else:
            _line2(p, p0, q)
        p0 = q
    xmin, xmax = (xmin + delta) >> shift, (xmax + delta) >> shift
    ymin, ymax = (ymin + delta) >> shift, (ymax + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= p.w or ymin >= p.h:
        return
    ymax = min(ymax, p.h - 1)
    edges = npts
    # per edge: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    y = ymin
    while True:
        for e in edge:
            if y >= e[4]:
                idx0, di = e[0], e[1]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> shift
                    if ty > y:
                        xs, xe = v[idx0][0] << up, v[idx][0] << up
                        e[4] = ty
                        e[3] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e[2] = xs
                        e[0] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            xx1 = (edge[left][2] + half) >> XY_SHIFT
            xx2 = (edge[right][2] + half) >> XY_SHIFT
            if xx2 >= 0 and xx1 < p.w:
                p.hline(y, max(xx1, 0), min(xx2, p.w - 1))
        edge[0][2] += edge[0][3]
        edge[1][2] += edge[1][3]
        y += 1
        if y > ymax:
            break


def _circle(p: _Painter, cx: int, cy: int, radius: int) -> None:
    """cv2's Circle, filled (the midpoint circle's spans, clipped)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, x1, x2 in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < p.h and x1 < p.w and x2 >= 0:
                p.hline(yy, max(x1, 0), min(x2, p.w - 1))
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _thick_line(p: _Painter, p0, p1, thickness: int, flags: int, shift: int) -> None:
    """cv2's ThickLine for LINE_8: `flags` bit 0 / 1 puts a joint circle
    at p0 / p1."""
    up = XY_SHIFT - shift
    p0 = (p0[0] << up, p0[1] << up)
    p1 = (p1[0] << up, p1[1] << up)
    half = XY_ONE >> 1
    if thickness <= 1:
        if shift == 0:
            _line(p, tuple((c + half) >> XY_SHIFT for c in p0),
                  tuple((c + half) >> XY_SHIFT for c in p1))
        else:
            _line2(p, p0, p1)
        return
    dx = (p0[0] - p1[0]) / XY_ONE
    dy = (p1[1] - p0[1]) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > 2.220446049250313e-16:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        ddx, ddy = _cv_round(dy * r), _cv_round(dx * r)
        _fill_convex_poly(p, [(p0[0] + ddx, p0[1] + ddy), (p0[0] - ddx, p0[1] - ddy),
                              (p1[0] - ddx, p1[1] - ddy), (p1[0] + ddx, p1[1] + ddy)],
                          XY_SHIFT)
    for i in range(2):
        if flags & (i + 1):
            _circle(p, (p0[0] + half) >> XY_SHIFT, (p0[1] + half) >> XY_SHIFT,
                    (thickness + half) >> XY_SHIFT)
        p0 = p1


def _poly_line(p: _Painter, v, closed: bool, thickness: int, shift: int) -> None:
    """cv2's PolyLine."""
    i = len(v) - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = v[i]
    for i in range(0 if closed else 1, len(v)):
        _thick_line(p, p0, v[i], thickness, flags, shift)
        p0 = v[i]
        flags = 2


def rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color,
              thickness: int = 1) -> np.ndarray:
    """cv2.rectangle(img, pt1, pt2, color, thickness) with LINE_8, in
    place; thickness < 0 fills. Returns img."""
    p = _Painter(img, color)
    (x1, y1), (x2, y2) = (int(pt1[0]), int(pt1[1])), (int(pt2[0]), int(pt2[1]))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    if thickness >= 0:
        _poly_line(p, pts, True, thickness, 0)
    else:
        _fill_convex_poly(p, pts, 0)
    return img


def _glyph(c: str) -> str:
    code = ord(c)
    if code < 32 or code > 126:
        raise ValueError(f"FONT_HERSHEY_SIMPLEX draws printable ASCII only, got {c!r}")
    return hershey.GLYPHS[hershey.SIMPLEX[code - 32 + 1]]


def _bearings(glyph: str) -> Tuple[int, int]:
    return ord(glyph[0]) - ord("R"), ord(glyph[1]) - ord("R")


def get_text_size(text: str, font_scale: float, thickness: int) -> Tuple[Tuple[int, int], int]:
    """cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, font_scale, thickness):
    ((width, height), baseline)."""
    base_line = hershey.SIMPLEX[0] & 15
    cap_line = (hershey.SIMPLEX[0] >> 4) & 15
    height = _cv_round((cap_line + base_line) * font_scale + (thickness + 1) // 2)
    view_x = 0.0
    for c in text:
        left, right = _bearings(_glyph(c))
        view_x += (right - left) * font_scale
    width = _cv_round(view_x + thickness)
    return (width, height), _cv_round(base_line * font_scale + thickness * 0.5)


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], font_scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, font_scale, color,
    thickness) with LINE_8, in place. Returns img."""
    p = _Painter(img, color)
    hscale = vscale = _cv_round(font_scale * XY_ONE)
    view_x = int(org[0]) << XY_SHIFT
    view_y = (int(org[1]) << XY_SHIFT) - (hershey.SIMPLEX[0] & 15) * vscale
    for c in text:
        glyph = _glyph(c)
        left, right = _bearings(glyph)
        view_x -= left * hscale
        for stroke in glyph[2:].split(" "):
            pts = [((ord(stroke[k]) - ord("R")) * hscale + view_x,
                    (ord(stroke[k + 1]) - ord("R")) * vscale + view_y)
                   for k in range(0, len(stroke) - 1, 2)]
            if len(pts) > 1:
                _poly_line(p, pts, False, thickness, XY_SHIFT)
        view_x += right * hscale
    return img


def add_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float,
                 gamma: float = 0.0) -> np.ndarray:
    """cv2.addWeighted on u8: saturate(round(src1*alpha + src2*beta +
    gamma)), in float32 as cv2 computes it."""
    f32 = np.float32
    acc = src1.astype(f32) * f32(alpha) + src2.astype(f32) * f32(beta) + f32(gamma)
    return np.rint(acc).clip(0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _jet_lut() -> np.ndarray:
    """cv2's COLORMAP_JET table (256, 3) u8 BGR: its linear_colormap, i.e.
    interp1 of the base tables at their own 256 nodes, then a float32
    multiply by 255 and a round to nearest even, in float32 as cv2."""
    f32 = np.float32
    x = np.array([i * (1.0 / 255) for i in range(256)], f32)   # cv2's linspace(0, 1, 256)
    lut = np.zeros((256, 3), np.uint8)
    for ch, base in enumerate((hershey.JET_B, hershey.JET_G, hershey.JET_R)):
        yv = np.asarray(base, f32)
        out = np.empty(256, f32)
        for i in range(256):
            # interp1's binary search for x[i] among the nodes: low < i <= high
            low, high = 0, 255
            while high - low > 1:
                mid = low + ((high - low) >> 1)
                if x[i] > x[mid]:
                    low = mid
                else:
                    high = mid
            out[i] = yv[low] + f32(f32(x[i] - x[low]) * f32(yv[high] - yv[low])) / f32(
                x[high] - x[low])
        lut[:, ch] = np.rint(out * f32(255)).clip(0, 255).astype(np.uint8)
    return lut


def apply_colormap_jet(gray_u8: np.ndarray) -> np.ndarray:
    """cv2.applyColorMap(gray_u8, COLORMAP_JET): (H, W) u8 -> (H, W, 3) u8
    BGR."""
    return _jet_lut()[np.asarray(gray_u8, np.uint8)]
