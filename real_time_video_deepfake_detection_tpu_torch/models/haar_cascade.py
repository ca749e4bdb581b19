"""Viola-Jones Haar cascade evaluator without cv2: the `haar_native` rung of
the face-detector ladder (pipeline/faces.py).

Port of real_time_video_deepfake_detection_tpu/models/haar_cascade.py.
With no SSD caffemodel, and with a cv2 that has no CascadeClassifier (cv2
5.0 removed it), this is the reference's effective detector
(face_detection.py:19-31,108-123: scaleFactor 1.1, minNeighbors 5,
minSize (30, 30), CASCADE_SCALE_IMAGE), run on the standard OpenCV cascade
XML (haarcascade_frontalface_default.xml, which distro packages still ship).

Semantics follow OpenCV's CascadeClassifierImpl::detectMultiScale for stump
HAAR cascades:

  * image pyramid: for factor = 1, x scaleFactor, ...: the image is resized
    (cv2 INTER_LINEAR, fixed point) while the 24x24 window stays fixed;
    windows are scaled back by `factor` (cvRound, half to even);
  * window step 2 px, 1 px once factor > 2;
  * variance normalisation over the window inset by 1 px (22x22):
    featureVal = sum_r(w_r * rectsum_r) / nf, nf = sqrt(area*sqsum - sum^2);
    setWindow rejects windows with nf2 <= 0 or area >= 0.1*nf (pixel std
    <= ~10) with runAt result -1 and no extra skip; a stage-0 rejection
    (result 0) also skips the next x position;
  * stump vote: leaf0 if featureVal < nodeThreshold else leaf1; a stage
    rejects when its vote sum (accumulated in float64) < stageThreshold;
  * groupRectangles(minNeighbors, eps=0.2).

Two evaluators give the same raw windows: the C++ one (csrc/haar.cpp via
utils/native_haar.py), which serving uses, and the vectorised numpy one
below, the plain version the tests hold it to (`detect_multiscale(
use_native=False)`). `use_native=True` means the library or an exception:
the JAX package's silent drop to numpy is not kept.
"""

from __future__ import annotations

import os
import threading
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.host_resize import resize_analysis

Box = Tuple[int, int, int, int]

CASCADE_XML = "haarcascade_frontalface_default.xml"

# Standard install locations of OpenCV's cascade XMLs (the data files
# survive where the cv2 module dropped the evaluator).
_XML_SEARCH_PATHS = (
    "/usr/share/opencv4/haarcascades",
    "/usr/share/opencv/haarcascades",
    "/usr/local/share/opencv4/haarcascades",
)


def find_cascade_xml(name: str = CASCADE_XML) -> Optional[str]:
    """The cascade XML: $HAARCASCADE_DIR first, then the distro paths. The
    JAX package also looks in cv2.data.haarcascades; the port has no cv2, so
    this is the JAX search on a host without cv2."""
    cands = []
    env = os.environ.get("HAARCASCADE_DIR")
    if env:
        cands.append(os.path.join(env, name))
    cands += [os.path.join(d, name) for d in _XML_SEARCH_PATHS]
    for c in cands:
        if os.path.isfile(c):
            return c
    return None


def bgr_to_gray_u8(frame_bgr: np.ndarray) -> np.ndarray:
    """cv2.COLOR_BGR2GRAY bit for bit: fixed-point BT.601 weights,
    y = (R*4899 + G*9617 + B*1868 + 8192) >> 14."""
    b = frame_bgr[..., 0].astype(np.int32)
    g = frame_bgr[..., 1].astype(np.int32)
    r = frame_bgr[..., 2].astype(np.int32)
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def _cv_round(x):
    """cvRound: round half to even (numpy's rint)."""
    return np.rint(x).astype(np.int64)


def resize_gray_linear(gray: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """u8 plane resize with cv2 INTER_LINEAR semantics, through the port's
    cv2-exact resize (exact for downscales; the pyramid only shrinks)."""
    if gray.shape == (dh, dw):
        return gray
    return resize_analysis(np.ascontiguousarray(gray), dh, dw)


@dataclass
class _Stage:
    threshold: float
    rects: np.ndarray        # (ntrees, 3, 4) int32 x, y, w, h; w == 0: unused
    weights: np.ndarray      # (ntrees, 3) float32
    node_thresh: np.ndarray  # (ntrees,) float32
    leaf0: np.ndarray        # (ntrees,) float32, taken when val <  node_thresh
    leaf1: np.ndarray        # (ntrees,) float32, taken when val >= node_thresh


class HaarCascade:
    """A parsed new-format (`opencv-cascade-classifier`) stump cascade."""

    def __init__(self, window: Tuple[int, int], stages: Sequence[_Stage]):
        self.win_w, self.win_h = window
        self.stages = list(stages)
        self._offset_cache: dict = {}
        self._native = None
        self._native_lock = threading.Lock()

    # ------------------------------------------------------------- parsing

    @classmethod
    def from_xml(cls, path: str) -> "HaarCascade":
        root = ET.parse(path).getroot()
        casc = root[0]
        if casc.get("type_id") != "opencv-cascade-classifier":
            raise ValueError(f"unsupported cascade format in {path} "
                             f"(old-style type_id={casc.get('type_id')!r})")
        if casc.findtext("featureType", "").strip() != "HAAR":
            raise ValueError("only HAAR featureType cascades are supported")
        w = int(casc.findtext("width"))
        h = int(casc.findtext("height"))

        feats = []
        for f in casc.find("features"):
            if f.findtext("tilted") and int(f.findtext("tilted")):
                raise ValueError("tilted features are not supported (the "
                                 "frontalface_default cascade has none)")
            rects = []
            for r in f.find("rects"):
                vals = r.text.split()
                rects.append((int(vals[0]), int(vals[1]), int(vals[2]),
                              int(vals[3]), float(vals[4])))
            feats.append(rects)

        stages = []
        for s in casc.find("stages"):
            st_thresh = float(s.findtext("stageThreshold"))
            wk = s.find("weakClassifiers")
            n = len(wk)
            rects = np.zeros((n, 3, 4), np.int32)
            weights = np.zeros((n, 3), np.float32)
            node_thresh = np.zeros(n, np.float32)
            leaf0 = np.zeros(n, np.float32)
            leaf1 = np.zeros(n, np.float32)
            for i, wc in enumerate(wk):
                nodes = wc.findtext("internalNodes").split()
                if len(nodes) != 4:
                    raise ValueError("only stump-based cascades are supported "
                                     f"(got {len(nodes) // 4} nodes)")
                fidx = int(nodes[2])
                node_thresh[i] = float(nodes[3])
                leaves = [float(v) for v in wc.findtext("leafValues").split()]
                leaf0[i], leaf1[i] = leaves[0], leaves[1]
                for k, (rx, ry, rw, rh, rwt) in enumerate(feats[fidx]):
                    rects[i, k] = (rx, ry, rw, rh)
                    weights[i, k] = rwt
            stages.append(_Stage(st_thresh, rects, weights, node_thresh, leaf0, leaf1))
        return cls((w, h), stages)

    # ---------------------------------------------------------- evaluation

    def _stage_offsets(self, stride: int):
        """Per stage, (ntrees, 12) flat corner offsets and signed weights for
        an integral image of row stride `stride`; corner signs follow
        rectsum = II[y,x] - II[y,x+w] - II[y+h,x] + II[y+h,x+w]."""
        cached = self._offset_cache.get(stride)
        if cached is not None:
            return cached
        out = []
        for st in self.stages:
            x = st.rects[:, :, 0].astype(np.int64)
            y = st.rects[:, :, 1].astype(np.int64)
            w = st.rects[:, :, 2].astype(np.int64)
            h = st.rects[:, :, 3].astype(np.int64)
            tl = y * stride + x
            tr = y * stride + x + w
            bl = (y + h) * stride + x
            br = (y + h) * stride + x + w
            offs = np.stack([tl, tr, bl, br], axis=-1).reshape(-1, 12)
            sw = (st.weights[:, :, None]
                  * np.array([1.0, -1.0, -1.0, 1.0], np.float32)).reshape(-1, 12)
            out.append((offs.astype(np.int64), sw.astype(np.float32)))
        if len(self._offset_cache) > 64:
            self._offset_cache.clear()
        self._offset_cache[stride] = out
        return out

    def _run_scale(self, gray: np.ndarray, ystep: int) -> np.ndarray:
        """All windows of one pyramid level: (N, 2) origins (x, y), in the
        level's coordinates, of the windows that pass every stage."""
        h, w = gray.shape
        ww, wh = self.win_w, self.win_h
        # OpenCV's processingRectSize = scaledImageSize - origWinSize, the
        # positions taken over [0, processingRectSize)
        nx = w - ww
        ny = h - wh
        if nx <= 0 or ny <= 0:
            return np.zeros((0, 2), np.int64)

        g = gray.astype(np.int64)
        ii = np.zeros((h + 1, w + 1), np.int64)
        np.cumsum(np.cumsum(g, 0), 1, out=ii[1:, 1:])
        ii2 = np.zeros((h + 1, w + 1), np.int64)
        np.cumsum(np.cumsum(g * g, 0), 1, out=ii2[1:, 1:])
        iif = ii.ravel().astype(np.float64)
        stride = w + 1

        xs0 = np.arange(0, nx, ystep, dtype=np.int64)
        ys0 = np.arange(0, ny, ystep, dtype=np.int64)
        wy, wx = np.meshgrid(ys0, xs0, indexing="ij")

        # setWindow over the 1 px inset normrect: a window is evaluated only
        # when nf2 = area*sqsum - sum^2 > 0 and area < 0.1*sqrt(nf2) (OpenCV's
        # `area*varianceNormFactor < 1e-1`). Its rejection makes runAt return
        # -1, which does not trigger the invoker's extra x skip; only a
        # stage-0 rejection (result 0) does.
        nr_w, nr_h = ww - 2, wh - 2
        area = float(nr_w * nr_h)
        y1, x1 = wy + 1, wx + 1
        s = (ii[y1 + nr_h, x1 + nr_w] - ii[y1 + nr_h, x1]
             - ii[y1, x1 + nr_w] + ii[y1, x1]).astype(np.float64)
        sq = (ii2[y1 + nr_h, x1 + nr_w] - ii2[y1 + nr_h, x1]
              - ii2[y1, x1 + nr_w] + ii2[y1, x1]).astype(np.float64)
        nf2 = area * sq - s * s
        nf = np.sqrt(np.maximum(nf2, 0.0))
        setwin_ok = (nf2 > 0.0) & (area < 0.1 * nf)
        inv_nf = np.zeros_like(nf2)
        np.divide(1.0, nf, out=inv_nf, where=setwin_ok)

        # stage 0 over the whole grid, then the sequential skip scan per
        # row: window j is skipped iff j-1 was evaluated (not itself
        # skipped), passed setWindow and was rejected by stage 0
        offs0, sw0 = self._stage_offsets(stride)[0]
        st0 = self.stages[0]
        base_grid = (wy * stride + wx).ravel()
        vals0 = iif[base_grid[:, None] + offs0.reshape(-1)[None, :]]
        vals0 = vals0.reshape(base_grid.shape[0], offs0.shape[0], 12)
        feat0 = np.einsum("ntc,tc->nt", vals0, sw0) * inv_nf.ravel()[:, None]
        votes0 = np.where(feat0 < st0.node_thresh[None, :],
                          st0.leaf0[None, :], st0.leaf1[None, :])
        pass0 = (votes0.sum(axis=1, dtype=np.float64)
                 >= np.float64(st0.threshold)).reshape(setwin_ok.shape)
        reject0 = setwin_ok & ~pass0
        skip = np.zeros_like(reject0)
        for j in range(1, reject0.shape[1]):
            skip[:, j] = reject0[:, j - 1] & ~skip[:, j - 1]
        alive = ~skip & setwin_ok & pass0

        idx = np.flatnonzero(alive.ravel())
        if idx.size == 0:
            return np.zeros((0, 2), np.int64)
        wyf = wy.ravel()[idx]
        wxf = wx.ravel()[idx]
        inv_nf = inv_nf.ravel()[idx]
        base = base_grid[idx]

        for (offs, sw), st in zip(self._stage_offsets(stride)[1:], self.stages[1:]):
            # (N, ntrees*12) gather -> weighted rect sums -> stump votes
            vals = iif[base[:, None] + offs.reshape(-1)[None, :]]
            vals = vals.reshape(base.shape[0], offs.shape[0], 12)
            feat = np.einsum("ntc,tc->nt", vals, sw) * inv_nf[:, None]
            votes = np.where(feat < st.node_thresh[None, :],
                             st.leaf0[None, :], st.leaf1[None, :])
            # float64 accumulation, as the C++ evaluator's double accumulator
            keep = votes.sum(axis=1, dtype=np.float64) >= np.float64(st.threshold)
            if not keep.any():
                return np.zeros((0, 2), np.int64)
            base = base[keep]
            inv_nf = inv_nf[keep]
            wyf = wyf[keep]
            wxf = wxf[keep]
        return np.stack([wxf, wyf], axis=1)

    def native(self):
        """This cascade's C++ evaluator (utils/native_haar.NativeHaar), made
        on first use; raises when the library cannot be built or loaded."""
        with self._native_lock:
            if self._native is None:
                from ..utils.native_haar import NativeHaar
                self._native = NativeHaar(self)
            return self._native

    def detect_multiscale(self, gray: np.ndarray, scale_factor: float = 1.1,
                          min_neighbors: int = 5,
                          min_size: Tuple[int, int] = (30, 30),
                          max_size: Optional[Tuple[int, int]] = None,
                          use_native: bool = True) -> List[Box]:
        """OpenCV `detectMultiScale` on a u8 grey (or BGR) image: the C++
        evaluator with use_native, else the numpy one; same boxes."""
        if gray.ndim == 3:
            gray = bgr_to_gray_u8(gray)
        if use_native:
            raw = self.native().detect_raw(gray, scale_factor, min_size, max_size)
        else:
            raw = self.detect_raw(gray, scale_factor, min_size, max_size)
        return group_rectangles(raw, min_neighbors)

    def detect_raw(self, gray: np.ndarray, scale_factor: float = 1.1,
                   min_size: Tuple[int, int] = (30, 30),
                   max_size: Optional[Tuple[int, int]] = None) -> List[Box]:
        """Every window of the pyramid before grouping (numpy evaluator)."""
        gray = np.ascontiguousarray(gray, np.uint8)
        H, W = gray.shape
        max_w = max_size[0] if max_size else W
        max_h = max_size[1] if max_size else H

        raw: List[Box] = []
        factor = 1.0
        while True:
            win_w = int(_cv_round(self.win_w * factor))
            win_h = int(_cv_round(self.win_h * factor))
            sw = int(_cv_round(W / factor))
            sh = int(_cv_round(H / factor))
            if sw - self.win_w <= 0 or sh - self.win_h <= 0:
                break
            if win_w > max_w or win_h > max_h:
                break
            if win_w < min_size[0] or win_h < min_size[1]:
                factor *= scale_factor
                continue
            scaled = resize_gray_linear(gray, sh, sw)
            ystep = 1 if factor > 2.0 else 2
            for x, y in self._run_scale(scaled, ystep):
                raw.append((int(_cv_round(x * factor)), int(_cv_round(y * factor)),
                            win_w, win_h))
            factor *= scale_factor
        return raw


# ---------------------------------------------------------------- grouping

def _similar(r1: Box, r2: Box, eps: float) -> bool:
    delta = eps * (min(r1[2], r2[2]) + min(r1[3], r2[3])) * 0.5
    return (abs(r1[0] - r2[0]) <= delta and abs(r1[1] - r2[1]) <= delta
            and abs(r1[0] + r1[2] - r2[0] - r2[2]) <= delta
            and abs(r1[1] + r1[3] - r2[1] - r2[3]) <= delta)


def group_rectangles(rects: List[Box], group_threshold: int,
                     eps: float = 0.2) -> List[Box]:
    """OpenCV groupRectangles: union-find partition under SimilarRects, the
    rounded mean of each class, classes with count <= group_threshold
    dropped, then small clusters inside larger ones suppressed."""
    n = len(rects)
    if n == 0:
        return []
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if _similar(rects[i], rects[j], eps):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj

    classes: dict = {}
    for i in range(n):
        classes.setdefault(find(i), []).append(rects[i])

    rrects, counts = [], []
    for members in classes.values():
        arr = np.asarray(members, np.float64)
        m = arr.sum(axis=0) / len(members)
        rrects.append(tuple(int(v) for v in _cv_round(m)))
        counts.append(len(members))

    out: List[Box] = []
    for i, (r1, n1) in enumerate(zip(rrects, counts)):
        if n1 <= group_threshold:
            continue
        suppressed = False
        for j, (r2, n2) in enumerate(zip(rrects, counts)):
            if j == i or n2 <= group_threshold:
                continue
            dx = int(r2[2] * eps)
            dy = int(r2[3] * eps)
            if (r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                    and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                    and r1[1] + r1[3] <= r2[1] + r2[3] + dy
                    and (n2 > max(3, n1) or n1 < 3)):
                suppressed = True
                break
        if not suppressed:
            out.append(r1)
    return out


# ------------------------------------------------------------- module API

_lock = threading.Lock()
_cascade: Optional[HaarCascade] = None


def native_haar_available() -> bool:
    return find_cascade_xml() is not None


def default_cascade() -> HaarCascade:
    """The frontal-face cascade of find_cascade_xml(), parsed once per
    process, with its C++ evaluator built and loaded: a missing XML or a
    failed build raises here."""
    global _cascade
    with _lock:
        if _cascade is None:
            path = find_cascade_xml()
            if path is None:
                raise FileNotFoundError(f"no {CASCADE_XML} found (set $HAARCASCADE_DIR)")
            cascade = HaarCascade.from_xml(path)
            cascade.native()
            _cascade = cascade
        return _cascade


def detect_haar_native(frame_bgr: np.ndarray) -> List[Box]:
    """The reference's `_detect_haar` (face_detection.py:108-123): BGR to
    grey, scaleFactor 1.1, minNeighbors 5, minSize (30, 30), on the C++
    evaluator."""
    gray = bgr_to_gray_u8(frame_bgr) if frame_bgr.ndim == 3 else frame_bgr
    return default_cascade().detect_multiscale(gray)
