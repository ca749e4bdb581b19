"""MTCNN (P-Net / R-Net / O-Net) face alignment in PyTorch.

Port of real_time_video_deepfake_detection_tpu/models/mtcnn.py. The
reference aligns every face crop with facenet-pytorch's MTCNN
(deepfake_detection.py:24-28: select_largest=False, post_process=False,
image_size 160). The nets are nn.Modules in NCHW with facenet-pytorch's
state-dict keys, so facenet's pnet.pt / rnet.pt / onet.pt load directly.
The detect flow is the JAX package's, batched over a leading axis in place
of vmap:

  - a static image pyramid (scales from the static input size, factor
    0.709, minsize 20), resampled with facenet's 'area' interpolation as
    two weight matrices times the image
  - fixed-capacity box lists (padded top-K and masks): no host sync inside
    the cascade, so one call queues all of its device work
  - NMS as masked O(K^2) suppression, a static loop over the K rows; stage
    1's per-scale NMS runs once over the scales stacked to (B, S, max_p)
  - R/O-Net patches: facenet's pad() integer crop and 'area' resample, as
    box-dependent weight matrices; the final crop is PIL's
    Image.BILINEAR (antialiased triangle, taps clipped to the crop)

Ordering is JAX's exactly: `_top_k` is a stable descending sort (ties
lowest index first, as jax.lax.top_k), NMS orders with a stable argsort
(jnp.argsort), the best face is the first maximum (jnp.argmax). A division
by a constant (a pyramid scale, the output size of PIL's resize) is a
product with its float32 reciprocal, as XLA compiles it in the JAX
package's jitted cascade: the quotient can differ in the last bit, and
generateBoundingBox floors it. The reciprocal is a float32 tensor on the
image's device, so the CPU and the card multiply alike. Compute is
float32; TF32 stays off, as everywhere in the port.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device

NETS = ("pnet", "rnet", "onet")
# the reference's MTCNN settings (facenet-pytorch's defaults, image_size 160)
IMAGE_SIZE, MINSIZE, FACTOR = 160, 20, 0.709

# ------------------------------------------------------------------ nets


def _matlab_flatten(x: torch.Tensor) -> torch.Tensor:
    """facenet's permute(0, 3, 2, 1) + flatten of an NCHW tensor."""
    return x.permute(0, 3, 2, 1).reshape(x.shape[0], -1)


class PNet(nn.Module):
    """(B, 3, H, W) normalized -> (probs (B, 2, h, w), reg (B, 4, h, w))."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 10, 3)
        self.prelu1 = nn.PReLU(10)
        self.conv2 = nn.Conv2d(10, 16, 3)
        self.prelu2 = nn.PReLU(16)
        self.conv3 = nn.Conv2d(16, 32, 3)
        self.prelu3 = nn.PReLU(32)
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.prelu1(self.conv1(x))
        x = F.max_pool2d(x, 2, 2, ceil_mode=True)
        x = self.prelu2(self.conv2(x))
        x = self.prelu3(self.conv3(x))
        return torch.softmax(self.conv4_1(x), dim=1), self.conv4_2(x)


class RNet(nn.Module):
    """(B, 3, 24, 24) -> (probs (B, 2), reg (B, 4))."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 28, 3)
        self.prelu1 = nn.PReLU(28)
        self.conv2 = nn.Conv2d(28, 48, 3)
        self.prelu2 = nn.PReLU(48)
        self.conv3 = nn.Conv2d(48, 64, 2)
        self.prelu3 = nn.PReLU(64)
        self.dense4 = nn.Linear(576, 128)
        self.prelu4 = nn.PReLU(128)
        self.dense5_1 = nn.Linear(128, 2)
        self.dense5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = self.prelu4(self.dense4(_matlab_flatten(self.prelu3(self.conv3(x)))))
        return torch.softmax(self.dense5_1(x), dim=1), self.dense5_2(x)


class ONet(nn.Module):
    """(B, 3, 48, 48) -> (probs (B, 2), reg (B, 4), landmarks (B, 10))."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3)
        self.prelu1 = nn.PReLU(32)
        self.conv2 = nn.Conv2d(32, 64, 3)
        self.prelu2 = nn.PReLU(64)
        self.conv3 = nn.Conv2d(64, 64, 3)
        self.prelu3 = nn.PReLU(64)
        self.conv4 = nn.Conv2d(64, 128, 2)
        self.prelu4 = nn.PReLU(128)
        self.dense5 = nn.Linear(1152, 256)
        self.prelu5 = nn.PReLU(256)
        self.dense6_1 = nn.Linear(256, 2)
        self.dense6_2 = nn.Linear(256, 4)
        self.dense6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = F.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
        x = F.max_pool2d(self.prelu3(self.conv3(x)), 2, 2, ceil_mode=True)
        x = self.prelu5(self.dense5(_matlab_flatten(self.prelu4(self.conv4(x)))))
        return (torch.softmax(self.dense6_1(x), dim=1), self.dense6_2(x),
                self.dense6_3(x))


NET_CLASSES = {"pnet": PNet, "rnet": RNet, "onet": ONet}


def build_nets(nets_or_state_dicts: Dict[str, Union[nn.Module, Dict[str, torch.Tensor]]],
               device: Union[str, torch.device]) -> Dict[str, nn.Module]:
    """{"pnet", "rnet", "onet"} -> the three modules on `device` in eval
    mode. A value may be a module or a facenet-keyed state dict (loaded
    strictly: a missing or unexpected key raises)."""
    out = {}
    for name in NETS:
        v = nets_or_state_dicts[name]
        if not isinstance(v, nn.Module):
            m = NET_CLASSES[name]()
            m.load_state_dict(v)
            v = m
        out[name] = v.to(device).eval()
    return out


def init_random_mtcnn(seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """Facenet-keyed state dicts holding the numpy draws of the JAX
    package's init_random_mtcnn(seed) (conv weights N(0, 0.1) drawn HWIO,
    dense N(0, 0.05) drawn (in, out), zero biases, PReLU 0.25), for tests
    and weightless runs."""
    from ..utils.convert import mtcnn_state_dicts_from_jax
    rng = np.random.default_rng(seed)

    def conv(cin, cout, k):
        return {"w": rng.standard_normal((k, k, cin, cout)).astype(np.float32) * 0.1,
                "b": np.zeros((cout,), np.float32)}

    def dense(cin, cout):
        return {"w": rng.standard_normal((cin, cout)).astype(np.float32) * 0.05,
                "b": np.zeros((cout,), np.float32)}

    def pr(c):
        return np.full((1, 1, 1, c), 0.25, np.float32)

    pnet = {"conv1": conv(3, 10, 3), "prelu1": pr(10),
            "conv2": conv(10, 16, 3), "prelu2": pr(16),
            "conv3": conv(16, 32, 3), "prelu3": pr(32),
            "conv4_1": conv(32, 2, 1), "conv4_2": conv(32, 4, 1)}
    rnet = {"conv1": conv(3, 28, 3), "prelu1": pr(28),
            "conv2": conv(28, 48, 3), "prelu2": pr(48),
            "conv3": conv(48, 64, 2), "prelu3": pr(64),
            "dense4": dense(576, 128), "prelu4": np.full((1, 128), 0.25, np.float32),
            "dense5_1": dense(128, 2), "dense5_2": dense(128, 4)}
    onet = {"conv1": conv(3, 32, 3), "prelu1": pr(32),
            "conv2": conv(32, 64, 3), "prelu2": pr(64),
            "conv3": conv(64, 64, 3), "prelu3": pr(64),
            "conv4": conv(64, 128, 2), "prelu4": pr(128),
            "dense5": dense(1152, 256), "prelu5": np.full((1, 256), 0.25, np.float32),
            "dense6_1": dense(256, 2), "dense6_2": dense(256, 4),
            "dense6_3": dense(256, 10)}
    return mtcnn_state_dicts_from_jax({"pnet": pnet, "rnet": rnet, "onet": onet})


# ----------------------------------------------------------- detect flow

def _normalize(x: torch.Tensor) -> torch.Tensor:
    """facenet preprocessing: (x - 127.5) * 0.0078125."""
    return (x - 127.5) * 0.0078125


def _recip(v: float) -> float:
    """float32(1) / float32(v): the factor XLA multiplies by in place of a
    division by the constant v."""
    return float(np.float32(1) / np.float32(v))


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jax.lax.top_k over the last axis: the k largest, descending, ties
    lowest index first (a stable descending sort, sliced)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., N, C), idx (..., K) -> (..., K, C)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              thresh: float, method_min: bool = False) -> torch.Tensor:
    """Greedy NMS over fixed K boxes, batched over leading axes: boxes
    (..., K, 4), scores and valid (..., K) -> keep mask (..., K). Boxes in
    score order (a stable sort, valid first) each suppress every later box
    whose IoU (Union, or Min with method_min) exceeds `thresh`, while kept:
    K rows of device work, no host sync."""
    k = boxes.shape[-2]
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    iy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    ix2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    iy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    if method_min:
        denom = torch.minimum(area[..., :, None], area[..., None, :])
    else:
        denom = area[..., :, None] + area[..., None, :] - inter
    iou = torch.where(denom > 0, inter / denom, torch.zeros_like(denom))

    order = torch.argsort(torch.where(valid, -scores, float("inf")), dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1)
    rows = torch.gather(iou, -2, order[..., :, None].expand(iou.shape))
    iou_s = torch.gather(rows, -1, order[..., None, :].expand(iou.shape))
    later = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    drops = (iou_s > thresh) & later
    keep = torch.gather(valid, -1, order)
    for i in range(k):   # keep > sup is keep & ~sup on booleans: two launches a row
        keep = keep > (drops[..., i, :] & keep[..., i:i + 1])
    return torch.gather(keep, -1, inv)


def _rerec(boxes: torch.Tensor) -> torch.Tensor:
    """Square boxes around their centre (facenet rerec)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w, h = x2 - x1, y2 - y1
    l = torch.maximum(w, h)
    cx, cy = x1 + w * 0.5, y1 + h * 0.5
    return torch.stack([cx - l / 2, cy - l / 2, cx + l / 2, cy + l / 2], dim=-1)


def _bbreg(boxes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """facenet bbreg: regression scaled by w = x2 - x1 + 1 (the +1 of stages
    2 and 3; stage 1's inline regression has none)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w, h = x2 - x1 + 1.0, y2 - y1 + 1.0
    return torch.stack([x1 + reg[..., 0] * w, y1 + reg[..., 1] * h,
                        x2 + reg[..., 2] * w, y2 + reg[..., 3] * h], dim=-1)


def _adaptive_weights_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix of torch's 'area' interpolation
    (adaptive_avg_pool): output i averages input
    [floor(i*n_in/n_out), ceil((i+1)*n_in/n_out))."""
    W = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        s = (i * n_in) // n_out
        e = -((-(i + 1) * n_in) // n_out)
        W[i, s:e] = 1.0 / (e - s)
    return W


def _area_resize_static(x: torch.Tensor, Wh: torch.Tensor, Ww: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, sh, sw, C) with the (sh, H) and (sw, W) area
    matrices."""
    y = torch.einsum("oh,bhwc->bowc", Wh, x)
    return torch.einsum("pw,bowc->bopc", Ww, y)


def _adaptive_weights_dyn(start: torch.Tensor, length: torch.Tensor, n_out: int,
                          n_src: int) -> torch.Tensor:
    """Area-interpolation weights for the crops [start, start + length) of a
    static-size axis, with start and length int32 tensors (...,). Returns
    (..., n_out, n_src)."""
    dev = start.device
    i = torch.arange(n_out, dtype=torch.int32, device=dev)
    L = torch.clamp(length, min=1)[..., None]
    s = torch.div(i * L, n_out, rounding_mode="floor")
    e = torch.div((i + 1) * L + (n_out - 1), n_out, rounding_mode="floor")
    j = torch.arange(n_src, dtype=torch.int32, device=dev)
    st = start[..., None]
    inside = (j >= (st + s)[..., None]) & (j < (st + e)[..., None])
    return inside.to(torch.float32) / torch.clamp(e - s, min=1)[..., None].to(torch.float32)


def _pil_weights_dyn(start: torch.Tensor, length: torch.Tensor, n_out: int,
                     n_src: int) -> torch.Tensor:
    """PIL Image.BILINEAR resize weights for the crops [start, start +
    length): a triangle filter whose support scales with the downscale
    factor, taps clipped to the crop and renormalized (PIL
    precompute_coeffs). start, length: int32 (...,). Returns (..., n_out,
    n_src)."""
    dev = start.device
    L = torch.clamp(length, min=1).to(torch.float32)
    scale = L * L.new_full((), _recip(n_out))
    support = torch.clamp(scale, min=1.0)
    centers = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * scale[..., None]
    j = torch.arange(n_src, dtype=torch.float32, device=dev)
    rel = j - start.to(torch.float32)[..., None] + 0.5
    w = torch.clamp(1.0 - torch.abs(rel[..., None, :] - centers[..., :, None])
                    / support[..., None, None], min=0.0)
    st = start[..., None]
    inside = (j >= st) & (j < st + torch.clamp(length, min=1)[..., None])
    w = w * inside[..., None, :]
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)


def _extract_patch_area(img: torch.Tensor, boxes: torch.Tensor, out: int) -> torch.Tensor:
    """facenet pad() (trunc, then clamp to the image) + integer crop + 'area'
    resample to (out, out, 3): img (B, H, W, 3), boxes (B, R, 4) float ->
    (B, R, out, out, 3)."""
    h, w = img.shape[1], img.shape[2]
    b = torch.trunc(boxes).to(torch.int32)
    x = torch.clamp(b[..., 0], min=1)
    y = torch.clamp(b[..., 1], min=1)
    ex = torch.clamp(b[..., 2], max=w)
    ey = torch.clamp(b[..., 3], max=h)
    Wv = _adaptive_weights_dyn(y - 1, ey - (y - 1), out, h)
    Wu = _adaptive_weights_dyn(x - 1, ex - (x - 1), out, w)
    patch = torch.einsum("broh,bhwc->browc", Wv, img)
    return torch.einsum("brpw,browc->bropc", Wu, patch)


def _extract_face_pil(img: torch.Tensor, boxes: torch.Tensor, out: int) -> torch.Tensor:
    """facenet extract_face with margin 0 on a PIL image: the int-clipped
    crop + PIL BILINEAR resize. img (B, H, W, 3), boxes (B, 4) -> (B, out,
    out, 3)."""
    h, w = img.shape[1], img.shape[2]
    x1 = torch.trunc(torch.clamp(boxes[:, 0], min=0)).to(torch.int32)
    y1 = torch.trunc(torch.clamp(boxes[:, 1], min=0)).to(torch.int32)
    x2 = torch.trunc(torch.clamp(boxes[:, 2], max=w)).to(torch.int32)
    y2 = torch.trunc(torch.clamp(boxes[:, 3], max=h)).to(torch.int32)
    Wv = _pil_weights_dyn(y1, y2 - y1, out, h)
    Wu = _pil_weights_dyn(x1, x2 - x1, out, w)
    face = torch.einsum("boh,bhwc->bowc", Wv, img)
    return torch.einsum("bpw,bowc->bopc", Wu, face)


def pyramid_scales(h: int, w: int) -> List[float]:
    """facenet detect_face's image-pyramid scales for a static (h, w)."""
    m = 12.0 / MINSIZE
    minl = min(h, w) * m
    scales = []
    s = m
    while minl >= 12:
        scales.append(s)
        s *= FACTOR
        minl *= FACTOR
    return scales


# static pyramid constants by (h, w, device): the area matrices and the
# float32 reciprocal of each level's scale, built once so that the cascade
# copies nothing from the host. The host aligner sees a new crop size for
# almost every face, so the cache is an LRU of PYRAMID_CACHE sizes, the
# bound the JAX aligner puts on its compiled sizes (max_compiled=64).
PYRAMID_CACHE = 64
_pyramids: "OrderedDict[tuple, list]" = OrderedDict()
_pyramids_lock = threading.Lock()


def _pyramid(h: int, w: int, device: torch.device) -> list:
    key = (h, w, str(device))
    with _pyramids_lock:
        levels = _pyramids.pop(key, None)
        if levels is None:
            levels = []
            for scale in pyramid_scales(h, w):
                sh, sw = int(h * scale + 1), int(w * scale + 1)
                levels.append((torch.from_numpy(_adaptive_weights_np(h, sh)).to(device),
                               torch.from_numpy(_adaptive_weights_np(w, sw)).to(device),
                               torch.tensor(_recip(scale), dtype=torch.float32).to(device)))
            if len(_pyramids) >= PYRAMID_CACHE:
                _pyramids.popitem(last=False)         # least recently used
        _pyramids[key] = levels
    return levels


@torch.no_grad()
def mtcnn_align_batch(nets: Dict[str, nn.Module], img_rgb: torch.Tensor, *,
                      image_size: int = IMAGE_SIZE, thresholds=(0.6, 0.7, 0.7),
                      max_p: int = 64, max_r: int = 16, max_o: int = 8):
    """The full P/R/O cascade over B images of one static size, the JAX
    package's mtcnn_detect_static on each (facenet-pytorch detect_face stage
    by stage). img_rgb: (B, H, W, 3) float RGB 0-255 on the nets' device.
    Returns (faces (B, image_size, image_size, 3) f32 raw-range RGB, scores
    (B,), boxes (B, 4)); a score <= 0 means no face passed the cascade (the
    caller's `mtcnn(img) is None`). The default box caps are the in-tick
    aligner's, as in the JAX package (an SSD face crop holds at most one
    face); the host aligner passes larger ones."""
    bsz, h, w = img_rgb.shape[:3]
    dev = img_rgb.device
    t1, t2, t3 = thresholds
    img = img_rgb.to(torch.float32)
    levels = _pyramid(h, w, dev)
    if not levels:
        raise ValueError(f"a {h}x{w} image has no pyramid level at minsize {MINSIZE}")

    # ---- P-Net over the area-resampled pyramid, each level's top max_p
    boxes_l, vals_l, regs_l, valid_l = [], [], [], []
    for Wh, Ww, inv_scale in levels:
        probs, reg = nets["pnet"](_normalize(_area_resize_static(img, Wh, Ww)).permute(0, 3, 1, 2))
        gw = probs.shape[3]
        p = probs[:, 1].reshape(bsz, -1)
        k = min(max_p, p.shape[1])
        vals, idx = _top_k(p, k)
        ix = (idx % gw).to(torch.float32)
        iy = torch.div(idx, gw, rounding_mode="floor").to(torch.float32)
        # generateBoundingBox: stride 2, cell 12, unregressed
        boxes = torch.floor(torch.stack(
            [(2.0 * ix + 1.0) * inv_scale, (2.0 * iy + 1.0) * inv_scale,
             (2.0 * ix + 12.0) * inv_scale, (2.0 * iy + 12.0) * inv_scale], dim=-1))
        rr = _gather_rows(reg.permute(0, 2, 3, 1).reshape(bsz, -1, 4), idx)
        pad = max_p - k
        boxes_l.append(F.pad(boxes, (0, 0, 0, pad)))
        vals_l.append(F.pad(vals, (0, pad)))
        regs_l.append(F.pad(rr, (0, 0, 0, pad)))
        valid_l.append(F.pad(vals >= t1, (0, pad), value=False))
    # per-scale NMS, all scales in one pass: levels do not interact before
    # the cross-scale top-k, and padded entries are invalid
    vals = torch.stack(vals_l, 1)
    keep = _nms_mask(torch.stack(boxes_l, 1), vals, torch.stack(valid_l, 1), 0.5)
    scores = torch.where(keep, vals, 0.0).reshape(bsz, -1)
    boxes = torch.cat(boxes_l, 1)
    regs = torch.cat(regs_l, 1)

    vals, idx = _top_k(scores, max_p)
    boxes, regs = _gather_rows(boxes, idx), _gather_rows(regs, idx)
    keep = _nms_mask(boxes, vals, vals > 0, 0.7)            # cross-scale NMS
    scores = torch.where(keep, vals, 0.0)
    # stage-1 regression after the NMS, inline convention (no +1)
    x1, y1, x2, y2 = boxes.unbind(-1)
    regw, regh = x2 - x1, y2 - y1
    boxes = _rerec(torch.stack([x1 + regs[..., 0] * regw, y1 + regs[..., 1] * regh,
                                x2 + regs[..., 2] * regw, y2 + regs[..., 3] * regh], dim=-1))

    # ---- R-Net stage
    vals, idx = _top_k(scores, max_r)
    rboxes = _gather_rows(boxes, idx)
    patches = _normalize(_extract_patch_area(img, rboxes, 24))
    probs, reg = nets["rnet"](patches.reshape(-1, 24, 24, 3).permute(0, 3, 1, 2))
    p, reg = probs[:, 1].reshape(bsz, max_r), reg.reshape(bsz, max_r, 4)
    rscores = torch.where((p > t2) & (vals > 0), p, 0.0)
    keep = _nms_mask(rboxes, rscores, rscores > 0, 0.7)     # on the raw boxes
    rscores = torch.where(keep, rscores, 0.0)
    rboxes = _rerec(_bbreg(rboxes, reg))

    # ---- O-Net stage (regression before the 'Min'-IoU NMS)
    vals, idx = _top_k(rscores, max_o)
    oboxes = _gather_rows(rboxes, idx)
    patches = _normalize(_extract_patch_area(img, oboxes, 48))
    probs, reg, _pts = nets["onet"](patches.reshape(-1, 48, 48, 3).permute(0, 3, 1, 2))
    p, reg = probs[:, 1].reshape(bsz, max_o), reg.reshape(bsz, max_o, 4)
    oscores = torch.where((p > t3) & (vals > 0), p, 0.0)
    oboxes = _bbreg(oboxes, reg)
    keep = _nms_mask(oboxes, oscores, oscores > 0, 0.7, method_min=True)
    oscores = torch.where(keep, oscores, 0.0)

    # the highest-probability face (select_largest=False: facenet takes the
    # first box of its score-ordered NMS output)
    best = torch.argmax(oscores, dim=1, keepdim=True)
    best_score = torch.gather(oscores, 1, best)[:, 0]
    best_box = _gather_rows(oboxes, best)[:, 0]
    face = _extract_face_pil(img, best_box, image_size)
    return face.contiguous(), best_score, best_box


class MTCNNAligner:
    """The reference's aligner: BGR face crop -> aligned 160x160 RGB float
    (raw 0-255), or None when no face is found in the crop
    (deepfake_detection.py:376-383).

    `nets`: {"pnet", "rnet", "onet"} modules or facenet-keyed state dicts.
    `device`: None means CUDA (raising when it is absent); pass "cpu" to
    run on the CPU. Eager torch compiles nothing per input size; what it
    keeps per size is the pyramid's matrices, in an LRU of PYRAMID_CACHE
    sizes, the bound of the JAX aligner's `max_compiled`."""

    MAX_P, MAX_R, MAX_O = 256, 64, 16

    def __init__(self, nets, thresholds=(0.6, 0.7, 0.7),
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.nets = build_nets(nets, self.device)
        self.thresholds = thresholds

    @classmethod
    def from_weights(cls, path_or_dir: str,
                     device: Optional[Union[str, torch.device]] = None) -> "MTCNNAligner":
        """Load facenet-pytorch's pnet.pt / rnet.pt / onet.pt (a directory)
        or one .pt holding the three state dicts with "pnet." / "rnet." /
        "onet." prefixes. Always weights_only=True: these are plain tensor
        state dicts, and this path feeds the serving bootstrap
        (--mtcnn-weights), so a file that needs a full unpickle is refused."""
        if os.path.isdir(path_or_dir):
            sds = {net: torch.load(os.path.join(path_or_dir, f"{net}.pt"),
                                   map_location="cpu", weights_only=True) for net in NETS}
        else:
            sd = torch.load(path_or_dir, map_location="cpu", weights_only=True)
            sds = {net: {k[len(net) + 1:]: v for k, v in sd.items()
                         if k.startswith(net + ".")} for net in NETS}
        return cls(sds, device=device)

    def detect(self, face_bgr: np.ndarray):
        """(aligned (IMAGE_SIZE, IMAGE_SIZE, 3) RGB f32 raw-range, score,
        box) or (None, 0.0, None)."""
        h, w = face_bgr.shape[:2]
        if min(h, w) < MINSIZE or not pyramid_scales(h, w):
            return None, 0.0, None
        rgb = torch.from_numpy(np.ascontiguousarray(face_bgr[..., ::-1], dtype=np.float32))
        face, score, box = mtcnn_align_batch(
            self.nets, rgb[None].to(self.device), thresholds=self.thresholds,
            max_p=self.MAX_P, max_r=self.MAX_R, max_o=self.MAX_O)
        score = float(score[0])
        if score <= 0.0:
            return None, 0.0, None
        return face[0].cpu().numpy(), score, box[0].cpu().numpy()

    def __call__(self, face_bgr: np.ndarray) -> Optional[np.ndarray]:
        return self.detect(face_bgr)[0]
