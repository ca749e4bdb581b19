"""Caffe graph executor for SSD detectors, as an nn.Module.

Port of real_time_video_deepfake_detection_tpu/models/caffe_net.py. The
deploy.prototxt is parsed (utils/prototxt.py) and its layer list is run in
order on the caffemodel's blobs (utils/caffe_convert.py, no caffe
dependency). Supports the op set of SSD detectors (the res10_300x300 face
SSD and kin):

  Convolution, BatchNorm+Scale, ReLU, Pooling (MAX/AVE, Caffe's ceil mode),
  Eltwise (SUM/PROD/MAX), Permute, Flatten, Concat, Reshape, Softmax,
  PriorBox (numpy, per feature-map shape), DetectionOutput (decode, greedy
  NMS over a fixed top-k, score sort; batched over frames).

Blobs stay in Caffe's NCHW layout throughout (the JAX package keeps NHWC
and converts at Permute/Flatten/Concat/Reshape); the flattened orders are
Caffe's either way. Convolution weights are the caffemodel's OIHW blobs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.caffe_convert import load_caffemodel
from ..utils.prototxt import as_list, load_prototxt

# layer types whose caffemodel blobs the graph consumes
_WEIGHTED = ("Convolution", "BatchNorm", "Scale")


def _pool_out(size: int, k: int, s: int, p: int) -> int:
    """Caffe's pooled extent: ceil mode, minus a window that would start in
    the padding."""
    out = int(math.ceil((size + 2 * p - k) / s)) + 1
    if p > 0 and (out - 1) * s >= size + p:
        out -= 1
    return out


class CaffeNet(nn.Module):
    """Executable Caffe graph; `forward` returns every blob by name, each
    with the batch on its leading axis (detection_out: (B, 1, K, 7))."""

    def __init__(self, prototxt_path: str, caffemodel_path: Optional[str] = None,
                 weights: Optional[Dict[str, List[np.ndarray]]] = None):
        super().__init__()
        self.cfg = load_prototxt(prototxt_path)
        self.layers = as_list(self.cfg.get("layer") or self.cfg.get("layers"))
        if weights is None:
            weights = load_caffemodel(caffemodel_path) if caffemodel_path else {}
        self.input_name = self.cfg.get("input", "data")
        dims = as_list(self.cfg.get("input_dim"))
        if not dims and "input_shape" in self.cfg:
            dims = as_list(self.cfg["input_shape"].get("dim"))
        self.input_shape = tuple(int(d) for d in dims) if dims else (1, 3, 300, 300)
        # blobs as buffers named by layer index: Caffe layer names may hold
        # characters a module attribute cannot
        self._n_blobs: Dict[int, int] = {}
        # BatchNorm's moving-average scale factor, read once here rather
        # than from the device on every forward
        self._bn_scale: Dict[int, float] = {}
        for i, lay in enumerate(self.layers):
            if lay.get("type") in _WEIGHTED:
                blobs = weights.get(lay.get("name", ""), [])
                for j, b in enumerate(blobs):
                    self.register_buffer(f"l{i}_{j}", torch.from_numpy(
                        np.ascontiguousarray(b, dtype=np.float32)))
                self._n_blobs[i] = len(blobs)
                if lay.get("type") == "BatchNorm":
                    sf = float(np.asarray(blobs[2]).reshape(-1)[0])
                    self._bn_scale[i] = 1.0 / sf if sf != 0 else 0.0
        self._priors: Dict[Tuple, torch.Tensor] = {}

    def _blob(self, i: int, j: int) -> torch.Tensor:
        return getattr(self, f"l{i}_{j}")

    # ------------------------------------------------------------------ ops

    def _conv(self, i, lay, x):
        p = lay.get("convolution_param", {})
        s = int(p.get("stride", 1))
        pad = int(p.get("pad", 0))
        bias = None
        if p.get("bias_term", True) and self._n_blobs[i] > 1:
            bias = self._blob(i, 1)
        return F.conv2d(x, self._blob(i, 0), bias, stride=s, padding=pad)

    def _bn(self, i, lay, x):
        scale = self._bn_scale[i]
        mean = (self._blob(i, 0) * scale).view(1, -1, 1, 1)
        var = (self._blob(i, 1) * scale).view(1, -1, 1, 1)
        eps = float(lay.get("batch_norm_param", {}).get("eps", 1e-5))
        return (x - mean) * torch.rsqrt(var + eps)

    def _scale(self, i, lay, x):
        y = x * self._blob(i, 0).view(1, -1, 1, 1)
        if lay.get("scale_param", {}).get("bias_term", False) and self._n_blobs[i] > 1:
            y = y + self._blob(i, 1).view(1, -1, 1, 1)
        return y

    @staticmethod
    def _pool(lay, x):
        p = lay.get("pooling_param", {})
        mode = p.get("pool", "MAX")
        if p.get("global_pooling", False):
            if mode == "MAX":
                return torch.amax(x, dim=(2, 3), keepdim=True)
            return torch.mean(x, dim=(2, 3), keepdim=True)
        k = int(p.get("kernel_size", 2))
        s = int(p.get("stride", 1))
        pad = int(p.get("pad", 0))
        h, w = x.shape[2], x.shape[3]
        oh, ow = _pool_out(h, k, s, pad), _pool_out(w, k, s, pad)
        # pad explicitly so every ceil-mode window lies in the padded blob
        # (MAX pads with -inf; AVE with zeros and divides by k*k, padding
        # included, as Caffe does)
        extra_h = max((oh - 1) * s + k - h - pad, 0)
        extra_w = max((ow - 1) * s + k - w - pad, 0)
        fill = -math.inf if mode == "MAX" else 0.0
        xp = F.pad(x, (pad, extra_w, pad, extra_h), value=fill)
        if mode == "MAX":
            y = F.max_pool2d(xp, k, s)
        else:
            y = F.avg_pool2d(xp, k, s, divisor_override=k * k)
        return y[:, :, :oh, :ow]

    def _prior_box(self, lay, feat_hw, img_hw, device) -> torch.Tensor:
        """PriorBox rows (1, 2, N*4): boxes, then variances (numpy, cached
        per feature-map shape and device)."""
        key = (id(lay), feat_hw, img_hw, str(device))
        if key in self._priors:
            return self._priors[key]
        p = lay.get("prior_box_param", {})
        min_sizes = [float(v) for v in as_list(p.get("min_size"))]
        max_sizes = [float(v) for v in as_list(p.get("max_size"))]
        ars = [float(v) for v in as_list(p.get("aspect_ratio"))]
        flip = bool(p.get("flip", True))
        clip = bool(p.get("clip", False))
        variances = [float(v) for v in as_list(p.get("variance"))] or [0.1]
        step = float(p.get("step", 0))
        offset = float(p.get("offset", 0.5))
        fh, fw = feat_hw
        ih, iw = img_hw
        step_h = step or ih / fh
        step_w = step or iw / fw

        widths: List[float] = []
        heights: List[float] = []
        for i, ms in enumerate(min_sizes):
            widths.append(ms)
            heights.append(ms)
            if i < len(max_sizes):
                d = math.sqrt(ms * max_sizes[i])
                widths.append(d)
                heights.append(d)
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                widths.append(ms * math.sqrt(ar))
                heights.append(ms / math.sqrt(ar))
                if flip:
                    widths.append(ms / math.sqrt(ar))
                    heights.append(ms * math.sqrt(ar))

        boxes = np.zeros((fh, fw, len(widths), 4), np.float32)
        for y in range(fh):
            for x in range(fw):
                cx = (x + offset) * step_w
                cy = (y + offset) * step_h
                for k, (bw, bh) in enumerate(zip(widths, heights)):
                    boxes[y, x, k] = [(cx - bw / 2) / iw, (cy - bh / 2) / ih,
                                      (cx + bw / 2) / iw, (cy + bh / 2) / ih]
        boxes = boxes.reshape(-1, 4)
        if clip:
            boxes = np.clip(boxes, 0.0, 1.0)
        if len(variances) == 1:
            var = np.full_like(boxes, variances[0])
        else:
            var = np.tile(np.asarray(variances, np.float32), (boxes.shape[0], 1))
        out = torch.from_numpy(np.stack([boxes.reshape(-1), var.reshape(-1)])[None])
        self._priors[key] = out.to(device)
        return self._priors[key]

    # ------------------------------------------------------------- execution

    @torch.no_grad()
    def forward(self, x_nchw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x_nchw: (B, 3, H, W) f32 on the module's device."""
        blobs: Dict[str, torch.Tensor] = {self.input_name: x_nchw}
        ih, iw = self.input_shape[2], self.input_shape[3]
        for i, lay in enumerate(self.layers):
            t = lay.get("type")
            name = lay.get("name", "")
            bottoms = as_list(lay.get("bottom"))
            tops = as_list(lay.get("top")) or [name]
            if t == "Input":
                continue
            x = blobs[bottoms[0]] if bottoms else None
            if t == "Convolution":
                y = self._conv(i, lay, x)
            elif t == "BatchNorm":
                y = self._bn(i, lay, x)
            elif t == "Scale":
                y = self._scale(i, lay, x)
            elif t == "ReLU":
                y = torch.relu(x)
            elif t == "Pooling":
                y = self._pool(lay, x)
            elif t == "Eltwise":
                op = lay.get("eltwise_param", {}).get("operation", "SUM")
                y = x
                for b in bottoms[1:]:
                    v = blobs[b]
                    y = y + v if op == "SUM" else (y * v if op == "PROD"
                                                   else torch.maximum(y, v))
            elif t == "Permute":
                y = x.permute(*[int(v) for v in as_list(lay["permute_param"]["order"])])
            elif t == "Flatten":
                y = x.reshape(x.shape[0], -1)
            elif t == "Concat":
                axis = int(lay.get("concat_param", {}).get("axis", 1))
                y = torch.cat([blobs[b] for b in bottoms], dim=axis)
            elif t == "PriorBox":
                y = self._prior_box(lay, (x.shape[2], x.shape[3]), (ih, iw), x.device)
            elif t == "Reshape":
                dims = [int(v) for v in as_list(lay["reshape_param"]["shape"]["dim"])]
                y = x.reshape([x.shape[j] if d == 0 else d for j, d in enumerate(dims)])
            elif t == "Softmax":
                y = torch.softmax(x, dim=int(lay.get("softmax_param", {}).get("axis", 1)))
            elif t == "DetectionOutput":
                y = _detection_output(lay, *(blobs[b] for b in bottoms[:3]))
            else:
                raise NotImplementedError(f"Caffe layer type {t} ({name})")
            blobs[tops[0]] = y
        return blobs


def _detection_output(lay, loc_all: torch.Tensor, conf_all: torch.Tensor,
                      priors: torch.Tensor) -> torch.Tensor:
    """SSD decode + per-class NMS, fixed-size padded output (B, 1, K, 7) of
    cv2.dnn's DetectionOutput rows [image_id, label, conf, x1, y1, x2, y2],
    batched over frames. Decode runs in f32."""
    p = lay.get("detection_output_param", {})
    num_classes = int(p.get("num_classes", 2))
    bg = int(p.get("background_label_id", 0))
    nms_p = p.get("nms_param", {})
    nms_thresh = float(nms_p.get("nms_threshold", 0.45))
    nms_top_k = int(nms_p.get("top_k", 400))
    keep_top_k = int(p.get("keep_top_k", 200))
    conf_thresh = float(p.get("confidence_threshold", 0.01))
    variance_encoded = bool(p.get("variance_encoded_in_target", False))

    b = loc_all.shape[0]
    loc = loc_all.to(torch.float32).reshape(b, -1, 4)       # (B, N, 4) deltas
    conf = conf_all.to(torch.float32).reshape(b, -1, num_classes)
    pr = priors[0].to(torch.float32)
    pb, pv = pr[0].reshape(-1, 4), pr[1].reshape(-1, 4)
    pw = pb[:, 2] - pb[:, 0]
    ph = pb[:, 3] - pb[:, 1]
    pcx = (pb[:, 0] + pb[:, 2]) / 2
    pcy = (pb[:, 1] + pb[:, 3]) / 2
    # CENTER_SIZE decode
    if variance_encoded:
        cx = loc[..., 0] * pw + pcx
        cy = loc[..., 1] * ph + pcy
        bw = torch.exp(loc[..., 2]) * pw
        bh = torch.exp(loc[..., 3]) * ph
    else:
        cx = pv[:, 0] * loc[..., 0] * pw + pcx
        cy = pv[:, 1] * loc[..., 1] * ph + pcy
        bw = torch.exp(pv[:, 2] * loc[..., 2]) * pw
        bh = torch.exp(pv[:, 3] * loc[..., 3]) * ph
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)

    rows = []
    for c in range(num_classes):
        if c == bg:
            continue
        scores = conf[..., c]
        scores = torch.where(scores >= conf_thresh, scores, torch.zeros_like(scores))
        keep_scores, keep_boxes = _nms_padded(
            scores, boxes, nms_thresh, min(nms_top_k, scores.shape[1]), keep_top_k)
        head = torch.zeros((b, keep_top_k, 2), dtype=torch.float32, device=loc.device)
        head[..., 1] = float(c)
        rows.append(torch.cat([head, keep_scores[..., None], keep_boxes], dim=-1))
    out = torch.cat(rows, dim=1)
    # order by score, descending; equal scores keep their order
    order = torch.sort(out[..., 2], dim=1, descending=True, stable=True).indices
    out = torch.gather(out, 1, order[:, :keep_top_k, None].expand(-1, -1, 7))
    return out[:, None]


def _nms_padded(scores: torch.Tensor, boxes: torch.Tensor, iou_thresh: float,
                top_k: int, out_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over each frame's top_k boxes by score, padded to out_k.
    scores (B, N), boxes (B, N, 4) -> (B, out_k), (B, out_k, 4).

    The selection keeps lax.top_k's order (score descending, lower index
    first on ties). Suppression runs row by row as the JAX fori_loop does:
    box i, when still kept and scored, drops every later box whose IoU with
    it exceeds the threshold. Rows at or past the last scored box change
    nothing, so the loop stops there."""
    top_k = min(top_k, scores.shape[1])
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :top_k]
    vals = torch.gather(scores, 1, order)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))

    x1, y1, x2, y2 = bx.unbind(-1)
    area = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = torch.clamp(ix2 - ix1, min=0) * torch.clamp(iy2 - iy1, min=0)
    union = area[:, :, None] + area[:, None, :] - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, torch.ones_like(union)),
                      torch.zeros_like(union))
    scored = vals > 0
    later = torch.ones((top_k, top_k), dtype=torch.bool, device=scores.device).triu(1)
    # drops[b, i, j]: box i suppresses box j when i is kept
    drops = (iou > iou_thresh) & later & scored[:, :, None]
    keep = scored.clone()
    for i in range(int(scored.sum(1).max()) if scored.numel() else 0):
        keep &= ~(drops[:, i] & keep[:, i:i + 1])
    kept = torch.where(keep, vals, torch.zeros_like(vals))
    order = torch.sort(kept, dim=1, descending=True, stable=True).indices[:, :out_k]
    out_scores = torch.gather(kept, 1, order)
    out_boxes = torch.gather(bx, 1, order[..., None].expand(-1, -1, 4))
    pad = out_k - out_scores.shape[1]
    if pad > 0:
        out_scores = F.pad(out_scores, (0, pad))
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
    return out_scores, out_boxes
