"""SSD ResNet-10 face detector (the reference's primary detector).

Port of real_time_video_deepfake_detection_tpu/models/ssd_res10.py: the
Caffe graph executor (models/caffe_net.py) with the exact preprocessing
and postprocessing of the reference's DNN path (face_detection.py:71-105):
the cv2-exact 300x300 INTER_LINEAR resize, mean (104, 177, 123) in BGR
order, confidence strictly above the threshold, boxes scaled to the frame
with int() truncation, clamped, both sides strictly above 20 px.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.resize import resize_bilinear_u8_cv2
from .caffe_net import CaffeNet

Box = Tuple[int, int, int, int]

MEAN_BGR = (104.0, 177.0, 123.0)


def detect_postprocess_batch(det: torch.Tensor, frame_h: int, frame_w: int,
                             confidence_threshold: float = 0.5,
                             min_face_px: int = 20) -> Dict[str, torch.Tensor]:
    """DetectionOutput rows (B, 1, K, 7) -> the FIRST valid box per frame
    (the reference server uses faces[0]; rows are score-sorted, so the
    first valid row is the highest-confidence valid box).

    Per row, as face_detection.py:71-105: conf strictly > threshold, int()
    truncation toward zero of row * frame size, clamp to the frame, both
    sides strictly > min_face_px; rows with a non-finite coordinate never
    count. Returns box_xywh i32 (B, 4) (zeros when none), has_face bool (B,)
    and n_faces i32 (B,)."""
    rows = det[:, 0]                          # (B, K, 7)
    conf = rows[..., 2]
    finite = torch.isfinite(rows[..., 3:7]).all(-1)
    coords = torch.nan_to_num(rows[..., 3:7], nan=0.0, posinf=2.0, neginf=-2.0)
    # float -> int32 truncates toward zero, as int() does
    x1 = torch.clamp((coords[..., 0] * frame_w).to(torch.int32), min=0)
    y1 = torch.clamp((coords[..., 1] * frame_h).to(torch.int32), min=0)
    x2 = torch.clamp((coords[..., 2] * frame_w).to(torch.int32), max=frame_w)
    y2 = torch.clamp((coords[..., 3] * frame_h).to(torch.int32), max=frame_h)
    bw = x2 - x1
    bh = y2 - y1
    valid = finite & (conf > confidence_threshold) & (bw > min_face_px) & (bh > min_face_px)
    has_face = valid.any(1)
    n_faces = valid.sum(1).to(torch.int32)
    first = torch.argmax(valid.to(torch.int8), dim=1, keepdim=True)  # first True
    box = torch.stack([torch.gather(a, 1, first)[:, 0] for a in (x1, y1, bw, bh)], dim=1)
    box = torch.where(has_face[:, None], box, torch.zeros_like(box))
    return {"box_xywh": box, "has_face": has_face, "n_faces": n_faces}


def ssd_input(frames_bgr_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) u8 BGR -> the SSD's (B, 3, 300, 300) f32 blob:
    blobFromImage's cv2-exact resize and mean subtraction."""
    resized = resize_bilinear_u8_cv2(frames_bgr_u8, 300, 300)
    mean = torch.tensor(MEAN_BGR, dtype=torch.float32, device=frames_bgr_u8.device)
    return (resized.to(torch.float32) - mean).permute(0, 3, 1, 2)


def make_detect_batch(net: CaffeNet, confidence_threshold: float = 0.5,
                      min_face_px: int = 20) -> Callable:
    """Batched detector: frames_bgr u8 (B, H, W, 3) on the net's device ->
    the detect_postprocess_batch dict (resize, the Caffe graph, decode, NMS
    and box selection for every frame of the batch in one call)."""

    @torch.no_grad()
    def detect_batch(frames_bgr_u8: torch.Tensor):
        h, w = frames_bgr_u8.shape[1], frames_bgr_u8.shape[2]
        det = net(ssd_input(frames_bgr_u8))["detection_out"]
        return detect_postprocess_batch(det, h, w, confidence_threshold, min_face_px)

    return detect_batch


class SSDRes10:
    """The host detector of pipeline/faces.FaceDetector's "ssd" rung."""

    def __init__(self, net: CaffeNet):
        self.net = net

    @classmethod
    def from_caffemodel(cls, caffemodel_path: str, prototxt_path: Optional[str] = None,
                        device: Optional[Union[str, torch.device]] = None) -> "SSDRes10":
        """deploy.prototxt defaults to the caffemodel's directory; `device`
        None means CUDA (raising without it), "cpu" the CPU."""
        if prototxt_path is None:
            prototxt_path = os.path.join(os.path.dirname(caffemodel_path), "deploy.prototxt")
        net = CaffeNet(prototxt_path, caffemodel_path).to(resolve_device(device))
        return cls(net.eval())

    @property
    def device(self) -> torch.device:
        return next(iter(self.net.buffers())).device

    def detect(self, frame_bgr: np.ndarray, confidence_threshold: float = 0.5,
               min_face_px: int = 20) -> List[Box]:
        h, w = frame_bgr.shape[:2]
        x = ssd_input(torch.from_numpy(np.ascontiguousarray(frame_bgr))[None].to(self.device))
        det = self.net(x)["detection_out"].cpu().numpy()   # (1, 1, K, 7)
        out: List[Box] = []
        for row in det[0, 0]:
            # non-finite decodes (exp overflow on garbage weights) never
            # count, as in detect_postprocess_batch
            if not np.isfinite(row[3:7]).all():
                continue
            if float(row[2]) > confidence_threshold:
                x1, y1 = max(0, int(row[3] * w)), max(0, int(row[4] * h))
                x2, y2 = min(w, int(row[5] * w)), min(h, int(row[6] * h))
                bw, bh = x2 - x1, y2 - y1
                if bw > min_face_px and bh > min_face_px:
                    out.append((x1, y1, bw, bh))
        return out
