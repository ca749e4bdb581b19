"""Batched multi-stream serving tick.

Port of real_time_video_deepfake_detection_tpu/serving/batcher.py (the
host-prep tick): one call serves every stream of the batch.

  frames (N,256,256,3 u8 BGR) -> six forensic signals
  faces  (N,160,160,3 f32|u8 RGB) -> resize 224 + normalize -> EfficientNet
         -> sigmoid -> calibrator -> small-face boost
  vote = face prob if face else forensic prob
  tracker ring-buffer update + verdict

Padded entries carry active=False: their state update is a no-op. The
kernels of this tick are selected by DetectorConfig.use_pallas_preproc
(kernels/preproc.py), use_pallas_color (kernels/color_stats.py) and
clahe_device (Lab, then CLAHE on L through kernels/clahe.py, then RGB).

make_device_step_detect builds the capture-to-verdict tick of device-detect
serving: capture-size BGR frames -> the 300x300 and 256x256 cv2-exact
resizes -> the SSD Caffe graph, decode and NMS -> the reference's box
selection -> per-stream crop and align to 160x160 RGB -> the tick above.
make_device_step_detect_wire feeds the same tick from a wire plane of the
JPEG ingest (quantised coefficients, or the 4:2:0 planes after the inverse
DCT), finishing the decode in the tick. Clip attention, in-tick MTCNN and
the SSD in bf16 come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import numpy as np
import torch

from ..core.config import DetectorConfig
from ..models.caffe_net import CaffeNet
from ..models.efficientnet import EfficientNet
from ..models.ssd_res10 import detect_postprocess_batch, ssd_input
from ..ops import forensics
from ..ops.color import lab_to_rgb_u8, rgb_to_lab_u8
from ..ops.jpeg_decode import bgr_from_coefs_420, bgr_from_ycbcr420
from ..ops.resize import crop_resize_u8_cv2, resize_bilinear_u8_cv2
from ..pipeline.classify import classify_batch
from ..state.forensic_state import ForensicState, forensic_state_init_batch
from ..state.tracker import (
    TrackerState, tracker_init_batch, tracker_stability,
    tracker_temporal_average, tracker_update, tracker_verdict,
)
from ..state.tree import tree_map


@dataclasses.dataclass
class StreamStates:
    forensic: ForensicState   # batched (leading stream axis)
    tracker: TrackerState     # batched
    frame_count: torch.Tensor  # i32[N] server-semantics per-stream frame count


def init_stream_states(n_streams: int, cfg: DetectorConfig = DetectorConfig(),
                       device: Union[str, torch.device] = "cpu") -> StreamStates:
    return StreamStates(
        forensic=forensic_state_init_batch(n_streams, cfg.forensic, device),
        tracker=tracker_init_batch(n_streams, cfg.tracker, device),
        frame_count=torch.zeros((n_streams,), dtype=torch.int32, device=device))


def reset_streams(states: StreamStates, mask: torch.Tensor) -> StreamStates:
    """Zero the streams selected by `mask` (bool[N]) — per-stream /reset."""
    def sel(s):
        m = mask.reshape((-1,) + (1,) * (s.ndim - 1))
        return torch.where(m, torch.zeros_like(s), s)
    return tree_map(sel, states)


# jnp.interp treats an interval no wider than spacing(eps(f32)) as zero-width
_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp(x, xp, fp) with its edge handling: fp[0] left of xp[0],
    fp[-1] right of xp[-1], and a zero-width interval takes its left value."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _unported(cfg: DetectorConfig) -> None:
    if cfg.clip_window > 0:
        raise NotImplementedError(
            "clip_window > 0: the clip-attention head comes with a later slice")


@torch.no_grad()
def _step_core(model: EfficientNet, cfg: DetectorConfig,
               frames_u8: torch.Tensor, faces_raw: torch.Tensor,
               has_face: torch.Tensor, face_hw: torch.Tensor,
               active: torch.Tensor, states: StreamStates
               ) -> Tuple[Dict[str, torch.Tensor], StreamStates]:
    """One tick over all streams.

    frames_u8: (N,256,256,3) u8 analysis-size BGR frames
    faces_raw: (N,160,160,3) f32 or u8 aligned face crops, raw RGB 0-255
        (zeros for streams without faces)
    has_face:  bool[N]; face_hw: i32[N,2] original crop size (h, w)
    active:    bool[N] padded-slot mask
    """
    _unported(cfg)
    n = frames_u8.shape[0]
    dev = frames_u8.device
    # server off-by-one: forensics scheduled on the PRE-increment count
    # (backend_server.py:148-156)
    if cfg.forensic_schedule == "tick_fast":
        full = torch.zeros((n,), dtype=torch.bool, device=dev)
    elif cfg.forensic_schedule == "tick_full":
        full = torch.ones((n,), dtype=torch.bool, device=dev)
    elif cfg.forensic_schedule == "frame":
        full = torch.remainder(states.frame_count, cfg.full_forensic_interval) == 0
    else:
        raise ValueError(
            f"unknown forensic_schedule {cfg.forensic_schedule!r} "
            "(expected 'frame', 'tick_full' or 'tick_fast')")

    fres, new_forensic = forensics.analyze_frame_batch(
        frames_u8, states.forensic, full, cfg.forensic,
        use_pallas_color=cfg.use_pallas_color,
        fast_only=cfg.forensic_schedule == "tick_fast")
    # inactive slots keep their old forensic state
    new_forensic = tree_map(
        lambda new, old: torch.where(
            active.reshape((-1,) + (1,) * (new.ndim - 1)), new, old),
        new_forensic, states.forensic)
    forensic_prob = fres["fake_probability"]

    if cfg.clahe_device:
        # CLAHE on the L channel of the aligned crop, on the device (the
        # host path applies it to the crop before alignment); the engine
        # ships u8 crops from the resize aligner
        from ..kernels.clahe import clahe_u8
        if faces_raw.dtype != torch.uint8:
            raise TypeError(f"clahe_device needs u8 face crops, got {faces_raw.dtype}")
        lab = rgb_to_lab_u8(faces_raw)
        L = clahe_u8(lab[..., 0].contiguous())
        faces_raw = lab_to_rgb_u8(torch.stack([L, lab[..., 1], lab[..., 2]], dim=-1))

    face_prob = classify_batch(model, faces_raw, cfg.model_input_size,
                               cfg.bf16_inference, cfg.use_pallas_preproc)
    if cfg.calibrator_knots is not None:
        # isotonic calibration between sigmoid and the small-face heuristic
        # (deepfake_detection.py:535-538)
        cx = torch.tensor(cfg.calibrator_knots[0], dtype=torch.float32, device=dev)
        cy = torch.tensor(cfg.calibrator_knots[1], dtype=torch.float32, device=dev)
        face_prob = interp(face_prob, cx, cy)
    small = (face_hw[:, 0] < cfg.small_face_px) | (face_hw[:, 1] < cfg.small_face_px)
    face_prob = torch.clamp(
        face_prob + torch.where(small, cfg.small_face_boost, 0.0), 0.0, 1.0)

    if cfg.fuse_forensics:
        fused = cfg.face_weight * face_prob + cfg.forensic_weight * forensic_prob
    else:
        fused = face_prob   # reference default (deepfake_detection.py:620-623)
    vote_prob = torch.where(has_face, fused, forensic_prob)

    new_tracker = tracker_update(states.tracker, vote_prob, active,
                                 cfg.detection_threshold)
    new_counts = states.frame_count + active.to(torch.int32)
    out = {
        "fake_probability": torch.where(has_face, face_prob, forensic_prob),
        "face_probability": face_prob,
        "frame_forensic_probability": forensic_prob,
        "verdict": tracker_verdict(new_tracker),
        "temporal_average": tracker_temporal_average(new_tracker),
        "stability_score": tracker_stability(new_tracker),
        "frame_count": new_counts,
        "full_forensic": full,
    }
    return out, StreamStates(new_forensic, new_tracker, new_counts)


@torch.no_grad()
def device_step_compact(model: EfficientNet, cfg: DetectorConfig,
                        frames_u8: torch.Tensor, faces_raw: torch.Tensor,
                        has_face: torch.Tensor, face_hw: torch.Tensor,
                        active: torch.Tensor, slot_idx: torch.Tensor,
                        states: StreamStates
                        ) -> Tuple[Dict[str, torch.Tensor], StreamStates]:
    """Occupancy-bucketed tick: the inputs carry B <= N_slots entries and
    `slot_idx` maps each to its row of the full state. Padded entries point
    at the dummy row N with active=False; their update is a no-op, so the
    duplicate scatters into row N write identical values.

    `states` must have N_slots + 1 rows (the engine allocates the dummy)."""
    idx = slot_idx.to(torch.int64)
    sub = tree_map(lambda s: s[idx], states)
    out, new_sub = _step_core(model, cfg, frames_u8, faces_raw, has_face,
                              face_hw, active, sub)
    new_full = tree_map(lambda full, ns: full.index_put((idx,), ns), states, new_sub)
    return out, new_full


def _make_detect_prep(net: CaffeNet, cfg: DetectorConfig):
    """The capture -> (frames_256, faces, has_face, face_hw, box, n_faces)
    stage of the detect tick."""
    if cfg.mtcnn_device:
        raise NotImplementedError("mtcnn_device: in-tick MTCNN comes with the MTCNN slice")
    if cfg.ssd_bf16:
        raise NotImplementedError("ssd_bf16: the SSD in bf16 comes with a later slice")
    h256, w256 = cfg.forensic.analysis_size
    m = cfg.mtcnn_image_size

    def detect_prep(frames_capture_u8: torch.Tensor, active: torch.Tensor):
        hc, wc = frames_capture_u8.shape[1], frames_capture_u8.shape[2]
        frames_256 = resize_bilinear_u8_cv2(frames_capture_u8, h256, w256)
        det = net(ssd_input(frames_capture_u8))["detection_out"]
        d = detect_postprocess_batch(det, hc, wc, cfg.ssd_confidence_threshold,
                                     cfg.min_face_px)
        box = d["box_xywh"]
        # BGR -> RGB (the host aligner's channel order) on the crop, where
        # it moves the fewest bytes; the crop treats channels alike
        faces_raw = crop_resize_u8_cv2(frames_capture_u8, box, m, m).flip(-1)
        face_hw = torch.stack([box[:, 3], box[:, 2]], dim=1)   # (fh, fw)
        return frames_256, faces_raw, d["has_face"] & active, face_hw, box, d["n_faces"]

    return detect_prep


@torch.no_grad()
def _detect_tick(detect_prep, model: EfficientNet, cfg: DetectorConfig,
                 frames_capture_u8: torch.Tensor, active: torch.Tensor,
                 slot_idx: torch.Tensor, states: StreamStates
                 ) -> Tuple[Dict[str, torch.Tensor], StreamStates]:
    """Compact-layout detect tick: detection, forensics, crop/align (and
    CLAHE), classification and the tracker; slot-indexed state gather and
    scatter with a dummy row for padding, as device_step_compact."""
    (frames_256, faces_raw, has_face, face_hw, box,
     n_faces) = detect_prep(frames_capture_u8, active)
    out, new_full = device_step_compact(model, cfg, frames_256, faces_raw, has_face,
                                        face_hw, active, slot_idx, states)
    out["face_bbox"] = box
    out["has_face"] = has_face
    out["faces_detected"] = n_faces
    return out, new_full


def make_device_step_detect(net: CaffeNet, model: EfficientNet, cfg: DetectorConfig):
    """The capture-to-verdict tick of device-detect serving, one call per
    tick on the device of `net` and `model`:

      step(frames_capture_u8 (B, Hc, Wc, 3) u8 BGR, active bool (B,),
           slot_idx i32 (B,), states) -> (out, new_states)

    `out` holds the keys of device_step_compact plus face_bbox (i32 (B, 4),
    x y w h in capture coordinates), has_face and faces_detected. `net` is
    the SSD's Caffe graph (models/caffe_net.CaffeNet)."""
    detect_prep = _make_detect_prep(net, cfg)

    def step(frames_capture_u8, active, slot_idx, states):
        return _detect_tick(detect_prep, model, cfg, frames_capture_u8, active,
                            slot_idx, states)

    return step


def make_device_step_detect_wire(net: CaffeNet, model: EfficientNet, cfg: DetectorConfig,
                                 wire: str, capture_hw: Tuple[int, int]):
    """The detect tick fed by a wire plane of the JPEG ingest
    (ServerConfig.ingest_plane) instead of decoded frames: the tick first
    finishes the decode with libjpeg's integer math (ops/jpeg_decode), then
    runs make_device_step_detect's tick.

      wire="coef":     step(coef_y i16 (B, yb, 64), coef_c i16 (B, 2, yb/4,
                       64), qtab (B, 2, 64) uint16 values in any integer
                       dtype (int16 bits included), active, slot_idx, states):
                       dequantise, inverse DCT, upsample, YCbCr -> BGR
      wire="ycbcr420": step(y u8 (B, H, W), c u8 (B, 2, H/2, W/2), active,
                       slot_idx, states): upsample, YCbCr -> BGR

    Inactive rows may hold garbage (the engine decodes straight into its
    padded bucket and flags the ineligible entries): the arithmetic is
    integer only, its output is clamped, and active=False masks every
    state update."""
    detect_prep = _make_detect_prep(net, cfg)
    hc, wc = capture_hw

    if wire == "coef":
        def step(coef_y, coef_c, qtab, active, slot_idx, states):
            frames = bgr_from_coefs_420(coef_y, coef_c, qtab.to(torch.int32) & 0xFFFF, hc, wc)
            return _detect_tick(detect_prep, model, cfg, frames, active, slot_idx, states)
        return step
    if wire == "ycbcr420":
        def step(y, c, active, slot_idx, states):
            return _detect_tick(detect_prep, model, cfg, bgr_from_ycbcr420(y, c), active,
                                slot_idx, states)
        return step
    raise ValueError(f"unknown ingest wire plane: {wire!r}")
