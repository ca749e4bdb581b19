"""Batched multi-stream serving tick.

Port of real_time_video_deepfake_detection_tpu/serving/batcher.py (the
host-prep tick): one call serves every stream of the batch.

  frames (N,256,256,3 u8 BGR) -> six forensic signals
  faces  (N,160,160,3 f32|u8 RGB) -> resize 224 + normalize -> backbone
         (EfficientNet, ViT or Xception) -> sigmoid -> calibrator ->
         small-face boost
  vote = face prob if face else forensic prob
  tracker ring-buffer update + verdict
  [clip mode: the backbone's pooled features into a per-stream ring, the
   temporal-attention head over it, its verdict in place of the vote's]

Padded entries carry active=False: their state update is a no-op. The
kernels of this tick are selected by DetectorConfig.use_pallas_preproc
(kernels/preproc.py), use_pallas_color (kernels/color_stats.py) and
clahe_device (Lab, then CLAHE on L through kernels/clahe.py, then RGB).

device_step_from_capture is the tick over every stream's row of the state
with the capture-to-256 resize in front of it (the classify-only bench
tick); device_step_compact takes a bucket of entries and their slots.
make_device_step_detect builds the capture-to-verdict
tick of device-detect serving: capture-size BGR frames -> the 300x300 and
256x256 cv2-exact resizes -> the SSD Caffe graph, decode and NMS -> the
reference's box selection -> per-stream crop and align to 160x160 RGB ->
the tick above.
make_device_step_detect_wire feeds the same tick from a wire plane of the
JPEG ingest (quantised coefficients, or the 4:2:0 planes after the inverse
DCT), finishing the decode in the tick. DetectorConfig.mtcnn_device puts
the MTCNN P/R/O cascade (models/mtcnn.py) between the crop and the
classifier, and ssd_bf16 runs the SSD in bfloat16.

Clip mode (BASELINE config 5, DetectorConfig.clip_window > 0): every tick
takes `model` as {"backbone": module, "clip_head": TemporalHead}, the JAX
tick's params; the ring is StreamStates.clip, (N, clip_window,
clip_feature_dim), and (N, 1, 1) when clip mode is off.

make_sharded_device_step and make_sharded_device_step_detect run the dense
tick over a device mesh (parallel/mesh.py): one contiguous shard of streams
per mesh entry, each on its device with a model replica bound there.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import DetectorConfig
from ..models.caffe_net import CaffeNet
from ..models.ssd_res10 import detect_postprocess_batch, ssd_input
from ..models.temporal_head import (
    ClipState, TemporalHeadSpec, clip_state_init, clip_state_push, clip_verdict,
)
from ..ops import forensics
from ..ops.color import lab_to_rgb_u8, rgb_to_lab_u8
from ..ops.jpeg_decode import bgr_from_coefs_420, bgr_from_ycbcr420
from ..ops.resize import crop_resize_u8_cv2, resize_bilinear_u8_cv2
from ..parallel.mesh import Mesh, as_mesh, replicated, shard_batch
from ..pipeline.classify import classify_features
from ..state.forensic_state import ForensicState, forensic_state_init_batch
from ..state.tracker import (
    VERDICT_FAKE, VERDICT_REAL, VERDICT_UNCERTAIN, TrackerState, tracker_init_batch,
    tracker_stability, tracker_temporal_average, tracker_update, tracker_verdict,
)
from ..state.tree import tree_map


@dataclasses.dataclass
class StreamStates:
    forensic: ForensicState   # batched (leading stream axis)
    tracker: TrackerState     # batched
    frame_count: torch.Tensor  # i32[N] server-semantics per-stream frame count
    # clip mode: per-stream ring of backbone features; (N, 1, 1) when off
    clip: ClipState


def clip_head_spec(cfg: DetectorConfig) -> TemporalHeadSpec:
    return TemporalHeadSpec(feature_dim=cfg.clip_feature_dim,
                            window=max(cfg.clip_window, 1))


def init_stream_states(n_streams: int, cfg: DetectorConfig = DetectorConfig(),
                       device: Union[str, torch.device] = "cpu") -> StreamStates:
    clip = cfg.clip_window > 0
    return StreamStates(
        forensic=forensic_state_init_batch(n_streams, cfg.forensic, device),
        tracker=tracker_init_batch(n_streams, cfg.tracker, device),
        frame_count=torch.zeros((n_streams,), dtype=torch.int32, device=device),
        clip=clip_state_init(n_streams, max(cfg.clip_window, 1),
                             cfg.clip_feature_dim if clip else 1, device))


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


@torch.no_grad()
def _step_core(model, cfg: DetectorConfig,
               frames_u8: torch.Tensor, faces_raw: torch.Tensor,
               has_face: torch.Tensor, face_hw: torch.Tensor,
               active: torch.Tensor, states: StreamStates
               ) -> Tuple[Dict[str, torch.Tensor], StreamStates]:
    """One tick over all streams.

    model: the backbone module, or in clip mode (cfg.clip_window > 0)
        {"backbone": module, "clip_head": models.temporal_head.TemporalHead}
    frames_u8: (N,256,256,3) u8 analysis-size BGR frames
    faces_raw: (N,160,160,3) f32 or u8 aligned face crops, raw RGB 0-255
        (zeros for streams without faces)
    has_face:  bool[N]; face_hw: i32[N,2] original crop size (h, w)
    active:    bool[N] padded-slot mask
    """
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

    backbone = model["backbone"] if cfg.clip_window > 0 else model
    face_prob, feats = classify_features(backbone, faces_raw, cfg.model_input_size,
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
    verdict = tracker_verdict(new_tracker)

    new_clip = states.clip
    if cfg.clip_window > 0:
        # clip-attention verdict: this frame's features (float32, also in
        # bf16 inference) into the ring of each stream with a face, the
        # head over every stream's window, its verdict in place of the vote
        new_clip = clip_state_push(states.clip, feats, has_face & active)
        clip_prob = clip_verdict(model["clip_head"], new_clip)
        # the ring caps n at clip_window, so a window below clip_min_frames
        # must still leave UNCERTAIN
        min_frames = min(cfg.clip_min_frames, cfg.clip_window)
        decided = torch.where(clip_prob > cfg.detection_threshold,
                              VERDICT_FAKE, VERDICT_REAL).to(verdict.dtype)
        verdict = torch.where(new_clip.n >= min_frames, decided,
                              torch.full_like(verdict, VERDICT_UNCERTAIN))

    new_counts = states.frame_count + active.to(torch.int32)
    out = {
        "fake_probability": torch.where(has_face, face_prob, forensic_prob),
        "face_probability": face_prob,
        "frame_forensic_probability": forensic_prob,
        "verdict": verdict,
        "temporal_average": tracker_temporal_average(new_tracker),
        "stability_score": tracker_stability(new_tracker),
        "frame_count": new_counts,
        "full_forensic": full,
    }
    if cfg.clip_window > 0:
        out["clip_probability"] = clip_prob
        out["clip_frames"] = new_clip.n
    return out, StreamStates(new_forensic, new_tracker, new_counts, new_clip)


@torch.no_grad()
def device_step_from_capture(model, cfg: DetectorConfig,
                             frames_capture_u8: torch.Tensor, faces_raw: torch.Tensor,
                             has_face: torch.Tensor, face_hw: torch.Tensor,
                             active: torch.Tensor, states: StreamStates
                             ) -> Tuple[Dict[str, torch.Tensor], StreamStates]:
    """The tick over every stream's row of the state, with the cv2-exact
    capture-to-analysis resize in the same call: frames_capture_u8
    (N, H, W, 3) u8 BGR at the capture size."""
    h, w = cfg.forensic.analysis_size
    return _step_core(model, cfg, resize_bilinear_u8_cv2(frames_capture_u8, h, w),
                      faces_raw, has_face, face_hw, active, states)


@torch.no_grad()
def device_step_compact(model, cfg: DetectorConfig,
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


def _make_detect_prep(net: CaffeNet, cfg: DetectorConfig,
                      mtcnn_nets: Optional[Dict[str, nn.Module]] = None):
    """The capture -> (frames_256, faces, has_face, face_hw, box, n_faces)
    stage of the detect tick. Returns (detect_prep, step_cfg): step_cfg is
    cfg with clahe_device off when the MTCNN path applies CLAHE itself (the
    reference's CLAHE-then-align order), so the core never applies it
    twice.

    cfg.ssd_bf16 runs a copy of `net` whose floating weights are bfloat16
    on a bfloat16 blob; DetectionOutput decodes in float32. cfg.mtcnn_device
    runs the P/R/O cascade (models/mtcnn.mtcnn_align_batch with
    cfg.mtcnn_tick_caps) on the crops, after CLAHE when cfg.clahe_device;
    its faces (float32) replace the crops, and a crop the cascade rejects
    falls to forensic-only (the reference's `mtcnn(img) is None`)."""
    h256, w256 = cfg.forensic.analysis_size
    m = cfg.mtcnn_image_size
    step_cfg = cfg
    if cfg.mtcnn_device:
        if mtcnn_nets is None:
            raise ValueError("cfg.mtcnn_device requires mtcnn_nets (the P/R/O-Net "
                             "modules of an MTCNNAligner)")
        from ..models.mtcnn import mtcnn_align_batch
        step_cfg = dataclasses.replace(cfg, clahe_device=False)
    if cfg.ssd_bf16:
        net = copy.deepcopy(net).to(torch.bfloat16)

    def detect_prep(frames_capture_u8: torch.Tensor, active: torch.Tensor):
        hc, wc = frames_capture_u8.shape[1], frames_capture_u8.shape[2]
        frames_256 = resize_bilinear_u8_cv2(frames_capture_u8, h256, w256)
        blob = ssd_input(frames_capture_u8)
        if cfg.ssd_bf16:
            blob = blob.to(torch.bfloat16)
        det = net(blob)["detection_out"]
        d = detect_postprocess_batch(det, hc, wc, cfg.ssd_confidence_threshold,
                                     cfg.min_face_px)
        box = d["box_xywh"]
        has_face = d["has_face"] & active
        # BGR -> RGB (the host aligner's channel order) on the crop, where
        # it moves the fewest bytes; the crop treats channels alike
        faces_raw = crop_resize_u8_cv2(frames_capture_u8, box, m, m).flip(-1)
        face_hw = torch.stack([box[:, 3], box[:, 2]], dim=1)   # (fh, fw)
        if cfg.mtcnn_device:
            if cfg.clahe_device:
                # the reference's order: CLAHE on the crop, then the
                # alignment (deepfake_detection.py:357-383)
                from ..kernels.clahe import clahe_u8
                lab = rgb_to_lab_u8(faces_raw)
                L = clahe_u8(lab[..., 0].contiguous())
                faces_raw = lab_to_rgb_u8(torch.stack([L, lab[..., 1], lab[..., 2]], dim=-1))
            mp, mr, mo = cfg.mtcnn_tick_caps
            faces_raw, scores, _ = mtcnn_align_batch(
                mtcnn_nets, faces_raw.to(torch.float32), image_size=m,
                max_p=mp, max_r=mr, max_o=mo)
            has_face = has_face & (scores > 0.0)
        return frames_256, faces_raw, has_face, face_hw, box, d["n_faces"]

    return detect_prep, step_cfg


@torch.no_grad()
def _detect_tick(detect_prep, tick, frames_capture_u8: torch.Tensor, active: torch.Tensor,
                 *rest) -> Tuple[Dict[str, torch.Tensor], StreamStates]:
    """Detection, forensics, crop/align (and CLAHE), classification and the
    tracker: detect_prep's outputs through `tick`, device_step_compact
    (rest: slot_idx, states) or the dense _step_core (rest: states), with
    the model and cfg bound."""
    (frames_256, faces_raw, has_face, face_hw, box,
     n_faces) = detect_prep(frames_capture_u8, active)
    out, new_states = tick(frames_256, faces_raw, has_face, face_hw, active, *rest)
    out["face_bbox"] = box
    out["has_face"] = has_face
    out["faces_detected"] = n_faces
    return out, new_states


def make_device_step_detect(net: CaffeNet, model, cfg: DetectorConfig,
                            mtcnn_nets: Optional[Dict[str, nn.Module]] = None):
    """The capture-to-verdict tick of device-detect serving, one call per
    tick on the device of `net` and `model`:

      step(frames_capture_u8 (B, Hc, Wc, 3) u8 BGR, active bool (B,),
           slot_idx i32 (B,), states) -> (out, new_states)

    `out` holds the keys of device_step_compact plus face_bbox (i32 (B, 4),
    x y w h in capture coordinates), has_face and faces_detected. `net` is
    the SSD's Caffe graph (models/caffe_net.CaffeNet); `mtcnn_nets`, the
    cascade's modules for cfg.mtcnn_device (MTCNNAligner.nets)."""
    detect_prep, step_cfg = _make_detect_prep(net, cfg, mtcnn_nets)
    tick = functools.partial(device_step_compact, model, step_cfg)

    def step(frames_capture_u8, active, slot_idx, states):
        return _detect_tick(detect_prep, tick, frames_capture_u8, active, slot_idx, states)

    return step


def make_device_step_detect_wire(net: CaffeNet, model, cfg: DetectorConfig,
                                 wire: str, capture_hw: Tuple[int, int],
                                 mtcnn_nets: Optional[Dict[str, nn.Module]] = None):
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
    state update. With cfg.mtcnn_device the cascade follows the decode
    unchanged."""
    n_wire, decode = _wire_decode(wire, capture_hw)
    detect_prep, step_cfg = _make_detect_prep(net, cfg, mtcnn_nets)
    tick = functools.partial(device_step_compact, model, step_cfg)

    def step(*args):
        return _detect_tick(detect_prep, tick, decode(*args[:n_wire]), *args[n_wire:])

    return step


def _wire_decode(wire: str, capture_hw: Tuple[int, int]):
    """(number of wire tensors, their decode to (B, Hc, Wc, 3) u8 BGR
    frames) for an ingest plane."""
    hc, wc = capture_hw
    if wire == "coef":
        return 3, lambda coef_y, coef_c, qtab: bgr_from_coefs_420(
            coef_y, coef_c, qtab.to(torch.int32) & 0xFFFF, hc, wc)
    if wire == "ycbcr420":
        return 2, bgr_from_ycbcr420
    raise ValueError(f"unknown ingest wire plane: {wire!r}")


def _shards(mesh: Mesh, x) -> list:
    """x as the mesh's shards: already a list of them, or split here."""
    return list(x) if isinstance(x, (list, tuple)) else shard_batch(mesh, x)


def _run_sharded(mesh: Mesh, per_device: dict, body, args) -> Tuple[list, list]:
    """body(per_device[shard's device], *shard i of every arg) for each
    shard, from this thread in mesh order (each launch is asynchronous on
    its device's current stream). Returns (outputs, new states), one per
    shard, left on their devices."""
    split = [_shards(mesh, a) for a in args]
    outs, states = [], []
    for i, dev in enumerate(mesh.devices):
        out, st = body(per_device[dev], *(a[i] for a in split))
        outs.append(out)
        states.append(st)
    return outs, states


def make_sharded_device_step(mesh, model, cfg: DetectorConfig):
    """The serving tick sharded over a mesh (JAX make_sharded_device_step,
    :528-551): the stream axis is split into one contiguous shard per mesh
    entry, and each shard runs _step_core on its device with the model
    replica there (parallel/mesh.replicated). There is no dataflow between
    shards and no collective. Dense layout: row i of the states belongs to
    stream i, and n_streams must divide by the mesh size.

      step(frames_u8, faces_raw, has_face, face_hw, active, states)
        -> ([out of each shard], [new states of each shard])

    Each argument is a whole tensor (StreamStates for `states`), split
    here, or the list of its shards from parallel/mesh.shard_batch; the
    shards' outputs and states stay on their devices (mesh.gather joins
    them), so the states can feed the next tick as they are. `mesh`: a
    parallel/mesh.Mesh or a device list. In clip mode `model` is {"backbone",
    "clip_head"}. JAX binds `params` at each call; the replicas here are
    bound when the step is built."""
    mesh = as_mesh(mesh)
    replicas = replicated(mesh, model)

    def step(*args):
        return _run_sharded(mesh, replicas,
                            lambda m, *a: _step_core(m, cfg, *a), args)

    return step


def make_sharded_device_step_detect(mesh, net: CaffeNet, model, cfg: DetectorConfig,
                                    mtcnn_nets: Optional[Dict[str, nn.Module]] = None,
                                    wire: Optional[str] = None,
                                    capture_hw: Optional[Tuple[int, int]] = None):
    """The capture-to-verdict tick sharded over a mesh (JAX
    make_sharded_device_step_detect, :450-525): each shard of streams runs
    the SSD, the forensics, crop/align (CLAHE, the MTCNN cascade) and the
    classifier on its device, with replicas of `net`, `model` and
    `mtcnn_nets` there (the bf16 copy of the SSD made per device with
    cfg.ssd_bf16). Dense layout as make_sharded_device_step:

      step(frames_capture_u8, active, states)            wire None
      step(coef_y, coef_c, qtab, active, states)         wire="coef"
      step(y, c, active, states)                         wire="ycbcr420"
        -> ([out of each shard], [new states of each shard])

    `out` holds the keys of make_device_step_detect's; a wire plane
    (capture_hw = (Hc, Wc)) is decoded per shard on its device."""
    mesh = as_mesh(mesh)
    nets, models = replicated(mesh, net), replicated(mesh, model)
    mtcnn = replicated(mesh, mtcnn_nets)
    per_device = {}
    for d in mesh.distinct:
        detect_prep, step_cfg = _make_detect_prep(nets[d], cfg, mtcnn[d])
        per_device[d] = (detect_prep, functools.partial(_step_core, models[d], step_cfg))
    n_wire, decode = (0, None) if wire is None else _wire_decode(wire, capture_hw)

    def body(parts, *args):
        detect_prep, tick = parts
        frames = args[0] if decode is None else decode(*args[:n_wire])
        return _detect_tick(detect_prep, tick, frames, *args[max(n_wire, 1):])

    def step(*args):
        return _run_sharded(mesh, per_device, body, args)

    return step
