"""Multi-stream serving engine: dynamic batching onto one tick.

Port of real_time_video_deepfake_detection_tpu/serving/multi.py
(MultiStreamEngine). N concurrent streams, each named by a stream id, park
their requests in a queue; a batcher thread ticks when `max_batch` frames
are pending or `batch_timeout_ms` elapses, runs ONE serving tick for all of
them on the engine's device, and a drainer thread completes the waiting
requests with the reference's JSON response. Two modes:

  - host prep (default): each request thread resizes the frame, detects
    and aligns the face on the host; the tick is
    serving/batcher.device_step_compact.
  - device detect (ServerConfig.device_detect): the request thread only
    enqueues the JPEG bytes (or conforms a decoded frame to
    detect_capture_hw); the batcher entropy-decodes the tick's JPEGs in one
    pooled host call, reconstructs and conforms them on the engine's device,
    and runs serving/batcher.make_device_step_detect (SSD detection,
    resizes, crop/align, CLAHE with clahe_device, classification, tracker);
    face_bbox comes back in the client frame's coordinates. With a wire
    plane (ServerConfig.ingest_plane "coef" or "ycbcr420") the JPEGs that
    are YCbCr 4:2:0 at detect_capture_hw skip the grouping and the conform:
    one pooled host call decodes their quantised coefficients (or their
    planes after the inverse DCT) straight into the padded bucket's rows of
    a host buffer, pinned on CUDA, one copy moves it to the device, and
    serving/batcher.make_device_step_detect_wire finishes the decode in the
    tick; the other JPEGs take the path above in a second dispatch.

`create_batched_app` puts the reference's HTTP surface in front of it.
Per-stream session state lives in the batched StreamStates on the device,
with one extra dummy row for padded entries; /reset with a stream id resets
only that slot. An MTCNNAligner (models/mtcnn.py) aligns faces on the host
in host-prep mode, or lends its nets to the tick with
DetectorConfig.mtcnn_device in device-detect mode. With
DetectorConfig.clip_window > 0 (BASELINE config 5) every tick pushes the
backbone's pooled features into a per-stream ring and the clip-attention
head's verdict replaces the majority vote; responses then carry
clip_probability and clip_frames. In host-prep mode
`analyze_jpeg` takes the JAX engine's route: where the prep it would run
is the heuristic face rung, the resize aligner and the host CLAHE
(`_native_prep_eligible`), one GIL-free host call does the whole of it
(utils/native_prep.prep_frame, csrc/prep_host.cpp); otherwise it decodes
with the port's decoder and calls `analyze`. With
ServerConfig.ingest_scaled_decode the device-detect tick's pooled decode
reconstructs each JPEG at libjpeg's DCT scale M/8, the largest whose
output still covers twice the capture size, before the resize, as the JAX
engine's fast decode does (utils/jpeg_ingest.frames_at).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import DetectorConfig, ServerConfig
from ..core.device import resolve_device
from ..models import backbones
from ..models.caffe_net import CaffeNet
from ..models.mtcnn import MTCNNAligner
from ..models.temporal_head import TemporalHead
from ..pipeline.detector import _ResizeAligner, preprocess_face_quality
from ..pipeline.faces import FaceDetector
from ..state.tracker import (
    VERDICT_NAMES, tracker_stability, tracker_temporal_average,
    tracker_verdict, tracker_voting_stats,
)
from ..state.tree import tree_map
from ..utils.host_resize import resize_analysis
from ..utils.jpeg_ingest import (
    WIRE_PLANES, JpegError, decode_coefs_batch, decode_jpeg, decode_wire_into, frames_at,
    log_refusal, wire_buffer, wire_views,
)
from ..utils.native_prep import prep_frame
from .batcher import (
    StreamStates, clip_head_spec, device_step_compact, init_stream_states,
    make_device_step_detect, make_device_step_detect_wire, reset_streams,
)
from .wsgi import App, Request, jsonify


def _jpeg_dims(data: bytes) -> Optional[tuple]:
    """(h, w) from the JPEG SOF marker — a header scan, no decode.

    Used on the device-detect JPEG path to learn the client frame's size
    before the pooled decode conforms it to detect_capture_hw, so face_bbox
    can be returned in the client's coordinates (reference
    face_detection.py:84-88). None when the bytes are not parsable JPEG."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    i = 2
    while i + 9 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        m = data[i + 1]
        if m == 0xFF:
            # 0xFF fill bytes may pad a marker (ITU T.81 B.1.1.2): resync on
            # the next byte rather than read a fill byte as a marker
            i += 1
            continue
        if m == 0x00:    # FF 00 is a stuffed data byte, not a marker
            i += 2
            continue
        if m == 0xDA:
            # SOS before any SOF: every valid JPEG has SOF first (T.81
            # B.2.1); scanning on would walk entropy-coded data
            return None
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:   # standalone markers
            i += 2
            continue
        if m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7,
                 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):   # SOFn
            h = (data[i + 5] << 8) | data[i + 6]
            w = (data[i + 7] << 8) | data[i + 8]
            return (h, w) if h and w else None
        seglen = (data[i + 2] << 8) | data[i + 3]
        if seglen < 2:
            return None
        i += 2 + seglen
    return None


_INVALID_IMAGE = {"error": "Invalid image format", "status": 400}


@dataclass
class _Pending:
    stream_slot: int
    frame_256: Optional[np.ndarray] = None   # (256,256,3) u8 analysis frame
    face_raw: Optional[np.ndarray] = None    # (160,160,3) aligned RGB or None
    face_hw: tuple = (0, 0)
    faces_detected: int = 0
    bbox: Optional[tuple] = None
    # device-detect mode: the capture-size frame (a host array, or a tensor
    # on the engine's device when the tick decoded it), and the client
    # frame's (h, w) when it was conformed to detect_capture_hw (face_bbox
    # is then scaled back to the client's coordinates)
    frame_capture: Optional[Union[np.ndarray, torch.Tensor]] = None
    orig_hw: Optional[tuple] = None
    # device-detect JPEG path: the raw bytes, decoded by the batcher in one
    # pooled call per tick; need_dims when the request thread's header scan
    # failed, so the client dims come from that decode
    jpeg: Optional[bytes] = None
    need_dims: bool = False
    # owning stream id, checked against the slot table at tick time: a
    # request parked while its stream was LRU-evicted must not write into
    # the slot's new owner's state
    stream_id: Optional[str] = None
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    t_start: float = 0.0


def _check_ingest_plane(server_cfg: ServerConfig) -> None:
    """The JAX engine's checks of ServerConfig.ingest_plane."""
    plane = server_cfg.ingest_plane
    if plane == "bgr":
        return
    if not server_cfg.device_detect:
        raise ValueError("ingest_plane wire formats require device_detect=True (the "
                         "decode finishes inside the device tick)")
    if plane not in WIRE_PLANES:
        raise ValueError(f"unknown ingest_plane {plane!r} (expected 'bgr', 'coef' or "
                         "'ycbcr420')")
    ch, cw = server_cfg.detect_capture_hw
    if ch % 16 or cw % 16:
        raise ValueError("ingest_plane wire formats need detect_capture_hw divisible by "
                         f"16 (got {server_cfg.detect_capture_hw})")


def _device_key(device: torch.device) -> tuple:
    """"cuda" and "cuda:0" name one card."""
    return device.type, device.index or 0


class MultiStreamEngine:
    """Owns the stream table, the batched device state and the batcher and
    drainer threads.

    `params`: a state dict for the backbone module (utils/convert.
    params_from_jax makes one from JAX parameters); None draws parameters
    from a torch.Generator seeded with `seed`. With cfg.clip_window > 0,
    cfg.clip_feature_dim follows the backbone, and `clip_head_params` is a
    state dict of the temporal head (params_from_jax of a JAX head); None
    draws it from a generator seeded with `seed + 1`. `device`: None means CUDA
    (raising when it is absent); pass "cpu" to run on the CPU.
    Device-detect mode needs the SSD: `ssd_net` (a models/caffe_net.CaffeNet,
    moved to the engine's device) or a `face_detector` built with a
    caffemodel. `aligner`: None is the resize aligner; an MTCNNAligner
    aligns on the host (float32 faces), or with cfg.mtcnn_device in
    device-detect mode runs its cascade inside the tick."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 server_cfg: ServerConfig = ServerConfig(),
                 params: Optional[Dict[str, torch.Tensor]] = None, spec=None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0,
                 face_detector: Optional[FaceDetector] = None,
                 ssd_net: Optional[CaffeNet] = None, aligner=None,
                 clip_head_params: Optional[Dict[str, torch.Tensor]] = None):
        _check_ingest_plane(server_cfg)
        self.device = resolve_device(device)
        self.server_cfg = server_cfg
        self.spec = spec if spec is not None else backbones.make("b0")
        if cfg.clip_window > 0:
            # the temporal head consumes whatever the backbone pools to
            cfg = dataclasses.replace(cfg, clip_feature_dim=backbones.feature_dim(self.spec))
        if cfg.calibrator_knots is None:
            # the optional weights/calibrator.pkl, applied inside the tick
            from ..train.calibration import load_default
            cal = load_default()
            if cal is not None and cal.x_ is not None:
                cfg = dataclasses.replace(cfg, calibrator_knots=(
                    tuple(float(v) for v in cal.x_), tuple(float(v) for v in cal.y_)))
        self.cfg = cfg
        model = backbones.build_model(
            self.spec, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        # what the tick takes: the backbone, or in clip mode the backbone
        # and the temporal head, as the JAX tick's params
        self.tick_model = self.model
        if cfg.clip_window > 0:
            head = TemporalHead(clip_head_spec(cfg),
                                generator=torch.Generator().manual_seed(seed + 1))
            if clip_head_params is not None:
                head.load_state_dict(clip_head_params)
            self.tick_model = {"backbone": self.model,
                               "clip_head": head.to(self.device).eval()}
        self.face_detector = face_detector or FaceDetector(
            confidence_threshold=cfg.ssd_confidence_threshold,
            min_face_px=cfg.min_face_px, backend=cfg.face_backend)
        self.aligner = aligner if aligner is not None else _ResizeAligner()
        mtcnn = isinstance(self.aligner, MTCNNAligner)
        # the resize aligner's crops are integer-valued, so they travel as
        # u8; MTCNN's are fractional and keep float32
        self._faces_dtype = np.float32 if mtcnn else np.uint8
        self._haar_probe = None   # the face ladder's effective rung, probed once
        if (cfg.clahe_device and mtcnn
                and not (server_cfg.device_detect and cfg.mtcnn_device)):
            # (an mtcnn_device tick CLAHEs the crop before its cascade)
            raise ValueError("clahe_device requires the resize aligner (u8 crops); "
                             "MTCNN alignment needs the CLAHE'd image on the host")

        # tick-schedule forensic variants: index 0 full tick, 1 fast tick
        if server_cfg.forensic_tick_schedule:
            self._tick_cfgs = (dataclasses.replace(cfg, forensic_schedule="tick_full"),
                               dataclasses.replace(cfg, forensic_schedule="tick_fast"))
        else:
            self._tick_cfgs = (cfg, cfg)
        self._tick_no = 0

        # device-detect mode: one detect step per tick variant, and with a
        # wire plane one wire step per variant
        self._detect_steps = None
        self._wire_steps = None
        if server_cfg.device_detect:
            mtcnn_nets = None
            if cfg.mtcnn_device:
                if not mtcnn:
                    raise ValueError("mtcnn_device requires an MTCNNAligner (its P/R/O-Net "
                                     "weights) on the engine")
                # the tick runs the aligner's own modules
                if _device_key(self.aligner.device) != _device_key(self.device):
                    raise ValueError(f"mtcnn_device needs the MTCNNAligner on the engine's "
                                     f"device ({self.device}), not {self.aligner.device}")
                mtcnn_nets = self.aligner.nets
            elif mtcnn:
                raise ValueError("device_detect pairs with the resize aligner (or "
                                 "cfg.mtcnn_device to run the cascade in the tick); the "
                                 "plain MTCNN aligner is host-side")
            net = ssd_net
            if net is None and self.face_detector._ssd is not None:
                net = self.face_detector._ssd.net
            if net is None:
                raise ValueError(
                    "device_detect requires SSD weights: pass ssd_net= or "
                    "construct the FaceDetector with a caffemodel")
            net = net.to(self.device).eval()
            self._detect_steps = {c: make_device_step_detect(net, self.tick_model, c,
                                                             mtcnn_nets)
                                  for c in dict.fromkeys(self._tick_cfgs)}
            if server_cfg.ingest_plane != "bgr":
                self._wire_steps = {
                    c: make_device_step_detect_wire(net, self.tick_model, c,
                                                    server_cfg.ingest_plane,
                                                    tuple(server_cfg.detect_capture_hw),
                                                    mtcnn_nets)
                    for c in dict.fromkeys(self._tick_cfgs)}

        self.n_slots = server_cfg.max_streams
        # +1 dummy row for the padded entries of compact ticks
        self.states: StreamStates = init_stream_states(self.n_slots + 1, cfg, self.device)
        # bucket sizes: powers of two >= 8 up to max_batch
        self.buckets = []
        b = 8
        while b < min(server_cfg.max_batch, self.n_slots):
            self.buckets.append(b)
            b *= 2
        self.buckets.append(min(server_cfg.max_batch, self.n_slots))
        # wire planes: two host buffers of the largest bucket, pinned on
        # CUDA, taken in turn (a tick decodes into a prefix of one while the
        # other's copy to the device may still run); each buffer's event is
        # recorded after its copy and waited on before the buffer is refilled
        self._wire_bufs: List[torch.Tensor] = []
        self._wire_copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._wire_turn = 0
        if self._wire_steps is not None:
            self._wire_bufs = [wire_buffer(server_cfg.ingest_plane, self.buckets[-1],
                                           *server_cfg.detect_capture_hw,
                                           pin_memory=self.device.type == "cuda")
                               for _ in range(2)]
        self.slot_of: Dict[str, int] = {}
        self.last_request: Dict[int, float] = {}
        self.lock = threading.Lock()
        # resets that land while a tick runs outside the lock; _run_tick
        # re-applies them to the tick's output state
        self._pending_reset: Optional[np.ndarray] = None
        self.queue: List[_Pending] = []
        self.queue_cv = threading.Condition(self.lock)
        self.metrics = {
            "ticks": 0, "frames_total": 0,
            "ewma_tick_latency_ms": 0.0, "ewma_host_prep_ms": 0.0,
            "ewma_batch_size": 0.0, "max_batch_seen": 0,
        }
        self._stop = False
        self._warmup()
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=max(int(server_cfg.pipeline_depth), 1))
        self._thread = threading.Thread(target=self._batcher_loop, daemon=True)
        self._thread.start()
        self._drainer = threading.Thread(target=self._drain_loop, daemon=True)
        self._drainer.start()

    def _ewma(self, key: str, value: float, alpha: float = 0.1):
        cur = self.metrics[key]
        self.metrics[key] = value if cur == 0.0 else (1 - alpha) * cur + alpha * value

    def _tick_inputs(self, b: int):
        h, w = self.cfg.forensic.analysis_size
        m = self.cfg.mtcnn_image_size
        return (np.zeros((b, h, w, 3), np.uint8),
                np.zeros((b, m, m, 3), self._faces_dtype),
                np.zeros(b, bool), np.zeros((b, 2), np.int32), np.zeros(b, bool),
                np.full(b, self.n_slots, np.int32))

    def _dispatch(self, cfg: DetectorConfig, arrays, states: StreamStates):
        dev = [torch.as_tensor(a, device=self.device) for a in arrays]
        if self._detect_steps is not None:   # (frames_capture, active, slot_idx)
            return self._detect_steps[cfg](*dev, states)
        return device_step_compact(self.tick_model, cfg, *dev[:5], dev[5], states)

    def _dispatch_wire(self, cfg: DetectorConfig, arrays, states: StreamStates):
        """A wire step: arrays are the plane's device tensors, then active
        and slot_idx."""
        dev = [torch.as_tensor(a, device=self.device) for a in arrays]
        return self._wire_steps[cfg](*dev, states)

    def _detect_inputs(self, b: int):
        ch, cw = self.server_cfg.detect_capture_hw
        return (np.zeros((b, ch, cw, 3), np.uint8), np.zeros(b, bool),
                np.full(b, self.n_slots, np.int32))

    def _warmup(self):
        """Run every bucket's tick once on all-inactive entries before
        serving, so kernel builds and allocator growth are not paid by a
        request."""
        inputs = self._tick_inputs if self._detect_steps is None else self._detect_inputs
        plane, (ch, cw) = self.server_cfg.ingest_plane, self.server_cfg.detect_capture_hw
        for cfg in dict.fromkeys(self._tick_cfgs):
            for b in self.buckets:
                out, _ = self._dispatch(cfg, inputs(b), self.states)
                out["verdict"].cpu()
                if self._wire_steps is not None:
                    zeros = torch.zeros_like(self._wire_bufs[0][:b], device=self.device)
                    out, _ = self._dispatch_wire(
                        cfg, wire_views(plane, zeros, ch, cw) + inputs(b)[1:], self.states)
                    out["verdict"].cpu()

    # ------------------------------------------------------------- streams

    def _reset_mask_locked(self, mask: np.ndarray) -> None:
        self.states = reset_streams(self.states, torch.from_numpy(mask).to(self.device))
        if self._pending_reset is None:
            self._pending_reset = mask.copy()
        else:
            self._pending_reset |= mask

    def slot_for(self, stream_id: str) -> int:
        with self.lock:
            return self._slot_for_locked(stream_id)

    def _slot_for_locked(self, stream_id: str) -> int:
        if stream_id in self.slot_of:
            return self.slot_of[stream_id]
        if len(self.slot_of) >= self.n_slots:
            # evict the least-recently-used stream
            lru = min(self.slot_of.items(),
                      key=lambda kv: self.last_request.get(kv[1], 0.0))
            slot = lru[1]
            del self.slot_of[lru[0]]
            self.last_request.pop(slot, None)
            mask = np.zeros(self.n_slots + 1, bool)
            mask[slot] = True
            self._reset_mask_locked(mask)
        else:
            slot = len(self.slot_of)
        self.slot_of[stream_id] = slot
        return slot

    def rate_limited(self, slot: int) -> Optional[int]:
        """Check and stamp a slot's rate window: None when admitted, else
        the milliseconds to wait."""
        now = time.time()
        with self.lock:
            last = self.last_request.get(slot, 0.0)
            if now - last < self.server_cfg.min_request_interval:
                return int((self.server_cfg.min_request_interval - (now - last)) * 1000)
            self.last_request[slot] = now
        return None

    def admit(self, stream_id: str) -> Tuple[int, Optional[int]]:
        """Resolve/create the stream's slot AND check+stamp its rate window
        under one lock. Returns (slot, retry_after_ms); admitted iff
        retry_after_ms is None (reference backend_server.py:195-204)."""
        now = time.time()
        with self.lock:
            existing = stream_id in self.slot_of
            slot = self._slot_for_locked(stream_id)
            last = self.last_request.get(slot, 0.0)
            if existing and now - last < self.server_cfg.min_request_interval:
                return slot, int((self.server_cfg.min_request_interval
                                  - (now - last)) * 1000)
            self.last_request[slot] = now
            return slot, None

    def reset(self, stream_id: Optional[str] = None) -> None:
        with self.lock:
            mask = np.zeros(self.n_slots + 1, bool)
            if stream_id is None:
                mask[:] = True
                self.last_request.clear()
            elif stream_id in self.slot_of:
                mask[self.slot_of[stream_id]] = True
                self.last_request.pop(self.slot_of[stream_id], None)
            self._reset_mask_locked(mask)

    def frame_count(self, stream_id: str = "default") -> int:
        with self.lock:
            slot = self.slot_of.get(stream_id)
            states = self.states
        if slot is None:
            return 0
        return int(states.frame_count[slot])

    def stream_stats(self, slot: int) -> dict:
        """/stats scalars for one slot."""
        with self.lock:
            states = self.states
        t = tree_map(lambda x: x[slot:slot + 1], states.tracker)
        fake, real, total = tracker_voting_stats(t)
        vals = torch.stack([
            states.frame_count[slot].to(torch.float64),
            tracker_temporal_average(t)[0].to(torch.float64),
            tracker_stability(t)[0].to(torch.float64),
            tracker_verdict(t)[0].to(torch.float64),
            t.n_scores[0].to(torch.float64), fake[0].to(torch.float64),
            real[0].to(torch.float64), total[0].to(torch.float64)]).cpu().numpy()
        fc, t_avg, stab, verdict, n_scores, nf, nr, nt = vals
        return {
            "frame_count": int(fc),
            "temporal_average": float(np.float32(t_avg)),
            "stability_score": float(np.float32(stab)),
            "confidence_level": VERDICT_NAMES[int(verdict)],
            "history_length": int(n_scores),
            "voting": {"fake_count": int(nf), "real_count": int(nr),
                       "total_frames": int(nt)},
        }

    # --------------------------------------------------------------- intake

    def _native_prep_eligible(self) -> bool:
        """The one-call host prep (utils/native_prep.prep_frame) reproduces
        exactly: heuristic detection + resize aligner + host CLAHE. It is
        used only when the ladder's effective rung is the heuristic (no SSD
        weights and no cascade XML, or face_backend="heuristic"); otherwise
        the Python path runs the real detector, so /analyze always behaves
        as analyze does."""
        if self._detect_steps is not None:   # detection runs in the tick
            return False
        if type(self.aligner) is not _ResizeAligner:
            return False
        if self.cfg.clahe_device:   # the one-call prep applies host CLAHE
            return False
        fd = self.face_detector
        if not isinstance(fd, FaceDetector):
            return False
        if self._haar_probe is None:
            self._haar_probe = fd.backend
        return self._haar_probe == "heuristic"

    def analyze_jpeg(self, data: bytes, stream_id: str = "default",
                     timeout: float = 60.0) -> dict:
        """JPEG bytes in, response out. Device-detect mode: enqueue the raw
        bytes; the batcher decodes the whole tick's JPEGs in one pooled call
        (request threads do no image work). Host-prep mode: decode, resize,
        detect, CLAHE and align in one GIL-free host call when
        `_native_prep_eligible`, else decode here (utils/jpeg_ingest.
        decode_jpeg), then analyze(). A stream the decoder refuses gives
        {"error": "Invalid image format", "status": 400}."""
        if self._detect_steps is None:
            if not self._native_prep_eligible():
                frame = decode_jpeg(data)
                return dict(_INVALID_IMAGE) if frame is None else self.analyze(
                    frame, stream_id, timeout)
            t0 = time.time()
            r = prep_frame(data, self.cfg.forensic.analysis_size, self.cfg.mtcnn_image_size)
            if r is None:
                return dict(_INVALID_IMAGE)
            frame256, aligned, box = r
            slot = self.slot_for(stream_id)
            if aligned is not None and self._faces_dtype == np.float32:
                aligned = aligned.astype(np.float32)
            return self._enqueue(_Pending(
                stream_slot=slot, stream_id=stream_id, frame_256=frame256, face_raw=aligned,
                face_hw=(box[3], box[2]) if box else (0, 0), faces_detected=1 if box else 0,
                bbox=box, t_start=t0), timeout)
        t0 = time.time()
        slot = self.slot_for(stream_id)
        dims = _jpeg_dims(data)
        capture = tuple(self.server_cfg.detect_capture_hw)
        return self._enqueue(_Pending(
            stream_slot=slot, stream_id=stream_id, jpeg=data, t_start=t0,
            orig_hw=dims if dims and dims != capture else None,
            need_dims=dims is None), timeout)

    def analyze(self, frame_bgr: np.ndarray, stream_id: str = "default",
                timeout: float = 60.0) -> dict:
        """Host prep (resize to the analysis frame, face detection, CLAHE,
        alignment), then enqueue for the next tick. Blocks until the tick
        completes.

        In device-detect mode the only host prep is conforming the frame to
        the capture shape; everything else runs in the tick."""
        t0 = time.time()
        slot = self.slot_for(stream_id)
        if self._detect_steps is not None:
            ch, cw = self.server_cfg.detect_capture_hw
            orig_hw = None
            if frame_bgr.shape[:2] != (ch, cw):
                # off-size capture: conform on the host (cv2-exact resize);
                # the tick's box is scaled back at response assembly
                orig_hw = frame_bgr.shape[:2]
                frame_bgr = resize_analysis(frame_bgr, ch, cw)
            return self._enqueue(_Pending(stream_slot=slot, stream_id=stream_id,
                                          frame_capture=frame_bgr, orig_hw=orig_hw,
                                          t_start=t0), timeout)

        h, w = self.cfg.forensic.analysis_size
        frame256 = resize_analysis(frame_bgr, h, w)

        faces = self.face_detector(frame_bgr)
        face_raw, face_hw, bbox = None, (0, 0), None
        if faces:
            x, y, fw, fh = faces[0]
            m = self.server_cfg.align_box_multiple
            if m > 0 and isinstance(self.aligner, MTCNNAligner):
                # the crop rounded up to a multiple of m, clipped to the
                # frame (the JAX engine's bound on MTCNN's compiled sizes)
                fh_frame, fw_frame = frame_bgr.shape[:2]
                fw = min(-(-fw // m) * m, fw_frame - x)
                fh = min(-(-fh // m) * m, fh_frame - y)
            region = frame_bgr[y:y + fh, x:x + fw]
            try:
                # clahe_device: ship the raw aligned crop; the tick applies
                # CLAHE (serving/batcher.py _step_core)
                pre = region if self.cfg.clahe_device else preprocess_face_quality(region)
                face_raw = self.aligner(pre)
            except Exception:   # reference: a failed face drops to forensic-only
                logging.getLogger(__name__).exception("face prep failed")
                face_raw = None
            if face_raw is not None:
                face_hw = (fh, fw)
                bbox = (x, y, fw, fh)

        return self._enqueue(_Pending(stream_slot=slot, stream_id=stream_id,
                                      frame_256=frame256, face_raw=face_raw,
                                      face_hw=face_hw, faces_detected=len(faces),
                                      bbox=bbox, t_start=t0), timeout)

    def _enqueue(self, p: _Pending, timeout: float) -> dict:
        with self.queue_cv:
            self.queue.append(p)
            self.queue_cv.notify()
        if not p.event.wait(timeout):
            raise TimeoutError("device tick timed out")
        return p.result

    # -------------------------------------------------------------- batcher

    def _batcher_loop(self):
        timeout_s = self.server_cfg.batch_timeout_ms / 1000.0
        while not self._stop:
            with self.queue_cv:
                if not self.queue:
                    self.queue_cv.wait(timeout=0.1)
                    continue
                deadline = time.time() + timeout_s
                while (len(self.queue) < self.server_cfg.max_batch
                       and time.time() < deadline):
                    self.queue_cv.wait(timeout=max(deadline - time.time(), 0.001))
                # at most one request per stream slot per tick, so per-stream
                # state updates stay ordered
                batch, taken, rest = [], set(), []
                for p in self.queue:
                    if (len(batch) < self.server_cfg.max_batch
                            and p.stream_slot not in taken):
                        batch.append(p)
                        taken.add(p.stream_slot)
                    else:
                        rest.append(p)
                self.queue = rest
            try:
                self._run_tick(batch)
            except Exception as e:   # the loop must survive: fail the batch
                logging.getLogger(__name__).exception("tick failed")
                for p in batch:
                    p.result = {"error": str(e)}
                    p.event.set()

    def _bucket_for(self, n_req: int) -> int:
        for b in self.buckets:
            if b >= n_req:
                return b
        return self.buckets[-1]

    def _drop_stale(self, batch: List[_Pending]) -> List[_Pending]:
        """Fail requests whose stream was LRU-evicted while queued."""
        with self.lock:
            stale = {id(p) for p in batch
                     if p.stream_id is not None
                     and self.slot_of.get(p.stream_id) != p.stream_slot}
        kept = []
        for p in batch:
            if id(p) in stale:
                p.result = {"error": "stream evicted while request queued "
                                     "(max_streams exceeded)", "status": 409}
                p.event.set()
            else:
                kept.append(p)
        return kept

    def _decode_tick_jpegs(self, entries: List[_Pending]) -> None:
        """Entropy-decode the tick's JPEGs in one pooled host call, then
        reconstruct each same-layout group as one batch on the engine's
        device and conform it to detect_capture_hw (ops/resize, the JAX
        package's resize), at libjpeg's DCT scale with
        ingest_scaled_decode. Refused streams are answered 400 here."""
        hw = tuple(self.server_cfg.detect_capture_hw)
        kept = []
        for p, jc in zip(entries, decode_coefs_batch([p.jpeg for p in entries],
                                                     self.server_cfg.prep_threads)):
            if isinstance(jc, JpegError):
                log_refusal(str(jc))
                p.result = dict(_INVALID_IMAGE)
                p.event.set()
                continue
            if p.need_dims:   # the header scan failed: the decode knows the size
                p.orig_hw = (jc.height, jc.width) if (jc.height, jc.width) != hw else None
            kept.append((p, jc))
        if kept:
            frames = frames_at([jc for _, jc in kept], self.device, hw,
                               scaled=self.server_cfg.ingest_scaled_decode)
            for k, (p, _) in enumerate(kept):
                p.frame_capture = frames[k]

    def _run_tick_wire(self, entries: List[_Pending]) -> set:
        """Wire-plane dispatch (ServerConfig.ingest_plane "coef" or
        "ycbcr420"): one pooled host call decodes the JPEGs' plane into the
        padded bucket's rows of a wire buffer, one copy moves it to the
        device, and the wire step finishes the decode inside the tick.
        Entries that are not eligible (not YCbCr 4:2:0 at detect_capture_hw,
        or not decodable) stay inactive rows here and are left to the
        caller's full-decode path. Returns the id()s of the entries this
        dispatch took."""
        (ch, cw), plane = self.server_cfg.detect_capture_hw, self.server_cfg.ingest_plane
        t_prep = time.time()
        b = self._bucket_for(len(entries))
        k, self._wire_turn = self._wire_turn, 1 - self._wire_turn
        if self._wire_copied[k] is not None:
            self._wire_copied[k].synchronize()   # its last copy to the device is done
        host = self._wire_bufs[k][:b]
        ok = decode_wire_into(plane, [p.jpeg for p in entries], ch, cw, host.numpy(),
                              self.server_cfg.prep_threads)
        if not ok.any():
            return set()
        dev = host.to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._wire_copied[k] = torch.cuda.Event()
            self._wire_copied[k].record()
        self._ewma("ewma_host_prep_ms", (time.time() - t_prep) * 1000)
        active = np.zeros(b, bool)
        slot_idx = np.full(b, self.n_slots, np.int32)
        taken = [(i, p) for i, p in enumerate(entries) if ok[i]]
        for i, p in taken:
            active[i] = True
            slot_idx[i] = p.stream_slot
            if p.need_dims:   # eligibility proved the size is detect_capture_hw
                p.orig_hw = None
        self._launch(self._dispatch_wire, wire_views(plane, dev, ch, cw) + (active, slot_idx),
                     [p for _, p in taken], None, np.array([i for i, _ in taken]))
        return {id(p) for _, p in taken}

    def _run_tick(self, batch: List[_Pending]):
        """Assemble the compact bucketed batch and run one tick; the drainer
        completes the requests. With a wire plane the eligible JPEGs go in
        a wire dispatch first and the rest in a second dispatch of the same
        batcher turn; a slot appears at most once per turn, so each
        stream's updates stay in order."""
        batch = self._drop_stale(batch)
        if self._wire_steps is not None:
            wire = [p for p in batch if p.jpeg is not None]
            if wire:
                taken = self._run_tick_wire(wire)
                batch = [p for p in batch if id(p) not in taken]
        jpegs = [p for p in batch if p.jpeg is not None]
        if jpegs:
            t_prep = time.time()
            self._decode_tick_jpegs(jpegs)
            batch = [p for p in batch if not p.event.is_set()]
            # only ticks that decoded JPEGs count: frame requests prep in
            # their own threads
            self._ewma("ewma_host_prep_ms", (time.time() - t_prep) * 1000)
        if not batch:
            return
        b = self._bucket_for(len(batch))
        if self._detect_steps is not None:
            # has_face comes from the tick's output; frames decoded on the
            # device go in by row after the host frames' one copy
            frames, active, slot_idx = self._detect_inputs(b)
            has_face = None
            rows = []
            for i, p in enumerate(batch):
                slot_idx[i] = p.stream_slot
                active[i] = True
                if isinstance(p.frame_capture, torch.Tensor):
                    rows.append(i)
                else:
                    frames[i] = p.frame_capture
            frames = torch.from_numpy(frames).to(self.device)
            if rows:
                frames[torch.tensor(rows, device=self.device)] = torch.stack(
                    [batch[i].frame_capture for i in rows])
            arrays = (frames, active, slot_idx)
        else:
            arrays = self._tick_inputs(b)
            frames, faces, has_face, face_hw, active, slot_idx = arrays
            for i, p in enumerate(batch):
                slot_idx[i] = p.stream_slot
                frames[i] = p.frame_256
                active[i] = True
                if p.face_raw is not None:
                    faces[i] = p.face_raw
                    has_face[i] = True
                    face_hw[i] = p.face_hw

        self._launch(self._dispatch, arrays, batch, has_face)

    def _launch(self, dispatch, arrays, entries: List[_Pending],
                has_face: Optional[np.ndarray], rows: Optional[np.ndarray] = None):
        """Run one tick through `dispatch` and queue it for the drainer.
        `rows` maps entry k to its row of the tick's output (None: row k)."""
        t_dev = time.time()
        # snapshot the state under the lock, run outside it; resets landing
        # meanwhile are re-applied to the new state below
        with self.lock:
            interval = self.cfg.full_forensic_interval
            tick_cfg = self._tick_cfgs[0 if self._tick_no % interval == 0 else 1]
            self._tick_no += 1
            states = self.states
            self._pending_reset = None
        out, new_states = dispatch(tick_cfg, arrays, states)
        with self.lock:
            if self._pending_reset is not None:
                new_states = reset_streams(
                    new_states, torch.from_numpy(self._pending_reset).to(self.device))
                self._pending_reset = None
            self.states = new_states
        self._inflight.put((out, list(entries), has_face, t_dev, rows))

    def _drain_loop(self):
        while not self._stop:
            try:
                out_dev, entries, has_face, t_dev, rows = self._inflight.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                out = {k: v.cpu().numpy() for k, v in out_dev.items()}
                if rows is not None:   # a wire tick: entry k is row rows[k]
                    out = {k: v[rows] for k, v in out.items()}
                self._complete(out, entries, has_face, t_dev)
            except Exception as e:
                # the drainer must survive any completion error, or the
                # batcher blocks on the full in-flight queue
                logging.getLogger(__name__).exception("tick completion failed")
                for p in entries:
                    if not p.event.is_set():
                        p.result = {"error": str(e)}
                        p.event.set()

    def _complete(self, out: Dict[str, np.ndarray], entries: List[_Pending],
                  has_face: Optional[np.ndarray], t_dev: float):
        if has_face is None:   # device-detect mode: detection ran in the tick
            has_face = out["has_face"]
        m = self.metrics
        n_req = len(entries)
        m["ticks"] += 1
        m["frames_total"] += n_req
        m["max_batch_seen"] = max(m["max_batch_seen"], n_req)
        # dispatch -> completed latency, including in-flight queue wait
        self._ewma("ewma_tick_latency_ms", (time.time() - t_dev) * 1000)
        self._ewma("ewma_batch_size", float(n_req))
        if self._detect_steps is None:   # host prep ran in the request threads
            self._ewma("ewma_host_prep_ms",
                       float(np.mean([(t_dev - p.t_start) * 1000 for p in entries])))

        for i, p in enumerate(entries):
            fake_prob = float(out["fake_probability"][i])
            resp = {
                "success": True,
                "analysis_mode": "face+frame" if has_face[i] else "frame_only",
                "faces_detected": (int(out["faces_detected"][i])
                                   if "faces_detected" in out else p.faces_detected),
                "fake_probability": fake_prob,
                "frame_forensic_probability": float(out["frame_forensic_probability"][i]),
                "real_probability": 1.0 - fake_prob,
                "confidence_level": VERDICT_NAMES[int(out["verdict"][i])],
                "temporal_average": float(out["temporal_average"][i]),
                "stability_score": float(out["stability_score"][i]),
                "frame_count": int(out["frame_count"][i]),
                "processing_time_ms": round((time.time() - p.t_start) * 1000, 1),
            }
            if has_face[i]:
                resp["face_probability"] = float(out["face_probability"][i])
                x, y, fw, fh = (p.bbox if p.bbox is not None
                                else (int(v) for v in out["face_bbox"][i]))
                if p.bbox is None and p.orig_hw is not None:
                    # the tick's box is in detect_capture_hw space: scale it
                    # back to the client's frame
                    oh, ow = p.orig_hw
                    ch, cw = self.server_cfg.detect_capture_hw
                    x = max(0, min(int(round(x * ow / cw)), ow - 1))
                    y = max(0, min(int(round(y * oh / ch)), oh - 1))
                    fw = max(1, min(int(round(fw * ow / cw)), ow - x))
                    fh = max(1, min(int(round(fh * oh / ch)), oh - y))
                resp["face_bbox"] = {"x": int(x), "y": int(y),
                                     "width": int(fw), "height": int(fh)}
            if "clip_probability" in out:   # clip-attention mode
                resp["clip_probability"] = float(out["clip_probability"][i])
                resp["clip_frames"] = int(out["clip_frames"][i])
            p.result = resp
            p.event.set()

    def shutdown(self):
        self._stop = True
        self._thread.join(timeout=2.0)
        self._drainer.join(timeout=2.0)


def create_batched_app(engine: Optional[MultiStreamEngine] = None,
                       server_cfg: ServerConfig = ServerConfig(),
                       device: Optional[Union[str, torch.device]] = None) -> App:
    """WSGI app with the reference surface, backed by the batching engine
    (made on `device` when not given: None means CUDA). Without a stream id
    a request belongs to the "default" stream, the reference's single
    global stream."""
    from .server import _decode_frame, _device_strings
    app = App()
    if engine is None:
        engine = MultiStreamEngine(
            DetectorConfig().with_threshold(server_cfg.detection_threshold), server_cfg,
            device=device)
    app.engine = engine
    device_str, accel_name = _device_strings(engine.device)

    def _stream_id(req: Request) -> str:
        return (req.form.get("stream_id") or req.environ.get("HTTP_X_STREAM_ID")
                or "default")

    @app.route("/health", methods=["GET"])
    def health(_req):
        return jsonify({
            "status": "healthy",
            "model_loaded": True,
            "device": device_str,
            "gpu_name": accel_name,
            "frame_count": engine.frame_count(),
            "capabilities": {"face_detection": True, "frame_forensics": True,
                             "temporal_tracking": True},
        })

    @app.route("/reset", methods=["POST"])
    def reset(req):
        engine.reset(req.form.get("stream_id") or req.environ.get("HTTP_X_STREAM_ID"))
        return jsonify({"success": True, "message": "Detector reset successfully"})

    @app.route("/analyze", methods=["POST"])
    def analyze(req):
        # validate before a slot is allocated: slot_for can LRU-evict (and
        # zero) a live stream, so an invalid request never may
        if "frame" not in req.files:
            return jsonify({"error": "No frame provided"}, 400)
        data = req.files["frame"]
        sid = _stream_id(req)
        # slot resolution, rate check and stamp under one lock (admit)
        _slot, retry = engine.admit(sid)
        if retry is not None:
            return jsonify({"error": "Rate limited", "retry_after_ms": retry}, 429)
        try:
            if data[:2] == b"\xff\xd8":
                result = engine.analyze_jpeg(data, sid)
            else:
                frame = _decode_frame(data)   # None: the port decodes JPEG only
                if frame is None:
                    return jsonify({"error": "Invalid image format"}, 400)
                result = engine.analyze(frame, sid)
            if "error" in result:
                # tick failures surface as error dicts; the reference answers
                # analyze exceptions with 500 (backend_server.py:235)
                return jsonify({"error": result["error"]}, result.get("status", 500))
            return jsonify(result)
        except Exception as e:
            return jsonify({"error": str(e)}, 500)

    @app.route("/metrics", methods=["GET"])
    def metrics(_req):
        """Batching telemetry (not part of the reference surface)."""
        with engine.lock:
            active_streams = len(engine.slot_of)
        return jsonify({**{k: (round(v, 3) if isinstance(v, float) else v)
                           for k, v in engine.metrics.items()},
                        "active_streams": active_streams, "max_streams": engine.n_slots})

    @app.route("/profile", methods=["POST"])
    def profile(req):
        """A torch.profiler trace of the next `seconds` (form field, default
        2, at most 30), written as a Chrome trace into `dir` (default
        torch_profile under the temporary directory)."""
        secs = min(float(req.form.get("seconds", "2")), 30.0)
        outdir = req.form.get("dir", os.path.join(tempfile.gettempdir(), "torch_profile"))
        acts = [torch.profiler.ProfilerActivity.CPU]
        if engine.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        try:
            prof.start()
        except RuntimeError as e:   # e.g. a trace already running
            return jsonify({"success": False, "error": str(e)}, 500)

        def _stop():
            time.sleep(secs)
            try:
                prof.stop()
                os.makedirs(outdir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(outdir, f"trace_{int(time.time())}.json"))
            except Exception:   # a background thread: log, never raise
                logging.getLogger(__name__).exception("profile trace failed")

        threading.Thread(target=_stop, daemon=True).start()
        return jsonify({"success": True, "dir": outdir, "seconds": secs})

    @app.route("/stats", methods=["GET"])
    def stats(req):
        sid = _stream_id(req)
        with engine.lock:
            slot = engine.slot_of.get(sid)
        if slot is None:
            return jsonify({"frame_count": 0, "temporal_average": 0.0,
                            "stability_score": 0.0, "confidence_level": "UNCERTAIN",
                            "history_length": 0,
                            "voting": {"fake_count": 0, "real_count": 0, "total_frames": 0},
                            "device": device_str})
        return jsonify({**engine.stream_stats(slot), "device": device_str})

    return app
