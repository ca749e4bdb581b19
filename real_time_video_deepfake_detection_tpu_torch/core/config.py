"""Typed configuration tree for the whole framework.

A copy of real_time_video_deepfake_detection_tpu/core/config.py with the
same dataclasses and defaults; the port keeps its own copy so that it never
imports the JAX package.

One dataclass config tree replaces the reference's three ad-hoc mechanisms
(argparse flags, constructor kwargs, module constants — SURVEY.md §5
"Config / flag system"). Every tunable the reference exposes is preserved
with the reference's default value; citations point at the reference source
of each default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Temporal voting tracker (reference: deepfake_detection.py:99-118).

    The verdict contract (deepfake_detection.py:120-196):
      - a frame votes FAKE iff fake_probability is STRICTLY > detection_threshold
      - verdict is UNCERTAIN until `voting_window` votes are collected
      - then verdict = majority of the last `voting_window` votes, tie -> REAL
    """

    window_size: int = 60          # score history depth (:99)
    voting_window: int = 10        # votes before a verdict (:99)
    detection_threshold: float = 0.5   # strict-> FAKE threshold (:99; server uses 0.55)
    high_confidence_threshold: float = 0.6  # forensic-trigger threshold (:99)
    variance_window: int = 30      # variance_history depth (:112)
    alert_cooldown: float = 5.0    # seconds between forensic triggers (:114)


@dataclasses.dataclass(frozen=True)
class ForensicConfig:
    """Frame-level forensic analyzer (reference: frame_analysis.py:22-56)."""

    analysis_size: Tuple[int, int] = (256, 256)  # (:28-34)
    temporal_window: int = 30                    # temporal_diffs deque (:36)
    # Full-analysis weights (:49-56)
    w_frequency: float = 0.25
    w_noise: float = 0.20
    w_ela: float = 0.20
    w_edge: float = 0.15
    w_color: float = 0.10
    w_temporal: float = 0.10
    # Fast-analysis weights (:118)
    fast_w_frequency: float = 0.45
    fast_w_temporal: float = 0.25
    fast_w_edge: float = 0.30


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Detection orchestrator (reference: deepfake_detection.py:300-342)."""

    detection_threshold: float = 0.5   # (:733 module default; 0.55 in server :57)
    # Isotonic-calibrator knots ((x...), (y...)) applied to the FACE
    # probability between sigmoid and the small-face heuristic — the
    # reference's apply_calibration-then-apply_heuristics order
    # (deepfake_detection.py:535-538). Tuples (hashable) so the config
    # stays a static jit argument; the batched engine fills this from
    # weights/calibrator.pkl at construction. None = identity.
    calibrator_knots: Optional[Tuple[Tuple[float, ...],
                                     Tuple[float, ...]]] = None
    face_weight: float = 0.70          # configurable fusion (:734); NOTE: the
    forensic_weight: float = 0.30      # reference's effective behavior is
    # face-only when a face is present (deepfake_detection.py:620-623) — that
    # is the default here for verdict parity; set fuse_forensics=True to get
    # the documented 70/30 blend (README.md:283-284, never active in ref code).
    fuse_forensics: bool = False
    use_tta: bool = False              # (:731 — disabled in prod)
    num_tta_augmentations: int = 1     # (:732)
    full_forensic_interval: int = 3    # full analysis every Nth frame (:330)
    small_face_px: int = 80            # +0.10 heuristic below this size (:494-496)
    small_face_boost: float = 0.10     # (:496)
    min_face_px: int = 20              # SSD box size filter (face_detection.py:102)
    ssd_confidence_threshold: float = 0.5  # (face_detection.py:37)
    # Detector ladder rung (pipeline/faces.py): "auto" = ssd -> cv2 haar ->
    # from-scratch haar (models/haar_cascade.py) -> skin heuristic; pinning
    # "heuristic" keeps the fully-native GIL-free prep fast path eligible.
    face_backend: str = "auto"
    model_input_size: int = 224        # classifier input (:383)
    mtcnn_image_size: int = 160        # MTCNN crop size (facenet default)
    # bf16 classifier compute (MXU fast path; ~1e-3-level prob deviations —
    # keep False when bit-comparing verdicts against the reference)
    bf16_inference: bool = False
    # bf16 SSD trunk in device-detect mode (decode/NMS stay f32). Detected
    # BOXES are integers, so small logit drift usually changes nothing; the
    # bench enables this only behind a boxes-identical guard. Keep False for
    # strict reference parity.
    ssd_bf16: bool = False
    # Fused resize+normalize preproc kernel (kernels/preproc.py; in this
    # package the hand-written CUDA kernel csrc/preproc.cu on a CUDA device,
    # its plain torch version on the CPU). The flag keeps the JAX package's
    # name so the two configurations read the same.
    use_pallas_preproc: bool = False
    # Unique-hue count kernel in the forensic color signal
    # (kernels/color_stats.py -> csrc/color_stats.cu; ops/forensics.py wires
    # it through).
    use_pallas_color: bool = False
    # CLAHE on device applied to the ALIGNED
    # 160x160 crop instead of host CLAHE on the pre-align crop — an
    # approximation (CLAHE and resize commuted) that removes per-face host
    # work; resize-aligner mode only (serving/multi.py enforces).
    clahe_device: bool = False
    # MTCNN alignment INSIDE the device-detect tick (batcher
    # make_device_step_detect): the SSD crop is resized to mtcnn_image_size
    # (static shape -> static pyramid), CLAHE'd (when clahe_device — the
    # reference's order, CLAHE before MTCNN, deepfake_detection.py:357-383),
    # then the full P/R/O cascade + PIL-parity extract runs batched on
    # device (models/mtcnn.mtcnn_align_batch). Deviation vs the host MTCNN
    # aligner: the cascade sees the RESIZED crop, not the original
    # dynamic-size crop (docs/DESIGN.md). Requires an MTCNNAligner (its
    # converted facenet weights) on the engine.
    mtcnn_device: bool = False
    # Padded box capacities for the in-tick cascade (P/R/O stages). The
    # host aligner uses (256, 64, 16); an SSD face crop holds at most one
    # face, so smaller caps cut the in-tick NMS cost.
    mtcnn_tick_caps: Tuple[int, int, int] = (64, 16, 8)
    # Forensic full/fast scheduling:
    #   "frame"     - per-stream, full every full_forensic_interval-th frame
    #                 by that stream's count (reference semantics,
    #                 deepfake_detection.py:329-330) — the default
    #   "tick_full" - force the full six-signal set for every stream
    #   "tick_fast" - fast trio only; the full-only signals (noise/ELA/
    #                 color) are NOT COMPUTED, cutting the tick's forensic
    #                 cost. The engine's tick-schedule mode alternates the
    #                 two tick variants; for streams that tick every tick
    #                 from frame 0 this is output-identical to "frame".
    forensic_schedule: str = "frame"
    # Clip-attention verdict mode (BASELINE config 5): when clip_window > 0
    # the per-stream majority vote is REPLACED by a temporal-attention head
    # (models/temporal_head.py) over a ring of the last clip_window backbone
    # feature vectors; UNCERTAIN until clip_min_frames face frames are seen.
    clip_window: int = 0
    clip_min_frames: int = 10          # mirrors the vote-window gating
    clip_feature_dim: int = 1280       # B0 pooled features; 384/768 for ViT
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    forensic: ForensicConfig = dataclasses.field(default_factory=ForensicConfig)

    def with_threshold(self, t: float) -> "DetectorConfig":
        return dataclasses.replace(
            self,
            detection_threshold=t,
            tracker=dataclasses.replace(self.tracker, detection_threshold=t),
        )


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """HTTP serving frontend (reference: backend_server.py:57-80, 275)."""

    host: str = "0.0.0.0"
    port: int = 5000
    detection_threshold: float = 0.55      # (:57)
    min_request_interval: float = 0.1      # rate limit, seconds (:63)
    # Batching frontend (new, TPU-native): collect up to max_batch frames or
    # wait batch_timeout_ms, then run one device step over the padded batch.
    max_batch: int = 64
    batch_timeout_ms: float = 5.0
    max_streams: int = 64
    # In-flight device ticks the batcher may dispatch before the drainer has
    # read back results (depth-2 overlaps host<->device sync with compute).
    pipeline_depth: int = 2
    # Tick-level forensic scheduling: the batcher alternates a full-signal
    # tick program (every detector full_forensic_interval-th tick) with a
    # fast-trio program that SKIPS the noise/ELA/color compute (~18% faster
    # ticks measured). Output-identical to the per-stream "frame" schedule
    # for streams that tick every tick from frame 0; streams that join late
    # or skip ticks follow the tick phase instead of their own frame count
    # (documented deviation — keep False for reference-exact scheduling).
    forensic_tick_schedule: bool = False
    # Device-detect mode (config 4+: capture->verdict in ONE program/tick):
    # SSD-Res10 detection, the 300/256 resizes, dynamic crop+align, CLAHE
    # (when clahe_device), classification and the tracker all run inside the
    # device tick (serving/batcher.make_device_step_detect). Requires SSD
    # weights (an engine ssd_net / FaceDetector caffemodel) and the resize
    # aligner; host work per request drops to JPEG decode (+ a resize to
    # detect_capture_hw when the capture size differs). Recommended with
    # clahe_device=True to keep the reference's CLAHE (device-side,
    # commuted-approximation variant).
    device_detect: bool = False
    # Fixed capture shape for the device-detect program (XLA needs static
    # shapes; 480x640 matches the default test/bench capture).
    detect_capture_hw: Tuple[int, int] = (480, 640)
    # Threads for the per-tick pooled native JPEG decode+resize
    # (native/ingest.cpp ingest_decode_resize_batch): in device-detect mode
    # requests enqueue RAW JPEG bytes and the batcher drains the whole tick
    # through ONE GIL-free native call. 0 = the native default
    # (hardware_concurrency).
    prep_threads: int = 0
    # Use libjpeg DCT-scaled decode in the pooled tick ingest: decode at the
    # smallest M/8 scale that stays >= 2x detect_capture_hw, then resize.
    # Cuts the dominant host-decode cost on large captures at the price of
    # pixel values that are no longer bit-identical to the reference's
    # full-decode path (docs/DESIGN.md "Known numeric deviations"). Off by
    # default: exactness is the contract.
    ingest_scaled_decode: bool = False
    # Wire format for device-detect JPEG ingest — where the JPEG codec is
    # split between host and device (native/ingest.cpp + ops/jpeg_decode.py;
    # both BIT-EXACT vs the full host decode):
    #   "bgr"       full decode on host, BGR u8 upload (3 B/px) — default.
    #   "coef"      host does the Huffman/entropy decode ONLY; quantized DCT
    #               coefficients upload (3 B/px); dequant/IDCT/upsample/color
    #               run inside the tick. Collapses the per-core host-decode
    #               ceiling (the reference's cv2.imdecode cost,
    #               backend_server.py:140-142) by ~2-3x.
    #   "ycbcr420"  host decodes to raw 4:2:0 planes (IDCT on host, no
    #               upsample/color); 1.5 B/px upload — halves host->device
    #               bytes for transfer-bound links.
    # JPEGs that are not 8-bit YCbCr 4:2:0 at exactly detect_capture_hw fall
    # back to the full-decode path automatically (second dispatch that tick).
    ingest_plane: str = "bgr"
    # When the MTCNN aligner is active, expand each detector box up to a
    # multiple of this (clamped to the frame) before cropping. The JAX MTCNN
    # compiles one program per exact crop size (facenet is eager — any jit
    # port must); quantizing the crop bounds the number of compiled sizes in
    # live serving where boxes wobble every frame. 0 = exact boxes
    # (reference behavior, deepfake_detection.py:376-383).
    align_box_multiple: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training stack defaults (reference: train.py:1090-1138 CLI defaults)."""

    epochs: int = 20                   # (train.py:1097)
    batch_size: int = 32               # (train.py:1098)
    grad_accum: int = 2
    lr: float = 3e-4
    backbone_lr_mult: float = 0.1      # differential LR (train.py:891-910)
    weight_decay: float = 0.05         # (train.py:1101)
    head_dropout: float = 0.5          # head Dropout base rate; the second and
    #                                    third head dropouts are 0.7x / 0.5x of
    #                                    it (model.py:51-59, train.py:1102)
    label_smoothing: float = 0.1       # FocalLoss ls (train.py:360-392)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    ema_decay: float = 0.999           # (train.py:398-436)
    mixup_alpha: float = 0.3           # (train.py:1109)
    cutmix_alpha: float = 0.3          # (train.py:1111)
    mixup_prob: float = 0.5            # 50% of batches augmented (train.py:546-629)
    clip_norm: float = 1.0
    freeze_frac: float = 0.6           # freeze stem + first 60% of blocks (:863-876)
    # BN running-stat momentum override. None = each donor architecture's
    # default (efficientnet_pytorch/keras backbone 0.01, torch BatchNorm1d
    # head 0.1) — correct when warm-starting from pretrained stats, as the
    # reference always does (model.py:36 pretrained=True). COLD-start
    # training should raise it (0.1-0.2): at 0.01 the stats need ~500 steps
    # to leave their (0,1) init, and a random-init EfficientNet evaluated
    # with init stats collapses to ~0 features (the SE/swish shrink
    # compounds with nothing renormalizing it).
    bn_momentum: Optional[float] = None
    early_stop_patience: int = 5       # (train.py:1123)
    image_size: int = 224
    seed: int = 42
    # bf16 forward/backward with f32 master params — the TPU analogue of the
    # reference's AMP (train.py:581,927); no loss scaler needed since bf16
    # keeps fp32's exponent range (SURVEY.md §2.9).
    bf16_compute: bool = False
