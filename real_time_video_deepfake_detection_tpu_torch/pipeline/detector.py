"""DeepfakeDetector — the single-stream per-frame orchestrator.

Port of real_time_video_deepfake_detection_tpu/pipeline/detector.py along
the server path (reference deepfake_detection.py:292-736,
backend_server.py:117-238):

  frame (BGR u8) -> [host] resize to the analysis frame -> [device]
  forensic signals (full every `full_forensic_interval`-th frame) ->
  [host] face detection -> CLAHE on the crop's Lab L channel -> align ->
  [device] classify (the backbone: EfficientNet, ViT or Xception) ->
  sigmoid -> [host] calibration and
  small-face heuristic -> [device] tracker update -> verdict.

Contracts kept: full forensics iff frame_count % interval == 0, with the
server's off-by-one (the caller increments frame_count after the
forensics); the tracker takes the face probability when a face is analyzed;
a failed face analysis returns (None, None, None) and the frame falls back
to forensic-only, with a warning the first time.

Also here, as in the JAX package: `preprocess_face_quality`, with the JAX
package's ladder of Lab rungs (cv2, native, jnp; an unpinned call takes
cv2's 8-bit conversion, which the port computes without cv2), and the resize
aligner, the host prep of the batched engine.

With `mtcnn_weights_path` (facenet's pnet.pt / rnet.pt / onet.pt, a
directory or one prefixed file) the MTCNN aligner (models/mtcnn.py) aligns
the crops on the detector's device; a path that does not exist keeps the
resize aligner, as in the JAX package.

Not in this slice (each raises NotImplementedError): checkpoint loading
(`weights_path`; the training slices), test-time augmentation, GradCAM,
and `predict` with its overlay drawing (the JAX package draws with cv2).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.config import DetectorConfig
from ..core.device import resolve_device
from ..models import backbones
from ..models.mtcnn import MTCNNAligner
from ..ops import forensics
from ..ops.clahe import clahe_u8_numpy
from ..ops.color import bgr_to_gray_u8, lab_to_rgb_u8_op_by_op, rgb_to_lab_u8_op_by_op
from ..state.forensic_state import ForensicState, forensic_state_init_batch, forensic_state_reset
from ..state.tracker import TemporalTracker
from ..utils.host_resize import resize_analysis
from .classify import apply_small_face_heuristic, classify_batch
from .faces import FaceDetector


LAB_BACKENDS = ("cv2", "native", "jnp")
# the rung an unpinned call takes: the JAX ladder's first, cv2, which the
# port computes without cv2 (ops/lab_u8.py); a test or a benchmark may pin
# another here, as the JAX package's tests pin theirs
_LAB_BACKEND = "cv2"


def preprocess_face_quality(face_bgr: np.ndarray,
                            lab_backend: Optional[str] = None) -> np.ndarray:
    """BGR u8 crop -> BGR u8 crop with CLAHE(2.0, 8x8) applied to the Lab L
    channel (deepfake_detection.py:357-370), with the numpy CLAHE. The Lab
    pair is a rung of the JAX package's ladder, `lab_backend` (None: the
    module's `_LAB_BACKEND`, "cv2"):

      "cv2"     cv2.cvtColor's 8-bit tables, rebuilt in numpy integer
                arithmetic (ops/lab_u8.py), the original repo's conversion
      "native"  the JAX package's float-formula C pair (csrc/lab_host.cpp)
      "jnp"     the JAX package's jnp Lab as its host path calls it, op by
                op (ops/color.py, in torch on the CPU)
    """
    backend = lab_backend or _LAB_BACKEND
    if backend == "cv2":
        from ..ops.lab_u8 import bgr_to_lab_u8_cv2 as to_lab, lab_to_bgr_u8_cv2 as to_bgr
    elif backend == "native":
        from ..utils.native_lab import bgr2lab_native as to_lab, lab2bgr_native as to_bgr
    elif backend == "jnp":
        def to_lab(bgr):
            rgb = torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1]))
            return rgb_to_lab_u8_op_by_op(rgb).numpy()

        def to_bgr(lab):
            return lab_to_rgb_u8_op_by_op(torch.from_numpy(lab)).numpy()[..., ::-1].copy()
    else:
        raise ValueError(f"unknown lab_backend {backend!r} (expected one of {LAB_BACKENDS})")
    lab = to_lab(face_bgr)
    l_eq = clahe_u8_numpy(lab[..., 0], clip_limit=2.0, tiles=8)
    return to_bgr(np.stack([l_eq, lab[..., 1], lab[..., 2]], axis=-1))


class _ResizeAligner:
    """Aligner used without MTCNN weights: the whole CLAHE'd crop ->
    160x160 RGB float (raw 0-255), the JAX package's fallback aligner."""

    def __call__(self, face_bgr_clahe: np.ndarray) -> Optional[np.ndarray]:
        rgb = np.ascontiguousarray(face_bgr_clahe[..., ::-1])
        return resize_analysis(rgb, 160, 160).astype(np.float32)


class DeepfakeDetector:
    """Reference-compatible orchestrator (deepfake_detection.py:292-726).

    `params`: a state dict of the backbone module (utils/convert.
    params_from_jax makes one from JAX parameters); without it an existing
    `weights_path` is loaded (utils/weights: the reference .pth, a JAX
    trainer .npz or the port trainer's .pt; its metadata lands in
    `checkpoint_meta`), else parameters are drawn from a torch.Generator
    seeded with `seed`. `device`: None means CUDA (raising when it is
    absent); pass "cpu" to run on the CPU."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig(),
                 params: Optional[Dict[str, torch.Tensor]] = None, spec=None,
                 weights_path: Optional[str] = None,
                 ssd_weights_path: Optional[str] = None,
                 mtcnn_weights_path: Optional[str] = None,
                 enable_gradcam: bool = False, use_tta: Optional[bool] = None,
                 num_tta_augmentations: int = 1,
                 detection_threshold: Optional[float] = None,
                 face_weight: Optional[float] = None,
                 forensic_weight: Optional[float] = None,
                 device: Optional[Union[str, torch.device]] = None, seed: int = 0):
        if enable_gradcam:
            raise NotImplementedError("enable_gradcam: GradCAM comes with a later slice")
        if cfg.use_tta if use_tta is None else use_tta:
            raise NotImplementedError("use_tta: test-time augmentation comes with a "
                                      "later slice")
        if detection_threshold is not None:
            cfg = cfg.with_threshold(detection_threshold)
        # the reference ctor takes the fusion weights; fold them into cfg, the
        # one source of truth for both serving modes
        if face_weight is not None or forensic_weight is not None:
            cfg = dataclasses.replace(
                cfg,
                face_weight=cfg.face_weight if face_weight is None else face_weight,
                forensic_weight=(cfg.forensic_weight if forensic_weight is None
                                 else forensic_weight))
        self.device = resolve_device(device)
        self.cfg = cfg
        self.spec = spec if spec is not None else backbones.make("b0")
        self.use_tta = False
        self.num_tta_augmentations = num_tta_augmentations
        self.enable_gradcam = False
        self.detection_threshold = cfg.detection_threshold
        model = backbones.build_model(self.spec, generator=torch.Generator().manual_seed(seed))
        # without parameters the reference falls back to ImageNet weights
        # (deepfake_detection.py:78-81); none ship here, so random ones, flagged
        self.checkpoint_meta = {}
        if params is None and weights_path and os.path.exists(weights_path):
            from ..utils.weights import load_params_and_meta
            params, self.checkpoint_meta = load_params_and_meta(weights_path, self.spec)
        self.model_loaded = params is not None
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()
        self.params = self.model.state_dict()

        self.face_detector = FaceDetector(
            ssd_weights_path=ssd_weights_path,
            confidence_threshold=cfg.ssd_confidence_threshold,
            min_face_px=cfg.min_face_px, backend=cfg.face_backend, device=self.device)
        self.aligner = _ResizeAligner()
        if mtcnn_weights_path and os.path.exists(mtcnn_weights_path):
            self.aligner = MTCNNAligner.from_weights(mtcnn_weights_path, device=self.device)
        self.temporal_tracker = TemporalTracker(
            window_size=cfg.tracker.window_size,
            high_confidence_threshold=cfg.tracker.high_confidence_threshold,
            voting_window=cfg.tracker.voting_window,
            detection_threshold=cfg.detection_threshold, device=self.device)
        self.frame_count = 0
        self.full_forensic_interval = cfg.full_forensic_interval
        self.forensic_state: ForensicState = forensic_state_init_batch(
            1, cfg.forensic, self.device)
        self.last_frame_forensic_result = None
        self._face_path_warned = False

        # the optional weights/calibrator.pkl (deepfake_detection.py:334-342)
        from ..train.calibration import load_default
        self.calibrator = load_default()

    # Reference-API attributes (deepfake_detection.py:315-316), views of cfg;
    # assignment writes through so both serving modes stay in agreement.
    @property
    def face_weight(self) -> float:
        return self.cfg.face_weight

    @face_weight.setter
    def face_weight(self, v: float) -> None:
        self.cfg = dataclasses.replace(self.cfg, face_weight=float(v))

    @property
    def forensic_weight(self) -> float:
        return self.cfg.forensic_weight

    @forensic_weight.setter
    def forensic_weight(self, v: float) -> None:
        self.cfg = dataclasses.replace(self.cfg, forensic_weight=float(v))

    # ------------------------------------------------------------------ state

    def reset(self) -> None:
        """(deepfake_detection.py:344-355)."""
        self.temporal_tracker.reset()
        self.frame_count = 0
        self.forensic_state = forensic_state_reset(self.forensic_state)
        self.last_frame_forensic_result = None

    # -------------------------------------------------------------- forensics

    def analyze_frame_forensics(self, frame_bgr: np.ndarray) -> dict:
        """Adaptive full/fast scheduling (deepfake_detection.py:504-515)."""
        full = self.frame_count % self.full_forensic_interval == 0
        h, w = self.cfg.forensic.analysis_size
        resized = torch.from_numpy(resize_analysis(frame_bgr, h, w)).to(self.device)
        res, self.forensic_state = forensics.analyze_frame(
            resized, self.forensic_state, full, self.cfg.forensic)
        keys = (["frequency", "noise", "ela", "edge", "color", "temporal"] if full
                else ["frequency", "temporal", "edge"])
        vals = torch.stack([res[k].to(torch.float64) for k in
                            keys + ["fake_probability", "frame_number"]]).cpu().tolist()
        result = {
            "scores": dict(zip(keys, vals)),
            "fake_probability": vals[-2],
            "analysis_type": "frame_forensic" if full else "frame_forensic_fast",
            "frame_number": int(vals[-1]),
        }
        self.last_frame_forensic_result = result
        return result

    # ------------------------------------------------------------- face path

    def _single_prediction(self, face_bgr: np.ndarray) -> Optional[float]:
        """(deepfake_detection.py:372-406)."""
        try:
            aligned = self.aligner(face_bgr)   # RGB float (160,160,3), raw 0-255
            if aligned is None:
                return None
            probs = classify_batch(self.model, torch.from_numpy(aligned)[None].to(self.device),
                                   self.cfg.model_input_size, self.cfg.bf16_inference)
            return float(probs[0])
        except Exception:   # reference: a failed prediction is None
            return None

    def apply_calibration(self, raw_prob: float) -> float:
        if self.calibrator is None:
            return raw_prob
        try:
            return float(self.calibrator.predict_proba([[raw_prob]])[0][1])
        except Exception:
            return raw_prob

    def analyze_frequency_domain(self, face_bgr: np.ndarray) -> float:
        """High-frequency-deficit boost (deepfake_detection.py:457-487, dead
        code on the reference's serving path): 0.15 when the energy outside
        the central low-frequency square of the FFT magnitude is < 15%."""
        try:
            gray = bgr_to_gray_u8(torch.from_numpy(
                np.ascontiguousarray(face_bgr)).to(self.device)).to(torch.float32)
            mag = torch.abs(torch.fft.fftshift(torch.fft.fft2(gray)))
            h, w = mag.shape
            ch, cw = h // 2, w // 2
            m = min(h, w) // 4
            center = torch.zeros_like(mag, dtype=torch.bool)
            center[ch - m:ch + m, cw - m:cw + m] = True
            high = torch.where(center, torch.zeros_like(mag), mag).sum()
            ratio = float(high / (mag.sum() + 1e-10))
            return 0.15 if ratio < 0.15 else 0.0
        except Exception:
            return 0.0

    def apply_heuristics(self, fake_prob: float, face_bgr: np.ndarray) -> float:
        h, w = face_bgr.shape[:2]
        return apply_small_face_heuristic(
            fake_prob, h, w, self.cfg.small_face_px, self.cfg.small_face_boost)

    def analyze_face(self, face_bgr: np.ndarray):
        """(fake_prob, fake_prob, None) or (None, None, None)
        (deepfake_detection.py:517-550)."""
        try:
            fake_prob = self._single_prediction(preprocess_face_quality(face_bgr))
            if fake_prob is None:
                return None, None, None
            fake_prob = self.apply_calibration(fake_prob)
            fake_prob = self.apply_heuristics(fake_prob, face_bgr)
            return fake_prob, fake_prob, None
        except Exception as e:
            # the reference falls back to forensic-only (:548-550); a lasting
            # failure changes every verdict, so say so the first time
            if not self._face_path_warned:
                self._face_path_warned = True
                warnings.warn("face analysis failed; verdicts degrade to forensic-only "
                              f"until the cause clears: {e!r}", RuntimeWarning, stacklevel=2)
            return None, None, None

    def predict(self, frame_bgr: np.ndarray):
        """The reference's library entry point draws its overlays with cv2;
        it comes with the CLI slice."""
        raise NotImplementedError("predict and its overlay drawing come with the CLI slice")
