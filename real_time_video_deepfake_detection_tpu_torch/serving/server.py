"""HTTP serving front end — the reference's API surface.

Port of real_time_video_deepfake_detection_tpu/serving/server.py. Routes
and JSON schemas are the reference's (backend_server.py:82-255), so the
Chrome extension (extension/content.js) works unchanged:

  GET  /health  -> status/model_loaded/device/gpu_name/frame_count/capabilities
  POST /reset   -> {success, message}
  POST /analyze -> face / frame_only result schema (+400/429/500 errors)
  GET  /stats   -> frame_count/temporal_average/stability_score/...

Rate limiting: >= 100 ms between /analyze requests -> 429 with
retry_after_ms (backend_server.py:61-80).

Frames are decoded by the port's own decoders on the JAX server's ladder
(utils/image_decode.decode_frame): bytes that start FF D8 through the
libjpeg route, then the cv2 route (JPEG with CMYK and YCCK, lossless
JPEG, PNG, BMP, EXIF orientation). What both refuse (12-bit JPEGs, the
other formats cv2 reads, a stream neither libjpeg nor cv2 decodes) answers
400 "Invalid image format", the reasons logged once.

    python -m real_time_video_deepfake_detection_tpu_torch.serving.server [--batched ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import pickle
import threading
import time
from socketserver import ThreadingMixIn
from typing import Optional, Tuple, Union
from wsgiref.simple_server import WSGIRequestHandler, WSGIServer
from wsgiref.simple_server import make_server as _wsgi_make_server

import numpy as np
import torch

from ..core.config import DetectorConfig, ServerConfig
from ..models import backbones
from ..models.temporal_head import TemporalHead
from ..pipeline.detector import DeepfakeDetector
from ..utils.image_decode import as_bgr, decode_frame
from .batcher import clip_head_spec
from .wsgi import App, Request, Response, jsonify

logger = logging.getLogger(__name__)


def _decode_frame(data: bytes) -> Optional[np.ndarray]:
    """Image bytes -> BGR u8 (H, W, 3) on the JAX server's ladder (native
    libjpeg route for FF D8, then the cv2 route; a one-channel frame gets
    three); None (the reasons logged once) when both refuse."""
    return as_bgr(decode_frame(data))


def _device_strings(device: Union[str, torch.device]) -> Tuple[str, Optional[str]]:
    """/health's `device` and `gpu_name`."""
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        return f"cuda:{idx}", torch.cuda.get_device_name(idx)
    return "cpu", None


class ThreadingWSGIServer(ThreadingMixIn, WSGIServer):
    """wsgiref's server with a thread per request (the reference runs Flask
    threaded)."""
    daemon_threads = True
    # socketserver's listen backlog of 5 resets connections when a few tens
    # of streams send at once (tests/test_torch_http.py
    # test_server_takes_a_burst_of_connections); the batched engine serves
    # up to 64 streams
    request_queue_size = 128


def make_server(host: str, port: int, app: App, handler_class=WSGIRequestHandler):
    """A threaded WSGI server for `app` bound to (host, port); port 0 picks
    a free one (server.server_port)."""
    return _wsgi_make_server(host, port, app, server_class=ThreadingWSGIServer,
                             handler_class=handler_class)


def create_app(detector: Optional[DeepfakeDetector] = None,
               server_cfg: ServerConfig = ServerConfig(),
               device: Optional[Union[str, torch.device]] = None) -> App:
    """Single-stream app. Without a detector, one is made on `device` (None:
    CUDA, raising when it is absent)."""
    app = App()
    if detector is None:
        detector = DeepfakeDetector(
            DetectorConfig().with_threshold(server_cfg.detection_threshold), device=device)
    app.detector = detector   # exposed for tests

    rate_lock = threading.Lock()
    state = {"last_request_time": 0.0}
    device_str, accel_name = _device_strings(detector.device)

    @app.route("/health", methods=["GET"])
    def health(_req: Request) -> Response:
        return jsonify({
            "status": "healthy",
            "model_loaded": detector.model_loaded or detector.params is not None,
            "device": device_str,
            "gpu_name": accel_name,
            "frame_count": detector.frame_count,
            "capabilities": {
                "face_detection": True,
                "frame_forensics": True,
                "temporal_tracking": True,
            },
        })

    @app.route("/reset", methods=["POST"])
    def reset(_req: Request) -> Response:
        try:
            detector.reset()
            return jsonify({"success": True, "message": "Detector reset successfully"})
        except Exception as e:
            logger.exception("reset failed")
            return jsonify({"success": False, "error": str(e)}, 500)

    @app.route("/analyze", methods=["POST"])
    def analyze(req: Request) -> Response:
        with rate_lock:   # backend_server.py:66-80
            now = time.time()
            elapsed = now - state["last_request_time"]
            if elapsed < server_cfg.min_request_interval:
                return jsonify({
                    "error": "Rate limited",
                    "retry_after_ms": int((server_cfg.min_request_interval - elapsed) * 1000),
                }, 429)
            state["last_request_time"] = now

        start_time = time.time()
        try:
            if "frame" not in req.files:
                return jsonify({"error": "No frame provided"}, 400)
            frame = _decode_frame(req.files["frame"])
            if frame is None:
                return jsonify({"error": "Invalid image format"}, 400)

            # server-path order: forensics first, then faces, then the frame
            # count (backend_server.py:147-156)
            frame_forensic = detector.analyze_frame_forensics(frame)
            frame_forensic_prob = frame_forensic["fake_probability"]
            faces = detector.face_detector(frame)
            detector.frame_count += 1

            if len(faces) > 0:
                x, y, w, h = faces[0]
                fake_prob, _, _ = detector.analyze_face(frame[y:y + h, x:x + w])
                if fake_prob is not None:
                    detector.temporal_tracker.update(fake_prob)
                    tracker = detector.temporal_tracker
                    processing_time = (time.time() - start_time) * 1000
                    return jsonify({
                        "success": True,
                        "analysis_mode": "face+frame",
                        "faces_detected": len(faces),
                        "fake_probability": float(fake_prob),
                        "face_probability": float(fake_prob),
                        "frame_forensic_probability": float(frame_forensic_prob),
                        "real_probability": float(1 - fake_prob),
                        "confidence_level": tracker.get_confidence_level(),
                        "temporal_average": float(tracker.get_temporal_average()),
                        "stability_score": float(tracker.get_stability_score()),
                        "frame_count": detector.frame_count,
                        "processing_time_ms": round(processing_time, 1),
                        "face_bbox": {"x": int(x), "y": int(y),
                                      "width": int(w), "height": int(h)},
                    })

            detector.temporal_tracker.update(frame_forensic_prob)
            tracker = detector.temporal_tracker
            processing_time = (time.time() - start_time) * 1000
            return jsonify({
                "success": True,
                "analysis_mode": "frame_only",
                "faces_detected": len(faces),
                "fake_probability": float(frame_forensic_prob),
                "frame_forensic_probability": float(frame_forensic_prob),
                "real_probability": float(1 - frame_forensic_prob),
                "confidence_level": tracker.get_confidence_level(),
                "temporal_average": float(tracker.get_temporal_average()),
                "stability_score": float(tracker.get_stability_score()),
                "frame_count": detector.frame_count,
                "processing_time_ms": round(processing_time, 1),
            })
        except Exception as e:
            logger.exception("error analyzing frame")
            return jsonify({"error": str(e)}, 500)

    @app.route("/stats", methods=["GET"])
    def stats(_req: Request) -> Response:
        try:
            tracker = detector.temporal_tracker
            return jsonify({
                "frame_count": detector.frame_count,
                "temporal_average": float(tracker.get_temporal_average()),
                "stability_score": float(tracker.get_stability_score()),
                "confidence_level": tracker.get_confidence_level(),
                "history_length": tracker.history_length,
                "voting": tracker.get_voting_stats(),
                "device": device_str,
            })
        except Exception as e:
            return jsonify({"error": str(e)}, 500)

    return app


def serve(host: str = "0.0.0.0", port: int = 5000,
          detector: Optional[DeepfakeDetector] = None,
          server_cfg: Optional[ServerConfig] = None) -> None:
    """Threaded WSGI server on (host, port) (backend_server.py:275); an
    explicit ServerConfig's host and port take precedence."""
    cfg = server_cfg or ServerConfig(host=host, port=port)
    httpd = make_server(cfg.host, cfg.port, create_app(detector, cfg))
    logger.info("deepfake detection server on http://%s:%d", cfg.host, cfg.port)
    httpd.serve_forever()


def _load_or_exit(flag: str, path: Optional[str], load, *args):
    """load(*args), or an exit naming the flag and the file when it fails."""
    try:
        return load(*args)
    except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
        raise SystemExit(f"{flag} {path}: {e}")


def _load_clip_head(path: str, cfg: DetectorConfig, spec):
    """--clip-head: the temporal head's state dict from a JAX trainer .npz
    (train/clip_head.py's params) or the port's .pt."""
    from ..utils.weights import read_state_dict
    hcfg = dataclasses.replace(cfg, clip_feature_dim=backbones.feature_dim(spec))
    return read_state_dict(path, TemporalHead(clip_head_spec(hcfg)))[0]


def main(argv=None):
    p = argparse.ArgumentParser(description="Deepfake detection server (PyTorch port)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:1, cpu)")
    p.add_argument("--weights", default=None,
                   help="classifier weights: best_model.pth (reference torch format, "
                        "EfficientNet only), a JAX trainer .npz or the port trainer's "
                        ".pt (any backbone; a resume checkpoint serves its EMA weights)")
    p.add_argument("--backbone", default="b0", choices=backbones.backbone_names(),
                   help="classifier backbone: EfficientNet b0..b7, vit_s16/b16/l16 or "
                        "xception; with --clip-window the temporal head's feature dim "
                        "follows it")
    p.add_argument("--threshold", type=float, default=0.55)
    p.add_argument("--batched", action="store_true",
                   help="multi-stream dynamic-batching engine: clients may send "
                        "stream_id / X-Stream-Id")
    p.add_argument("--max-streams", type=int, default=64)
    p.add_argument("--batch-timeout-ms", type=float, default=5.0)
    p.add_argument("--max-batch", type=int, default=64,
                   help="cap on requests per device tick")
    p.add_argument("--mtcnn-weights", default=None,
                   help="facenet-pytorch MTCNN weights (a directory of pnet.pt/rnet.pt/"
                        "onet.pt, or one .pt with prefixed keys): the MTCNN aligner in "
                        "the face path")
    p.add_argument("--clip-window", type=int, default=0,
                   help="batched mode: the temporal-attention head over the last N "
                        "backbone feature vectors of a stream replaces the majority "
                        "vote (BASELINE config 5); 0 = off")
    p.add_argument("--clip-head", default=None,
                   help="temporal-head weights (a JAX .npz or the port's .pt, as "
                        "train/clip_head.py saves them); drawn from a seed when omitted")
    p.add_argument("--face-backend", default="auto",
                   choices=["auto", "ssd", "haar", "haar_native", "heuristic"],
                   help="pin a detector-ladder rung (pipeline/faces.py)")
    p.add_argument("--ssd-weights", default=None,
                   help="res10 caffemodel path (deploy.prototxt alongside); enables "
                        "the SSD rung and --device-detect")
    p.add_argument("--device-detect", action="store_true",
                   help="batched mode only: SSD detection, crop/align and CLAHE "
                        "inside the device tick; requires --ssd-weights")
    p.add_argument("--scaled-decode", action="store_true",
                   help="batched mode: pooled tick ingest uses libjpeg DCT-scaled decode "
                        "(>=2x target) before the resize — cuts host decode cost on large "
                        "captures; pixels deviate from the reference's full-decode path "
                        "(docs/DESIGN.md)")
    p.add_argument("--mtcnn-device", action="store_true",
                   help="with --device-detect and --mtcnn-weights: run the MTCNN P/R/O "
                        "cascade inside the device tick (the reference's SSD -> CLAHE "
                        "-> MTCNN order)")
    p.add_argument("--ingest-plane", default="bgr", choices=["bgr", "coef", "ycbcr420"],
                   help="with --device-detect: the wire format of JPEG ingest. 'coef': the "
                        "host entropy-decodes only and the tick finishes the decode; "
                        "'ycbcr420': the host also runs the inverse DCT and the tick "
                        "upsamples and converts the colour. Both equal the full decode; "
                        "JPEGs that are not YCbCr 4:2:0 at the capture size take the "
                        "full decode")
    args = p.parse_args(argv)
    if args.ingest_plane != "bgr" and not args.device_detect:
        raise SystemExit("--ingest-plane requires --device-detect")
    spec = backbones.make(args.backbone)
    cfg = dataclasses.replace(DetectorConfig().with_threshold(args.threshold),
                              face_backend=args.face_backend, clip_window=args.clip_window)
    if args.mtcnn_device:
        if not (args.device_detect and args.mtcnn_weights):
            raise SystemExit("--mtcnn-device requires --device-detect and --mtcnn-weights")
        cfg = dataclasses.replace(cfg, mtcnn_device=True)
    if args.device_detect:
        if not args.batched:
            raise SystemExit("--device-detect requires --batched (the fused detect "
                             "tick lives in the multi-stream engine)")
        if not args.ssd_weights:
            raise SystemExit("--device-detect requires --ssd-weights "
                             "(res10 caffemodel for the in-tick SSD)")
        if args.face_backend not in ("auto", "ssd"):
            # the fused tick always detects with the in-tick SSD; a pinned
            # non-SSD rung cannot be honored, and is not silently overridden
            raise SystemExit(
                f"--device-detect runs SSD detection inside the device tick and "
                f"cannot honor --face-backend {args.face_backend}; drop the pin "
                "(or use 'ssd'), or serve without --device-detect")
        # the reference CLAHEs every face crop (deepfake_detection.py:357-370);
        # in device-detect mode the crop never reaches the host
        cfg = dataclasses.replace(cfg, clahe_device=True)
    aligner = None
    if args.mtcnn_weights:
        from ..models.mtcnn import MTCNNAligner
        try:
            aligner = MTCNNAligner.from_weights(args.mtcnn_weights, device=args.device)
        except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
            raise SystemExit(f"--mtcnn-weights {args.mtcnn_weights}: {e}")
    from ..utils.weights import load_params_any
    params = _load_or_exit("--weights", args.weights, load_params_any, args.weights, spec)
    if params is None:
        logger.warning("serving random classifier weights drawn from seed 0 (no --weights)")

    if args.batched:
        from ..pipeline.faces import FaceDetector
        from .multi import MultiStreamEngine, create_batched_app
        scfg = ServerConfig(detection_threshold=args.threshold,
                            max_streams=args.max_streams, max_batch=args.max_batch,
                            batch_timeout_ms=args.batch_timeout_ms,
                            device_detect=args.device_detect,
                            ingest_scaled_decode=args.scaled_decode,
                            ingest_plane=args.ingest_plane)
        fd = None
        if args.ssd_weights:
            fd = FaceDetector(ssd_weights_path=args.ssd_weights,
                              confidence_threshold=cfg.ssd_confidence_threshold,
                              min_face_px=cfg.min_face_px, backend=args.face_backend,
                              device=args.device)
        clip_head = (_load_or_exit("--clip-head", args.clip_head, _load_clip_head,
                                   args.clip_head, cfg, spec) if args.clip_head else None)
        engine = MultiStreamEngine(cfg, scfg, params=params, spec=spec, device=args.device,
                                   face_detector=fd, aligner=aligner,
                                   clip_head_params=clip_head)
        httpd = make_server(args.host, args.port, create_batched_app(engine, scfg))
        logger.info("batched deepfake server (%d streams) on http://%s:%d",
                    args.max_streams, args.host, args.port)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            engine.shutdown()
        return
    det = DeepfakeDetector(cfg, params=params, spec=spec, ssd_weights_path=args.ssd_weights,
                           mtcnn_weights_path=args.mtcnn_weights, device=args.device)
    serve(args.host, args.port, det)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s",
                        datefmt="%H:%M:%S")
    main()
