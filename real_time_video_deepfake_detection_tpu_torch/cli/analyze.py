"""Offline video analysis: the library `predict` loop over a video file,
writing an annotated video and a JSON verdict summary. Port of
real_time_video_deepfake_detection_tpu/cli/analyze.py.

    python -m real_time_video_deepfake_detection_tpu_torch.cli.analyze video.mp4 \\
        [--output annotated.mp4] [--json out.json] [--gradcam] [--device cuda]

Given several videos it runs them batched through the MultiStreamEngine:
each video is a stream, one reader thread per video, and frames of
different videos share the device ticks as concurrent HTTP streams do; one
JSON summary holds the per-video verdicts.

`--output` writes what the JAX CLI's cv2.VideoWriter(path, 'mp4v', fps,
size) writes, byte for byte: MPEG-4 Part 2 in the mp4, mov, m4v or AVI
container the path's extension names (utils/video.VideoWriter).

Stated differences from the JAX CLI: videos are read with utils/video.py,
which opens H.264 mp4 / mov (Constrained Baseline, Main and High,
progressive 8-bit 4:2:0), MPEG-4 Part 2 mp4 / mov / AVI as FFmpeg's mpeg4
encoder writes it (the JAX CLI's own --output among them) and Motion-JPEG
AVI, with cv2's frames byte for byte: an interlaced, 4:2:2 / 4:4:4 or
high-bit-depth H.264 video, an Xvid- or DivX-written or interlaced mp4v
one and a camera index are refused with the reason, where the JAX CLI
reads whatever cv2's FFmpeg backend reads; a damaged slice or VOP ends a
video where FFmpeg conceals it; an `--output` path ending in .mkv or .webm,
or in no extension, is refused before any frame is read (cv2 writes a
Matroska file no two writes of agree, or fails to open); the overlay's
text is cv2 4.x's Hershey font (pipeline/detector.py).
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import threading

import numpy as np

from ..core.device import resolve_device
from ..models import backbones
from ..utils.video import FORMATS, VideoReader


def _load_params(weights, spec):
    """--weights as the server reads it (utils/weights.py): the reference
    .pth, a JAX trainer .npz or the port trainer's .pt; None without it."""
    if not weights:
        return None
    from ..utils.weights import load_params_any
    try:
        return load_params_any(weights, spec)
    except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
        raise SystemExit(f"--weights {weights}: {e}")


def _open(path: str) -> VideoReader:
    if path.isdigit():
        raise SystemExit(f"cannot open {path}: camera capture is not supported; the port "
                         f"reads {FORMATS} files only")
    reader = VideoReader(path)
    if not reader.is_opened():
        raise SystemExit(f"cannot open {path}: {reader.reason}")
    return reader


def _analyze_multi(args) -> None:
    """N videos through the batched engine: one reader thread per video
    feeds engine.analyze(frame, stream_id=path)."""
    from ..core.config import DetectorConfig, ServerConfig
    from ..serving.multi import MultiStreamEngine

    if args.output:
        sys.exit("--output is single-video only (batch mode writes no "
                 "annotated video); drop it or pass one input")

    spec = backbones.make(args.backbone)
    cfg = DetectorConfig().with_threshold(args.threshold)
    scfg = ServerConfig(detection_threshold=args.threshold,
                        max_streams=max(len(args.input), 2))
    engine = MultiStreamEngine(cfg, scfg, params=_load_params(args.weights, spec), spec=spec,
                               device=args.device)

    summaries = [None] * len(args.input)

    def run_one(i: int, path: str) -> None:
        reader = VideoReader(path)
        if not reader.is_opened():
            summaries[i] = {"input": path, "error": f"cannot open: {reader.reason}"}
            return
        n, last = 0, None
        try:
            while True:
                ok, frame = reader.read()
                if not ok:
                    break
                r = engine.analyze(frame, stream_id=path)
                if "error" in r:   # a device-tick failure, reported per video
                    summaries[i] = {"input": path, "frames": n, "error": r["error"]}
                    return
                last = r
                n += 1
                if args.max_frames and n >= args.max_frames:
                    break
        except Exception as e:   # a boundary: tick timeout etc., never a null summary
            summaries[i] = {"input": path, "frames": n, "error": f"{type(e).__name__}: {e}"}
            return
        finally:
            reader.release()
        summaries[i] = {
            "input": path, "frames": n,
            "final_verdict": last["confidence_level"] if last else "UNCERTAIN",
            "temporal_average": last["temporal_average"] if last else 0.0,
            "fake_probability": last["fake_probability"] if last else 0.0,
        }

    threads = [threading.Thread(target=run_one, args=(i, path), daemon=True)
               for i, path in enumerate(args.input)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        engine.shutdown()

    out = {"videos": summaries,
           "engine_ticks": engine.metrics["ticks"],
           "frames_total": engine.metrics["frames_total"],
           "max_batch_seen": engine.metrics["max_batch_seen"]}
    print(json.dumps(out, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)


def _blend_gradcams(annotated: np.ndarray, gradcams) -> np.ndarray:
    """JET heatmap of each face's (224, 224) [0, 1] GradCAM, resized over
    its box and blended in at 0.4, as the JAX CLI does with cv2."""
    import torch

    from ..ops.draw import add_weighted, apply_colormap_jet
    from ..ops.resize import resize_bilinear_u8_cv2

    for (x, y, w, h), cam in gradcams:
        hm = apply_colormap_jet((np.clip(cam, 0.0, 1.0) * 255).astype(np.uint8))
        hm = resize_bilinear_u8_cv2(torch.from_numpy(hm), h, w, cv2_rows=True).numpy()
        roi = annotated[y:y + h, x:x + w]
        annotated[y:y + h, x:x + w] = add_weighted(
            roi, 0.6, hm[:roi.shape[0], :roi.shape[1]], 0.4, 0.0)
    return annotated


def main(argv=None):
    p = argparse.ArgumentParser(description="Analyze video(s) for deepfakes (PyTorch port)")
    p.add_argument("input", nargs="+",
                   help=f"video path(s), {FORMATS}; more than one path runs them batched "
                        "through the multi-stream engine")
    p.add_argument("--output", default=None,
                   help="annotated output video path: MPEG-4 Part 2 (mp4v) in the container "
                        "its extension names (.mp4, .mov, .m4v, .avi), as cv2.VideoWriter "
                        "writes it")
    p.add_argument("--weights", default=None,
                   help="best_model.pth (reference), a JAX trainer .npz or the port's .pt")
    p.add_argument("--backbone", default="b0", choices=backbones.backbone_names(),
                   help="classifier backbone the weights were trained for (must match "
                        "--weights)")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--max-frames", type=int, default=0, help="0 = all")
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the per-frame results to this JSON file")
    p.add_argument("--gradcam", action="store_true",
                   help="blend a GradCAM heatmap over each detected face in the annotated "
                        "output (EfficientNet backbones)")
    p.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e).replace("device='cpu'", "--device cpu"))

    if len(args.input) > 1:
        return _analyze_multi(args)

    from ..core.config import DetectorConfig
    from ..pipeline.detector import DeepfakeDetector
    from ..utils.video import VideoWriter, mp4v_container

    if args.output:
        try:
            mp4v_container(args.output)
        except ValueError as e:
            raise SystemExit(f"--output: {e}")
    reader = _open(args.input[0])
    spec = backbones.make(args.backbone)
    det = DeepfakeDetector(DetectorConfig().with_threshold(args.threshold),
                           params=_load_params(args.weights, spec), spec=spec,
                           enable_gradcam=args.gradcam, device=args.device)
    writer = None
    results = []
    n = 0
    try:
        while True:
            ok, frame = reader.read()
            if not ok:
                break
            annotated, _, _, data = det.predict(frame)
            if args.gradcam and det.last_gradcams:
                annotated = _blend_gradcams(annotated, det.last_gradcams)
            results.append({k: data[k] for k in
                            ("frame_count", "faces_detected", "confidence_level",
                             "temporal_average", "analysis_mode")})
            if args.output:
                if writer is None:
                    h, w = annotated.shape[:2]
                    writer = VideoWriter(args.output, "mp4v", reader.fps or 30, (w, h))
                writer.write(annotated)
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        reader.release()
        if writer is not None:
            writer.release()

    summary = {
        "frames": n,
        "final_verdict": results[-1]["confidence_level"] if results else "UNCERTAIN",
        "temporal_average": results[-1]["temporal_average"] if results else 0.0,
        "voting": det.temporal_tracker.get_voting_stats(),
    }
    print(json.dumps(summary, indent=2))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({"summary": summary, "frames": results}, f, indent=2)


if __name__ == "__main__":
    main()
