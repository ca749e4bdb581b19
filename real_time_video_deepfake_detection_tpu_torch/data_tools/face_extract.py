"""Face-crop pre-extraction from videos (reference train.py:100-276). Port
of real_time_video_deepfake_detection_tpu/data_tools/face_extract.py.

Videos in <videos>/{real,fake}/*.mp4 -> balanced 1:1 face-crop JPEGs in
<output>/{train,val}/{real,fake}/: random frames in the 5-95% span, the
largest face with a 30% margin, a minimum crop size, a deterministic 15%
validation split, resume by existence. The draws come from one
random.Random(42) in the JAX package's order, the crops are resized with
cv2's INTER_AREA (utils/host_resize.resize_area_u8) and written as
cv2.imwrite writes them at quality 95 (utils/jpeg_encode).

    python -m real_time_video_deepfake_detection_tpu_torch.data_tools.face_extract \\
        --videos dataset/videos --output dataset/faces [--device cuda]

Stated differences: the port reads H.264 mp4 (Constrained Baseline, Main
and High, as DFDC's and FaceForensics++'s x264 files are), MPEG-4 Part 2
mp4 as FFmpeg's mpeg4 encoder writes it (cv2.VideoWriter's mp4v) and
Motion-JPEG AVI (utils/video.py, by content: an AVI named .mp4 opens), so an
interlaced, 4:2:2 / 4:4:4 or high-bit-depth H.264 video, an Xvid-written
mp4v one or another codec is skipped as unreadable where cv2 reads it; frames are the ones
cv2.VideoCapture returns, seeks landing
where cv2's land; `--device` places the SSD rung when --ssd-weights is
given.
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

from ..core.device import resolve_device
from ..utils.host_resize import resize_area_u8
from ..utils.jpeg_encode import encode_jpeg
from ..utils.video import FORMATS, VideoReader

FACE_MARGIN = 0.3
MIN_FACE_SIZE = 80
VAL_SPLIT = 0.15
SEED = 42
VIDEO_GLOB = "*.mp4"


def largest_face_with_margin(frame, detector, min_size: int = 60):
    """The largest detected face at least `min_size` a side, grown by 30%
    on each side and clipped to the frame: (x, y, w, h) or None."""
    faces = [f for f in detector(frame) if f[2] >= min_size and f[3] >= min_size]
    if not faces:
        return None
    x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
    mx, my = int(w * FACE_MARGIN), int(h * FACE_MARGIN)
    fh, fw = frame.shape[:2]
    x1, y1 = max(0, x - mx), max(0, y - my)
    x2, y2 = min(fw, x + w + mx), min(fh, y + h + my)
    return (x1, y1, x2 - x1, y2 - y1)


def extract_crops(video_path: str, detector, rng: random.Random, max_frames: int = 15,
                  size: int = 224):
    """Up to `max_frames` (size, size, 3) u8 BGR face crops from frames
    drawn from `rng` (3x as many candidates, in frame order)."""
    reader = VideoReader(str(video_path))
    if not reader.is_opened():
        return []
    crops = []
    try:
        total = reader.frame_count
        if total <= 0:
            return []
        start, end = int(total * 0.05), int(total * 0.95)
        if end <= start:
            start, end = 0, total - 1
        n_cand = min(max_frames * 3, end - start + 1)
        for idx in sorted(rng.sample(range(start, end + 1), n_cand)):
            if len(crops) >= max_frames:
                break
            reader.seek(idx)
            ok, frame = reader.read()
            if not ok or frame is None:
                continue
            box = largest_face_with_margin(frame, detector)
            if box is None:
                continue
            x, y, w, h = box
            crop = frame[y:y + h, x:x + w]
            if crop.shape[0] < MIN_FACE_SIZE or crop.shape[1] < MIN_FACE_SIZE:
                continue
            crops.append(resize_area_u8(crop, size, size))
    finally:
        reader.release()
    return crops


def preextract(videos_dir: str, output_dir: str, frames_per_video: int = 15, size: int = 224,
               ssd_weights: str | None = None, device=None) -> dict:
    """Write the crops; returns {"real": n, "fake": n} written in this run.
    `device` places the SSD (None: CUDA)."""
    from ..pipeline.faces import FaceDetector

    detector = FaceDetector(ssd_weights_path=ssd_weights, device=device)
    rng = random.Random(SEED)
    out = Path(output_dir)
    stats = {"real": 0, "fake": 0}

    for label in ("real", "fake"):
        vids = sorted((Path(videos_dir) / label).glob(VIDEO_GLOB))
        rng.shuffle(vids)
        n_val = int(len(vids) * VAL_SPLIT)
        for split, split_vids in (("val", vids[:n_val]), ("train", vids[n_val:])):
            d = out / split / label
            d.mkdir(parents=True, exist_ok=True)
            for v in split_vids:
                if (d / f"{v.stem}_0.jpg").exists():   # resume by existence
                    continue
                for i, crop in enumerate(extract_crops(str(v), detector, rng,
                                                       frames_per_video, size)):
                    (d / f"{v.stem}_{i}.jpg").write_bytes(encode_jpeg(crop, 95))
                    stats[label] += 1

    # balance 1:1 by deleting the surplus of the larger train class
    counts = {lab: len(list((out / "train" / lab).glob("*.jpg"))) for lab in ("real", "fake")}
    smaller = min(counts.values())
    for lab in ("real", "fake"):
        files = sorted((out / "train" / lab).glob("*.jpg"))
        rng.shuffle(files)
        for f in files[smaller:]:
            f.unlink()
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description="Pre-extract balanced face crops (PyTorch port)")
    p.add_argument("--videos", required=True, help=f"dir with real/ fake/ of {FORMATS} files")
    p.add_argument("--output", required=True)
    p.add_argument("--frames-per-video", type=int, default=15)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--ssd-weights", default=None)
    p.add_argument("--device", default="cuda", help="torch device of the SSD (cuda, cpu)")
    args = p.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(str(e).replace("device='cpu'", "--device cpu"))
    stats = preextract(args.videos, args.output, args.frames_per_video, args.size,
                       args.ssd_weights, device=args.device)
    print(stats)


if __name__ == "__main__":
    main()
