"""Writes 'mp4v' files past avienc's 1 GiB OpenDML limit (AVI) and past
4 GiB (mp4, mov) with cv2.VideoWriter and with the port's
utils/video.VideoWriter, from the same 1920x1080 frames at 30 fps (noise
from a seed, every tenth frame a repeat of the one before, so some packets
are not keyframes), checks that each pair is equal byte for byte, reads a
few frames of the port's file back with utils/video.VideoReader against
cv2.VideoCapture on cv2's file (the first ones, and after a seek into the
last OpenDML part or past 4 GiB), and writes
tests/data/torch_writer_large/replay.json: each run's packet sizes and key
flags, the encoder's global header, and the SHA-256 of cv2's file without
the packets' payload bytes (headers, chunk and box headers, indexes),
which tests/test_torch_writer_large.py replays through the muxers.

Needs cv2 and about 10 GB of free disk (each file is deleted once its
digests are taken); takes about an hour on one host core for the three
runs:

    python tools/torch_writer_large_proof.py --dir /path/with/space [--kinds avi mp4 mov]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from real_time_video_deepfake_detection_tpu_torch.utils import video  # noqa: E402
from tests import torch_writer_replay as replay  # noqa: E402

WIDTH, HEIGHT, FPS, SEED = 1920, 1080, 30.0, 1000
FRAMES = {"avi": 2400, "mp4": 9000, "mov": 9000}


def frame(i: int, prev):
    if i % 10 == 9:
        return prev
    return np.random.default_rng(SEED + i).integers(0, 256, (HEIGHT, WIDTH, 3), dtype=np.uint8)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def read_back(port_path: str, cv2_path: str, seek: int) -> dict:
    """Frames 0-1 and frames seek..seek+1 of both files, compared."""
    out = {}
    for at in (0, seek):
        cap = cv2.VideoCapture(cv2_path)
        r = video.VideoReader(port_path)
        if at:
            cap.set(cv2.CAP_PROP_POS_FRAMES, at)
            r.seek(at)
        same = []
        for _ in range(2):
            ok1, a = cap.read()
            ok2, b = r.read()
            same.append(bool(ok1 and ok2 and np.array_equal(a, b)))
        out[f"frames_from_{at}_equal"] = same
        out["frame_count"] = [int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), r.frame_count]
        r.release()
    return out


def run(kind: str, n: int, folder: str) -> dict:
    cv2_path = os.path.join(folder, f"cv2.{kind}")
    port_path = os.path.join(folder, f"port.{kind}")
    cw = cv2.VideoWriter(cv2_path, cv2.CAP_FFMPEG, cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                         (WIDTH, HEIGHT))
    pw = video.VideoWriter(port_path, "mp4v", FPS, (WIDTH, HEIGHT))
    sizes, keys, payloads = [], [], []
    add = pw._mux.add

    def record(packet, key):
        payloads.append((pw._fh.tell() + (8 if kind == "avi" else 0), len(packet)))
        sizes.append(len(packet))
        keys.append("1" if key else "0")
        add(packet, key)

    pw._mux.add = record
    t0, f = time.time(), None
    for i in range(n):
        f = frame(i, f)
        cw.write(f)
        pw.write(f)
        if i % 500 == 0:
            print(f"{kind} {i}/{n} {time.time() - t0:.0f} s", flush=True)
    cw.release()
    pw.release()
    # an AVI chunk's payload follows its 8-byte header, except where a new
    # RIFF part opened in front of it: locate each in the file instead
    if kind == "avi":
        r = video.VideoReader(port_path)
        payloads = [(int(o), int(s)) for o, s in zip(r._mp4.track.offsets, r._mp4.track.sizes)]
        r.release()
    size_cv2, size_port = os.path.getsize(cv2_path), os.path.getsize(port_path)
    digest_cv2 = sha256(cv2_path)
    rec = {
        "kind": kind, "width": WIDTH, "height": HEIGHT, "fps": FPS, "frames": n,
        "header": pw._encoder.header.hex() if kind != "avi" else "",
        "sizes": replay.pack_sizes(sizes), "keys": "".join(keys),
        "file_size": size_cv2, "file_sha256": digest_cv2,
        "port_file_size": size_port, "port_equal": digest_cv2 == sha256(port_path),
        "nonpayload_sha256": replay.file_digest(cv2_path, payloads),
        "keyframes": keys.count("1"), "seconds": round(time.time() - t0, 1),
    }
    rec.update(read_back(port_path, cv2_path, n - 3))
    os.remove(cv2_path)
    os.remove(port_path)
    print(json.dumps({k: v for k, v in rec.items() if k not in ("sizes", "keys", "header")}),
          flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True, help="a folder with ~10 GB free")
    ap.add_argument("--kinds", nargs="+", default=["avi", "mp4", "mov"])
    ap.add_argument("--frames", type=int, default=0,
                    help="frames a run (default: enough to pass the limit); a shorter run "
                         "only checks, and leaves the fixture alone")
    args = ap.parse_args()
    os.makedirs(args.dir, exist_ok=True)
    out = replay.FIXTURE
    runs = {}
    if os.path.exists(out):
        runs = replay.load()["runs"]
    for kind in args.kinds:
        runs[kind] = run(kind, args.frames or FRAMES[kind], args.dir)
    if args.frames:
        return
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"cv2": cv2.__version__, "runs": runs}, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    main()
