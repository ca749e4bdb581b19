"""Write tests/data/torch_mpeg4_writer/digests.json: the SHA-256 of the
file cv2.VideoWriter(path, VideoWriter_fourcc(*"mp4v"), fps, size) writes
for each case of tests/torch_mpeg4_scenes.CASES (integer numpy scenes from
a seed, or the frames the port decodes from committed tests/data/torch_mpeg4
files), so that a machine without cv2 (chip_smoke.py on the card's) holds
the port's utils/video.VideoWriter to cv2's bytes.

    python tools/make_torch_mpeg4_writer_fixtures.py

Needs cv2 (5.0, bundling FFmpeg 8.0: libavcodec 62.28.101, libavformat
62.12.101); another build writes other bytes. It also writes each case
with the port and says whether the two agree.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import cv2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from tests import torch_mpeg4_scenes as scenes  # noqa: E402
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoWriter  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "torch_mpeg4_writer", "digests.json")


def write(cls, fourcc, path, fps, frames):
    h, w = frames[0].shape[:2]
    wr = cls(path, fourcc, fps, (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    with open(path, "rb") as fh:
        return fh.read()


def main():
    out = {"cv2": cv2.__version__, "cases": {}}
    agree = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, (scene, n, h, w, fps, ext) in scenes.CASES.items():
            frames = scenes.case_frames(name)
            want = write(cv2.VideoWriter, cv2.VideoWriter_fourcc(*"mp4v"),
                         os.path.join(tmp, "cv2" + ext), fps, frames)
            got = write(VideoWriter, "mp4v", os.path.join(tmp, "port" + ext), fps, frames)
            agree += got == want
            out["cases"][name] = {"scene": scene, "frames": n, "height": h, "width": w,
                                  "fps": fps, "ext": ext, "bytes": len(want),
                                  "sha256": hashlib.sha256(want).hexdigest()}
            print(f"{name:20s} {len(want):8d} bytes  port {'equal' if got == want else 'DIFFERS'}")
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"{agree} of {len(scenes.CASES)} cases equal; wrote {OUT}")


if __name__ == "__main__":
    main()
