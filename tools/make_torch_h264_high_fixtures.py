"""Write the fixtures of the PyTorch port's H.264 Main and High decode
(tests/data/torch_h264_high/): x264 mp4s of seeded synthetic scenes with
motion, a cut and brightness fades (x264 writes explicit weights only
where its analysis finds a fade), and digests.json with what
cv2.VideoCapture and the system libavcodec make of each, as
tools/make_torch_h264_fixtures.py records them for the Baseline files.

    python tools/make_torch_h264_high_fixtures.py

The files cover x264's medium defaults in High (CABAC, three B-frames with
b-pyramid normal, spatial direct, weightp=2, weightb, 8x8dct) at 640x360,
1920x1080 (coded 1088) and 1080x1920 (coded 1088 wide: the crop on the
right), 30000/1001 fps, CAVLC High (8x8 residuals as four interleaved 4x4
blocks), no 8x8 transform, temporal direct, b-pyramid none and strict,
bframes=16, weightp=1, weightb=0, cqm=jvt, four slices, partitions=all,
qp=4 (long CABAC level escapes), an open GOP and Main profile; a CAVLC and
a CABAC stream without B-frames (the steps a decoder is built in); and
272x320 clips of the face photograph and of a scene without a face for
the entry points' tests; and the High files of tests/data/torch_mp4
(digests only). Two files are for the refusals alone, with cv2's
frame count and no frames: MBAFF (interlaced=1) and 4:2:2 (High 4:2:2).
An 8-bit libx264 (the system's libx264.so.164) writes no higher bit
depth; those are refused through a hand-built SPS in the tests.

The C programs are those of tools/make_torch_h264_fixtures.py (gcc, the
system FFmpeg and libx264); the tests read the committed files.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import zlib

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_h264_fixtures as base  # noqa: E402

OUT = os.path.join(base.REPO, "tests", "data", "torch_h264_high")
SEED = 18

GOP = "keyint=12:min-keyint=12"
# name: (width, height, frames, fps, x264-params, profile[, content | pixel format])
FIXTURES = {
    "hi_640x360.mp4": (640, 360, 48, "25", f"{GOP}:crf=26", "high"),
    "hi_1920x1080.mp4": (1920, 1080, 8, "25", "keyint=8:crf=32", "high"),
    "hi_1080x1920.mp4": (1080, 1920, 6, "30", "keyint=6:crf=32", "high"),
    "hi_ntsc_320x180.mp4": (320, 180, 30, "30000/1001", f"{GOP}:crf=24", "high"),
    "hi_cavlc_nob_256x144.mp4": (256, 144, 24, "25", f"{GOP}:cabac=0:bframes=0:crf=24",
                                 "high"),
    "hi_cabac_nob_256x144.mp4": (256, 144, 24, "25", f"{GOP}:bframes=0:crf=24", "high"),
    "hi_cavlc_320x180.mp4": (320, 180, 36, "25", f"{GOP}:cabac=0:crf=24", "high"),
    "hi_no8x8_256x144.mp4": (256, 144, 24, "25", f"{GOP}:8x8dct=0:crf=24", "high"),
    "hi_temporal_320x180.mp4": (320, 180, 36, "25", f"{GOP}:direct=temporal:crf=24", "high"),
    "hi_pyrnone_256x144.mp4": (256, 144, 24, "25", f"{GOP}:b-pyramid=none:crf=24", "high"),
    "hi_pyrstrict_256x144.mp4": (256, 144, 24, "25", f"{GOP}:b-pyramid=strict:crf=24",
                                 "high"),
    "hi_bf16_256x144.mp4": (256, 144, 48, "25", "keyint=40:bframes=16:crf=26", "high"),
    "hi_weightp1_256x144.mp4": (256, 144, 24, "25", f"{GOP}:weightp=1:crf=24", "high"),
    "hi_weightb0_256x144.mp4": (256, 144, 24, "25", f"{GOP}:weightb=0:crf=24", "high"),
    "hi_cqmjvt_256x144.mp4": (256, 144, 24, "25", f"{GOP}:cqm=jvt:crf=24", "high"),
    "hi_slices4_320x180.mp4": (320, 180, 24, "25", f"{GOP}:slices=4:crf=24", "high"),
    "hi_partall_320x180.mp4": (320, 180, 24, "25", f"{GOP}:partitions=all:subme=9:crf=20",
                               "high"),
    "hi_qp4_96x64.mp4": (96, 64, 8, "25", "keyint=4:qp=4", "high"),
    "hi_opengop_256x144.mp4": (256, 144, 36, "25", f"{GOP}:open-gop=1:crf=24", "high"),
    "main_256x144.mp4": (256, 144, 24, "25", f"{GOP}:crf=24", "main"),
    "hi_face_272x320.mp4": (272, 320, 14, "12", "keyint=6:crf=18", "high", "face"),
    "hi_plain_272x320.mp4": (272, 320, 10, "12", "keyint=5:crf=22", "high"),
}
REFUSED = {
    "hi_mbaff_160x96.mp4": (160, 96, 6, "25", "keyint=6:interlaced=1:crf=24", "high"),
    "hi422_160x96.mp4": (160, 96, 6, "25", "keyint=6:crf=24", "high422", "yuv422p"),
}


def fade_scene(w: int, h: int, n: int, seed: int, chroma_rows: int = 2) -> bytes:
    """n frames: a moving scene that fades to dark over its first half,
    then a cut to another scene that fades in. chroma_rows: 2 for 4:2:0,
    1 for 4:2:2."""
    planes = []
    for part, (start, count) in enumerate(((0, n // 2), (n // 2, n - n // 2))):
        raw = np.frombuffer(base.scene(w, h, count, seed + part), np.uint8)
        ysz, csz = w * h, (w // 2) * (h // 2)
        for i in range(count):
            f = raw[i * (ysz + 2 * csz):(i + 1) * (ysz + 2 * csz)].astype(np.float32)
            t = i / max(count - 1, 1)
            gain = 1.0 - 0.7 * t if part == 0 else 0.35 + 0.65 * t
            y = 16 + (f[:ysz] - 16) * gain
            c = 128 + (f[ysz:] - 128) * (0.5 + 0.5 * gain)
            u, v = c[:csz].reshape(h // 2, w // 2), c[csz:].reshape(h // 2, w // 2)
            if chroma_rows == 1:
                u, v = np.repeat(u, 2, 0), np.repeat(v, 2, 0)
            planes += [y, u.ravel(), v.ravel()]
    return b"".join(np.clip(np.rint(p), 0, 255).astype(np.uint8).tobytes() for p in planes)


def main() -> int:
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        tools = base.build(tmp)
        for name, (w, h, n, fps, params, profile, *extra) in sorted({**FIXTURES,
                                                                    **REFUSED}.items()):
            seed = SEED + zlib.crc32(name.encode())
            yuv = os.path.join(tmp, "in.yuv")
            pix = "yuv422p" if extra == ["yuv422p"] else "yuv420p"
            with open(yuv, "wb") as fh:
                if extra == ["face"]:
                    fh.write(base.face_clip(w, h, n))
                else:
                    fh.write(fade_scene(w, h, n, seed, 1 if pix == "yuv422p" else 2))
            path = os.path.join(OUT, name)
            subprocess.run([tools["h264write"], path, yuv, str(w), str(h), str(n), fps, params,
                            "-", profile, pix], check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        paths = {name: os.path.join(OUT, name) for name in FIXTURES}
        for name in ("high_160x96.mp4", "high_160x96.mov"):
            paths["torch_mp4/" + name] = os.path.join(base.MP4_DIR, name)
        for name, path in sorted(paths.items()):
            records[name] = dict(base.cv2_record(path), yuv=base.yuv_record(tools, tmp, path),
                                 bytes=os.path.getsize(path))
        for name in sorted(REFUSED):
            cap = cv2.VideoCapture(os.path.join(OUT, name))
            records[name] = {"frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT), "refused": True,
                             "bytes": os.path.getsize(os.path.join(OUT, name))}
            cap.release()
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "files": records}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(r["bytes"] for r in records.values())
    print(f"wrote {len(records)} mp4s ({total} bytes) and digests.json to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
