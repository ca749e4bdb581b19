"""Write the Motion-JPEG AVI fixtures of the port's reader into
tests/data/torch_mjpeg/, with digests.json: for every file, what
cv2.VideoCapture(path) (cv2 5.0's default, FFmpeg backend) gives, so that a
machine without cv2 (chip_smoke.py on the card's) holds the port's
utils/video.VideoReader to it: CAP_PROP_FRAME_COUNT, CAP_PROP_FPS, the
SHA-256 and shape of every frame read in order, and of every frame read
after set(CAP_PROP_POS_FRAMES, i) for each i from 0 to the frame count.

    python tools/make_torch_mjpeg_fixtures.py

The files, 8 frames of a moving texture each:
- cv2.VideoWriter's own Motion-JPEG AVIs, from its FFmpeg writer and from
  its CAP_OPENCV_MJPEG writer (4:2:0), at 96x64 and at the odd 67x45;
- the port's 'MJPG' writer around cv2.imencode frames: 4:4:4, 4:2:2,
  4:2:0, 4:1:1 and 4:4:0 (IMWRITE_JPEG_SAMPLING_FACTOR), even and odd
  sizes (libswscale's unscaled and scaled paths), gray, progressive,
  frames without DHT segments (the Annex K tables), frames whose DHT only
  the first carries (libavcodec keeps a stream's tables: one picture five
  times), an AVI without idx1, and one of OpenDML parts (the avienc layout
  of utils/video._Mp4vAvi with a small RIFF limit);
- arithmetic-coded frames (cv2 reads none; the port names them), and a
  stream with a damaged frame (cv2 conceals it; the port stops there).

Needs cv2 (5.0.0); deterministic from its seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "torch_mjpeg")
SEED = 21
N = 8

from real_time_video_deepfake_detection_tpu_torch.utils import video  # noqa: E402


def frames(h: int, w: int, seed: int = SEED):
    """N frames of a texture moving 3 x 2 pixels a frame, with a noise band."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h + 3 * N, :w + 3 * N]
    base = np.stack([120 + 60 * np.sin(xx / 5.0) * np.cos(yy / 7.0),
                     110 + 70 * np.cos((xx + yy) / 9.0),
                     130 + 50 * np.sin(yy / 4.0)], -1)
    base += rng.normal(0, 18, base.shape)
    base = np.clip(base, 0, 255).astype(np.uint8)
    return [np.ascontiguousarray(base[2 * k:2 * k + h, 3 * k:3 * k + w]) for k in range(N)]


def imencode(img, **flags) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    for k, v in flags.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def strip_dht(jpeg: bytes) -> bytes:
    out, i = jpeg[:2], 2
    while jpeg[i] == 0xFF and jpeg[i + 1] != 0xDA:
        n = struct.unpack(">H", jpeg[i + 2:i + 4])[0]
        if jpeg[i + 1] != 0xC4:
            out += jpeg[i:i + 2 + n]
        i += 2 + n
    return out + jpeg[i:]


def port_avi(path, jpegs, w, h):
    wr = video.VideoWriter(path, "MJPG", 25, (w, h))
    for j in jpegs:
        wr.write_jpeg(j)
    wr.release()


def without_idx1(path):
    data = bytearray(open(path, "rb").read())
    at = data.rindex(b"idx1")
    data = data[:at]
    struct.pack_into("<I", data, 4, len(data) - 8)
    open(path, "wb").write(bytes(data))


def opendml(path, jpegs, w, h, riff_limit):
    with open(path, "wb") as fh:
        mux = video._Mp4vAvi(fh, w, h, 1, 25, 2 * 25 * w * h, riff_limit=riff_limit,
                             fourcc=b"MJPG")
        for j in jpegs:
            mux.add(j, True)
        mux.finish()


def cv2_writer(path, imgs, api):
    h, w = imgs[0].shape[:2]
    wr = cv2.VideoWriter(path, api, cv2.VideoWriter_fourcc(*"MJPG"), 25, (w, h))
    for f in imgs:
        wr.write(f)
    wr.release()


def write_all():
    os.makedirs(OUT, exist_ok=True)
    made = {}

    def p(name):
        made[name] = os.path.join(OUT, name)
        return made[name]

    f96 = frames(64, 96)
    cv2_writer(p("cv2_ffmpeg_96x64.avi"), f96, cv2.CAP_FFMPEG)
    cv2_writer(p("cv2_mjpeg_96x64.avi"), f96, cv2.CAP_OPENCV_MJPEG)
    f67 = frames(45, 67)
    cv2_writer(p("cv2_ffmpeg_67x45.avi"), f67, cv2.CAP_FFMPEG)
    cv2_writer(p("cv2_mjpeg_67x45.avi"), f67, cv2.CAP_OPENCV_MJPEG)
    for name, sf, (h, w) in (("s444", 0x111111, (45, 67)), ("s422", 0x211111, (48, 67)),
                             ("s420", 0x221111, (48, 67)), ("s420", 0x221111, (64, 96)),
                             ("s422", 0x211111, (64, 96)), ("s420", 0x221111, (45, 66)),
                             ("s422", 0x211111, (45, 67)), ("s411", 0x411111, (64, 96)),
                             ("s411", 0x411111, (45, 67)), ("s440", 0x121111, (64, 96)),
                             ("s440", 0x121111, (45, 67))):
        imgs = frames(h, w)
        port_avi(p(f"port_{name}_{w}x{h}.avi"),
                 [imencode(f, sampling_factor=sf) for f in imgs], w, h)
    gray = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames(45, 67)]
    port_avi(p("port_gray_67x45.avi"), [imencode(g) for g in gray], 67, 45)
    port_avi(p("port_progressive_96x64.avi"), [imencode(f, progressive=1) for f in f96], 96, 64)
    port_avi(p("port_no_dht_96x64.avi"), [strip_dht(imencode(f)) for f in f96], 96, 64)
    # one picture's optimized tables, carried by the first frame only
    optimized = imencode(f96[0], optimize=1)
    port_avi(p("port_dht_first_only_96x64.avi"), [optimized] + [strip_dht(optimized)] * 4,
             96, 64)
    port_avi(p("port_no_idx1_96x64.avi"), [imencode(f) for f in f96], 96, 64)
    without_idx1(made["port_no_idx1_96x64.avi"])
    opendml(p("opendml_96x64.avi"), [imencode(f) for f in f96], 96, 64, riff_limit=12000)
    # refusals
    with open(os.path.join(REPO, "tests", "data", "torch_jpeg_modes",
                           "arith_seq_420_83x41.jpg"), "rb") as fh:
        arith = fh.read()
    port_avi(p("refused_arithmetic_83x41.avi"), [arith] * 3, 83, 41)
    damaged = [imencode(f) for f in f96]
    damaged[4] = damaged[4][:len(damaged[4]) // 2] + damaged[4][-2:]
    port_avi(p("damaged_frame4_96x64.avi"), damaged, 96, 64)
    return made


def digest(img):
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def reads(path, seek=None):
    cap = cv2.VideoCapture(path)
    assert cap.getBackendName() == "FFMPEG"
    if seek is not None:
        cap.set(cv2.CAP_PROP_POS_FRAMES, seek)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(digest(f))
    return out, cap


def main():
    made = write_all()
    files = {}
    for name, path in sorted(made.items()):
        seq, cap = reads(path)
        count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        files[name] = {"frame_count": count, "fps": cap.get(cv2.CAP_PROP_FPS), "read": seq,
                       "seek": {str(i): reads(path, i)[0] for i in range(count + 1)},
                       "bytes": os.path.getsize(path)}
        print(f"{name:36s} {os.path.getsize(path):7d} bytes  {count} frames, cv2 reads {len(seq)}")
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "files": files}, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
