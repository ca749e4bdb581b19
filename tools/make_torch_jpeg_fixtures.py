"""Write the JPEG fixtures of the PyTorch port's decoder tests and of
chip_smoke.py into tests/data/torch_jpeg/, with digests.json: for each
file, the sha256 and shape of cv2.imdecode(..., IMREAD_COLOR)'s output (null
where cv2 refuses the stream), and
whether the port's decoder must accept it (progressive and truncated
streams are refused).

    python tools/make_torch_jpeg_fixtures.py

Needs cv2 (the encoder and the reference decoder); deterministic from its
seed, so a rerun with the same cv2 rewrites the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "torch_jpeg")
SEED = 0


def face_frame(h: int, w: int, rng) -> np.ndarray:
    """A textured gray background with a skin-toned ellipse the heuristic
    face detector finds, like a frame of a video call."""
    yy, xx = np.mgrid[:h, :w]
    f = 100 + 40 * np.sin(xx / 37.0) * np.cos(yy / 53.0)
    f = np.repeat((f + rng.integers(-4, 5, (h, w)))[..., None], 3, axis=2)
    m = ((xx - w / 2) / (w * 0.14)) ** 2 + ((yy - h / 2) / (h * 0.3)) ** 2 <= 1.0
    f[m] = np.array([140, 160, 210]) + rng.integers(-4, 5, (int(m.sum()), 3))
    return np.clip(f, 0, 255).astype(np.uint8)


def encode(img, quality=85, sampling=None, optimize=False, restart=0,
           progressive=False) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def main() -> None:
    rng = np.random.default_rng(SEED)
    frame = face_frame(405, 720, rng)        # the extension's 16:9 capture
    small = face_frame(241, 319, rng)        # odd sizes: partial MCUs
    portrait = face_frame(720, 405, rng)
    capture = face_frame(480, 640, rng)      # detect_capture_hw: the wire planes' size
    files = {
        "frame_720x405_q85_420.jpg": encode(frame),
        "frame_405x720_q85_420.jpg": encode(portrait),
        "frame_640x480_q85_420.jpg": encode(capture),
        "q50_640x480_420.jpg": encode(capture, quality=50),
        "q95_640x480_420.jpg": encode(capture, quality=95),
        "tiny_33x17_q85_420.jpg": encode(face_frame(17, 33, rng)),
        "one_1x1_q85_420.jpg": encode(face_frame(1, 1, rng)),
        "s422_319x241_q85.jpg": encode(small, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "s444_319x241_q85.jpg": encode(small, sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "gray_319x241_q85.jpg": encode(cv2.cvtColor(small, cv2.COLOR_BGR2GRAY)),
        "restart_319x241_q85.jpg": encode(small, restart=3),
        "optimized_319x241_q85.jpg": encode(small, optimize=True),
        "q50_720x405_420.jpg": encode(frame, quality=50),
        "q95_720x405_420.jpg": encode(frame, quality=95),
        "progressive_720x405_q85.jpg": encode(frame, progressive=True),
    }
    whole = files["frame_720x405_q85_420.jpg"]
    files["truncated_720x405_q85.jpg"] = whole[:len(whole) * 3 // 5]
    os.makedirs(OUT, exist_ok=True)
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as fh:
            fh.write(data)
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        digests[name] = {"sha256": None if img is None else hashlib.sha256(img.tobytes()).hexdigest(),
                         "shape": None if img is None else list(img.shape),
                         "port_decodes": not name.startswith(("progressive", "truncated"))}
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "files": digests}, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
