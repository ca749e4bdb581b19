"""Write tests/data/torch_haar/expected.json: the JAX package's Haar cascade
(models/haar_cascade.py, its native evaluator native/haar.cpp and its
numpy one) on the committed cascade XML, for the frames that the port's
tests and chip_smoke.py hold the port's `haar_native` rung to:

  - grace_hopper.jpg (tests/data/torch_haar/, decoded with cv2.imdecode,
    which the port's decoder equals on it);
  - the 720x405 and 640x480 q85 frames of tests/data/torch_jpeg/;
  - one seeded noise frame (numpy default_rng(NOISE_SEED), NOISE_SHAPE u8).

For each: the raw (pre-grouping) window count of both JAX evaluators,
which must agree, and the boxes of detect_multiscale (scaleFactor 1.1,
minNeighbors 5, minSize (30, 30)) on the native one, as the JAX ladder's
haar_native rung returns them.

    python tools/make_torch_haar_fixtures.py

Needs cv2 and the JAX package (with g++ for its native evaluator).
"""

from __future__ import annotations

import json
import os
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from real_time_video_deepfake_detection_tpu.models.haar_cascade import (  # noqa: E402
    HaarCascade, bgr_to_gray_u8, group_rectangles)
from real_time_video_deepfake_detection_tpu.utils.native_haar import NativeHaar  # noqa: E402

OUT = os.path.join(REPO, "tests", "data", "torch_haar")
XML = os.path.join(OUT, "haarcascade_frontalface_default.xml")
NOISE_SEED = 7
NOISE_SHAPE = (405, 720, 3)
FRAMES = {
    "grace_hopper.jpg": os.path.join(OUT, "grace_hopper.jpg"),
    "frame_720x405_q85_420.jpg": os.path.join(REPO, "tests", "data", "torch_jpeg",
                                              "frame_720x405_q85_420.jpg"),
    "frame_640x480_q85_420.jpg": os.path.join(REPO, "tests", "data", "torch_jpeg",
                                              "frame_640x480_q85_420.jpg"),
}


def noise_frame() -> np.ndarray:
    return np.random.default_rng(NOISE_SEED).integers(0, 256, NOISE_SHAPE, dtype=np.uint8)


def main() -> None:
    cascade = HaarCascade.from_xml(XML)
    native = NativeHaar(cascade)
    frames = {}
    for name, path in FRAMES.items():
        with open(path, "rb") as fh:
            frames[name] = cv2.imdecode(np.frombuffer(fh.read(), np.uint8), cv2.IMREAD_COLOR)
    frames["noise"] = noise_frame()
    out = {"noise": {"seed": NOISE_SEED, "shape": list(NOISE_SHAPE)}, "frames": {}}
    for name, bgr in frames.items():
        gray = bgr_to_gray_u8(bgr)
        raw_native = sorted(native.detect_raw(gray))
        raw_numpy = sorted(cascade.detect_raw(gray))
        if raw_native != raw_numpy:
            raise SystemExit(f"{name}: the JAX evaluators disagree")
        boxes = group_rectangles(native.detect_raw(gray), 5)
        if boxes != cascade.detect_multiscale(gray):
            raise SystemExit(f"{name}: detect_multiscale disagrees with the grouping")
        out["frames"][name] = {"shape": list(bgr.shape), "raw_windows": len(raw_native),
                               "boxes": [list(b) for b in boxes]}
    with open(os.path.join(OUT, "expected.json"), "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
