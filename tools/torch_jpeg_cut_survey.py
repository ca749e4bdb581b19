"""Count where the port's JPEG decode and libjpeg's disagree on cut streams.

Encodes seeded images with cv2 at several sizes, samplings (4:2:0, 4:2:2,
4:4:0, 4:4:4, 4:1:1, gray), qualities and restart intervals, baseline and
progressive, cuts each at seeded points, and decodes every cut with the
port (utils/jpeg_ingest, full size and DCT scales 4/8, 3/8, 1/8) and with
the JAX package's native libjpeg decoder at the hint that selects the
same scale. Then it rewrites the streams of the first --arith-images
sizes (4:2:0, 4:4:4, 4:1:1 and gray) arithmetic-coded, sequential and
progressive, with and without restart markers (libjpeg's transcoder,
tools/make_torch_jpeg_mode_fixtures.py), and cuts each at every byte from
its first SOS marker on. Prints one JSON line: the cuts decoded, how many
of them libjpeg block-smooths, and how many frames differ (0 expected),
for the Huffman streams and, under "arith", the arithmetic ones.

    python tools/torch_jpeg_cut_survey.py [--images N] [--arith-images N]

Needs cv2, gcc with libjpeg's headers and the JAX package's native library
(JAX itself does not run); about 10 s for the Huffman streams, a few
minutes for the arithmetic ones.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_jpeg_mode_fixtures import arith, build  # noqa: E402
from make_torch_scaled_jpeg_digests import native_decode, scale_hint  # noqa: E402

SIZES = ((41, 83), (64, 48), (33, 17), (100, 9), (203, 157), (16, 16))
SAMPLING = ("420", "422", "440", "444", "411", "gray")


def _survey(counts: dict, t: bytes, h: int, w: int, lib, J) -> None:
    """Decode the cut `t` of an (h, w) stream with the port and with libjpeg
    at every scale of the survey, and count the outcomes."""
    counts["cuts"] += 1
    try:
        jc = J.decode_coefs(t)
    except J.JpegError:
        jc = None
    for m in (8, 4, 3, 1):
        hint = 0 if m == 8 else scale_hint(h, w, m)
        if m < 8 and not hint:
            continue
        try:
            want = native_decode(lib, t, hint)
        except RuntimeError:
            want = None
        if want is None and jc is None:
            counts["refused_both"] += m == 8
            continue
        if (want is None) != (jc is None):
            counts["refused_by_one"] += 1
            continue
        got = J.reconstruct([jc], "cpu", scale=m)[0].numpy()
        counts["decodes"] += 1
        counts["differ"] += got.shape != want.shape or bool((got != want).any())
    counts["smoothed"] += bool(jc is not None and jc.smoothing)


def _counts() -> dict:
    return {"streams": 0, "cuts": 0, "smoothed": 0, "refused_both": 0, "decodes": 0,
            "differ": 0, "refused_by_one": 0}


def _encode(img, sampling: str, quality: int, progressive: int, restart: int) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive, cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    src = img[..., 0] if sampling == "gray" else img
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
    return cv2.imencode(".jpg", src, params)[1].tobytes()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=len(SIZES))
    ap.add_argument("--cuts", type=int, default=16, help="cuts per stream")
    ap.add_argument("--arith-images", type=int, default=2,
                    help="sizes whose arithmetic-coded streams are cut at every byte")
    args = ap.parse_args()
    from real_time_video_deepfake_detection_tpu.utils.native_ingest import get_lib
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    lib = get_lib()
    rng = np.random.default_rng(15)
    counts = _counts()
    for h, w in SIZES[:args.images]:
        img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), (7, 7), 0)
        for sampling in SAMPLING:
            for progressive in (0, 1):
                quality = int(rng.integers(30, 96))
                data = _encode(img, sampling, quality, progressive, int(rng.integers(0, 4)))
                counts["streams"] += 1
                for cut in sorted(set(rng.integers(2, len(data), args.cuts).tolist())):
                    _survey(counts, data[:cut], h, w, lib, J)
    counts["arith"] = arith_counts = _counts()
    with tempfile.TemporaryDirectory() as tmp:
        tools = build(tmp, ("arith",))
        for h, w in SIZES[:args.arith_images]:
            img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), (7, 7), 0)
            for sampling in ("420", "444", "411", "gray"):
                base = _encode(img, sampling, int(rng.integers(30, 96)), 0, 0)
                for progressive in (False, True):
                    for restart in (0, 2):
                        data = arith(tools, tmp, base, progressive, restart)
                        arith_counts["streams"] += 1
                        for cut in range(data.index(b"\xff\xda"), len(data)):
                            _survey(arith_counts, data[:cut], h, w, lib, J)
    print(json.dumps(counts))
    bad = counts["differ"] + counts["refused_by_one"] + arith_counts["differ"] + \
        arith_counts["refused_by_one"]
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
