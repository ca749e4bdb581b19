"""Count where the port's JPEG decode and libjpeg's disagree on cut streams.

Encodes seeded images with cv2 at several sizes, samplings (4:2:0, 4:2:2,
4:4:0, 4:4:4, 4:1:1, gray), qualities and restart intervals, baseline and
progressive, cuts each at seeded points, and decodes every cut with the
port (utils/jpeg_ingest, full size and DCT scales 4/8, 3/8, 1/8) and with
the JAX package's native libjpeg decoder at the hint that selects the
same scale. Prints one JSON line: the cuts decoded, how many of them
libjpeg block-smooths, and how many frames differ (0 expected).

    python tools/torch_jpeg_cut_survey.py [--images N]

Needs cv2 and the JAX package's native library (JAX itself does not run);
about 10 s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_scaled_jpeg_digests import native_decode, scale_hint  # noqa: E402

SIZES = ((41, 83), (64, 48), (33, 17), (100, 9), (203, 157), (16, 16))
SAMPLING = ("420", "422", "440", "444", "411", "gray")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=len(SIZES))
    ap.add_argument("--cuts", type=int, default=16, help="cuts per stream")
    args = ap.parse_args()
    from real_time_video_deepfake_detection_tpu.utils.native_ingest import get_lib
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    lib = get_lib()
    rng = np.random.default_rng(15)
    counts = {"streams": 0, "cuts": 0, "smoothed": 0, "refused_both": 0, "decodes": 0,
              "differ": 0, "refused_by_one": 0}
    for h, w in SIZES[:args.images]:
        img = cv2.GaussianBlur(rng.integers(0, 255, (h, w, 3), dtype=np.uint8), (7, 7), 0)
        for sampling in SAMPLING:
            for progressive in (0, 1):
                params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(30, 96)),
                          cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                          cv2.IMWRITE_JPEG_RST_INTERVAL, int(rng.integers(0, 4))]
                src = img[..., 0] if sampling == "gray" else img
                if sampling != "gray":
                    params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                               getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
                data = cv2.imencode(".jpg", src, params)[1].tobytes()
                counts["streams"] += 1
                for cut in sorted(set(rng.integers(2, len(data), args.cuts).tolist())):
                    t = data[:cut]
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
    print(json.dumps(counts))
    return 0 if counts["differ"] == counts["refused_by_one"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
