"""How often the JAX package's C++ Haar evaluator (native/haar.cpp) and the
port's (csrc/haar.cpp) disagree. The two differ only in the residual of the
INTER_LINEAR resize tables of the image pyramid: the JAX copy keeps it in
double, the port's in float32 as cv2's resize.cpp does.

1. The pyramids of the committed fixtures (the photograph, 600x512, and the
   405x720 and 480x640 frames): how many levels have a resize table with a
   coefficient or source index that differs between the two, and how many
   table entries (rows plus columns) differ.
2. The photograph stretched by nearest neighbour to 150 sizes (600..712 rows
   by 512..602 columns, steps of 8 and 10): on how many the raw windows of
   the two evaluators differ, and on how many the grouped boxes do.

    python tools/haar_pyramid_survey.py

Needs the JAX package (g++ for its native evaluator) and the port.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from real_time_video_deepfake_detection_tpu.models import haar_cascade as JH  # noqa: E402
from real_time_video_deepfake_detection_tpu.utils.native_haar import NativeHaar  # noqa: E402
from real_time_video_deepfake_detection_tpu_torch.models import haar_cascade as TH  # noqa: E402
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg  # noqa: E402

HAAR_DIR = os.path.join(REPO, "tests", "data", "torch_haar")


def table(src: int, dst: int, double_residual: bool):
    """One axis of the INTER_LINEAR table: source index and Q11 weights."""
    v = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    if double_residual:
        sx = np.floor(v)
        f = (v - sx).astype(np.float32)
    else:
        v32 = v.astype(np.float32)
        sx = np.floor(v32).astype(np.float64)
        f = v32 - sx.astype(np.float32)
    sx = sx.astype(np.int64)
    f = np.where((sx < 0) | (sx >= src - 1), np.float32(0), f)
    sx = np.clip(sx, 0, src - 1)
    return (sx, np.rint(f * np.float32(2048)).astype(np.int32),
            np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32))


def pyramid_levels(h: int, w: int):
    """The resized levels of detect_raw's pyramid (scaleFactor 1.1,
    minSize 30): identity and the exact 2x area path need no table."""
    factor = 1.0
    while True:
        sw, sh = int(TH._cv_round(w / factor)), int(TH._cv_round(h / factor))
        if sw < 24 or sh < 24:
            return
        if TH._cv_round(24 * factor) >= 30 and (sh, sw) != (h, w) and (2 * sh, 2 * sw) != (h, w):
            yield factor, sh, sw
        factor *= 1.1


def main() -> None:
    levels = differing_levels = entries = differing_entries = 0
    for h, w in ((600, 512), (405, 720), (480, 640)):
        for _, sh, sw in pyramid_levels(h, w):
            d = 0
            for src, dst in ((w, sw), (h, sh)):
                a, b = table(src, dst, True), table(src, dst, False)
                d += int(np.any([x != y for x, y in zip(a, b)], axis=0).sum())
                entries += dst
            levels += 1
            differing_levels += d > 0
            differing_entries += d
    print(f"fixture pyramids: {differing_levels} of {levels} resized levels have a differing "
          f"table; {differing_entries} of {entries} table entries differ")

    cascade = TH.HaarCascade.from_xml(os.path.join(HAAR_DIR, TH.CASCADE_XML))
    jax_native = NativeHaar(JH.HaarCascade.from_xml(os.path.join(HAAR_DIR, TH.CASCADE_XML)))
    with open(os.path.join(HAAR_DIR, "grace_hopper.jpg"), "rb") as fh:
        gray = TH.bgr_to_gray_u8(decode_jpeg(fh.read()))
    frames = raw_differ = boxes_differ = 0
    for fh_, fw in [(600 + d, 512 + e) for d in range(0, 120, 8) for e in range(0, 100, 10)]:
        g = np.ascontiguousarray(gray[np.arange(fh_) * 600 // fh_][:, np.arange(fw) * 512 // fw])
        rj, rt = sorted(jax_native.detect_raw(g)), sorted(cascade.native().detect_raw(g))
        frames += 1
        if rj != rt:
            raw_differ += 1
            bj, bt = JH.group_rectangles(rj, 5), TH.group_rectangles(rt, 5)
            boxes_differ += bj != bt
            print(f"  {fh_}x{fw}: raw windows only JAX {sorted(set(rj) - set(rt))}, only the "
                  f"port {sorted(set(rt) - set(rj))}; boxes JAX {bj}, port {bt}")
    print(f"stretched photographs: raw windows differ on {raw_differ} of {frames}, "
          f"boxes on {boxes_differ}")


if __name__ == "__main__":
    main()
