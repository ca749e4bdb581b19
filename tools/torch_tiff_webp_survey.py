"""Count the TIFF and WebP files on which the port's decode
(utils/image_decode.cv2_route) and cv2.imdecode differ (0 expected):

- damaged files: seeded files cv2 writes under each TIFF compression and
  each WebP kind (tests/torch_tiff_webp_writers.cv2_tiff_writes /
  cv2_webp_writes), and copies of them cut short or with one to three
  bytes replaced (`damaged`), over many seeds;
- with --random N: N TIFFs the system libtiff writes with random
  photometrics, depths, compressions, predictors, strips or tiles, planes,
  YCbCr subsamplings, orientations and byte orders, and N WebPs the system
  libwebp writes with random encoder settings (lossless methods and
  palettes, lossy segments, partitions, filters, alpha), through the C
  writers in tools/ (needs gcc, libtiff-dev and libwebp-dev; settings a
  library refuses to write are skipped).

Prints one line per family and the files that differ.

    python tools/torch_tiff_webp_survey.py [--seeds 10] [--copies 40] [--random 0]

Needs cv2 (5.0.0); ~10 s at the defaults, ~1 min more with --random 500.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from real_time_video_deepfake_detection_tpu_torch.utils.image_decode import cv2_route  # noqa: E402
from tests.torch_tiff_webp_writers import (  # noqa: E402
    WEBP_KINDS, cv2_tiff_writes, cv2_webp_writes, damaged, libtiff_file, libwebp_file,
)

TIFF_COMPRESSIONS = (1, 5, 7, 8, 32773, 32946)


def _cv2(data: bytes):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and bool((a == b).all())


def random_tiff(rng) -> bytes:
    """A TIFF libtiff writes with random settings."""
    kind = rng.choice(["gray", "pal", "rgb", "rgba", "ycc", "cmyk", "ga"])
    h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
    comp = int(rng.choice([1, 5, 8, 32773, 32946]))
    tags = [(259, comp), (274, int(rng.integers(1, 9)))]
    tile, rps, planar, bps, ycbcr = (), 0, 1, 8, ()
    if rng.random() < 0.4:
        tile = (int(rng.choice([16, 32, 48])), int(rng.choice([16, 32])))
    else:
        rps = int(rng.integers(1, h + 3))
    if kind == "gray":
        bps = int(rng.choice([1, 8, 16]))
        img = rng.integers(0, 1 << bps, (h, w, 1))
        tags.insert(0, (262, int(rng.integers(0, 2))))
    elif kind == "ga":
        bps = int(rng.choice([8, 16]))
        img = rng.integers(0, 1 << bps, (h, w, 2))
        tags += [(338, int(rng.integers(0, 3)))]
        tags.insert(0, (262, 1))
        planar = int(rng.choice([1, 2]))
    elif kind == "pal":
        bps = int(rng.choice([1, 4, 8]))
        img = rng.integers(0, 1 << bps, (h, w, 1))
        tags.insert(0, (262, 3))
        tags.append((320, list(rng.integers(0, 65536 if rng.random() < 0.5 else 256, 3 << bps))))
    elif kind in ("rgb", "rgba"):
        bps = int(rng.choice([8, 16]))
        img = rng.integers(0, 1 << bps, (h, w, 3 if kind == "rgb" else 4))
        tags.insert(0, (262, 2))
        planar = int(rng.choice([1, 2]))
        if kind == "rgba":
            tags.append((338, int(rng.integers(0, 3))))
    elif kind == "cmyk":
        img = rng.integers(0, 256, (h, w, 4))
        tags.insert(0, (262, 5))
        tags.append((332, 1))
        planar = int(rng.choice([1, 2]))
    else:
        img = rng.integers(0, 256, (h, w, 3))
        tags.insert(0, (262, 6))
        if rng.random() < 0.3:
            planar = 2
            tags.append((530, [1, 1]))
        else:
            ycbcr = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)][int(rng.integers(0, 7))]
            tags.append((530, list(ycbcr)))
            tile, rps = (), int(rng.integers(1, 4)) * 4
    if comp in (5, 8, 32946) and bps >= 8 and rng.random() < 0.5:
        tags.append((317, 2))
    return libtiff_file(tags, img, bps=bps, rows_per_strip=rps, tile=tile, planar=planar,
                        ycbcr=ycbcr, mode=str(rng.choice(["wl", "wb", "w8l"])))


def random_webp(rng) -> bytes:
    """A WebP libwebp writes with random settings."""
    h, w = int(rng.integers(1, 150)), int(rng.integers(1, 150))
    kind = int(rng.integers(0, 4))
    img = rng.integers(0, 256, (h, w, 4), np.uint8)
    if kind == 1:
        img = cv2.GaussianBlur(img, (7, 7), 3)
    elif kind == 2:
        n = int(rng.integers(1, 300))
        img = rng.integers(0, 256, (n, 4), np.uint8)[rng.integers(0, n, (h, w))]
    elif kind == 3:
        img = cv2.resize(rng.integers(0, 256, (max(1, h // 8), max(1, w // 8), 4), np.uint8),
                         (w, h), interpolation=cv2.INTER_CUBIC)
    if rng.random() < 0.5:
        img[..., 3] = 255
    lossless = int(rng.random() < 0.5)
    kw = dict(lossless=lossless, quality=int(rng.integers(0, 101)), method=int(rng.integers(0, 7)))
    if lossless:
        kw.update(exact=int(rng.integers(0, 2)))
    else:
        kw.update(segments=int(rng.integers(1, 5)), partitions=int(rng.integers(0, 4)),
                  filter_type=int(rng.integers(0, 2)), filter_sharpness=int(rng.integers(0, 8)),
                  filter_strength=int(rng.integers(0, 101)), sns=int(rng.integers(0, 101)),
                  alpha_compression=int(rng.integers(0, 2)),
                  alpha_filtering=int(rng.integers(0, 3)), alpha_quality=int(rng.integers(0, 101)))
    return libwebp_file(img, **kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--copies", type=int, default=40)
    ap.add_argument("--random", type=int, default=0,
                    help="libtiff- and libwebp-written files of random settings, of each")
    args = ap.parse_args()
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    total = bad = 0
    families = [(f"tiff-{c}", lambda rng, c=c: cv2_tiff_writes(c, rng)) for c in TIFF_COMPRESSIONS]
    families += [(f"webp-{k}", lambda rng, k=k: cv2_webp_writes(k, rng)) for k in WEBP_KINDS]
    for name, writes in families:
        n = b = 0
        for seed in range(args.seeds):
            rng = np.random.default_rng(1000 + seed)
            for k, data in enumerate(writes(rng)):
                for j in range(args.copies):
                    m = damaged(data, rng, j)
                    n += 1
                    if not _same(cv2_route(m), _cv2(m)):
                        b += 1
                        print(f"  differs: {name} seed {seed} file {k} copy {j}")
        print(f"{name} damaged: {b} of {n} files differ", flush=True)
        total, bad = total + n, bad + b
    for name, make in (("tiff", random_tiff), ("webp", random_webp)):
        if not args.random:
            break
        rng = np.random.default_rng(2000)
        n = b = 0
        for i in range(args.random):
            try:
                data = make(rng)
            except subprocess.CalledProcessError:
                continue   # settings the library refuses to write
            n += 1
            if not _same(cv2_route(data), _cv2(data)):
                b += 1
                print(f"  differs: random {name} {i}")
        print(f"{name} random settings: {b} of {n} files differ", flush=True)
        total, bad = total + n, bad + b
    print(f"all: {bad} of {total} files differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
