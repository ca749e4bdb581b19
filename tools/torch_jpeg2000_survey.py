"""Count the JPEG 2000 files on which the port's decode
(utils/image_decode.cv2_route) and cv2.imdecode differ (0 expected):

- damaged fixtures: every file of tests/data/torch_jpeg2000 but the timing
  frames, cut short or with one to three bytes replaced (`damaged`), over
  many seeds;
- random files: Pillow (tests/torch_jpeg2000_writers.random_pillow_file:
  modes, raw or JP2, tiles, progressions, resolutions, code-block and
  precinct sizes, layers, both transforms, most of them lossy 9/7 with
  layers), cv2 (random_cv2_file), and the system libopenjp2 through
  tools/torch_jpeg2000_writer.c (random code-block styles, SOP/EPH, POC,
  ROI shifts, tile-parts, layers; needs gcc and libopenjp2.so.7), each
  with --copies damaged copies. A writer that aborts or refuses its
  settings is skipped (each file is written in a child process).

Prints one line per family and the files that differ.

    python tools/torch_jpeg2000_survey.py [--seeds 10] [--copies 20] [--random 1000] [--asan]
        [--keep DIR]

--asan decodes with an AddressSanitizer and UndefinedBehaviorSanitizer
build of csrc/jpeg2000.cpp (g++ -fsanitize=address,undefined, in a
temporary directory; the process re-runs itself with libasan preloaded)
and stops at the first report. Needs cv2 (5.0.0) and Pillow; ~1 min at
the defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from real_time_video_deepfake_detection_tpu_torch.utils import jpeg2000  # noqa: E402
from real_time_video_deepfake_detection_tpu_torch.utils.image_decode import cv2_route  # noqa: E402
from tests.torch_jpeg2000_writers import (  # noqa: E402
    PROGRESSIONS, damaged, opj_file, picture, random_cv2_file, random_pillow_file,
)

DATA = os.path.join(REPO, "tests", "data", "torch_jpeg2000")


def _cv2(data: bytes):
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and bool((a == b).all())


def random_opj_file(rng) -> bytes:
    """A file the system libopenjp2 writes with random settings."""
    h, w = int(rng.integers(8, 80)), int(rng.integers(8, 80))
    c = int(rng.choice([1, 3, 3, 4]))
    img = picture(rng, h, w, c, int(rng.integers(0, 4)))
    kw = dict(mode=int(rng.integers(0, 64)), csty=int(rng.choice([0, 2, 4, 6])),
              prog=str(rng.choice(PROGRESSIONS)), irreversible=int(rng.random() < 0.85),
              numres=int(rng.integers(1, 4)))
    if rng.random() < 0.9:
        kw["rates"] = sorted((int(v) for v in rng.integers(2, 60, int(rng.integers(2, 5)))),
                             reverse=True)
    if rng.random() < 0.25:
        kw["roi"] = (int(rng.integers(0, c)), int(rng.integers(1, 12)))
    if rng.random() < 0.25:
        kw["tp"] = str(rng.choice(["R", "L", "C"]))
    if rng.random() < 0.2 and c >= 3:
        kw["poc"] = "RLCP,0,0,1,2,{c};LRCP,0,0,{l},{r},{c}".format(
            c=c, l=len(kw.get("rates", [0])), r=kw["numres"])
    if rng.random() < 0.2:
        kw["cblk"] = (1 << int(rng.integers(2, 7)), 1 << int(rng.integers(2, 7)))
    return opj_file(img, 8, bool(rng.random() < 0.5), **kw)


def _guarded(write, rng):
    """write(rng) in a child process: its bytes, or None where the writer
    raised or aborted; the parent's generator advances as the child's did."""
    r, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            out = (write(rng), rng.bit_generator.state)
        except Exception:
            out = (None, rng.bit_generator.state)
        with os.fdopen(wfd, "wb") as fh:
            pickle.dump(out, fh)
        os._exit(0)
    os.close(wfd)
    with os.fdopen(r, "rb") as fh:
        blob = fh.read()
    os.waitpid(pid, 0)
    if not blob:
        rng.integers(0, 2)   # the child died: move on from a different state
        return None
    data, state = pickle.loads(blob)
    rng.bit_generator.state = state
    return data


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--copies", type=int, default=20)
    ap.add_argument("--random", type=int, default=1000, help="random files of each writer")
    ap.add_argument("--asan", action="store_true")
    ap.add_argument("--keep", help="a directory to write the files that differ into")
    args = ap.parse_args()
    if args.asan and "J2K_ASAN_LIB" not in os.environ:
        d = tempfile.mkdtemp(prefix="j2k_asan_")
        lib = os.path.join(d, "libjpeg2000_asan.so")
        subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
                        "-fno-strict-aliasing", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=undefined", jpeg2000.SRC, "-o", lib], check=True)
        pre = ":".join(subprocess.run(["gcc", f"-print-file-name={n}"], capture_output=True,
                                      text=True).stdout.strip() for n in ("libasan.so",
                                                                          "libubsan.so"))
        env = dict(os.environ, J2K_ASAN_LIB=lib, LD_PRELOAD=pre,
                   ASAN_OPTIONS="detect_leaks=0:abort_on_error=1")
        return subprocess.run([sys.executable] + sys.argv, env=env).returncode
    if "J2K_ASAN_LIB" in os.environ:
        jpeg2000.build_host_library = lambda *a, **k: os.environ["J2K_ASAN_LIB"]
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    total = bad = 0

    def check(name, data) -> None:
        nonlocal total, bad
        total += 1
        if not _same(cv2_route(data), _cv2(data)):
            bad += 1
            print(f"  differs: {name}", flush=True)
            if args.keep:
                os.makedirs(args.keep, exist_ok=True)
                with open(os.path.join(args.keep, f"{bad}.bin"), "wb") as fh:
                    fh.write(data)

    with open(os.path.join(DATA, "digests.json")) as fh:
        digests = json.load(fh)["inputs"]
    # (the files refused by name differ from cv2 by design: ROADMAP, Stated differences)
    names = sorted(k for k, e in digests.items() if "timing" not in k and "not_ported" not in e)
    n0 = total
    for seed in range(args.seeds):
        rng = np.random.default_rng(3000 + seed)
        for name in names:
            with open(os.path.join(DATA, name), "rb") as fh:
                data = fh.read()
            for j in range(args.copies):
                check(f"{name} seed {seed} copy {j}", damaged(data, rng, j))
    b0 = bad
    print(f"damaged fixtures: {b0} of {total - n0} files differ", flush=True)
    for family, write in (("pillow", random_pillow_file), ("cv2", random_cv2_file),
                          ("libopenjp2", random_opj_file)):
        rng = np.random.default_rng(4000 + len(family))
        n0, b0, lossy = total, bad, 0
        for i in range(args.random):
            data = _guarded(write, rng)
            if data is None:
                continue
            if b"\xff\x52" in data[:400]:
                cod = data.index(b"\xff\x52")
                lossy += data[cod + 13] == 0 and int.from_bytes(data[cod + 6:cod + 8], "big") > 1
            check(f"{family} random {i}", data)
            for j in range(args.copies // 4):
                check(f"{family} random {i} copy {j}", damaged(data, rng, j))
        print(f"{family} random settings and damaged copies: {bad - b0} of {total - n0} files "
              f"differ ({lossy} of the random files lossy 9/7 with layers)", flush=True)
    print(f"all: {bad} of {total} files differ")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
