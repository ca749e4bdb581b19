"""Write tests/data/torch_jpeg/scaled_digests.json: for every fixture the
port's decoder accepts (digests.json "port_decodes") and every libjpeg DCT
scale M/8, M = 1..8, the sha256 and shape of the JAX package's native
decode at that scale (utils/native_ingest.get_lib().ingest_decode with the
size hint that selects M, native/ingest.cpp:74-80), with the libjpeg-turbo
version it links. A scale that no hint selects (every M below 8 of the
1x1 image, whose larger side is under 8) is not listed. The PyTorch
port's scaled reconstruction (ops/jpeg_scaled.py) is held to these digests
on the CPU (tests/test_torch_scaled_decode.py) and on the card
(chip_smoke.py, phase final).

    python tools/make_torch_scaled_jpeg_digests.py

Needs the JAX package's native library (g++ and libjpeg's headers); JAX
itself does not run.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_jpeg")
OUT = os.path.join(DATA, "scaled_digests.json")


def scale_hint(height: int, width: int, m: int) -> int:
    """A hint for which native/ingest.cpp's loop stops at M = m, or 0 when
    none does (its loop: the largest M whose larger side at M/8 still
    covers the hint)."""
    full = max(height, width)
    hint = full if m == 8 else full * m // 8
    if hint <= 0 or (m > 1 and full * (m - 1) // 8 >= hint):
        return 0
    return hint


def jpeg_dims(data: bytes):
    """(height, width) from the first SOF marker."""
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3):
            return int.from_bytes(data[i + 5:i + 7], "big"), int.from_bytes(data[i + 7:i + 9], "big")
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    raise ValueError("no SOF marker")


def native_decode(lib, data: bytes, hint: int) -> np.ndarray:
    h, w = ctypes.c_int(), ctypes.c_int()
    buf = lib.ingest_decode(data, len(data), hint, ctypes.byref(h), ctypes.byref(w))
    if not buf:
        raise RuntimeError("the native decoder refused a fixture")
    try:
        return np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.ingest_free(buf)


def libjpeg_turbo_version() -> str:
    for path in ("/usr/include/x86_64-linux-gnu/jconfig.h", "/usr/include/jconfig.h"):
        if os.path.exists(path):
            m = re.search(r"LIBJPEG_TURBO_VERSION\s+(\S+)", open(path).read())
            if m:
                return m.group(1)
    return "unknown"


def main() -> int:
    sys.path.insert(0, REPO)
    from real_time_video_deepfake_detection_tpu.utils.native_ingest import get_lib
    lib = get_lib()
    if lib is None:
        raise SystemExit("the JAX package's native ingest library did not build")
    with open(os.path.join(DATA, "digests.json")) as fh:
        files = json.load(fh)["files"]
    out = {}
    for name in sorted(files):
        if not files[name]["port_decodes"]:
            continue
        with open(os.path.join(DATA, name), "rb") as fh:
            data = fh.read()
        h, w = jpeg_dims(data)
        scales = {}
        for m in range(1, 9):
            hint = scale_hint(h, w, m)
            if hint == 0:
                continue
            img = native_decode(lib, data, hint)
            scales[str(m)] = {"hint": hint, "shape": list(img.shape),
                              "sha256": hashlib.sha256(img.tobytes()).hexdigest()}
        out[name] = scales
    with open(OUT, "w") as fh:
        json.dump({"libjpeg_turbo": libjpeg_turbo_version(), "files": out}, fh, indent=1,
                  sort_keys=True)
        fh.write("\n")
    print(f"wrote {OUT}: {sum(len(v) for v in out.values())} decodes of {len(out)} files")
    return 0


if __name__ == "__main__":
    sys.exit(main())
