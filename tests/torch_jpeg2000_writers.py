"""Writers of JPEG 2000 files for the port's JPEG 2000 tests, for
tools/make_torch_jpeg2000_fixtures.py and tools/torch_jpeg2000_survey.py:

- `box`, `jp2`, `jp2_boxes`, `codestream_of`: JP2 boxes built by hand, a
  file's boxes, and the codestream of a JP2 file;
- `pillow_file`: a file Pillow writes through its bundled OpenJPEG with the
  settings given; `random_pillow_file`: one with random settings (modes L,
  LA, RGB, RGBA and I;16, raw or JP2, tiles, the five progressions,
  resolutions, code-block and precinct sizes, quality layers, both
  transforms, mct, PLT, comments), most of them lossy 9/7 with layers;
- `cv2_file`, `random_cv2_file`: files cv2 writes (cv2 imported when
  called), lossless at 1000 and lossy below;
- `damaged`: a copy cut short or with one to three bytes replaced;
- `opj_file`: a file the system's libopenjp2 writes through the C writer
  in tools/ (code-block styles, SOP/EPH, POC, ROI shift, subsampling,
  tile-parts, image offsets; built with gcc into a temporary directory on
  first use; the fixture tool and the survey call it, the tests do not).
"""

from __future__ import annotations

import atexit
import io
import os
import shutil
import struct
import subprocess
import tempfile
from typing import List, Sequence, Tuple

import numpy as np

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def box(kind: bytes, payload: bytes, form: str = "short") -> bytes:
    """A box: `short` (32-bit length), `xl` (length 1 and a 64-bit length) or
    `zero` (length 0: to the end of the file)."""
    if form == "xl":
        return struct.pack(">I4sQ", 1, kind, len(payload) + 16) + payload
    if form == "zero":
        return struct.pack(">I4s", 0, kind) + payload
    return struct.pack(">I4s", len(payload) + 8, kind) + payload


SIGNATURE_BOX = box(b"jP  ", b"\r\n\x87\n")
FTYP_BOX = box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")


def ihdr(w: int, h: int, nc: int, bpc: int = 7) -> bytes:
    return box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))


def colr(enumcs: int = 16, meth: int = 1, icc: bytes = b"") -> bytes:
    if meth == 1:
        return box(b"colr", bytes([1, 0, 0]) + struct.pack(">I", enumcs))
    return box(b"colr", bytes([meth, 0, 0]) + icc)


def pclr(entries: np.ndarray, bits: Sequence[int]) -> bytes:
    """A palette box: entries (NE, NPC), each column of `bits` bits."""
    out = struct.pack(">HB", entries.shape[0], entries.shape[1])
    out += bytes((b - 1) & 0x7F for b in bits)
    for row in entries:
        for v, b in zip(row, bits):
            out += int(v).to_bytes((b + 7) // 8, "big")
    return box(b"pclr", out)


def cmap(entries: Sequence[Tuple[int, int, int]]) -> bytes:
    return box(b"cmap", b"".join(struct.pack(">HBB", *e) for e in entries))


def cdef(entries: Sequence[Tuple[int, int, int]]) -> bytes:
    return box(b"cdef", struct.pack(">H", len(entries))
               + b"".join(struct.pack(">HHH", *e) for e in entries))


def jp2(codestream: bytes, header: Sequence[bytes], before: Sequence[bytes] = (),
        after: Sequence[bytes] = (), jp2c_form: str = "short") -> bytes:
    """A JP2 file: signature, ftyp, `before`, jp2h of `header`, jp2c, `after`."""
    return (SIGNATURE_BOX + FTYP_BOX + b"".join(before) + box(b"jp2h", b"".join(header))
            + box(b"jp2c", codestream, jp2c_form) + b"".join(after))


def jp2_boxes(data: bytes) -> List[Tuple[bytes, bytes]]:
    """The top-level (type, payload) boxes of a JP2 file with 32-bit lengths."""
    out, at = [], 0
    while at + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, at)
        n = n or len(data) - at
        out.append((kind, data[at + 8:at + n]))
        at += n
    return out


def codestream_of(data: bytes) -> bytes:
    """The codestream of a JP2 file (or the file, if it is one)."""
    if data[:4] == b"\xff\x4f\xff\x51":
        return data
    return dict(jp2_boxes(data))[b"jp2c"]


def header_boxes(data: bytes) -> List[bytes]:
    """The boxes inside a JP2 file's jp2h, each with its header."""
    p = dict(jp2_boxes(data))[b"jp2h"]
    out, at = [], 0
    while at + 8 <= len(p):
        n = struct.unpack_from(">I", p, at)[0]
        out.append(p[at:at + n])
        at += n
    return out


def pillow_file(img: np.ndarray, mode: str, **settings) -> bytes:
    """What Pillow's JPEG 2000 plugin writes of `img` in `mode` (the mode
    Pillow gives the array: L, LA, RGB, RGBA, I;16)."""
    from PIL import Image
    im = Image.fromarray(np.ascontiguousarray(img))
    assert im.mode == mode, (im.mode, mode)
    b = io.BytesIO()
    im.save(b, "JPEG2000", **settings)
    return b.getvalue()


def picture(rng, h: int, w: int, channels: int, kind: int, depth: int = 8) -> np.ndarray:
    """A seeded picture: noise, blurred noise, flat patches or a smooth ramp."""
    top = (1 << depth) - 1
    if kind == 0:
        img = rng.integers(0, top + 1, (h, w, channels))
    elif kind == 1:
        img = rng.integers(0, top + 1, ((h + 5) // 6, (w + 5) // 6, channels))
        img = np.repeat(np.repeat(img, 6, 0), 6, 1)[:h, :w]
    elif kind == 2:
        img = rng.integers(0, 4, (h, w, channels)) * (top // 3)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([(xx * (c + 3) + yy * 7 + c * 40) % (top + 1) for c in range(channels)],
                       -1)
        img = img + rng.integers(-3, 4, img.shape)
    img = np.clip(img, 0, top)
    return img.astype(np.uint16 if depth > 8 else np.uint8)


_MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": 1}


def random_pillow_file(rng) -> bytes:
    """A Pillow-written file of random settings; raises where Pillow's
    OpenJPEG refuses them (too many resolutions for the size, ...)."""
    mode = str(rng.choice(["L", "LA", "RGB", "RGB", "RGBA", "I;16"]))
    h, w = int(rng.integers(1, 90)), int(rng.integers(1, 90))
    img = picture(rng, h, w, _MODES[mode], int(rng.integers(0, 4)),
                     16 if mode == "I;16" else 8)
    if mode in ("L", "I;16"):
        img = img[..., 0]
    kw = dict(no_jp2=bool(rng.random() < 0.3), irreversible=bool(rng.random() < 0.85),
              progression=str(rng.choice(PROGRESSIONS)))
    if rng.random() < 0.9:
        n = int(rng.integers(2, 6))
        if rng.random() < 0.5:
            kw.update(quality_mode="rates", quality_layers=sorted(
                (float(v) for v in rng.uniform(1, 80, n)), reverse=True))
        else:
            kw.update(quality_mode="dB", quality_layers=sorted(
                float(v) for v in rng.uniform(20, 60, n)))
    tw, th = w, h
    if rng.random() < 0.4:
        tw, th = int(rng.integers(8, 64)), int(rng.integers(8, 64))
        kw["tile_size"] = (tw, th)
    # the smallest tile side (an edge tile may be narrower): Pillow's OpenJPEG
    # asserts on a transform of a one-sample line, so every level keeps two
    side = min(min(tw, w - tw * ((w - 1) // tw)), min(th, h - th * ((h - 1) // th)))
    top = 1
    while (1 << top) <= side and top < 7:
        top += 1
    kw["num_resolutions"] = int(rng.integers(1, top + 1)) if side >= 2 else 1
    if rng.random() < 0.4:
        a = int(rng.integers(2, 8))
        b = int(rng.integers(2, min(10, 12 - a) + 1))
        kw["codeblock_size"] = (1 << a, 1 << b)
    if rng.random() < 0.3:
        kw["precinct_size"] = (1 << int(rng.integers(2, 9)), 1 << int(rng.integers(2, 9)))
    if rng.random() < 0.3:
        kw["mct"] = 1
    if rng.random() < 0.15:
        kw["plt"] = True
    if rng.random() < 0.15:
        kw["comment"] = "port survey " + str(int(rng.integers(0, 1000)))
    return pillow_file(img, mode, **kw)


def cv2_file(img: np.ndarray, quality: int = 1000) -> bytes:
    import cv2
    ok, buf = cv2.imencode(".jp2", img, [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, quality])
    if not ok:
        raise ValueError("cv2 does not write this image as JPEG 2000")
    return buf.tobytes()


def random_cv2_file(rng) -> bytes:
    """A cv2-written file: gray, BGR, BGRA or 16-bit, lossless or lossy."""
    h, w = int(rng.integers(1, 90)), int(rng.integers(1, 90))
    kind = int(rng.integers(0, 4))
    ch = int(rng.choice([1, 3, 4]))
    depth = 16 if rng.random() < 0.2 else 8
    img = picture(rng, h, w, ch, kind, depth)
    if ch == 1:
        img = img[..., 0]
    q = 1000 if rng.random() < 0.3 else int(rng.integers(1, 1000))
    return cv2_file(img, q)


def damaged(data: bytes, rng, j: int) -> bytes:
    """Copy j of `data`: cut short (every third copy) or with one to three
    bytes replaced anywhere."""
    if j % 3 == 0:
        return data[:int(rng.integers(1, len(data)))]
    m = bytearray(data)
    for _ in range(int(rng.integers(1, 4))):
        m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
    return bytes(m)


# ------------------------------------------------- the system libopenjp2's writer

_built: dict = {}


def _writer() -> str:
    if "opj" not in _built:
        d = tempfile.mkdtemp(prefix="torch_j2k_writer_")
        atexit.register(shutil.rmtree, d, True)
        exe = os.path.join(d, "torch_jpeg2000_writer")
        subprocess.run(["gcc", "-O1", os.path.join(TOOLS, "torch_jpeg2000_writer.c"), "-o", exe,
                        "-l:libopenjp2.so.7"], check=True, capture_output=True)
        _built["opj"] = exe
    return _built["opj"]


def opj_file(img: np.ndarray, prec: int = 8, jp2_format: bool = False, **settings) -> bytes:
    """A file the system libopenjp2 writes of `img` ((H, W) or (H, W, C),
    up to 16 bits): settings are the C writer's options (see
    tools/torch_jpeg2000_writer.c), e.g. mode=cblk style bits, csty=2|4
    (SOP/EPH), poc="RLCP,0,0,1,3,3;...", roi=(comp, shift),
    subsampling=(dx, dy), offset=(x0, y0), tile=(w, h), tp="R", rates=[...],
    numres, cblk=(w, h), prec_size=(w, h), irreversible, mct, prog."""
    img = np.ascontiguousarray(img.astype(np.int32))
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    d = tempfile.mkdtemp(prefix="torch_j2k_")
    try:
        raw = os.path.join(d, "in.raw")
        out = os.path.join(d, "out.jp2" if jp2_format else "out.j2k")
        img.transpose(2, 0, 1).tofile(raw)
        args = [_writer(), raw, out, str(w), str(h), str(c), str(prec), "1" if jp2_format else "0"]
        for k, v in settings.items():
            if isinstance(v, (list, tuple)):
                v = ",".join(str(x) for x in v)
            args.append(f"{k}={v}")
        subprocess.run(args, check=True, capture_output=True)
        with open(out, "rb") as fh:
            return fh.read()
    finally:
        shutil.rmtree(d, ignore_errors=True)
