"""Write the image-format fixtures of the PyTorch port's decoders into
tests/data/torch_formats/, with digests.json: for every input, the sha256
and shape of the frame of each of the JAX package's decode routes, or null
where that route refuses it.

    python tools/make_torch_format_fixtures.py

The inputs: JPEGs the port's libjpeg route must now decode (progressive
4:2:0 (also at 640x480 and 1920x1080), 4:4:4, grayscale and with restart
markers; 4:1:1 (also at 640x480) and 4:4:0; RGB-coded
with an Adobe marker), CMYK and YCCK JPEGs (cv2 decodes them, libjpeg's BGR
output does not), JPEGs with EXIF orientations 1-8, PNGs (8- and 16-bit
colour, 1-, 2-, 4-, 8- and 16-bit gray, gray with alpha, RGBA, palettes
with tRNS and one shorter than the indices it is read with, Adam7, an eXIf
orientation) and BMPs (1-, 4-, 8-, 16-, 24- and 32-bit, RLE4 and RLE8,
top-down). The made-by-hand PNG and BMP writers below cover the layouts cv2
and PIL do not write. cv2 writes no 4:1:0 JPEG, and neither cv2 nor PIL
writes an arithmetic-coded or a 12-bit one, so there are none.

Truncated streams are cuts of a baseline and a progressive fixture, keyed
"<file>@<length>": the first <length> bytes.

Routes in digests.json, per input:
- "native": the JAX package's libjpeg decode (utils/native_ingest.
  decode_jpeg; the single-stream server and the device-detect tick);
- "cv2": cv2.imdecode(..., IMREAD_COLOR) (EXIF applied; the fallback of
  every route and, as cv2.imread, the training loader);
- "scaled": for JPEGs the native route decodes, the native decode with the
  size hint that selects each libjpeg DCT scale M/8 (native/ingest.cpp:
  74-80), keyed by M.
and "smoothed": libjpeg block-smooths the frame (a truncated progressive
stream), as the port's decoder reports it.

Needs cv2, PIL and the JAX package's native library (g++ and libjpeg's
headers; JAX itself does not run). Deterministic from its seed for the same
cv2 and PIL.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import sys
import zlib

import cv2
import numpy as np
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_formats")
SEED = 15
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_scaled_jpeg_digests import jpeg_dims, native_decode, scale_hint  # noqa: E402


def frame(h: int, w: int, rng) -> np.ndarray:
    """A textured background with a skin-toned ellipse, BGR."""
    yy, xx = np.mgrid[:h, :w]
    f = 100 + 40 * np.sin(xx / 9.0) * np.cos(yy / 13.0)
    f = np.stack([f, f + 20 * np.sin(yy / 7.0), f - 20 * np.cos(xx / 5.0)], axis=-1)
    f = f + rng.integers(-6, 7, (h, w, 3))
    m = ((xx - w / 2) / (w * 0.2)) ** 2 + ((yy - h / 2) / (h * 0.35)) ** 2 <= 1.0
    f[m] = np.array([140, 160, 210]) + rng.integers(-6, 7, (int(m.sum()), 3))
    return np.clip(f, 0, 255).astype(np.uint8)


def jpeg(img, quality=85, **flags) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    for k, v in flags.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def pil(img_bgr, fmt: str, mode: str = "RGB", **kw) -> bytes:
    im = Image.fromarray(np.ascontiguousarray(img_bgr[..., ::-1]))
    if mode != "RGB":
        im = im.convert(mode, **({"palette": Image.ADAPTIVE, "colors": 16} if mode == "P"
                                 else {}))
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def exif_block(orientation: int) -> bytes:
    e = Image.Exif()
    e[0x0112] = orientation
    return e.tobytes()


def png(samples: np.ndarray, ctype: int, depth: int, palette=None, trns=None,
        interlace=False, rng=None) -> bytes:
    """A PNG of (h, w, channels) integer samples, each row given a seeded
    filter type (0-4); Adam7 when `interlace`."""
    h, w = samples.shape[:2]

    def raw_rows(img):
        out = bytearray()
        prev = None
        for row in img:
            packed = _pack(row.reshape(-1), depth)
            f = int(rng.integers(0, 5))
            out.append(f)
            out += _filter(packed, prev, f, max(1, depth * img.shape[2] // 8))
            prev = packed
        return bytes(out)

    if interlace:
        data = b"".join(raw_rows(samples[y0::dy, x0::dx]) for x0, y0, dx, dy in (
            (0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
            (1, 0, 2, 2), (0, 1, 1, 2)) if samples[y0::dy, x0::dx].size)
    else:
        data = raw_rows(samples)
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        chunks.append((b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        chunks.append((b"tRNS", trns))
    chunks += [(b"IDAT", zlib.compress(data, 9)), (b"IEND", b"")]
    return b"\x89PNG\r\n\x1a\n" + b"".join(
        struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))
        for k, d in chunks)


def _pack(values: np.ndarray, depth: int) -> bytes:
    if depth == 16:
        return values.astype(">u2").tobytes()
    if depth == 8:
        return values.astype(np.uint8).tobytes()
    per = 8 // depth
    v = np.zeros(-(-len(values) // per) * per, np.uint8)
    v[:len(values)] = values
    v = v.reshape(-1, per)
    return (sum(v[:, i] << (8 - depth * (i + 1)) for i in range(per))).astype(np.uint8).tobytes()


def _filter(row: bytes, prev, f: int, bpp: int) -> bytes:
    cur = np.frombuffer(row, np.uint8).astype(np.int32)
    up = np.zeros_like(cur) if prev is None else np.frombuffer(prev, np.uint8).astype(np.int32)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])[:len(cur)]
    ul = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])[:len(cur)]
    if f == 0:
        pred = 0
    elif f == 1:
        pred = left
    elif f == 2:
        pred = up
    elif f == 3:
        pred = (left + up) >> 1
    else:
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    return ((cur - pred) & 255).astype(np.uint8).tobytes()


def bmp(pixels: np.ndarray, bpp: int, palette=None, compression=0, top_down=False,
        masks=None) -> bytes:
    """A BMP (BITMAPINFOHEADER) of palette indices (bpp <= 8) or BGR
    pixels; compression 1 and 2 are RLE8 and RLE4 of runs and absolute
    stretches, each row ended by an end-of-line code and the image by
    end-of-bitmap."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if compression:
        body = _rle(rows, bpp)
    else:
        pitch = ((w * bpp + 7) // 8 + 3) & ~3
        out = bytearray()
        for row in rows:
            if bpp <= 8:
                b = _pack(row, bpp)
            elif bpp == 16:
                b = row.astype("<u2").tobytes()
            else:
                b = row.astype(np.uint8).tobytes()
            out += b + b"\0" * (pitch - len(b))
        body = bytes(out)
    pal = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for b, g, r in palette)
    extra = b"" if masks is None else struct.pack("<III", *masks)
    offset = 14 + 40 + len(extra) + len(pal)
    header = struct.pack("<iiHHIIiiII", w, -h if top_down else h, 1, bpp,
                         3 if masks is not None else compression, len(body), 2835, 2835,
                         0 if palette is None else len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + struct.pack("<I", 40) + header + extra + pal + body)


def _rle(rows: np.ndarray, bpp: int) -> bytes:
    out = bytearray()
    for row in rows:
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                n = min(run, w - x)
                code = int(row[x]) if bpp == 8 else (int(row[x]) << 4) | int(row[x])
                out += bytes([n, code])
                x += n
            else:
                n = min(w - x, 8)
                vals = row[x:x + n]
                if bpp == 8:
                    b = bytes(int(v) for v in vals)
                    b += b"\0" * (len(b) & 1)
                else:
                    b = _pack(vals, 4)
                    b += b"\0" * (len(b) & 1)
                out += bytes([0, n]) + b
                x += n
        out += b"\0\0"
    return bytes(out) + b"\0\1"


def inputs(rng) -> dict:
    img = frame(41, 83, rng)
    cap = frame(480, 640, rng)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    sf = {k: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{k}") for k in ("411", "440", "444")}
    f = {
        "prog_420_83x41.jpg": jpeg(img, progressive=1),
        "prog_444_83x41.jpg": jpeg(img, progressive=1, sampling_factor=sf["444"]),
        "prog_gray_83x41.jpg": jpeg(gray, progressive=1),
        "prog_restart_83x41.jpg": jpeg(img, 70, progressive=1, rst_interval=2),
        "prog_420_640x480.jpg": jpeg(cap, progressive=1),
        # the timing inputs of chip_smoke.py's formats phase
        "prog_420_1920x1080.jpg": jpeg(cv2.GaussianBlur(frame(1080, 1920, rng), (5, 5), 0),
                                       progressive=1),
        "s411_640x480.jpg": jpeg(cap, sampling_factor=sf["411"]),
        "s411_83x41.jpg": jpeg(img, sampling_factor=sf["411"]),
        "s440_83x41.jpg": jpeg(img, sampling_factor=sf["440"]),
        "s411_prog_83x41.jpg": jpeg(img, 60, progressive=1, sampling_factor=sf["411"]),
        "base_420_83x41.jpg": jpeg(img, 90),
        "rgb_adobe_83x41.jpg": pil(img, "JPEG", keep_rgb=True),
        "cmyk_83x41.jpg": pil(img, "JPEG", "CMYK"),
    }
    ycck = bytearray(f["cmyk_83x41.jpg"])
    at = ycck.index(b"Adobe") + 11   # the Adobe marker's transform byte
    ycck[at] = 2
    f["ycck_83x41.jpg"] = bytes(ycck)
    for o in range(1, 9):
        f[f"exif{o}_83x41.jpg"] = pil(img, "JPEG", exif=exif_block(o))
    # PNG
    h, w = img.shape[:2]
    f["png_rgb8_83x41.png"] = cv2.imencode(".png", img)[1].tobytes()
    f["png_rgb16_83x41.png"] = cv2.imencode(".png", img.astype(np.uint16) * 257 + rng.integers(
        0, 256, img.shape).astype(np.uint16))[1].tobytes()
    f["png_rgba_83x41.png"] = cv2.imencode(".png", np.dstack([img, gray]))[1].tobytes()
    f["png_gray_alpha_83x41.png"] = pil(img, "PNG", "LA")
    f["png_palette_trns_83x41.png"] = pil(img, "PNG", "P", transparency=0)
    f["png_exif6_83x41.png"] = pil(img, "PNG", exif=exif_block(6))
    for depth in (1, 2, 4, 8, 16):
        g = rng.integers(0, 1 << depth, (h, w, 1))
        f[f"png_gray{depth}_83x41.png"] = png(g, 0, depth, rng=rng)
    f["png_adam7_rgb8_83x41.png"] = png(img[..., ::-1], 2, 8, interlace=True, rng=rng)
    f["png_adam7_rgb16_83x41.png"] = png(img[..., ::-1].astype(np.uint16) * 257, 2, 16,
                                         interlace=True, rng=rng)
    pal = rng.integers(0, 256, (5, 3))
    f["png_adam7_palette2_83x41.png"] = png(rng.integers(0, 4, (h, w, 1)), 3, 2,
                                            palette=pal[:4], interlace=True, rng=rng)
    # a 5-entry palette read with 4-bit indices up to 15: the rest are black
    f["png_palette_short_83x41.png"] = png(rng.integers(0, 16, (h, w, 1)), 3, 4, palette=pal,
                                           trns=b"\x10\x80", rng=rng)
    # BMP
    idx8 = (gray // 16).astype(np.uint8)
    pal16 = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(16)]
    f["bmp24_83x41.bmp"] = cv2.imencode(".bmp", img)[1].tobytes()
    f["bmp8_83x41.bmp"] = cv2.imencode(".bmp", gray)[1].tobytes()
    f["bmp32_83x41.bmp"] = cv2.imencode(".bmp", np.dstack([img, gray]))[1].tobytes()
    f["bmp1_83x41.bmp"] = pil(img, "BMP", "1")
    f["bmp4_83x41.bmp"] = bmp(idx8, 4, pal16)
    f["bmp_rle8_83x41.bmp"] = bmp(idx8, 8, pal16, compression=1)
    f["bmp_rle4_83x41.bmp"] = bmp(idx8, 4, pal16, compression=2)
    f["bmp_topdown24_83x41.bmp"] = bmp(img, 24, top_down=True)
    v565 = ((img[..., 2].astype(np.uint16) >> 3) << 11) | ((img[..., 1].astype(np.uint16) >> 2)
                                                          << 5) | (img[..., 0] >> 3)
    f["bmp16_565_83x41.bmp"] = bmp(v565, 16, masks=(0xF800, 0x7E0, 0x1F))
    return f


def cuts(data: bytes) -> list:
    """Cut points of a stream: inside its headers, inside its first scan,
    between scans, and just before its EOI marker."""
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    n = len(data)
    pts = {sos[0] // 2, sos[0] + 40, (sos[0] + n) // 2, n - 2, n - 1}
    for s in sos[1:]:
        pts.update((s - 3, s + 20))
    return sorted(p for p in pts if 2 < p < n)


def digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def main() -> int:
    from real_time_video_deepfake_detection_tpu.utils.native_ingest import decode_jpeg, get_lib
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
        JpegError, decode_coefs)
    lib = get_lib()
    if lib is None:
        raise SystemExit("the JAX package's native ingest library did not build")
    rng = np.random.default_rng(SEED)
    files = inputs(rng)
    os.makedirs(OUT, exist_ok=True)
    for name in os.listdir(OUT):
        if name != "digests.json":
            os.remove(os.path.join(OUT, name))
    entries = dict(files)
    for base in ("base_420_83x41.jpg", "prog_420_83x41.jpg"):
        for p in cuts(files[base]):
            entries[f"{base}@{p}"] = files[base][:p]
    out = {}
    for key, data in sorted(entries.items()):
        if "@" not in key:
            with open(os.path.join(OUT, key), "wb") as fh:
                fh.write(data)
        native = decode_jpeg(data) if data[:2] == b"\xff\xd8" else None
        e = {"native": digest(native),
             "cv2": digest(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))}
        if native is not None:
            h, w = jpeg_dims(data)
            e["scaled"] = {}
            for m in range(1, 9):
                hint = scale_hint(h, w, m)
                if hint:
                    e["scaled"][str(m)] = dict(digest(native_decode(lib, data, hint)), hint=hint)
        try:
            e["smoothed"] = decode_coefs(data, None).smoothing if data[:2] == b"\xff\xd8" \
                else False
        except JpegError:
            e["smoothed"] = False
        out[key] = e
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "PIL": Image.__version__, "inputs": out}, fh,
                  indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {len(files)} files and {len(out)} digests to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
