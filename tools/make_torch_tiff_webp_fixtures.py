"""Write the fixtures of the port's TIFF and WebP decoders into
tests/data/torch_tiff_webp/, with digests.json: for every file, the sha256
and shape of cv2.imdecode(..., IMREAD_COLOR), or null where cv2 refuses
it, so that a machine without cv2 (chip_smoke.py on the card's) holds the
port's decode to cv2's; "not_ported" marks the files cv2 reads and the
port refuses by name (their reason).

    python tools/make_torch_tiff_webp_fixtures.py

The inputs, 83x41 frames of tools/make_torch_format_fixtures.frame:
- what cv2 5.0 writes itself: TIFF under each compression it writes (none,
  LZW, JPEG, both Deflates, PackBits), with and without the horizontal
  predictor, 8-bit BGR, gray, 16-bit and BGRA; WebP lossless (its
  default), lossy at qualities 10, 50, 90 and 100, BGRA lossless and
  lossy, and animations through cv2.imencodeanimation;
- TIFFs the system libtiff writes through tools/torch_tiff_writer.c: tiles,
  planar separate RGB, RGBA and CMYK, palettes of 1, 4 and 8 bits with
  8- and 16-bit colormaps, 1-bit, MinIsWhite, 16-bit gray, YCbCr at every
  subsampling with its coefficients and ReferenceBlackWhite, contiguous
  CMYK, associated and unassociated alpha (8 and 16 bits), the eight
  orientations in strips and in tiles, BigTIFF in both byte orders, two
  pages, fill order 2, big-endian 16-bit with the predictor, JPEG in
  strips and tiles (RGB, gray, YCbCr 4:2:0 and 4:2:2), and what cv2
  refuses (2-bit gray, float samples, ZSTD, LZMA) or decodes and the port
  refuses by name (CIELab, CCITT fax 4);
- a TIFF built by hand with old-style (compat) LZW codes;
- WebPs the system libwebp writes through tools/torch_webp_writer.c: VP8
  with 2, 4 and 8 partitions, 1 and 4 segments, the simple and the normal
  filter at several sharpnesses, VP8L with palettes of 2, 4, 16 and 256
  colours (odd widths: the bundled pixels) and every method, lossy alpha
  raw and compressed with each filter;
- WebPs built by hand from cv2's chunks: VP8X with ICCP, EXIF and XMP, an
  unknown chunk, two ALPH chunks, a damaged ALPH (refused), trailing
  bytes past the RIFF size, a raw VP8L bitstream, animations whose first
  frame lies at an offset (with and without blending, a background colour);
- chip_smoke.py's decode-time inputs: the 720x405 and 1920x1080 frames of
  the JPEG fixtures as cv2 writes them lossy at quality 80.

Needs cv2 (5.0.0), gcc, and the system's libtiff and libwebp headers and
libraries (libtiff-dev, libwebp-dev); deterministic from its seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_tiff_webp")
SEED = 22

from make_torch_format_fixtures import frame  # noqa: E402
from tests.torch_tiff_webp_writers import (  # noqa: E402
    animation, anmf, chunk, image_chunks, libtiff_file, libwebp_file, lzw_compat, riff,
    tiff_file, vp8x,
)

H, W = 41, 83
NOT_PORTED = {"tiff_cielab_83x41.tif": "TIFF with CIELab photometric",
              "tiff_ccitt_fax4_83x41.tif": "TIFF with CCITT fax 4 compression"}


def imencode(ext, img, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


def tiff_inputs(rng) -> dict:
    bgr = frame(H, W, rng)
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    gray = bgr[..., 1:2]
    wide = (bgr.astype(np.uint16) * 257 + rng.integers(0, 257, bgr.shape)).astype(np.uint16)
    alpha = rng.integers(0, 256, (H, W, 1), np.uint8)
    alpha[:10, :20] = 0
    rgba = np.concatenate([rgb, alpha], 2)
    out = {}
    # cv2's own files
    for comp, tag in ((1, "none"), (5, "lzw"), (7, "jpeg"), (8, "deflate"),
                      (32946, "deflate_old"), (32773, "packbits")):
        for pred in ((1, 2) if comp in (5, 8, 32946) else (1,)):
            p = [cv2.IMWRITE_TIFF_COMPRESSION, comp, cv2.IMWRITE_TIFF_PREDICTOR, pred]
            suffix = "_pred" if pred == 2 else ""
            out[f"tiff_cv2_{tag}{suffix}_83x41.tif"] = imencode(".tiff", bgr, p)
            out[f"tiff_cv2_{tag}{suffix}_gray_83x41.tif"] = imencode(".tiff", bgr[..., 0], p)
            if comp != 7:
                out[f"tiff_cv2_{tag}{suffix}_16bit_83x41.tif"] = imencode(".tiff", wide, p)
            out[f"tiff_cv2_{tag}{suffix}_bgra_83x41.tif"] = imencode(
                ".tiff", np.concatenate([bgr, alpha], 2), p)
    out["tiff_cv2_rows_per_strip_7_83x41.tif"] = imencode(
        ".tiff", bgr, [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 7])
    # libtiff's
    lt = libtiff_file
    out["tiff_tiles_lzw_pred_83x41.tif"] = lt([(262, 2), (259, 5), (317, 2)], rgb, tile=(32, 16))
    out["tiff_tiles_deflate_83x41.tif"] = lt([(262, 2), (259, 8)], rgb, tile=(16, 32))
    out["tiff_tiles_none_32x32_83x41.tif"] = lt([(262, 2)], rgb, tile=(32, 32))
    out["tiff_tiles_none_refused_83x41.tif"] = lt([(262, 2)], rgb, tile=(16, 16))
    out["tiff_planar_rgb_83x41.tif"] = lt([(262, 2), (259, 5)], rgb, rows_per_strip=8, planar=2)
    out["tiff_planar_rgba_unassoc_83x41.tif"] = lt([(262, 2), (338, 2), (259, 8)], rgba,
                                                   rows_per_strip=16, planar=2)
    out["tiff_planar_tiles_83x41.tif"] = lt([(262, 2), (259, 5)], rgb, tile=(16, 16), planar=2)
    cmyk = rng.integers(0, 256, (H, W, 4), np.uint8)
    cmyk[..., 3] //= 3
    out["tiff_cmyk_83x41.tif"] = lt([(262, 5), (332, 1), (259, 5)], cmyk, rows_per_strip=9)
    out["tiff_cmyk_planar_83x41.tif"] = lt([(262, 5), (332, 1)], cmyk, rows_per_strip=9, planar=2)
    for bps in (1, 4, 8):
        n = 1 << bps
        idx = rng.integers(0, n, (H, W, 1))
        cmap16 = list(rng.integers(0, 65536, 3 * n))
        cmap8 = list(rng.integers(0, 256, 3 * n))
        out[f"tiff_palette{bps}_map16_83x41.tif"] = lt([(262, 3), (320, cmap16), (259, 5)], idx,
                                                      bps=bps, rows_per_strip=11)
        out[f"tiff_palette{bps}_map8_83x41.tif"] = lt([(262, 3), (320, cmap8)], idx, bps=bps,
                                                     rows_per_strip=11)
    out["tiff_palette4_tiles_83x41.tif"] = lt([(262, 3), (320, list(rng.integers(0, 65536, 48))),
                                               (259, 32773)], rng.integers(0, 16, (H, W, 1)),
                                              bps=4, tile=(16, 16))
    bits = (bgr[..., 1:2] > 128).astype(np.uint8)
    out["tiff_bilevel_83x41.tif"] = lt([(262, 1), (259, 32773)], bits, bps=1, rows_per_strip=10)
    out["tiff_bilevel_miniswhite_83x41.tif"] = lt([(262, 0)], bits, bps=1)
    out["tiff_gray_miniswhite_83x41.tif"] = lt([(262, 0), (259, 5)], gray, rows_per_strip=13)
    out["tiff_gray16_83x41.tif"] = lt([(262, 1), (259, 8), (317, 2)], wide[..., :1], bps=16,
                                      rows_per_strip=13)
    out["tiff_gray16_miniswhite_tiles_83x41.tif"] = lt([(262, 0), (259, 5)], wide[..., :1],
                                                       bps=16, tile=(16, 16))
    out["tiff_gray_alpha_83x41.tif"] = lt([(262, 1), (338, 2)],
                                          np.concatenate([gray, alpha], 2), rows_per_strip=8)
    ycc = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)[..., [0, 2, 1]]
    for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)):
        out[f"tiff_ycbcr{hs}{vs}_83x41.tif"] = lt([(262, 6), (259, 5), (530, [hs, vs])], ycc,
                                                 ycbcr=(hs, vs), rows_per_strip=8)
    out["tiff_ycbcr22_refbw_coeffs_83x41.tif"] = lt(
        [(262, 6), (530, [2, 2]), (529, [0.2126, 0.7152, 0.0722]),
         (532, [16, 235, 128, 240, 128, 240])], ycc, ycbcr=(2, 2))
    out["tiff_ycbcr_planar_83x41.tif"] = lt([(262, 6), (530, [1, 1])], ycc, rows_per_strip=16,
                                            planar=2)
    for extra, tag in ((1, "assoc"), (2, "unassoc"), (0, "unspecified")):
        out[f"tiff_rgba_{tag}_83x41.tif"] = lt([(262, 2), (338, extra), (259, 5)], rgba,
                                               rows_per_strip=8)
    wide_a = np.concatenate([wide[..., ::-1], (alpha.astype(np.uint16) * 257)], 2)
    out["tiff_rgba16_unassoc_83x41.tif"] = lt([(262, 2), (338, 2)], wide_a, bps=16,
                                              rows_per_strip=8)
    for o in range(1, 9):
        out[f"tiff_orientation{o}_83x41.tif"] = lt([(262, 2), (259, 5), (274, o)], rgb,
                                                   rows_per_strip=8)
        out[f"tiff_orientation{o}_tiles_83x41.tif"] = lt([(262, 2), (259, 8), (274, o)], rgb,
                                                         tile=(32, 16))
    out["tiff_bigtiff_le_83x41.tif"] = lt([(262, 2), (259, 5)], rgb, rows_per_strip=8, mode="w8l")
    out["tiff_bigtiff_be_83x41.tif"] = lt([(262, 2), (259, 8)], rgb, tile=(16, 16), mode="w8b")
    second = (["page", f"256 {W}", f"257 {H}", "258 8", "277 1", "284 1", "262 1", f"278 {H}",
               f"chunks {W * H}"], bgr[..., 2].tobytes())
    out["tiff_two_pages_83x41.tif"] = lt([(262, 2), (259, 5)], rgb, rows_per_strip=8,
                                         pages=[second])
    out["tiff_fillorder2_83x41.tif"] = lt([(262, 2), (259, 5), (266, 2)], rgb, rows_per_strip=8)
    out["tiff_be16_pred_83x41.tif"] = lt([(262, 2), (259, 5), (317, 2)], wide[..., ::-1], bps=16,
                                         rows_per_strip=8, mode="wb")
    out["tiff_jpeg_rgb_83x41.tif"] = lt([(262, 2), (259, 7)], rgb, rows_per_strip=16)
    out["tiff_jpeg_gray_tiles_83x41.tif"] = lt([(262, 1), (259, 7)], gray, tile=(32, 32))
    out["tiff_jpeg_ycbcr420_83x41.tif"] = lt([(262, 6), (259, 7), (530, [2, 2]), (65538, 1)], rgb,
                                             rows_per_strip=16)
    out["tiff_jpeg_ycbcr422_tiles_83x41.tif"] = lt([(262, 6), (259, 7), (530, [2, 1]),
                                                    (65538, 1), (65537, 60)], rgb, tile=(32, 16))
    out["tiff_gray2_refused_83x41.tif"] = lt([(262, 1)], rng.integers(0, 4, (H, W, 1)), bps=2)
    out["tiff_float_refused_83x41.tif"] = imencode(".tiff", bgr.astype(np.float32) / 255)
    out["tiff_zstd_refused_83x41.tif"] = lt([(262, 2), (259, 50000)], rgb, rows_per_strip=8)
    out["tiff_lzma_refused_83x41.tif"] = lt([(262, 2), (259, 34925)], rgb, rows_per_strip=8)
    lab = cv2.cvtColor(bgr, cv2.COLOR_BGR2Lab).astype(np.int16)
    lab[..., 1:] -= 128
    out["tiff_cielab_83x41.tif"] = lt([(262, 8)], lab.astype(np.uint8), rows_per_strip=8)
    out["tiff_ccitt_fax4_83x41.tif"] = lt([(262, 0), (259, 4)], bits, bps=1)
    # old-style LZW, by hand
    strips = [lzw_compat(rgb[y:y + 16].tobytes()) for y in range(0, H, 16)]
    out["tiff_lzw_compat_83x41.tif"] = tiff_file(
        [(256, 4, [W]), (257, 4, [H]), (258, 3, [8, 8, 8]), (259, 3, [5]), (262, 3, [2]),
         (277, 3, [3]), (278, 4, [16]), (273, 4, "OFFS"), (279, 4, [len(s) for s in strips])],
        strips)
    return out


def webp_inputs(rng) -> dict:
    bgr = frame(H, W, rng)
    alpha = rng.integers(0, 256, (H, W, 1), np.uint8)
    alpha[:12, :30] = 0
    bgra = np.concatenate([bgr, alpha], 2)
    rgba = np.ascontiguousarray(bgra[..., [2, 1, 0, 3]])
    opaque = rgba.copy()
    opaque[..., 3] = 255
    out = {"webp_cv2_lossless_83x41.webp": imencode(".webp", bgr),
           "webp_cv2_bgra_lossless_83x41.webp": imencode(".webp", bgra)}
    for q in (10, 50, 90, 100):
        out[f"webp_cv2_q{q}_83x41.webp"] = imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, q])
    out["webp_cv2_bgra_q80_83x41.webp"] = imencode(".webp", bgra, [cv2.IMWRITE_WEBP_QUALITY, 80])
    anim = cv2.Animation()
    anim.frames = [bgra, np.ascontiguousarray(np.roll(bgra, 9, 1)), bgra[::-1].copy()]
    anim.durations = [80, 80, 80]
    out["webp_cv2_animation_lossless_83x41.webp"] = cv2.imencodeanimation(
        ".webp", anim)[1].tobytes()
    out["webp_cv2_animation_q60_83x41.webp"] = cv2.imencodeanimation(
        ".webp", anim, [cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes()
    lw = libwebp_file
    for parts in (1, 2, 3):
        out[f"webp_vp8_partitions{1 << parts}_83x41.webp"] = lw(opaque, quality=70,
                                                                partitions=parts)
    noise = np.concatenate([rng.integers(0, 256, (H, W, 3), np.uint8),
                            np.full((H, W, 1), 255, np.uint8)], 2)
    for seg in (1, 4):
        out[f"webp_vp8_segments{seg}_83x41.webp"] = lw(noise, quality=40, segments=seg, sns=90)
    for ftype in (0, 1):
        for sharp in (0, 5):
            out[f"webp_vp8_filter{ftype}_sharp{sharp}_83x41.webp"] = lw(
                noise, quality=30, filter_type=ftype, filter_sharpness=sharp,
                filter_strength=80)
    for ncol in (2, 4, 16, 256):
        pal = rng.integers(0, 256, (ncol, 4), np.uint8)
        pal[:, 3] = 255
        img = pal[rng.integers(0, ncol, (H, W))]
        out[f"webp_vp8l_palette{ncol}_83x41.webp"] = lw(img, lossless=1, method=4, quality=75)
    for method in (0, 3, 6):
        out[f"webp_vp8l_method{method}_83x41.webp"] = lw(rgba, lossless=1, method=method,
                                                         quality=100)
    for comp in (0, 1):
        for filt in (0, 1, 2, 3):
            out[f"webp_alpha_comp{comp}_filter{filt}_83x41.webp"] = lw(
                rgba, quality=70, alpha_compression=comp, alpha_filtering=min(filt, 2),
                alpha_quality=100 if filt < 3 else 40)
    # by hand, from cv2's chunks
    lossy = image_chunks(out["webp_cv2_bgra_q80_83x41.webp"])
    alph, vp8 = lossy
    out["webp_vp8x_metadata_83x41.webp"] = riff([vp8x(W, H, 0x10 | 0x20 | 0x08 | 0x04),
                                                 chunk(b"ICCP", bytes(39)), alph, vp8,
                                                 chunk(b"EXIF", b"II*\x00" + bytes(17)),
                                                 chunk(b"XMP ", b"<x:xmpmeta/>")])
    out["webp_vp8x_unknown_chunk_83x41.webp"] = riff([vp8x(W, H, 0x10), alph,
                                                      chunk(b"ABCD", bytes(5)), vp8])
    damaged = bytearray(alph)
    for k in range(13, len(damaged), 5):
        damaged[k] ^= 0x5A
    out["webp_two_alph_83x41.webp"] = riff([vp8x(W, H, 0x10), bytes(damaged), alph, vp8])
    out["webp_alph_damaged_refused_83x41.webp"] = riff([vp8x(W, H, 0x10), alph, bytes(damaged),
                                                        vp8])
    out["webp_alph_without_flag_83x41.webp"] = riff([vp8x(W, H, 0), alph, vp8])
    simple = out["webp_cv2_q50_83x41.webp"]
    out["webp_trailing_bytes_83x41.webp"] = simple + b"trailing bytes past the RIFF size"
    short = bytearray(simple)
    short[4:8] = struct.pack("<I", len(simple) - 8 - 2)
    out["webp_riff_size_short_refused_83x41.webp"] = bytes(short)
    vp8l = image_chunks(out["webp_cv2_lossless_83x41.webp"])[0]
    out["webp_raw_vp8l_83x41.webp"] = vp8l[8:] + bytes(32)
    small = bgra[5:25, 10:50]
    small_lossless = image_chunks(imencode(".webp", small))
    small_lossy = image_chunks(imencode(".webp", small, [cv2.IMWRITE_WEBP_QUALITY, 70]))
    out["webp_animation_offset_lossless_83x41.webp"] = animation(
        W, H, [anmf(12, 8, 40, 20, 100, 0, small_lossless),
               anmf(0, 0, 40, 20, 100, 0, small_lossless)], background=0xFF2040A0)
    out["webp_animation_offset_lossy_blend_83x41.webp"] = animation(
        W, H, [anmf(30, 14, 40, 20, 100, 2, small_lossy)], background=0x80808080, alpha=False)
    out["webp_animation_past_canvas_refused_83x41.webp"] = animation(
        W, H, [anmf(50, 30, 40, 20, 100, 0, small_lossy)])
    # the decode-time inputs of chip_smoke.py: the capture frames of the JPEG fixtures
    for name, jpg in (("720x405", "torch_jpeg/frame_720x405_q85_420.jpg"),
                      ("1920x1080", "torch_formats/prog_420_1920x1080.jpg")):
        img = cv2.imread(os.path.join(REPO, "tests", "data", jpg), cv2.IMREAD_COLOR)
        out[f"webp_timing_q80_{name}.webp"] = imencode(".webp", img,
                                                       [cv2.IMWRITE_WEBP_QUALITY, 80])
    return out


def digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(SEED)
    files = {**tiff_inputs(rng), **webp_inputs(rng)}
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as fh:
            fh.write(data)
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        digests[name] = {"cv2": digest(img), "bytes": len(data)}
        if name in NOT_PORTED:
            assert img is not None, name
            digests[name]["not_ported"] = NOT_PORTED[name]
        print(f"{name:48s} {len(data):7d} bytes  cv2 {None if img is None else img.shape}")
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "inputs": digests}, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
