"""Write the fixtures of the port's PxM, PAM, PFM, Sun raster, Radiance HDR
and GIF decoders into tests/data/torch_image_formats/, with digests.json:
for every file, the sha256 and shape of cv2.imdecode(..., IMREAD_COLOR),
or null where cv2 refuses it, so that a machine without cv2 (chip_smoke.py
on the card's) holds the port's decode to cv2's.

    python tools/make_torch_image_formats_fixtures.py

The inputs, 83x41 frames of tools/make_torch_format_fixtures.frame:
- what cv2 5.0 writes itself: PBM, PGM and PPM in ASCII and binary, PAM,
  PFM, Sun raster (24-bit and 8-bit gray), Radiance HDR and GIF;
- what it does not, written here by hand: comments in a PxM header,
  maxvals under 255 (ASCII rescaled, binary kept) and over it (16-bit),
  PAM's BLACKANDWHITE (packed bits), GRAYSCALE, 16-bit RGB and a PAM
  without TUPLTYPE, a big-endian PFM with a scale of 2 and a gray Pf (cv2
  returns it with one channel), the old Sun raster type, 8-bit with a
  colormap, 1-bit with and without one, 32-bit, and the run-length and RGB
  types (cv2 refuses both), a flat HDR scanline file, a "#?RGBE" header,
  an XYZE file (refused); GIF87a, an interlaced GIF, local palettes, a
  first frame smaller than the screen over the background colour with a
  transparent index, an animation (its first frame), no palette at all
  (cv2's default), a table that fills up without a clear code, and an
  index past the palette (refused).
The alpha PAM tuple types are not among them: cv2 5.0 converts only the
first pixel of each row and leaves the rest as the allocator gave it.

Needs cv2 (5.0.0); deterministic from its seed.
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
OUT = os.path.join(REPO, "tests", "data", "torch_image_formats")
SEED = 21
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_format_fixtures import frame  # noqa: E402
from tests.torch_gif_writer import gif  # noqa: E402

H, W = 41, 83


def quantize(img, n: int):
    """A palette of n colours (k-means free: the first n distinct colours of
    a coarse cut) and the indices of img."""
    q = (img // (256 // 4)).astype(np.int32)
    key = q[..., 0] * 16 + q[..., 1] * 4 + q[..., 2]
    keys, inverse = np.unique(key, return_inverse=True)
    pal = np.stack([(keys >> 4) & 3, (keys >> 2) & 3, keys & 3], -1) * 64 + 32
    idx = inverse.reshape(key.shape) % n
    return pal[:n, ::-1].astype(np.uint8), idx   # RGB palette


# ---------------------------------------------------------------- the files

def imencode(ext, img, params=()) -> bytes:
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok, ext
    return buf.tobytes()


def ascii_rows(values) -> bytes:
    return b"\n".join(b" ".join(b"%d" % v for v in row) for row in values) + b"\n"


def ras(w, h, depth, kind, maptype, cmap, data) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, maptype,
                       len(cmap)) + bytes(cmap) + bytes(data)


def ras_rows(rows) -> bytes:
    """Sun raster rows padded to 16 bits."""
    return b"".join(r + (b"\0" if len(r) % 2 else b"") for r in rows)


def inputs(rng) -> dict:
    img = frame(H, W, rng)
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    rgb = img[..., ::-1]
    out = {
        "p1_ascii_83x41.pbm": imencode(".pbm", gray, [cv2.IMWRITE_PXM_BINARY, 0]),
        "p4_83x41.pbm": imencode(".pbm", gray),
        "p2_ascii_83x41.pgm": imencode(".pgm", gray, [cv2.IMWRITE_PXM_BINARY, 0]),
        "p5_83x41.pgm": imencode(".pgm", gray),
        "p3_ascii_83x41.ppm": imencode(".ppm", img, [cv2.IMWRITE_PXM_BINARY, 0]),
        "p6_83x41.ppm": imencode(".ppm", img),
        "pam_rgb_cv2_83x41.pam": imencode(".pam", img),
        "pfm_rgb_cv2_83x41.pfm": imencode(".pfm", img.astype(np.float32) / 97),
        "ras24_cv2_83x41.ras": imencode(".ras", img),
        "ras8_gray_cv2_83x41.ras": imencode(".ras", gray),
        "hdr_rle_cv2_83x41.hdr": imencode(".hdr", (img.astype(np.float32) / 200) ** 2,
                                          [cv2.IMWRITE_HDR_COMPRESSION, 1]),
        "gif_cv2_83x41.gif": imencode(".gif", img),
    }
    # PxM by hand: comments, small and 16-bit maxvals
    g100 = (gray.astype(np.int32) * 100 // 255)
    out["p2_comment_maxval100_83x41.pgm"] = (b"P2\n# a comment\n83 41 # another\n100\n"
                                             + ascii_rows(g100))
    out["p5_maxval100_83x41.pgm"] = b"P5\n83 41\n100\n" + g100.astype(np.uint8).tobytes()
    g16 = gray.astype(np.int32) * 1000 // 255 + rng.integers(0, 4, gray.shape)
    out["p2_maxval1000_83x41.pgm"] = b"P2\n83 41\n1000\n" + ascii_rows(g16)
    out["p5_maxval1000_83x41.pgm"] = b"P5\n83 41\n1000\n" + g16.astype(">u2").tobytes()
    c16 = rgb.astype(np.int32) * 257 + rng.integers(0, 256, rgb.shape)
    out["p6_16bit_83x41.ppm"] = b"P6\n83 41\n65535\n" + c16.astype(">u2").tobytes()
    out["p3_16bit_83x41.ppm"] = b"P3\n83 41 65535\n" + ascii_rows(c16.reshape(H, -1))
    out["p1_packed_digits_83x41.pbm"] = b"P1\n83 41\n" + b"\n".join(
        b"".join(b"%d" % v for v in row) for row in (gray < 128).astype(int)) + b"\n"
    # PAM by hand
    def pam(depth, maxval, tupl, data):
        head = b"P7\nWIDTH 83\nHEIGHT 41\nDEPTH %d\nMAXVAL %d\n" % (depth, maxval)
        return head + (b"TUPLTYPE " + tupl + b"\n" if tupl else b"") + b"ENDHDR\n" + data
    out["pam_gray_83x41.pam"] = pam(1, 255, b"GRAYSCALE", gray.tobytes())
    out["pam_notupltype_83x41.pam"] = pam(3, 255, None, rgb.tobytes())
    out["pam_rgb16_83x41.pam"] = pam(3, 65535, b"RGB", c16.astype(">u2").tobytes())
    out["pam_blackandwhite_83x41.pam"] = pam(1, 1, b"BLACKANDWHITE", rng.integers(
        0, 256, (H, W), dtype=np.uint8).tobytes())
    # PFM by hand: big-endian with a scale of 2; gray
    f3 = (rgb.astype(np.float32) / 90)[::-1]
    out["pfm_bigendian_scale2_83x41.pfm"] = b"PF\n83 41\n2.0\n" + (f3 * 2).astype(">f4").tobytes()
    out["pfm_gray_83x41.pfm"] = b"Pf\n83 41\n-1.0\n" + (gray[::-1].astype("<f4") / 3).tobytes()
    # Sun raster by hand
    bgr_rows = [img[y].tobytes() for y in range(H)]
    out["ras24_old_83x41.ras"] = ras(W, H, 24, 0, 0, b"", ras_rows(bgr_rows))
    out["ras32_83x41.ras"] = ras(W, H, 32, 1, 0, b"", ras_rows(
        [np.concatenate([np.zeros((W, 1), np.uint8), img[y]], 1).tobytes() for y in range(H)]))
    pal, idx = quantize(img, 64)
    cmap = pal[:, 0].tobytes() + pal[:, 1].tobytes() + pal[:, 2].tobytes()
    out["ras8_colormap_83x41.ras"] = ras(W, H, 8, 1, 1, cmap, ras_rows(
        [idx[y].astype(np.uint8).tobytes() for y in range(H)]))
    bits = [np.packbits(gray[y] < 128).tobytes() for y in range(H)]
    out["ras1_83x41.ras"] = ras(W, H, 1, 1, 0, b"", ras_rows(bits))
    out["ras1_colormap_83x41.ras"] = ras(W, H, 1, 1, 1, bytes([200, 20, 30, 10, 150, 90]),
                                         ras_rows(bits))
    out["ras_rle_refused_83x41.ras"] = ras(W, H, 8, 2, 0, b"", b"\x80\x05\x07" * 700)
    out["ras_rgb_refused_83x41.ras"] = ras(W, H, 24, 3, 0, b"", ras_rows(bgr_rows))
    # HDR by hand: flat scanlines, the RGBE header, XYZE
    flat = imencode(".hdr", (img.astype(np.float32) / 200) ** 2, [cv2.IMWRITE_HDR_COMPRESSION, 0])
    head, _, body = flat.partition(b"\n\n")
    size_line, _, pixels = body.partition(b"\n")
    rgbe = np.frombuffer(imencode(".hdr", np.zeros((1, 1, 3), np.float32)), np.uint8)[-4:]
    assert rgbe.size == 4
    # flat RGBE pixels of the frame: encode each as cv2 would, row by row
    f = (img[..., ::-1].astype(np.float64) / 200) ** 2
    mx = f.max(-1)
    mant, ex = np.frexp(mx)
    scale = np.where(mx < 1e-32, 0, mant * 256.0 / np.where(mx < 1e-32, 1, mx))
    flat_px = np.concatenate([(f * scale[..., None]).astype(np.uint8),
                              np.where(mx < 1e-32, 0, ex + 128)[..., None].astype(np.uint8)], -1)
    out["hdr_flat_83x41.hdr"] = (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 41 +X 83\n"
                                 + flat_px.tobytes())
    out["hdr_rgbe_header_83x41.hdr"] = (b"#?RGBE\nEXPOSURE=1.5\nFORMAT=32-bit_rle_rgbe\n\n"
                                        + size_line + b"\n" + pixels)
    out["hdr_xyze_refused_83x41.hdr"] = (b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n-Y 41 +X 83\n"
                                         + flat_px.tobytes())
    # GIF by hand
    pal16, idx16 = quantize(img, 16)
    pal256 = rng.integers(0, 256, (256, 3))
    noise = rng.integers(0, 256, (H, W))
    out["gif87a_83x41.gif"] = gif(W, H, [dict(idx=idx16, min_size=4)], gpal=pal16,
                                  version=b"GIF87a")
    out["gif_interlaced_83x41.gif"] = gif(W, H, [dict(idx=idx16, interlace=True, min_size=4)],
                                          gpal=pal16)
    out["gif_local_palette_83x41.gif"] = gif(W, H, [dict(idx=idx16, lpal=pal16[::-1],
                                                         min_size=4)], gpal=pal16)
    out["gif_transparent_offset_83x41.gif"] = gif(
        W, H, [dict(idx=idx16[5:35, 10:70], x=10, y=5, trans=int(idx16[20, 40]), min_size=4)],
        gpal=pal16, bg=3)
    out["gif_animation_83x41.gif"] = gif(W, H, [dict(idx=idx16, min_size=4),
                                                dict(idx=idx16[::-1], lpal=pal16[::-1],
                                                     min_size=4)], gpal=pal16)
    out["gif_no_palette_83x41.gif"] = gif(W, H, [dict(idx=idx16, min_size=4)])
    out["gif_full_table_83x41.gif"] = gif(W, H, [dict(idx=noise, clear_at_full=False)],
                                          gpal=pal256)
    out["gif_index_past_palette_refused_83x41.gif"] = gif(W, H, [dict(idx=idx16, min_size=4)],
                                                          gpal=pal16[:8])
    return out


def digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(SEED)
    files = inputs(rng)
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as fh:
            fh.write(data)
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        digests[name] = {"cv2": digest(img), "bytes": len(data)}
        print(f"{name:44s} {len(data):7d} bytes  cv2 {None if img is None else img.shape}")
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "inputs": digests}, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
