"""The two decode ladders of the JAX package, without cv2 or libjpeg.

The JAX package decodes an image by one of two routes, and the port takes
the same one at each entry point:

- `native_route`: its libjpeg decode to BGR (native/ingest.cpp, the
  single-stream server, the device-detect tick's pooled decode, host prep).
  Sequential and progressive JPEGs, Huffman or arithmetic coded, truncated
  ones too (libjpeg pads them), grayscale, YCbCr and RGB; no EXIF
  orientation. Lossless JPEGs are refused, as libjpeg-turbo 2.1.5 refuses
  them.
- `cv2_route`: cv2.imdecode / cv2.imread with IMREAD_COLOR (the fallback
  of every native entry point, and the training loader). The decoder is
  picked by cv2's own signature checks: JPEG (CMYK and YCCK too, and
  lossless RGB and CMYK frames as cv2's libjpeg-turbo 3.1.2 decodes them,
  but not a stream that ends before its EOI marker), PNG and BMP, each
  turned by its EXIF orientation; Radiance HDR (utils/hdr.py), Sun raster
  (utils/sunras.py), PBM / PGM / PPM, PAM and PFM (utils/pxm.py; a Pf
  comes out (H, W), one channel, as cv2 returns it), GIF's first frame
  (utils/gif.py), WebP (utils/webp.py: lossless, lossy, with alpha, an
  animation's first frame), TIFF's first page (utils/tiff.py, as
  libtiff 4.7.1's RGBA interface reads it) and JPEG 2000 (utils/
  jpeg2000.py: JP2 files and raw codestreams, as OpenJPEG 2.5.3 decodes
  them).

`decode_frame` is the single-stream server's ladder (server.py:40-49):
bytes that start FF D8 try the native route, then the cv2 route. What
both routes refuse gives None, its reason logged once: 12- and 16-bit
JPEGs (neither libjpeg build decodes them); the formats cv2 5.0 reads and
the port does not yet: AVIF, the TIFF compressions and photometrics
utils/tiff.py names, and the JPEG 2000 features utils/jpeg2000.py names
(HTJ2K code-blocks among them); and OpenEXR, which the port refuses by its
signature and which this cv2 build (OpenEXR "NO") refuses too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import bmp, exif, gif, hdr, jpeg2000, png, pxm, sunras, tiff, webp
from .jpeg_ingest import decode_jpeg, log_refusal

JPEG_SIGNATURE = b"\xff\xd8\xff"   # cv2's JPEG decoder signature


# Leading bytes of OpenEXR, which neither this cv2 build nor the port reads
_UNPORTED = (b"\x76\x2f\x31\x01",)


def unported_format(data: bytes) -> bool:
    """Whether `data` is an image the port does not decode in a format
    cv2 5.0 reads: AVIF, a TIFF whose compression or photometric the port
    does not decode yet, a JPEG 2000 file with a feature utils/jpeg2000.py
    refuses by name; and OpenEXR, which this cv2 build refuses as well."""
    if tiff.is_tiff(data):
        try:
            tiff.decode_tiff(data)
        except tiff.NotPorted:
            return True
        return False
    if jpeg2000.is_jpeg2000(data):
        return jpeg2000.not_ported(data) is not None
    return data.startswith(_UNPORTED) or data[4:12] in (b"ftypavif", b"ftypavis")


def _oriented(frame: np.ndarray, orientation: int) -> np.ndarray:
    return exif.apply_orientation(torch.from_numpy(frame), orientation).numpy()


def _refused(why: str) -> None:
    log_refusal(why)
    return None


def native_route(data: bytes) -> Optional[np.ndarray]:
    """The JAX package's libjpeg decode: (H, W, 3) u8 BGR, or None (the
    reason logged once)."""
    return decode_jpeg(data, "native")


def cv2_route(data: bytes, from_file: bool = False) -> Optional[np.ndarray]:
    """cv2.imdecode(data, IMREAD_COLOR): (H, W, 3) u8 BGR, or None (the
    reason logged once). `from_file`: cv2.imread(path, IMREAD_COLOR) of a
    file holding `data`, which differs for TIFF (utils/tiff.decode_tiff)."""
    if data.startswith(JPEG_SIGNATURE):
        frame = decode_jpeg(data, "cv2")
        return None if frame is None else _oriented(frame, exif.jpeg_orientation(data))
    if data.startswith(png.SIGNATURE):
        r = png.decode_png(data)
        if r is None:
            return _refused("PNG that cv2 refuses")
        frame, exif_block = r
        return _oriented(frame, exif.tiff_orientation(exif_block))
    if data.startswith(bmp.SIGNATURE):
        frame = bmp.decode_bmp(data)
        return frame if frame is not None else _refused("BMP that cv2 refuses")
    if tiff.is_tiff(data):
        try:
            frame = tiff.decode_tiff(data, from_file)
        except tiff.NotPorted as e:
            return _refused(f"{e} (cv2 reads it; the port does not decode it yet)")
        return frame if frame is not None else _refused("TIFF that cv2 refuses")
    if jpeg2000.is_jpeg2000(data):
        try:
            frame = jpeg2000.decode_jpeg2000(data)
        except jpeg2000.NotPorted as e:
            return _refused(f"JPEG 2000 with {e} (cv2 reads it; the port does not decode it yet)")
        return frame if frame is not None else _refused("JPEG 2000 that cv2 refuses")
    for name, claims, decode in _DECODERS:
        if claims(data):
            frame = decode(data)
            return frame if frame is not None else _refused(f"{name} that cv2 refuses")
    return _refused("not a JPEG, PNG, BMP, WebP, TIFF, JPEG 2000, Radiance HDR, Sun raster, "
                    "PxM, PAM, PFM or GIF image (cv2 5.0 reads AVIF too, which the port does "
                    "not decode yet; OpenEXR neither reads)")


# cv2's other decoders, each claiming its signature as cv2 checks it
_DECODERS = (
    ("Radiance HDR", lambda d: d.startswith(hdr.SIGNATURES), hdr.decode_hdr),
    ("WebP", webp.is_webp, webp.decode_webp),
    ("Sun raster", lambda d: d.startswith(sunras.SIGNATURE), sunras.decode_sunras),
    ("PBM/PGM/PPM", pxm.is_pxm, pxm.decode_pxm),
    ("PAM", pxm.is_pam, pxm.decode_pam),
    ("PFM", pxm.is_pfm, pxm.decode_pfm),
    ("GIF", lambda d: d.startswith(gif.SIGNATURES), gif.decode_gif),
)


def as_bgr(frame: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """A decoded frame as the analysis takes it: a one-channel one (a gray
    PFM, as cv2 returns it) with its gray in all three channels. JAX's
    entry points analyse cv2's two-dimensional array as it is, along other
    axes, so their verdicts on such a frame are not this one's."""
    return np.repeat(frame[..., None], 3, 2) if frame is not None and frame.ndim == 2 else frame


def decode_frame(data: bytes) -> Optional[np.ndarray]:
    """The single-stream server's ladder: native first for bytes that start
    FF D8, then the cv2 route. None when both refuse, each reason logged
    once."""
    if data[:2] == b"\xff\xd8":
        frame = native_route(data)
        if frame is not None:
            return frame
    return cv2_route(data)
