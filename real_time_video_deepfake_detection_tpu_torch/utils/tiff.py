"""TIFF decode as cv2 5.0's imdecode(..., IMREAD_COLOR) returns it, without
cv2 or libtiff: cv2 reads TIFF through its bundled libtiff 4.7.1, and for
an 8-bit read always through libtiff's RGBA interface (TIFFReadRGBAStrip /
TIFFReadRGBATile, tif_getimage.c), a strip or tile at a time. This follows
that path:

- the container: II and MM byte orders, classic TIFF and BigTIFF, the
  first directory only (imdecode reads page 0), with the tags libtiff reads
  for an image and its defaults (a sample count past the photometric's
  colour channels becomes extra samples; a palette image without a
  colormap becomes gray or RGB at 8 bits);
- cv2's header checks: the photometric tag is required, and the bit depth
  must be 1, 4 (palette only), 8 or 16 for this read (10, 12, 14, 32 and
  64 are refused at the RGBA step, float samples too);
- decompression: none, LZW (new and old-style "compat" codes, chosen by
  the first strip read as libtiff chooses), PackBits (csrc/tiff.cpp),
  Deflate (8 and 32946, through Python's zlib, bounded to the strip's
  size) and JPEG (7: each strip or tile an abbreviated stream completed by
  JPEGTables, decoded by the port's libjpeg decoder, utils/jpeg_ingest,
  YCbCr converted by libjpeg as libtiff's JPEGCOLORMODE_RGB asks, RGB
  kept as its components); fill order 2; the horizontal predictor (8 and
  16 bits); big-endian 16-bit samples swapped. A strip whose data fails
  part-way keeps what was decoded and zeros after it, without the
  predictor or the byte swap, as libtiff leaves its buffer; one whose
  data lies outside the file refuses the image;
- the RGBA conversion (csrc/tiff.cpp tiff_rgba): gray (1, 2, 4, 8, 16
  bits; MinIsWhite inverted; 16 bits keep their high byte), palette (1-8
  bits, the colormap taken as 8-bit unless an entry is 256 or more, as
  checkcmap decides), RGB (16 bits through (v + 128) // 257), CMYK (InkSet
  1), YCbCr (subsampling 1, 2 or 4, libtiff's tables from the file's
  coefficients and ReferenceBlackWhite), unassociated alpha premultiplied,
  contiguous or separate planes, strips or tiles;
- the orientation tag: libtiff flips each strip or tile as setorientation
  says, cv2 lays them out, then turns orientations 5-8 as their EXIF
  meaning says (the result is each orientation's display, apart from the
  per-tile flips of tiled images);
- and BGR out.

Refused as cv2 refuses them (None): float samples, the compressions cv2's
libtiff lacks (LZMA, ZSTD, WebP, LERC, JBIG), 2-bit gray, the photometrics
its RGBA interface lacks (ICCLab, ITULab, LogL / LogLuv outside SGI Log
compression), a damaged directory; a compression scheme libtiff does not
know decodes to zeros, as there. Refused by name although cv2 reads them
(`NotPorted`): CIELab (8 or 16 bits, three samples), the CCITT RLE, fax 3
and fax 4 compressions of bilevel images, ThunderScan, NeXT, PixarLog,
SGI Log and old-style JPEG (6), and JPEG-in-TIFF with separate planes.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
SRC = csrc("tiff.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
MAX_SIDE = 1 << 20       # cv2's CV_IO_MAX_IMAGE_WIDTH / HEIGHT
MAX_PIXELS = 1 << 30     # cv2's CV_IO_MAX_IMAGE_PIXELS
MAX_TILE = 1 << 24       # cv2's TILE_MAX_WIDTH / TILE_MAX_HEIGHT


class NotPorted(ValueError):
    """A TIFF that cv2 decodes with a feature the port does not decode yet."""


class _Refused(Exception):
    """A TIFF that cv2 refuses."""


# libtiff's codecs (tif_codec.c): those the port decodes, those cv2's
# libtiff decodes and the port does not yet, those it has not configured
# (TIFFRGBAImageOK refuses them); any other scheme decodes to zeros
_SUPPORTED_COMPRESSION = (1, 5, 7, 8, 32773, 32946)
_UNPORTED_COMPRESSION = {2: "CCITT RLE", 3: "CCITT fax 3", 4: "CCITT fax 4", 6: "old-style JPEG",
                         32771: "CCITT RLE-word", 32766: "NeXT", 32809: "ThunderScan",
                         32909: "PixarLog", 34676: "SGI LogL", 34677: "SGI LogLuv"}
_UNCONFIGURED_COMPRESSION = (34661, 34925, 50000, 50001, 34887)   # JBIG, LZMA, ZSTD, WebP, LERC
_CCITT = (2, 3, 4, 32771)   # bilevel only: other depths fail the codec's setup

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p


def library() -> ctypes.CDLL:
    """The loaded TIFF helper library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "tiff"))
            lib.tiff_decompress.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_char_p,
                                            ctypes.c_int64, _P, ctypes.c_int64]
            lib.tiff_decompress.restype = ctypes.c_int
            lib.tiff_predictor.argtypes = [_P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int]
            lib.tiff_predictor.restype = None
            lib.tiff_rgba.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]
            lib.tiff_rgba.restype = ctypes.c_int
            _lib = lib
        return _lib


# ------------------------------------------------------------ the directory

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 13: 4,
               16: 8, 17: 8, 18: 8}
_FORMATS = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
            11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
_INT_TYPES = (1, 3, 4, 6, 8, 9, 16, 17)
_FLOAT_TYPES = _INT_TYPES + (5, 10, 11, 12)


class _Dir:
    """The first image file directory as libtiff's TIFFFetchDirectory reads
    it: tag -> (type, count, raw bytes or None when they lie outside the
    file); a later entry of a tag already seen is ignored. The readers
    follow TIFFReadDirEntry*: a wrong type, count or range, or data outside
    the file, is an error, which refuses the image for the tags libtiff
    reads strictly (`strict`) and leaves the field unset for the rest."""

    def __init__(self, data: bytes):
        if len(data) < 8:
            raise _Refused
        self.data = data
        self.e = "<" if data[:2] == b"II" else ">"
        magic = struct.unpack_from(self.e + "H", data, 2)[0]
        self.big = magic == 43
        if self.big:
            if len(data) < 16:
                raise _Refused
            size, zero, off = struct.unpack_from(self.e + "HHQ", data, 4)
            if size != 8 or zero != 0:
                raise _Refused
        else:
            off = struct.unpack_from(self.e + "I", data, 4)[0]
        self.tags: Dict[int, Tuple[int, int, Optional[bytes]]] = {}
        self.entries: List[Tuple[int, int]] = []   # every entry's (type, count)
        self.pointers: Dict[int, int] = {}   # where each entry's value field is
        self.order: Dict[int, int] = {}   # each tag's place in the directory
        head, ent = (8, 20) if self.big else (2, 12)
        if off < 8 or off + head > len(data):
            raise _Refused
        n = struct.unpack_from(self.e + ("Q" if self.big else "H"), data, off)[0]
        if n == 0 or off + head + n * ent > len(data):
            raise _Refused   # "Can not read TIFF directory"
        for i in range(n):
            at = off + head + i * ent
            if self.big:
                tag, typ, count = struct.unpack_from(self.e + "HHQ", data, at)
                inline, vat = 8, at + 12
            else:
                tag, typ, count = struct.unpack_from(self.e + "HHI", data, at)
                inline, vat = 4, at + 8
            self.entries.append((typ, count))
            if tag in self.tags:
                continue
            self.pointers[tag] = vat
            self.order[tag] = i
            size = _TYPE_SIZES.get(typ, 0)
            nbytes = size * count
            if nbytes <= inline:
                raw = data[vat:vat + nbytes]
            else:
                p = struct.unpack_from(self.e + ("Q" if self.big else "I"), data, vat)[0]
                raw = data[p:p + nbytes] if p + nbytes <= len(data) else None
            self.tags[tag] = (typ, count, raw)

    def _values(self, tag: int, types) -> Optional[List]:
        typ, count, raw = self.tags[tag]
        if typ not in types or raw is None:
            return None
        vals = list(struct.unpack(self.e + _FORMATS[typ] * count, raw))
        if typ in (5, 10):
            vals = [vals[i] / vals[i + 1] if vals[i + 1] else 0.0 for i in range(0, len(vals), 2)]
        return vals

    def _fail(self, strict: bool):
        if strict:
            raise _Refused
        return None

    def array(self, tag: int, bits: int = 16, strict: bool = False,
              limit: Optional[int] = None) -> Optional[List[int]]:
        """TIFFReadDirEntryShortArray (bits 16) / Long8Array (64); `limit`:
        Long8ArrayWithLimit, which reads no more than that many values."""
        if tag not in self.tags:
            return None
        if limit is not None and self.tags[tag][1] > limit:
            typ, count, _ = self.tags[tag]
            size = _TYPE_SIZES.get(typ, 0)
            inline = 8 if self.big else 4
            if min(count, 10) * size <= inline:   # TIFFReadDirEntryArrayWithLimit
                at = self.pointers[tag]
            else:
                at = self._pointer(tag)
            raw = self.data[at:at + size * limit]
            if typ not in _INT_TYPES or len(raw) < size * limit:
                return self._fail(strict)
            vals = list(struct.unpack(self.e + _FORMATS[typ] * limit, raw))
            if any(v < 0 or v >= 1 << bits for v in vals):
                return self._fail(strict)
            return [int(v) for v in vals]
        vals = self._values(tag, _INT_TYPES)
        if vals is None or any(v < 0 or v >= 1 << bits for v in vals):
            return self._fail(strict)
        return [int(v) for v in vals]

    def _pointer(self, tag: int) -> int:
        return struct.unpack_from(self.e + ("Q" if self.big else "I"), self.data,
                                  self.pointers[tag])[0]

    def scalar(self, tag: int, bits: int = 16, strict: bool = False) -> Optional[int]:
        """TIFFReadDirEntryShort / Long: one value."""
        if tag not in self.tags:
            return None
        if self.tags[tag][1] != 1:
            return self._fail(strict)
        v = self.array(tag, bits, strict)
        return None if v is None else v[0]

    def per_sample(self, tag: int, spp: int) -> Optional[int]:
        """TIFFReadDirEntryShort, or PersampleShort when the count is not
        one: at least spp values, the first spp equal. Strict."""
        if tag not in self.tags:
            return None
        typ, count, _ = self.tags[tag]
        if count == 1:
            return self.scalar(tag, 16, True)
        if count < spp:
            raise _Refused
        vals = self.array(tag, 16, True)
        if len(set(vals[:spp])) > 1:
            raise _Refused
        return vals[0]

    def floats(self, tag: int, count: int) -> Optional[List[float]]:
        """TIFFReadDirEntryFloatArray of exactly `count` values, or None."""
        if tag not in self.tags or self.tags[tag][1] != count:
            return None
        vals = self._values(tag, _FLOAT_TYPES)
        return None if vals is None else [float(v) for v in vals]

    def raw(self, tag: int) -> Optional[bytes]:
        t = self.tags.get(tag)
        return None if t is None or t[0] not in (1, 7) else t[2]


def is_tiff(data: bytes) -> bool:
    """cv2's TiffDecoder signature check."""
    return data[:4] in SIGNATURES


# -------------------------------------------------------------- the decode

def decode_tiff(data: bytes, from_file: bool = False) -> Optional[np.ndarray]:
    """TIFF bytes -> (H, W, 3) u8 BGR of the first page, or None where cv2
    refuses the file; raises NotPorted for what cv2 reads and the port
    does not. `from_file`: as cv2.imread reads the bytes from a file, which
    libtiff maps (an uncompressed tile's byte count then need only match
    its size), and whose orientations 5-8 it refuses (the turned image no
    longer fits the buffer imread allocated); else as cv2.imdecode reads
    them from memory."""
    if not is_tiff(data):
        return None
    try:
        return _Image(data, from_file).decode()
    except _Refused:
        return None
    except (struct.error, IndexError, ValueError, ZeroDivisionError, OverflowError) as e:
        if isinstance(e, NotPorted):
            raise
        return None


# put routines of csrc/tiff.cpp (enum Put)
_PUT = {name: i + 1 for i, name in enumerate(
    ("gray1", "gray2", "gray4", "gray8", "grayalpha8", "gray16", "pal1", "pal2", "pal4", "pal8",
     "rgb8", "rgbassoc8", "rgbunassoc8", "rgb16", "rgbassoc16", "rgbunassoc16", "cmyk8",
     "ycc11", "ycc12", "ycc21", "ycc22", "ycc41", "ycc42", "ycc44", "seprgb8", "seprgbassoc8",
     "seprgbunassoc8", "seprgb16", "seprgbassoc16", "seprgbunassoc16", "sepcmyk8", "sepycc11"))}


class _Image:
    def __init__(self, data: bytes, mapped: bool = False):
        """The fields as TIFFReadDirectory sets them: SamplesPerPixel and
        Compression first, then the size, tiling, planar configuration,
        rows per strip and extra samples strictly (an error refuses the
        file), BitsPerSample and SampleFormat per sample, the strip arrays,
        the colormap (ignored unless it has 3 << bps entries), the rest
        leniently (a bad entry or value leaves the default)."""
        d = self.d = _Dir(data)
        self.data = data
        self.mapped = mapped
        self.spp = d.scalar(277, 16, True)
        if self.spp == 0:
            raise _Refused
        self.spp = self.spp or 1
        self.comp = d.per_sample(259, self.spp) or 1
        w, h = d.scalar(256, 32, True), d.scalar(257, 32, True)
        if w is None or h is None or w == 0 or h == 0:
            raise _Refused
        self.w, self.h = w, h
        tw, th = d.scalar(322, 32, True), d.scalar(323, 32, True)
        self.planar = d.scalar(284, 16, True) or 1
        if self.planar not in (1, 2):
            raise _Refused
        rps = d.scalar(278, 32, True)
        if rps == 0:
            raise _Refused
        self.rps = 0xFFFFFFFF if rps is None else rps
        extra = d.array(338, 16, True) or []
        if len(extra) > self.spp or any(v > 2 and v != 999 for v in extra):
            raise _Refused
        self.sampleinfo = [2 if v == 999 else v for v in extra]
        self.extras = len(extra)
        self.tiled = tw is not None or th is not None
        self.tw, self.th = tw or 0, th or 0
        bps = d.per_sample(258, self.spp)
        self.bps = 1 if bps is None else bps
        self.fmt = d.per_sample(339, self.spp) or 1
        if not 1 <= self.fmt <= 6:
            raise _Refused
        photo = d.scalar(262)
        if photo is None:
            raise _Refused   # cv2 requires the photometric tag
        fill = d.scalar(266)
        self.fillorder = fill if fill in (1, 2) else 1
        orient = d.scalar(274)
        self.orientation = orient if orient is not None and 1 <= orient <= 8 else 1
        self.predictor = d.scalar(317) or 1 if self.comp in (5, 8, 32946) else 1
        cmap = d.array(320) if self.bps <= 24 and 320 in d.tags and \
            d.tags[320][1] == 3 << self.bps else None
        self.colormap = cmap
        # a palette image without a colormap is gray or RGB (TIFFReadDirectory)
        if photo == 3 and cmap is None:
            if self.bps >= 8 and self.spp == 3:
                photo = 2
            elif self.bps >= 8:
                photo = 1
            else:
                raise _Refused
        self.photo = photo
        # non-colour samples become extra samples (unspecified)
        colors = {0: 1, 1: 1, 3: 1, 2: 3, 6: 3, 8: 3, 9: 3, 10: 3, 5: 4}.get(photo, 0)
        if colors and self.spp - self.extras > colors:
            self.extras = self.spp - colors
            self.sampleinfo = (self.sampleinfo + [0] * self.extras)[:self.extras]

    # ------------------------------------------------------------ checks

    def _header_checks(self):
        """cv2's readHeader and readData checks, then TIFFRGBAImageOK."""
        bps, photo = self.bps, self.photo
        if not (self.w <= MAX_SIDE and self.h <= MAX_SIDE and self.w * self.h <= MAX_PIXELS):
            raise _Refused
        if bps == 4 and photo != 3:
            raise _Refused   # "bitsperpixel value is 4 should be palette"
        if bps not in (1, 4, 8, 10, 12, 14, 16, 32, 64):
            raise _Refused
        if bps in (1, 4, 16) and self.fmt not in (1, 2):
            raise _Refused
        if self.spp > 4:
            raise _Refused   # cv2's CV_CheckLE(ncn, 4)
        if self.comp in _UNPORTED_COMPRESSION and (self.comp not in _CCITT or bps == 1):
            raise NotPorted(f"TIFF with {_UNPORTED_COMPRESSION[self.comp]} compression")
        if self.comp in _UNCONFIGURED_COMPRESSION:
            raise _Refused   # "requested compression method is not configured"
        if self.comp == 7 and self.planar == 2 and self.spp > 1:
            raise NotPorted("JPEG-compressed TIFF with separate planes")
        if self.predictor not in (1, 2) or (self.predictor == 2 and bps not in (8, 16, 32, 64)):
            raise _Refused   # PredictorSetup fails at the first strip
        if bps not in (1, 2, 4, 8, 16) or self.fmt == 3:
            raise _Refused
        if photo == 8 and self.spp == 3 and self.extras == 0 and bps in (8, 16):
            raise NotPorted("TIFF with CIELab photometric")
        if photo in (0, 1, 3):
            if self.planar == 1 and self.spp != 1 and bps < 8:
                raise _Refused
        elif photo == 2:
            if self.spp - self.extras < 3:
                raise _Refused
        elif photo == 5:
            if (self.d.scalar(332) or 1) != 1 or self.spp < 4:
                raise _Refused
        elif photo != 6:
            raise _Refused

    def _pick(self) -> Tuple[str, bool]:
        """(put routine, separate) as PickContigCase / PickSeparateCase."""
        bps, spp, photo = self.bps, self.spp, self.photo
        alpha = 0
        if self.extras >= 1:
            s = self.sampleinfo[0]
            if s == 0:
                alpha = 1 if spp > 3 else 0   # taken as associated
            elif s in (1, 2):
                alpha = s
        self.alpha = alpha
        if self.extras == 0 and spp == 4 and photo == 2:
            self.alpha = alpha = 1
        if photo == 6 and self.comp == 7 and self.planar == 1:
            photo = 2   # JPEGCOLORMODE_RGB: libjpeg converts
        self.rgba_photo = photo
        separate = self.planar == 2 and spp > 1
        put = None
        if not separate:
            if photo == 2:
                if bps == 8:
                    put = ("rgbassoc8" if alpha == 1 and spp >= 4 else
                           "rgbunassoc8" if alpha == 2 and spp >= 4 else
                           "rgb8" if spp >= 3 else None)
                elif bps == 16:
                    put = ("rgbassoc16" if alpha == 1 and spp >= 4 else
                           "rgbunassoc16" if alpha == 2 and spp >= 4 else
                           "rgb16" if spp >= 3 else None)
            elif photo == 5:
                put = "cmyk8" if spp >= 4 and bps == 8 else None
            elif photo == 3:
                put = {8: "pal8", 4: "pal4", 2: "pal2", 1: "pal1"}.get(bps)
            elif photo in (0, 1):
                put = {16: "gray16", 4: "gray4", 2: "gray2", 1: "gray1"}.get(bps)
                if bps == 8:
                    put = "grayalpha8" if alpha and spp == 2 else "gray8"
            elif photo == 6 and bps == 8 and spp == 3:
                hs, vs = self._subsampling()
                put = {(4, 4): "ycc44", (4, 2): "ycc42", (4, 1): "ycc41", (2, 2): "ycc22",
                       (2, 1): "ycc21", (1, 2): "ycc12", (1, 1): "ycc11"}.get((hs, vs))
        else:
            if photo in (0, 1, 2):
                if bps == 8:
                    put = ("seprgbassoc8" if alpha == 1 else "seprgbunassoc8" if alpha == 2
                           else "seprgb8")
                elif bps == 16:
                    put = ("seprgbassoc16" if alpha == 1 else "seprgbunassoc16" if alpha == 2
                           else "seprgb16")
            elif photo == 5:
                if bps == 8 and spp == 4:
                    put = "sepcmyk8"
                    self.alpha = 1   # the K plane is read where alpha would be
            elif photo == 6 and bps == 8 and spp == 3 and self._subsampling() == (1, 1):
                put = "sepycc11"
        if put is None:
            raise _Refused   # "Sorry, can not handle image"
        if "ycc" in put:
            self._ycbcr_tables()
        return put, separate

    def _subsampling(self) -> Tuple[int, int]:
        ss = self.d.array(530) if 530 in self.d.tags and self.d.tags[530][1] == 2 else None
        return (ss[0], ss[1]) if ss else (2, 2)

    def _ycbcr_tables(self):
        luma = self.d.floats(529, 3) or [0.299, 0.587, 0.114]
        if any(np.isnan(luma)) or luma[1] == 0:
            raise _Refused
        rbw = self.d.floats(532, 6) or [0.0, 255.0, 128.0, 255.0, 128.0, 255.0]
        lo, hi = np.float32(-0x7FFFFFFF + 128), np.float32(0x7FFFFFFF)
        if not all(lo < np.float32(f) < hi for f in rbw):
            raise _Refused
        self.luma = np.array(luma, np.float32)
        self.rbw = np.array(rbw, np.float32)

    # ------------------------------------------------------- strip layout

    def _layout(self):
        d = self.d
        w, h, spp, bps = self.w, self.h, self.spp, self.bps
        planes = spp if self.planar == 2 else 1
        if self.tiled:
            tw, th = self.tw, self.th
            if not tw or not th:
                raise _Refused
            across, down = -(-w // tw), -(-h // th)
            n = across * down * planes
        else:
            rps = self.rps
            per = -(-h // rps) if rps < h else 1
            n = per * planes

        def last(a, b):   # strip and tile arrays fill the same field: the later entry wins
            present = [t for t in (a, b) if t in d.tags]
            return max(present, key=d.order.get) if present else a
        offs = d.array(last(273, 324), 64, True, n)
        counts = d.array(last(279, 325), 64, True, n)
        if offs is None:
            raise _Refused   # missing StripOffsets
        offs = (offs + [0] * n)[:n]
        if counts is None:   # missing StripByteCounts
            if (self.planar == 1 and n > 1) or (self.planar == 2 and n != self.spp):
                raise _Refused
            counts = self._estimate_counts(n, offs)
        counts = (counts + [0] * n)[:n]
        if not self.tiled and n == 1 and self.comp == 1 and counts and (
                (counts[0] == 0 and offs[0] != 0)
                or (offs[0] <= len(self.data) and counts[0] > len(self.data) - offs[0])
                or counts[0] < self._scanline() * h):
            counts = self._estimate_counts(n, offs)   # "Bogus StripByteCounts"
        elif (not self.tiled and self.planar == 1 and n > 2 and self.comp == 1
              and counts[0] != counts[1] and counts[0] != 0 and counts[1] != 0):
            counts = self._estimate_counts(n, offs)   # "Wrong StripByteCounts"
        self.offs, self.counts, self.nplanes = offs, counts, planes

    def _estimate_counts(self, n: int, offs: List[int]) -> List[int]:
        """EstimateStripByteCounts: compressed strips each get the file's
        size less the header, the directory and its out-of-line values
        (divided among the planes), the last cut at the file's end;
        uncompressed ones their rows' size."""
        if self.comp != 1:
            d = self.d
            n_ent = len(d.entries)
            space = (16 + 8 + n_ent * 20 + 8) if d.big else (8 + 2 + n_ent * 12 + 4)
            for typ, count in d.entries:
                width = _TYPE_SIZES.get(typ, 0)
                if width == 0:
                    raise _Refused   # "Cannot determine size of unknown tag type"
                size = width * count
                space += size if size > (8 if d.big else 4) else 0
            size = len(self.data)
            space = size if size < space else size - space
            if self.planar == 2:
                space //= self.spp
            counts = [space] * n
            last = offs[n - 1]
            counts[-1] = 0 if last >= size else min(space, size - last)
            return counts
        if self.tiled:
            return [self._tile_size()] * n
        per = n // (self.spp if self.planar == 2 else 1)
        return [self._scanline() * (self.h // per)] * n

    def _scanline(self) -> int:
        """TIFFScanlineSize: bytes of one row of a strip (of one plane when
        separate; of a row of YCbCr sampling blocks over its height)."""
        w, spp, bps = self.w, self.spp, self.bps
        if self.planar == 2:
            return -(-w * bps // 8)
        if self.photo == 6 and spp == 3 and self.comp != 7:
            hs, vs = self._subsampling()
            if hs not in (1, 2, 4) or vs not in (1, 2, 4):
                raise _Refused
            blocks = -(-w // hs)
            return (-(-(blocks * (hs * vs + 2)) * bps // 8)) // vs
        return -(-w * spp * bps // 8)

    def _tile_row(self) -> int:
        if self.planar == 2:
            return -(-self.tw * self.bps // 8)
        if self.photo == 6 and self.spp == 3 and self.comp != 7:
            hs, vs = self._subsampling()
            return (-(-(-(-self.tw // hs) * (hs * vs + 2)) * self.bps // 8)) // vs
        return -(-self.tw * self.spp * self.bps // 8)

    def _tile_size(self) -> int:
        if self._packed_ycbcr():
            hs, vs = self._subsampling()
            row = -(-(-(-self.tw // hs) * (hs * vs + 2)) * self.bps // 8)
            return row * -(-self.th // vs)
        return self._tile_row() * self.th

    def _strip_size(self, rows: int) -> int:
        """TIFFVStripSize of `rows` rows."""
        if self._packed_ycbcr():
            hs, vs = self._subsampling()
            row = -(-(-(-self.w // hs) * (hs * vs + 2)) * self.bps // 8)
            return row * -(-rows // vs)
        return self._scanline() * rows

    # ------------------------------------------------------------ decoding

    def _raw(self, i: int) -> bytes:
        """TIFFFillStrip: the strip's bytes; raises _Refused where they lie
        outside the file (libtiff's read error ends cv2's read)."""
        off, count = self.offs[i], self.counts[i]
        if count == 0 or off + count > len(self.data):
            raise _Refused
        if self.mapped and self.fillorder == 1:   # the raw data is the mapped file's
            self.rawdatasize = count
        else:   # libtiff's raw buffer grows to the largest read, in KiB
            self.rawdatasize = max(self.rawdatasize, -(-count // 1024) * 1024)
        if self.tiled and self.comp == 1 and self.rawdatasize != self._tile_size():
            raise _Refused   # "Invalid tile byte count"
        raw = self.data[off:off + count]
        if self.fillorder == 2:
            raw = bytes(_REVERSED[np.frombuffer(raw, np.uint8)])
        return raw

    def _packed_ycbcr(self) -> bool:
        return self.photo == 6 and self.spp == 3 and self.planar == 1 and self.comp != 7

    def _decode_into(self, i: int, buf: np.ndarray, occ: int, rowsize: int) -> bool:
        """Decode strip/tile i into buf[:occ] (zeroed); the predictor and
        the byte swap after a clean decode. Returns whether it decoded."""
        raw = self._raw(i)
        if self.comp == 1:
            if len(raw) < occ:
                return False
            buf[:occ] = np.frombuffer(raw, np.uint8, occ)
            ok = True
        elif self.comp in (5, 32773):
            if self.comp == 5 and self.lzw_compat is None:
                self.lzw_compat = len(raw) >= 2 and raw[0] == 0 and raw[1] & 1
            ok = bool(library().tiff_decompress(self.comp, int(bool(self.lzw_compat)), raw,
                                                len(raw), buf.ctypes.data, occ))
        elif self.comp in (8, 32946):
            ok = _inflate(raw, buf, occ)
        elif self.comp == 7:
            return self._jpeg_into(i, raw, buf, occ, rowsize)
        else:
            return False   # a scheme libtiff does not know: its decoder fails, zeros stay
        if not ok:
            return False
        swap = self.bps == 16 and self.e == ">"
        if self.predictor == 2:   # PredictorDecodeTile (32- and 64-bit samples refused before)
            if occ % rowsize:
                return False   # "occ0%rowsize != 0": no predictor, no swap
            stride = 1 if self.planar == 2 else self.spp
            if (rowsize // (self.bps // 8)) % stride:   # horAcc: "(cc%stride)!=0" on row 0
                if swap:   # swabHorAcc16 swapped that row first
                    buf[:rowsize].view(np.uint16).byteswap(inplace=True)
                return False
            if swap:   # swabHorAcc16 swaps each row, then adds
                buf[:occ].view(np.uint16).byteswap(inplace=True)
            library().tiff_predictor(buf.ctypes.data, occ // rowsize, rowsize, self.bps, stride)
        elif swap:   # the codec's post-decode swap
            buf[:occ - occ % 2].view(np.uint16).byteswap(inplace=True)
        return True

    def _jpeg_into(self, i: int, raw: bytes, buf: np.ndarray, occ: int, rowsize: int) -> bool:
        """JPEGPreDecode and JPEGDecode of strip or tile i: its abbreviated
        stream after JPEGTables, through libjpeg's default decode, YCbCr
        converted to RGB (JPEGCOLORMODE_RGB), other colour spaces kept as
        their components (libtiff's JCS_UNKNOWN). An error in the header,
        the wrong component count, sampling or precision, or a stream larger
        than its strip refuses the image; a narrower or shorter stream
        fills the start of each row and leaves the rest zero. A baseline
        scan cut by a marker decodes as libjpeg pads it: the error libjpeg
        raises at the marker comes after the last row, which libtiff keeps."""
        from .jpeg_ingest import JpegError, decode_coefs, reconstruct
        if raw[:2] != b"\xff\xd8":
            raise _Refused   # "Not a JPEG file"
        t = self.d.raw(347)
        stream = raw if t is None else b"\xff\xd8" + _table_segments(t) + raw[2:]
        jc = _jpeg_coefs(stream, decode_coefs, JpegError)
        n = len(jc.factors)
        if n != self.spp or self.bps != 8 or n not in (1, 3, 4):
            raise _Refused   # "Improper JPEG component count" / data precision
        hs, vs = self._subsampling() if self.photo == 6 else (1, 1)
        if jc.factors[0] != (hs, vs) or any(f != (1, 1) for f in jc.factors[1:]):
            raise _Refused   # "Improper JPEG sampling factors"
        if self.tiled:
            seg_w, seg_h, last = self.tw, self.th, False
        else:
            rps = min(self.rps, self.h)
            first_row = (i % (len(self.offs) // self.nplanes)) * rps
            seg_w, seg_h = self.w, min(rps, self.h - first_row)
            last = first_row + seg_h == self.h
        height = jc.height
        if jc.width == seg_w and height > seg_h and last:
            height = seg_h
        elif jc.width > seg_w or height > seg_h:
            raise _Refused   # "JPEG strip/tile size exceeds expected dimensions"
        if self.photo == 6:
            jc.color = "ycbcr"
            pix = reconstruct([jc], "cpu")[0].numpy()[..., ::-1]
        else:
            pix = _jpeg_components(jc)
        rows = min(occ // rowsize, height)
        line = jc.width * n
        for r in range(rows):
            buf[r * rowsize:r * rowsize + line] = pix[r].reshape(-1)
        return True

    @property
    def e(self):
        return self.d.e

    def decode(self) -> np.ndarray:
        self._header_checks()
        put, separate = self._pick()
        self._layout()
        self.lzw_compat = None
        self.rawdatasize = 0
        self.put, self.separate = put, separate
        cmap = np.zeros(3 << min(self.bps, 8), np.uint16)
        if self.photo == 3:
            cmap[:] = np.array(self.colormap, np.int64).astype(np.uint16)
        self.cmap = cmap
        if not hasattr(self, "luma"):
            self.luma = np.zeros(3, np.float32)
            self.rbw = np.zeros(6, np.float32)
        out = np.zeros((self.h, self.w, 3), np.uint8)
        o = self.orientation
        flip = {1: 1, 2: 3, 3: 2, 4: 0, 5: 1, 6: 3, 7: 2, 8: 0}[o]
        vert = o in (3, 4, 7, 8)
        if self.tiled:
            th0, tw0 = self.th, self.tw
        else:
            th0 = self.rps if self.rps < 0xFFFFFFFF else self.h
            tw0 = self.w
        if not (0 < tw0 <= MAX_TILE and 0 < th0 <= MAX_TILE) or \
                tw0 * th0 * self.spp * max(1, self.bps // 8) >= 1 << 30:
            raise _Refused   # cv2's asserts on the strip or tile size
        for y in range(0, self.h, th0):
            rows = min(th0, self.h - y)
            img_y = self.h - y - rows if vert else y
            for x in range(0, self.w, tw0):
                cols = min(tw0, self.w - x)
                if self.tiled:
                    raster = self._read_tile(x, y, cols, rows, flip)
                    start = (th0 - rows) * tw0
                    block = raster.reshape(-1)[start:start + rows * tw0].reshape(rows, tw0)
                else:
                    raster = self._read_strip(y, rows, flip)
                    block = raster.reshape(rows, self.w)
                rgba = block[:, :cols].view(np.uint8).reshape(rows, cols, 4)
                out[img_y:img_y + rows, x:x + cols] = rgba[::-1, :, 2::-1]
        if self.mapped and o >= 5:
            raise _Refused   # cv2.imread: the turned image is not in imread's buffer
        return _oriented(out, o)

    def _read_strip(self, y: int, rows: int, flip: int) -> np.ndarray:
        """TIFFReadRGBAStrip at row y: the raster of `rows` image rows. The
        strip decodes as far as gtStripContig asks: its rows rounded up to
        the vertical subsampling, in scanlines, within the strip's size."""
        rps = min(self.rps, self.h)
        strip = y // rps
        per = len(self.offs) // self.nplanes
        rows_sub = rows
        if self._packed_ycbcr():
            rows_sub += (-rows) % self._subsampling()[1]
        scanline = self._scanline()
        occ = min(self._strip_size(min(rps, self.h - strip * rps)), rows_sub * scanline)
        return self._rgba([strip + p * per for p in range(self.nplanes)], self._strip_size(rps),
                          occ, scanline, self.w, rows, 0, flip)

    def _read_tile(self, x: int, y: int, cols: int, rows: int, flip: int) -> np.ndarray:
        """TIFFReadRGBATile at (x, y): a full tile raster, the read region
        bottom-aligned and the rest zero."""
        tw, th = self.tw, self.th
        across, down = -(-self.w // tw), -(-self.h // th)
        t = (y // th) * across + x // tw
        size = self._tile_size()
        rowsize = self._tile_row()
        region = self._rgba([t + p * across * down for p in range(self.nplanes)], size, size,
                            rowsize, cols, rows, tw - cols, flip)
        raster = np.zeros((th, tw), np.uint32)
        raster[th - rows:, :cols] = region.reshape(rows, cols)
        return raster

    def _rgba(self, strips: List[int], size: int, occ: int, rowsize: int, w: int, h: int,
              fromskew: int, flip: int) -> np.ndarray:
        """Decode the strips/tiles of one region (one per plane) and run
        the put routine over them."""
        sep = self.separate
        bufs = []
        if sep:
            color = 1 if self.photo in (0, 1, 3) else 3
            order = [0] * 3 if color == 1 else [0, 1, 2]
            if self.alpha:
                order.append(color)
            decoded = {}
            for k, p in enumerate(sorted(set(order))):
                buf = np.zeros(size + 8, np.uint8)
                if p >= len(strips):
                    decoded[p] = buf
                    continue
                try:
                    self._decode_into(strips[p], buf, occ, rowsize)
                except _Refused:
                    if k == 0:
                        raise   # the first plane's read error ends the read
                decoded[p] = buf
            bufs = [decoded[p] for p in order] + [decoded[order[0]]] * (4 - len(order))
        else:
            buf = np.zeros(size + 8, np.uint8)
            self._decode_into(strips[0], buf, occ, rowsize)
            bufs = [buf] * 4
        ptrs = (_P * 4)(*[b.ctypes.data for b in bufs])
        lens = np.array([size] * 4, np.int64)
        hs, vs = self._subsampling() if self.rgba_photo == 6 else (1, 1)
        params = np.array([_PUT[self.put], self.bps, self.spp,
                           self.photo if self.photo in (0, 1, 3) else 2, flip, fromskew,
                           int(sep), hs, vs], np.int32)
        raster = np.zeros(w * h, np.uint32)
        library().tiff_rgba(params.ctypes.data, ctypes.addressof(ptrs), lens.ctypes.data,
                            self.cmap.ctypes.data, self.luma.ctypes.data, self.rbw.ctypes.data,
                            w, h, raster.ctypes.data)
        return raster


_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _inflate(raw: bytes, buf: np.ndarray, occ: int) -> bool:
    """ZIPDecode: inflate into buf[:occ]; False where zlib fails or the
    stream ends short (what inflated before stays)."""
    d = zlib.decompressobj()
    try:
        out = d.decompress(raw, occ)
    except zlib.error:
        # keep what inflates from the longest prefix that decodes cleanly
        lo, hi = 0, len(raw)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            try:
                zlib.decompressobj().decompress(raw[:mid], occ)
                lo = mid
            except zlib.error:
                hi = mid - 1
        out = zlib.decompressobj().decompress(raw[:lo], occ)
        buf[:len(out)] = np.frombuffer(out, np.uint8)
        return False
    buf[:len(out)] = np.frombuffer(out, np.uint8)
    return len(out) == occ


def _table_segments(t: bytes) -> bytes:
    """The marker segments of a JPEGTables stream as libjpeg's tables-only
    header read takes them (JPEGSetupDecode), up to its EOI. Past the end of
    the data libtiff's source feeds a fake EOI, FF D9, over and over: a
    Huffman or quantisation table cut short reads on into those bytes (and
    is kept, or fails libjpeg's checks), any other segment cut short ends
    the read. A stream that does not open with SOI, or that reaches a
    frame, a scan or an unknown marker, is "Bogus JPEGTables" and refuses
    the image."""
    if t[:2] != b"\xff\xd8":
        raise _Refused
    pos, out = 2, []
    while pos < len(t):
        while pos < len(t) and t[pos] != 0xFF:   # extraneous bytes before a marker
            pos += 1
        while pos < len(t) and t[pos] == 0xFF:
            pos += 1
        if pos >= len(t):
            break
        marker = t[pos]
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:   # parameterless: skipped
            pos += 1
            continue
        if marker not in (0xC4, 0xCC, 0xDB, 0xDC, 0xDD, 0xFE) and not 0xE0 <= marker <= 0xEF:
            raise _Refused   # a frame, a scan, SOI or an unknown marker
        fed = t + b"\xff\xd9" * (1 + (pos + 3) // 2)
        length = struct.unpack_from(">H", fed, pos + 1)[0]
        cut = pos + 1 + length > len(t)
        if cut and marker not in (0xC4, 0xDB):
            break
        if cut:
            fed = t + b"\xff\xd9" * (1 + (pos + 1 + length) // 2)
        segment = fed[pos:pos + 1 + length]
        if marker == 0xC4:
            _check_dht(segment[3:])
        out.append(b"\xff" + segment)
        if cut:
            break
        pos += 1 + length
    return b"".join(out)


def _check_dht(body: bytes):
    """libjpeg's get_dht checks: each table's index, its count at most 256
    and within the segment, no bytes left over."""
    at, left = 0, len(body)
    while left > 16:
        index = body[at]
        count = sum(body[at + 1:at + 17])
        left -= 17
        if count > 256 or count > left:
            raise _Refused   # "Bogus Huffman table definition"
        if (index & ~0x10) >= 4:
            raise _Refused
        at += 17 + count
        left -= count
    if left != 0:
        raise _Refused


def _jpeg_coefs(stream: bytes, decode_coefs, JpegError):
    """The stream's coefficients as libjpeg reads them under libtiff, a
    baseline scan that a marker cuts short decoded up to it (libjpeg pads
    the rest and fails only at the marker, after the rows libtiff keeps);
    any other error refuses the image (libjpeg fails in JPEGPreDecode)."""
    try:
        return decode_coefs(stream, "tiff")
    except JpegError:
        pass
    cut = _marker_in_scan(stream)
    if cut is not None:
        try:
            return decode_coefs(stream[:cut] + b"\xff\xd9", "tiff")
        except JpegError:
            pass
    raise _Refused


def _marker_in_scan(stream: bytes) -> Optional[int]:
    """Where the first scan of a one-scan baseline stream meets a marker
    other than a restart or its EOI, or None."""
    pos, sof = 2, None
    while pos + 4 <= len(stream):
        if stream[pos] != 0xFF:
            return None
        marker = stream[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = struct.unpack_from(">H", stream, pos + 2)[0]
        if marker in (0xC0, 0xC1):
            sof = marker
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return None   # progressive and the rest: read whole in jpeg_start_decompress
        if marker == 0xDA:
            if sof is None:
                return None
            at = pos + 2 + length
            while at + 1 < len(stream):
                if stream[at] == 0xFF and stream[at + 1] not in (0x00, 0xFF) and not (
                        0xD0 <= stream[at + 1] <= 0xD7):
                    return None if stream[at + 1] == 0xD9 else at
                at += 1
            return None
        pos += 2 + length
    return None


def _jpeg_components(jc) -> np.ndarray:
    """A frame's components at full size as libjpeg outputs them without a
    colour conversion: (H, W, n) u8 (every component 1x1 sampled)."""
    import torch
    from ..ops.jpeg_decode import samples_islow_simd
    planes = []
    for c, coef in enumerate(jc.coefs):
        bh, bw, _ = coef.shape
        s = samples_islow_simd(torch.from_numpy(coef.reshape(1, bh * bw, 64)),
                               torch.from_numpy(jc.qtabs[c:c + 1].astype(np.int32)))
        plane = s.reshape(bh, bw, 8, 8).transpose(1, 2).reshape(bh * 8, bw * 8)
        planes.append(plane[:jc.height, :jc.width].numpy().astype(np.uint8))
    return np.stack(planes, -1)


def _oriented(frame: np.ndarray, orientation: int) -> np.ndarray:
    """cv2's turn of orientations 5-8 after libtiff's flips of 1-4."""
    if orientation in (5, 7):
        return np.ascontiguousarray(frame.transpose(1, 0, 2))
    if orientation in (6, 8):
        return np.ascontiguousarray(frame[::-1, ::-1].transpose(1, 0, 2))
    return frame
