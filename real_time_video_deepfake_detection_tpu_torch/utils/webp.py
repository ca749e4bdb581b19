"""WebP decode as cv2 5.0's imdecode(..., IMREAD_COLOR) returns it, without
cv2 or libwebp: cv2 5.0's WebP decoder reads the features of the first 32 bytes
(WebPGetFeatures), then decodes a still image with WebPDecodeBGRInto
(WebPDecodeBGRAInto when the header announces alpha, the alpha then
dropped) and an animation with libwebp's WebPAnimDecoder, whose demuxer
checks the whole RIFF container, as its first frame (BGRA, alpha
dropped). This follows it:

- the container: RIFF size and padding rules, the simple `VP8 ` and
  `VP8L` forms and a raw bitstream without RIFF, `VP8X` with `ALPH`,
  `ICCP`, `EXIF`, `XMP ` and unknown chunks (skipped) and `ANIM` /
  `ANMF`, with the checks of WebPGetFeatures / WebPParseHeaders (ParseRIFF,
  ParseVP8X, ParseOptionalChunks, whose last `ALPH` before the image is
  the one decoded, ParseVP8Header, VP8GetInfo, VP8LGetInfo) and, for an
  animation, of WebPDemux (ParseVP8X, ParseAnimationFrame, StoreFrame,
  IsValidExtendedFormat);
- VP8L (csrc/webp_lossless.cpp) and VP8 key frames with libwebp's fancy
  upsampling and 14-bit YUV to BGR (csrc/vp8.cpp), each reading from its
  chunk to the end of the buffer as libwebp's decoders do;
- an ALPH chunk beside a VP8 frame is decoded (raw, or VP8L without its
  header) only for its status: libwebp decodes it whatever the output
  mode, and a damaged one fails the read, while its values never reach
  the BGR cv2 returns;
- an animation's first frame is its key frame: a zeroed canvas with the
  frame's pixels at the frame's offset (no blend, no background colour).

A file cv2 refuses gives None.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

HEADER_SIZE = 32   # cv2's WEBP_HEADER_SIZE: WebPGetFeatures sees these bytes first
SRC_LOSSY = csrc("vp8.cpp")
SRC_LOSSLESS = csrc("webp_lossless.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
MAX_SIDE = 1 << 20      # cv2's CV_IO_MAX_IMAGE_WIDTH / HEIGHT
MAX_PIXELS = 1 << 30    # cv2's CV_IO_MAX_IMAGE_PIXELS
ALPHA_FLAG, ANIMATION_FLAG = 0x10, 0x02
ALL_VALID_FLAGS = 0x3E   # alpha, animation, EXIF, ICCP, XMP

_lock = threading.Lock()
_libs: dict = {}
_P = ctypes.c_void_p


def _lib(which: str) -> ctypes.CDLL:
    with _lock:
        if which not in _libs:
            if which == "vp8":
                lib = ctypes.CDLL(build_host_library(SRC_LOSSY, CXX_FLAGS, "vp8"))
                lib.vp8_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, _P]
                lib.vp8_decode.restype = ctypes.c_int
            else:
                lib = ctypes.CDLL(build_host_library(SRC_LOSSLESS, CXX_FLAGS, "webp_lossless"))
                lib.vp8l_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int, _P]
                lib.vp8l_decode.restype = ctypes.c_int
            _libs[which] = lib
        return _libs[which]


def _le32(b: bytes, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _le24(b: bytes, at: int) -> int:
    return b[at] | (b[at + 1] << 8) | (b[at + 2] << 16)


# ------------------------------------------------- WebPGetFeatures and co.

OK, NOT_ENOUGH_DATA, BITSTREAM_ERROR = 0, 7, 3   # VP8StatusCode


class _Headers:
    """What ParseHeadersInternal reads: status, width, height, has_alpha,
    has_animation, and with all the data the offset of the VP8 / VP8L
    payload, its size, whether it is VP8L, and the ALPH payload."""

    def __init__(self):
        self.status = OK
        self.width = self.height = 0
        self.has_alpha = self.has_animation = False
        self.offset = 0
        self.compressed_size = 0
        self.lossless = False
        self.alpha: Optional[Tuple[int, int]] = None   # (offset, size)


def _vp8_info(d: bytes, at: int, size: int, chunk_size: int):
    """VP8GetInfo: (width, height) or None."""
    if size < 10 or d[at + 3:at + 6] != b"\x9d\x01\x2a":
        return None
    bits = d[at] | (d[at + 1] << 8) | (d[at + 2] << 16)
    w = ((d[at + 7] << 8) | d[at + 6]) & 0x3fff
    h = ((d[at + 9] << 8) | d[at + 8]) & 0x3fff
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        return None
    if w == 0 or h == 0:
        return None
    return w, h


def _vp8l_signature(d: bytes, at: int, size: int) -> bool:
    return size >= 5 and d[at] == 0x2f and (d[at + 4] >> 5) == 0


def _vp8l_info(d: bytes, at: int, size: int):
    """VP8LGetInfo: (width, height, has_alpha) or None."""
    if not _vp8l_signature(d, at, size):
        return None
    bits = int.from_bytes(d[at + 1:at + 5], "little")
    return (bits & 0x3fff) + 1, ((bits >> 14) & 0x3fff) + 1, bool((bits >> 28) & 1)


def parse_headers(d: bytes, have_all_data: bool) -> _Headers:
    """ParseHeadersInternal over d (WebPGetFeatures when not
    have_all_data, WebPParseHeaders when it is)."""
    r = _Headers()
    size, at = len(d), 0
    if size < 12:
        r.status = NOT_ENOUGH_DATA
        return r
    riff_size = 0
    if d[:4] == b"RIFF":   # ParseRIFF
        if d[8:12] != b"WEBP":
            r.status = BITSTREAM_ERROR
            return r
        riff_size = _le32(d, 4)
        if riff_size < 12 or riff_size > MAX_CHUNK_PAYLOAD:
            r.status = BITSTREAM_ERROR
            return r
        if have_all_data and riff_size > size - 8:
            r.status = NOT_ENOUGH_DATA
            return r
        at, size = 12, size - 12
    found_riff = riff_size > 0
    # ParseVP8X
    found_vp8x, flags, canvas_w, canvas_h = False, 0, 0, 0
    if size < 8:
        r.status = NOT_ENOUGH_DATA
        return r
    if d[at:at + 4] == b"VP8X":
        if _le32(d, at + 4) != 10:
            r.status = BITSTREAM_ERROR
            return r
        if size < 18:
            r.status = NOT_ENOUGH_DATA
            return r
        flags = _le32(d, at + 8)
        canvas_w, canvas_h = 1 + _le24(d, at + 12), 1 + _le24(d, at + 15)
        if canvas_w * canvas_h >= MAX_IMAGE_AREA:
            r.status = BITSTREAM_ERROR
            return r
        at, size, found_vp8x = at + 18, size - 18, True
    if not found_riff and found_vp8x:
        r.status = BITSTREAM_ERROR
        return r
    r.has_alpha = bool(flags & ALPHA_FLAG)
    r.has_animation = bool(flags & ANIMATION_FLAG)
    image_w, image_h = canvas_w, canvas_h

    def done(st):
        if st == OK or (st == NOT_ENOUGH_DATA and found_vp8x and not have_all_data):
            r.has_alpha = r.has_alpha or r.alpha is not None
            r.width, r.height = image_w, image_h
            r.status = OK
        else:
            r.status = st
        return r

    if found_vp8x and r.has_animation and not have_all_data:
        return done(OK)
    if size < 4:
        return done(NOT_ENOUGH_DATA)
    if (found_riff and found_vp8x) or (not found_riff and not found_vp8x and
                                       d[at:at + 4] == b"ALPH"):
        # ParseOptionalChunks
        total = 4 + 8 + 10
        while True:
            if size < 8:
                return done(NOT_ENOUGH_DATA)
            chunk = _le32(d, at + 4)
            if chunk > MAX_CHUNK_PAYLOAD:
                return done(BITSTREAM_ERROR)
            disk = (8 + chunk + 1) & ~1
            total += disk
            if riff_size > 0 and total > riff_size:
                return done(BITSTREAM_ERROR)
            if d[at:at + 4] in (b"VP8 ", b"VP8L"):
                break
            if size < disk:
                return done(NOT_ENOUGH_DATA)
            if d[at:at + 4] == b"ALPH":
                r.alpha = (at + 8, chunk)
            at, size = at + disk, size - disk
    # ParseVP8Header
    if size < 8:
        return done(NOT_ENOUGH_DATA)
    tag = d[at:at + 4]
    if tag in (b"VP8 ", b"VP8L"):
        chunk = _le32(d, at + 4)
        if riff_size >= 12 and chunk > riff_size - 12:
            return done(BITSTREAM_ERROR)
        if have_all_data and chunk > size - 8:
            return done(NOT_ENOUGH_DATA)
        r.compressed_size, r.lossless = chunk, tag == b"VP8L"
        at, size = at + 8, size - 8
    else:
        r.lossless = _vp8l_signature(d, at, size)
        r.compressed_size = size
    if r.compressed_size > MAX_CHUNK_PAYLOAD:
        r.status = BITSTREAM_ERROR
        return r
    if not r.lossless:
        if size < 10:
            return done(NOT_ENOUGH_DATA)
        info = _vp8_info(d, at, size, r.compressed_size)
        if info is None:
            r.status = BITSTREAM_ERROR
            return r
        image_w, image_h = info
    else:
        if size < 5:
            return done(NOT_ENOUGH_DATA)
        info = _vp8l_info(d, at, size)
        if info is None:
            r.status = BITSTREAM_ERROR
            return r
        image_w, image_h, a = info
        r.has_alpha = a
    if found_vp8x and (canvas_w != image_w or canvas_h != image_h):
        r.status = BITSTREAM_ERROR
        return r
    r.offset = at
    return done(OK)


def is_webp(data: bytes) -> bool:
    """cv2's WebPDecoder signature check: WebPGetFeatures accepts the
    first 32 bytes."""
    return len(data) >= HEADER_SIZE and parse_headers(data[:HEADER_SIZE], False).status == OK


# ------------------------------------------------------------- WebPDemux

class _Frame:
    """An ANMF frame: its offset, size, and its image and ALPH chunks
    (offset, size) as StoreFrame records them."""

    def __init__(self, num: int):
        self.num = num
        self.x = self.y = self.w = self.h = 0
        self.image: Optional[Tuple[int, int]] = None
        self.alpha: Optional[Tuple[int, int]] = None
        self.has_alpha = False
        self.complete = False


class _Refused(Exception):
    pass


class _Demux:
    """WebPDemux over the whole buffer of an animated file (a RIFF with a
    VP8X whose animation flag is set; no partial data): its frames and
    canvas, or _Refused."""

    def __init__(self, d: bytes):
        self.d = d
        self.frames: List[_Frame] = []
        riff = _le32(d, 4)
        if riff < 8 or riff > MAX_CHUNK_PAYLOAD:
            raise _Refused
        self.end = riff + 8
        self.size = min(len(d), self.end)
        if self.size < self.end:
            raise _Refused   # a partial file
        self.pos = 12
        if self._vp8x() == "need":
            raise _Refused
        self._valid()

    def _left(self) -> int:
        return self.size - self.pos

    def _invalid(self, n: int) -> bool:   # SizeIsInvalid
        return n > self.end - self.pos

    def _store_frame(self, num: int, min_size: int, f: _Frame) -> str:
        """StoreFrame: 'ok', 'need' or raises _Refused."""
        if self._left() < 8 or self._left() < min_size:
            return "need"
        status = "ok"
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            tag = self.d[self.pos:self.pos + 4]
            payload = _le32(self.d, self.pos + 4)
            self.pos += 8
            if payload > MAX_CHUNK_PAYLOAD:
                raise _Refused
            padded = payload + (payload & 1)
            avail = min(padded, self._left())
            chunk_size = 8 + avail
            if self._invalid(padded):
                raise _Refused
            if padded > self._left():
                status = "need"
            done = False
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks += 1
                f.alpha = (start, chunk_size)
                f.has_alpha = True
                f.num = num
                self.pos += avail
            elif tag in (b"VP8L", b"VP8 ") and image_chunks == 0:
                if tag == b"VP8L" and alpha_chunks > 0:
                    raise _Refused   # VP8L has its own alpha
                h = parse_headers(self.d[start:start + chunk_size], False)
                if status == "need" and h.status == NOT_ENOUGH_DATA:
                    return "need"
                if h.status != OK:
                    raise _Refused
                image_chunks += 1
                f.image = (start, chunk_size)
                f.w, f.h = h.width, h.height
                f.has_alpha = f.has_alpha or h.has_alpha
                f.num = num
                f.complete = status == "ok"
                self.pos += avail
            else:
                self.pos -= 8   # rewind: a chunk of the level above
                done = True
            if self.pos == self.end:
                done = True
            elif self._left() < 8:
                status = "need"
            if done or status != "ok":
                return status

    def _vp8x(self) -> str:
        """ParseVP8X, then ParseVP8XChunks."""
        if self._left() < 8 or self.d[12:16] != b"VP8X":
            raise _Refused
        size = _le32(self.d, 16)
        self.pos = 20
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise _Refused
        size += size & 1
        if self._invalid(size):
            raise _Refused
        if self._left() < size:
            return "need"
        self.flags = self.d[self.pos]
        self.canvas_w = 1 + _le24(self.d, self.pos + 4)
        self.canvas_h = 1 + _le24(self.d, self.pos + 7)
        if self.canvas_w * self.canvas_h >= MAX_IMAGE_AREA:
            raise _Refused
        self.pos += size
        if self._invalid(8):
            raise _Refused
        if self._left() < 8:
            return "need"
        anim_chunks = 0
        status = "ok"
        while True:
            tag = self.d[self.pos:self.pos + 4]
            size = _le32(self.d, self.pos + 4)
            self.pos += 8
            if size > MAX_CHUNK_PAYLOAD:
                raise _Refused
            padded = size + (size & 1)
            if self._invalid(padded):
                raise _Refused
            if tag in (b"VP8X", b"ALPH", b"VP8 ", b"VP8L"):
                raise _Refused   # an animation's frames are all in ANMF chunks
            if tag == b"ANIM":
                if padded < 6:
                    raise _Refused
                if self._left() < padded:
                    status = "need"
                elif anim_chunks == 0:
                    anim_chunks += 1
                    self.pos += padded
                else:
                    status = self._skip(padded)
            elif tag == b"ANMF":
                if anim_chunks == 0:
                    raise _Refused   # ANIM precedes the frames
                status = self._anmf(padded)
            else:   # ICCP, EXIF, XMP and unknown chunks
                status = self._skip(padded)
            if self.pos == self.end:
                break
            if self._left() < 8:
                status = "need"
            if status != "ok":
                break
        return status

    def _skip(self, padded: int) -> str:
        if padded <= self._left():
            self.pos += padded
            return "ok"
        return "need"

    def _anmf(self, chunk_size: int) -> str:
        """ParseAnimationFrame: the ANMF header, then the frame's chunks
        (StoreFrame) within its payload."""
        if self._invalid(16) or chunk_size < 16:
            raise _Refused
        if self._left() < 16:
            return "need"
        f = _Frame(0)
        d, p = self.d, self.pos
        f.x, f.y = 2 * _le24(d, p), 2 * _le24(d, p + 3)
        f.w, f.h = 1 + _le24(d, p + 6), 1 + _le24(d, p + 9)
        self.pos += 16
        if f.w * f.h >= MAX_IMAGE_AREA:
            raise _Refused
        start = self.pos
        st = self._store_frame(len(self.frames) + 1, chunk_size - 16, f)
        if self.pos - start > chunk_size - 16:
            raise _Refused
        if f.num > 0:
            if self.frames and not self.frames[-1].complete:
                raise _Refused   # AddFrame: after an incomplete frame
            self.frames.append(f)
        return st

    def _valid(self):
        """IsValidExtendedFormat for an animation."""
        if not self.frames or self.flags & ~ALL_VALID_FLAGS:
            raise _Refused
        for f in self.frames:
            if not f.complete or f.image is None or f.w <= 0 or f.h <= 0:
                raise _Refused   # a partial frame, or alpha without an image
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                raise _Refused   # alpha must precede the image
            if f.x + f.w > self.canvas_w or f.y + f.h > self.canvas_h:
                raise _Refused


# ---------------------------------------------------------------- decode

def decode_webp(data: bytes) -> Optional[np.ndarray]:
    """WebP bytes -> (H, W, 3) u8 BGR (an animation's first frame), or
    None where cv2 refuses the file."""
    if not is_webp(data):
        return None
    feats = parse_headers(data[:HEADER_SIZE], False)
    w, h = feats.width, feats.height
    if not (0 < w <= MAX_SIDE and 0 < h <= MAX_SIDE and w * h <= MAX_PIXELS):
        return None
    if feats.has_animation:
        try:
            demux = _Demux(data)
        except (_Refused, struct.error, IndexError):
            return None
        return _first_frame(data, demux, w, h)
    return _decode_still(data, w, h)


def _decode_still(data: bytes, w: int, h: int) -> Optional[np.ndarray]:
    """DecodeInto over the whole buffer into a w x h BGR frame, or None."""
    hd = parse_headers(data, True)
    if hd.status != OK or hd.has_animation or hd.width != w or hd.height != h:
        return None
    return _decode_bitstream(data, hd)


def _decode_bitstream(data: bytes, hd: _Headers) -> Optional[np.ndarray]:
    w, h = hd.width, hd.height
    payload = data[hd.offset:]
    if hd.lossless:
        argb = np.empty((h, w), np.uint32)
        if _lib("vp8l").vp8l_decode(payload, len(payload), 0, w, h, argb.ctypes.data) != 0:
            return None
        return np.ascontiguousarray(argb.view(np.uint8).reshape(h, w, 4)[..., :3])
    out = np.empty((h, w, 3), np.uint8)
    if _lib("vp8").vp8_decode(payload, len(payload), w, h, out.ctypes.data) != 0:
        return None
    if hd.alpha is not None and not _alpha_ok(data[hd.alpha[0]:hd.alpha[0] + hd.alpha[1]], w, h):
        return None
    return out


def _alpha_ok(chunk: bytes, w: int, h: int) -> bool:
    """ALPHInit and ALPHDecode: whether the ALPH payload decodes."""
    if len(chunk) <= 1:
        return False
    head = chunk[0]
    method, pre, reserved = head & 3, (head >> 4) & 3, head >> 6
    if method > 1 or pre > 1 or reserved:
        return False
    if method == 0:
        return len(chunk) - 1 >= w * h
    plane = np.empty(w * h, np.uint32)
    return _lib("vp8l").vp8l_decode(chunk[1:], len(chunk) - 1, 1, w, h, plane.ctypes.data) == 0


def _first_frame(data: bytes, demux: _Demux, w: int, h: int) -> Optional[np.ndarray]:
    """WebPAnimDecoderGetNext's first frame: the key frame's pixels on a
    zeroed canvas."""
    f = demux.frames[0]
    start, size = f.image
    if f.alpha is not None:
        size += f.alpha[1] + (start - (f.alpha[0] + f.alpha[1]))
        start = f.alpha[0]
    fragment = data[start:start + size]
    hd = parse_headers(fragment, True)
    if hd.status != OK or hd.has_animation:
        return None
    frame = _decode_bitstream(fragment, hd)
    if frame is None:
        return None
    canvas = np.zeros((h, w, 3), np.uint8)
    canvas[f.y:f.y + hd.height, f.x:f.x + hd.width] = frame
    return canvas
