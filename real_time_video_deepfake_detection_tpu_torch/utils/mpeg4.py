"""MPEG-4 Part 2 (mp4v) decode on the host, without cv2 or FFmpeg: the
frames cv2.VideoCapture's FFmpeg backend decodes from an mp4's mp4v track
whose stream FFmpeg's own mpeg4 encoder wrote (cv2.VideoWriter's 'mp4v',
the JAX package's `cli/analyze.py --output`), picture for picture
(csrc/mpeg4.cpp), converted to BGR as cv2 5.0's bundled libswscale
converts them (csrc/yuv2bgr.cpp). Bound with ctypes, which drops the GIL
for each call; built with g++ at first use into `<repo>/.build/mpeg4_<hash>/`
(utils/host_build; a failed build raises, and there is no Python decoder
below it).

`Decoder` holds one stream's state: give it the esds decoder config (the
VOL header) and the track's first sample, then the samples in decode
order; pictures come out in FFmpeg's order. It refuses streams written by
Xvid or DivX, sprites (GMC), interlaced coding, the short video header,
non-rectangular shapes, not_8_bit, scalability, reversible VLCs, newpred
and reduced-resolution VOPs with a reason naming the feature, and stops at
a damaged VOP with a reason that says where (FFmpeg would conceal it).
utils/video.VideoReader drives it as cv2's FFmpeg backend drives
libavcodec.

`Encoder` is the other way (csrc/mpeg4_enc.cpp, built into
`<repo>/.build/mpeg4_enc_<hash>/`): the packets cv2.VideoWriter's 'mp4v'
writes, byte for byte, from BGR frames converted as cv2 converts them
(csrc/bgr2yuv.cpp); utils/video.VideoWriter muxes them. `fdct` and
`bgr_to_yuv420` expose its transform and conversion for the tests.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

SRC = csrc("mpeg4.cpp")
INCLUDES = (csrc("simple_idct.cpp"), csrc("yuv2bgr.cpp"))
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_IP = ctypes.POINTER(ctypes.c_int)


class Mpeg4Error(ValueError):
    """A stream the decoder refuses or a damaged VOP, with the reason."""


def library() -> ctypes.CDLL:
    """The loaded decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "mpeg4", INCLUDES))
            lib.mpeg4_new.argtypes = [ctypes.c_int]
            lib.mpeg4_new.restype = _P
            lib.mpeg4_free.argtypes = [_P]
            lib.mpeg4_config.argtypes = [_P, _P, _I64, _P, _I64]
            lib.mpeg4_check.argtypes = [_P]
            lib.mpeg4_check.restype = ctypes.c_char_p
            lib.mpeg4_user_data.argtypes = [_P]
            lib.mpeg4_user_data.restype = ctypes.c_char_p
            lib.mpeg4_decode.argtypes = [_P, _P, _I64, _I64, ctypes.c_int]
            lib.mpeg4_drain.argtypes = [_P]
            lib.mpeg4_flush.argtypes = [_P]
            lib.mpeg4_peek.argtypes = [_P, _IP, _IP, ctypes.POINTER(_I64), _IP, _IP]
            lib.mpeg4_take.argtypes = [_P, _P, _P, _P, _P]
            lib.mpeg4_error.argtypes = [_P]
            lib.mpeg4_error.restype = ctypes.c_char_p
            lib.mpeg4_idct.argtypes = [_P, _P, _I64]
            lib.mpeg4_idct.restype = None
            lib.mpeg4_stats.argtypes = [_P, ctypes.POINTER(_I64), ctypes.c_int]
            _lib = lib
        return _lib


def idct(blocks: np.ndarray) -> np.ndarray:
    """The decoder's IDCT (libavcodec's x86-64 simple_idct8) on (N, 64)
    int16 blocks in natural order: (N, 64) int16, saturated as libavcodec's
    `idct` leaves them."""
    blocks = np.ascontiguousarray(blocks, np.int16).reshape(-1, 64)
    out = np.empty_like(blocks)
    library().mpeg4_idct(blocks.ctypes.data, out.ctypes.data, len(blocks))
    return out


class Picture:
    """A decoded picture waiting in the decoder: its pts and size; `take`
    gives its pixels."""

    def __init__(self, pts: int, width: int, height: int, matrix: int, full_range: int):
        self.pts, self.width, self.height = pts, width, height
        self.matrix, self.full_range = matrix, full_range


# Decoder.stats() keys, in the order csrc/mpeg4.cpp counts them
STATS = ("intra_mb", "inter_1mv", "inter_4mv", "skipped_mb", "direct", "direct_skip", "forward",
         "backward", "interpolated", "colocated_skip", "dquant", "dbquant", "escape1", "escape2",
         "escape3", "ac_pred", "video_packets", "not_coded_vops", "b_vops", "p_vops", "i_vops",
         "b_vops_dropped", "partitioned_vops", "no_rounding_vops", "direct_8x8", "qpel_mb",
         "intra_in_p", "ac_rescaled", "edge_clip")


class Decoder:
    """One MPEG-4 Part 2 stream: the esds decoder config, then samples.
    `approx16` rounds put_no_rnd half-pel averages of 16-pixel rows as the
    system's FFmpeg 5.1 does on x86 (a non-bitexact mmxext routine, which
    cv2's bundled FFmpeg 8 keeps for 8-pixel rows only); the tests use it to
    hold the decoder to that library too."""

    def __init__(self, config: bytes = b"", first_sample: bytes = b"",
                 approx16: bool = False):
        self._lib = library()
        self._h = self._lib.mpeg4_new(int(approx16))
        if self._lib.mpeg4_config(self._h, config, len(config), first_sample or None,
                                  len(first_sample)) < 0:
            raise Mpeg4Error(self.error)

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mpeg4_free(h)

    @property
    def error(self) -> str:
        return self._lib.mpeg4_error(self._h).decode()

    @property
    def user_data(self) -> str:
        """The headers' user data string (the encoder's name and build)."""
        return self._lib.mpeg4_user_data(self._h).decode("latin-1")

    def stats(self) -> dict:
        """Counts of what the decoder met (macroblock and VOP kinds, escapes,
        video packets...), by STATS name."""
        out = (_I64 * len(STATS))()
        self._lib.mpeg4_stats(self._h, out, len(STATS))
        return dict(zip(STATS, out))

    def unsupported(self) -> str:
        """The feature of the headers seen so far that the decoder refuses,
        or ""."""
        return self._lib.mpeg4_check(self._h).decode()

    def decode(self, sample: bytes, pts: int, discard: bool = False) -> int:
        """Decode one sample; a discarded one is decoded as a reference and
        its picture never output. Returns the pictures ready."""
        n = self._lib.mpeg4_decode(self._h, sample, len(sample), int(pts), int(bool(discard)))
        if n < 0:
            raise Mpeg4Error(self.error)
        return n

    def drain(self) -> int:
        """The end of the stream: the picture held back becomes ready."""
        n = self._lib.mpeg4_drain(self._h)
        if n < 0:
            raise Mpeg4Error(self.error)
        return n

    def flush(self) -> None:
        """Drop every picture and reference (a seek)."""
        self._lib.mpeg4_flush(self._h)

    def peek(self) -> Optional[Picture]:
        """The next ready picture, or None."""
        w, h, m, f, pts = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), _I64()
        if not self._lib.mpeg4_peek(self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(pts),
                                    ctypes.byref(m), ctypes.byref(f)):
            return None
        return Picture(pts.value, w.value, h.value, m.value, f.value)

    def take(self, bgr: bool = True, planes: bool = False
             ) -> Tuple[Optional[np.ndarray], Optional[List[np.ndarray]]]:
        """Pop the next ready picture: (its BGR frame or None, its [Y, U, V]
        planes or None)."""
        pic = self.peek()
        if pic is None:
            raise Mpeg4Error("no picture is ready")
        w, h = pic.width, pic.height
        cw, ch = (w + 1) // 2, (h + 1) // 2
        out = np.empty((h, w, 3), np.uint8) if bgr else None
        yuv = ([np.empty((h, w), np.uint8), np.empty((ch, cw), np.uint8),
                np.empty((ch, cw), np.uint8)] if planes else None)
        ptr = [p.ctypes.data if p is not None else None
               for p in (yuv if yuv else [None] * 3) + [out]]
        self._lib.mpeg4_take(self._h, *ptr)
        return out, yuv


# ------------------------------------------------------------------ encoder

ENC_SRC = csrc("mpeg4_enc.cpp")
ENC_INCLUDES = (SRC, csrc("simple_idct.cpp"), csrc("yuv2bgr.cpp"), csrc("bgr2yuv.cpp"))
ENC_CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]   # no -march: no FMA contraction
_enc_lib = None


def encoder_library() -> ctypes.CDLL:
    """The loaded encoder (built on first use; it holds a decoder of its own
    for the reconstruction)."""
    global _enc_lib
    with _lock:
        if _enc_lib is None:
            lib = ctypes.CDLL(build_host_library(ENC_SRC, ENC_CXX_FLAGS, "mpeg4_enc", ENC_INCLUDES))
            lib.mpeg4enc_new.argtypes = [ctypes.c_int] * 4 + [_I64, ctypes.c_int]
            lib.mpeg4enc_new.restype = _P
            lib.mpeg4enc_free.argtypes = [_P]
            lib.mpeg4enc_error.argtypes = [_P]
            lib.mpeg4enc_error.restype = ctypes.c_char_p
            lib.mpeg4enc_header.argtypes = [_P, _P, _I64]
            lib.mpeg4enc_header.restype = _I64
            lib.mpeg4enc_encode_bgr.argtypes = [_P, _P, _I64, _I64]
            lib.mpeg4enc_encode_bgr.restype = _I64
            lib.mpeg4enc_packet.argtypes = [_P, _P]
            lib.mpeg4enc_bgr_to_yuv.argtypes = [_P, _I64, ctypes.c_int, ctypes.c_int, _P, _P, _P]
            lib.mpeg4enc_bgr_to_yuv.restype = None
            lib.mpeg4enc_reconstruction.argtypes = [_P, _P]
            lib.mpeg4enc_fdct.argtypes = [_P, _I64]
            lib.mpeg4enc_fdct.restype = None
            _enc_lib = lib
        return _enc_lib


def bgr_to_yuv420(frame: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2.VideoWriter's BGR24 -> yuv420p conversion (csrc/bgr2yuv.cpp):
    the frame cut to even sizes, then its Y, U and V planes."""
    frame = np.ascontiguousarray(frame, np.uint8)
    h, w = frame.shape[0] & ~1, frame.shape[1] & ~1
    y = np.empty((h, w), np.uint8)
    u = np.empty((h // 2, w // 2), np.uint8)
    v = np.empty((h // 2, w // 2), np.uint8)
    encoder_library().mpeg4enc_bgr_to_yuv(frame.ctypes.data, frame.strides[0], w, h,
                                          y.ctypes.data, u.ctypes.data, v.ctypes.data)
    return y, u, v


def fdct(blocks: np.ndarray) -> np.ndarray:
    """The encoder's forward DCT (libavcodec's x86 ff_fdct_sse2) on (N, 64)
    int16 blocks in natural order."""
    out = np.array(blocks, np.int16, copy=True).reshape(-1, 64)
    encoder_library().mpeg4enc_fdct(out.ctypes.data, len(out))
    return out


class Encoder:
    """One MPEG-4 Part 2 stream as cv2.VideoWriter's 'mp4v' writes it
    (csrc/mpeg4_enc.cpp): `width` x `height` (even), the time base
    `num`/`den` seconds a tick, `bit_rate` bits a second. With
    `global_header` the VOS / VOL headers are `header` (the esds decoder
    config); without, every I-VOP carries them (AVI). `encode` takes a
    BGR frame and its pts in ticks and returns (packet, keyframe)."""

    def __init__(self, width: int, height: int, num: int, den: int, bit_rate: int,
                 global_header: bool):
        self._lib = encoder_library()
        self.width, self.height = int(width), int(height)
        self._h = self._lib.mpeg4enc_new(self.width, self.height, int(num), int(den),
                                         int(bit_rate), int(bool(global_header)))
        if self.error:
            raise Mpeg4Error(self.error)
        n = self._lib.mpeg4enc_header(self._h, None, 0)
        buf = ctypes.create_string_buffer(n)
        self._lib.mpeg4enc_header(self._h, buf, n)
        self.header = buf.raw

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.mpeg4enc_free(h)

    @property
    def error(self) -> str:
        return self._lib.mpeg4enc_error(self._h).decode()

    def encode(self, frame: np.ndarray, pts: int) -> Tuple[bytes, bool]:
        """One (H, W, 3) u8 BGR frame, H >= height and W >= width."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if (frame.ndim != 3 or frame.shape[2] != 3 or frame.shape[0] < self.height
                or frame.shape[1] < self.width):
            raise ValueError(f"frame {frame.shape} does not cover {self.width}x{self.height}")
        n = self._lib.mpeg4enc_encode_bgr(self._h, frame.ctypes.data, frame.strides[0], int(pts))
        if n < 0:
            raise Mpeg4Error(self.error)
        buf = ctypes.create_string_buffer(max(n, 1))
        key = self._lib.mpeg4enc_packet(self._h, buf)
        return buf.raw[:n], bool(key)

    def reconstruction(self) -> np.ndarray:
        """The last picture as a decoder of the stream gives it, converted
        to BGR as cv2 converts a decoded frame: (height, width, 3) u8."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        if self._lib.mpeg4enc_reconstruction(self._h, out.ctypes.data) < 0:
            raise Mpeg4Error("no picture was encoded")
        return out
