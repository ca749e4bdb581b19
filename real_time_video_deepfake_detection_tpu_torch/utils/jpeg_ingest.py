"""JPEG decode without cv2 or libjpeg: the port's counterpart of the decode
half of real_time_video_deepfake_detection_tpu/utils/native_ingest.py.

The host runs only the entropy (Huffman or arithmetic) decode, in C++
(csrc/jpeg_entropy.cpp, bound with ctypes); the reconstruction runs in
torch on any device (ops/jpeg_decode.py). Together they equal libjpeg-turbo
2.1.5's default decode, which is what the JAX package's native decode
returns, for sequential and progressive streams, Huffman or arithmetic
coded, with 1, 3 or 4 components and sampling factors 1-4, truncated
streams included (libjpeg pads them). Two routes decide what is refused,
each with a reason:

- "native" (the JAX package's libjpeg decode to BGR): CMYK and YCCK
  frames are refused, as libjpeg refuses to convert them to BGR, and so
  are lossless (SOF3) frames, which libjpeg-turbo 2.1.5 does not decode;
- "cv2" (cv2.imdecode's JPEG decoder): a stream that ends before its EOI
  marker is refused, as cv2 refuses it; CMYK and YCCK convert to BGR as
  cv2 converts them; a lossless frame of 2- to 8-bit samples decodes as
  cv2's libjpeg-turbo 3.1.2 decodes it (`lossless_bgr`; utils/
  image_decode.py adds PNG, BMP and EXIF);
- "tiff" (libjpeg under libtiff's JPEG codec, utils/tiff.py): nothing is
  refused after the entropy decode, a cut stream padded, the caller
  choosing the colour conversion.

A progressive frame whose first AC coefficients are inexact (in practice
a truncated progressive upload) is block-smoothed as libjpeg smooths it
(jdcoefct.c decompress_smooth_data, in csrc/jpeg_entropy.cpp). 12-bit
streams, which neither libjpeg-turbo build decodes, are refused on both
routes. `reconstruct` also takes libjpeg's DCT scaling (scale M/8,
ops/jpeg_scaled.py), and `frames_at` conforms a tick's streams to one size,
scaled as the JAX package's fast pooled decode scales them
(native/ingest.cpp:644-656).

The library is built with g++ at first use into
`<repo>/.build/jpeg_entropy_<hash of the source and flags>/`
(utils/host_build). If the build fails, decoding raises: there is no other
decoder below it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import logging
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.jpeg_decode import bgr_from_components, planes_to_bgr
from ..ops.jpeg_scaled import pick_scale
from ..ops.resize import resize_bilinear_u8_cv2
from .host_build import build_host_library, csrc

SRC = csrc("jpeg_entropy.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
INFO_LEN = 24   # kInfoLen in csrc/jpeg_entropy.cpp
EXTRA_LEN = 2   # kExtraLen
COLOR_SPACES = ("gray", "ycbcr", "rgb", "cmyk", "ycck")   # info[15]
ROUTES = ("native", "cv2", "tiff")

LOSSLESS = -7   # kLossless: a lossless (SOF3) frame
STATUS = {-1: "not a JPEG stream", -2: "truncated JPEG stream",
          -3: "corrupt JPEG stream",
          -4: "unsupported JPEG (12- or 16-bit samples, hierarchical or arithmetic "
              "lossless coding, 2 components, or fractional sampling ratios)",
          -5: "JPEG larger than 2^25 pixels",
          -6: "CMYK or YCCK JPEG (libjpeg does not convert it to BGR)",
          LOSSLESS: "lossless JPEG (libjpeg-turbo 2.1.5 does not decode it)"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p


class JpegError(ValueError):
    """A stream the entropy decoder refused; `status` is its negative code."""

    def __init__(self, status: int):
        super().__init__(STATUS.get(status, f"JPEG decode status {status}"))
        self.status = status


def library() -> ctypes.CDLL:
    """The loaded entropy decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "jpeg_entropy"))
            lib.jpeg_info_len.restype = ctypes.c_int
            if lib.jpeg_info_len() != INFO_LEN:
                raise RuntimeError("csrc/jpeg_entropy.cpp and utils/jpeg_ingest.py "
                                   "disagree on the info layout")
            lib.jpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _P]
            lib.jpeg_probe.restype = ctypes.c_int
            if lib.jpeg_extra_len() != EXTRA_LEN:
                raise RuntimeError("csrc/jpeg_entropy.cpp and utils/jpeg_ingest.py "
                                   "disagree on the extra layout")
            lib.jpeg_idct_islow_blocks.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int64, _P]
            lib.jpeg_idct_islow_blocks.restype = None
            lib.jpeg_decode_lossless.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _P, _P]
            lib.jpeg_decode_lossless.restype = ctypes.c_int
            lib.jpeg_decode_coefs_batch.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int,
                                                    ctypes.c_int, _P, _P]
            lib.jpeg_decode_coefs_batch.restype = None
            for fn in (lib.jpeg_wire_coefs_batch, lib.jpeg_wire_raw420_batch):
                fn.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
                               ctypes.c_int, _P]
                fn.restype = None
            _lib = lib
        return _lib


@dataclasses.dataclass
class JpegCoefs:
    """One stream's quantised coefficients, as csrc/jpeg_entropy.cpp lays
    them out: coefs[c] is component c's padded block grid (bh, bw, 64)
    int16 in natural order, qtabs (components, 64) uint16 natural order,
    factors[c] = (h, v) sampling factors, color one of COLOR_SPACES.
    past_end: the decode read past the end of the data (a truncated
    stream); smoothing: the coefficients were block-smoothed as libjpeg
    smooths them."""
    height: int
    width: int
    factors: Tuple[Tuple[int, int], ...]
    coefs: Tuple[np.ndarray, ...]
    qtabs: np.ndarray
    color: str = "ycbcr"
    past_end: bool = False
    smoothing: bool = False

    @property
    def layout(self):
        """Streams with equal layouts reconstruct as one batch."""
        return (self.height, self.width, self.factors, self.color)

    def refusal(self, route: str) -> Optional["JpegError"]:
        """Why `route` (ROUTES) refuses this decoded stream, or None."""
        if route not in ROUTES:
            raise ValueError(f"unknown decode route {route!r} (expected one of {ROUTES})")
        if route == "cv2" and self.past_end:
            return JpegError(-2)
        if route == "native" and self.color in ("cmyk", "ycck"):
            return JpegError(-6)
        return None


def _allocate(info: np.ndarray):
    ncomp, mcux, mcuy = int(info[2]), int(info[5]), int(info[6])
    factors = tuple((int(info[7 + 2 * c]), int(info[8 + 2 * c])) for c in range(ncomp))
    sizes = [mcuy * v * mcux * h * 64 for h, v in factors]
    flat = np.zeros(sum(sizes), np.int16)
    coefs, at = [], 0
    for (h, v), n in zip(factors, sizes):
        coefs.append(flat[at:at + n].reshape(mcuy * v, mcux * h, 64))
        at += n
    return flat, JpegCoefs(int(info[0]), int(info[1]), factors, tuple(coefs),
                           np.zeros((ncomp, 64), np.uint16), COLOR_SPACES[int(info[15])])


def decode_coefs_batch(datas: Sequence[bytes], n_threads: int = 0, route: str = "native"
                       ) -> List[Union[JpegCoefs, JpegError]]:
    """Entropy-decode a tick's streams in one pooled call (up to `n_threads`
    threads, 0 = one per core; the GIL is released while it runs). Each
    entry is the stream's JpegCoefs or the JpegError that refused it, on
    `route` (ROUTES)."""
    lib = library()
    out: List[Union[JpegCoefs, JpegError]] = []
    infos = np.zeros((len(datas), INFO_LEN), np.int32)
    todo = []
    for i, data in enumerate(datas):
        rc = lib.jpeg_probe(data, len(data), infos[i].ctypes.data)
        if rc != 0:
            out.append(JpegError(rc))
            continue
        flat, jc = _allocate(infos[i])
        out.append(jc)
        todo.append((i, flat, jc))
    if todo:
        n = len(todo)
        ptrs = (ctypes.c_char_p * n)(*[datas[i] for i, _, _ in todo])
        lens = (ctypes.c_size_t * n)(*[len(datas[i]) for i, _, _ in todo])
        sel = np.ascontiguousarray(infos[[i for i, _, _ in todo]])
        coef_p = (_P * n)(*[flat.ctypes.data for _, flat, _ in todo])
        qt_p = (_P * n)(*[jc.qtabs.ctypes.data for _, _, jc in todo])
        rcs = np.zeros(n, np.int32)
        extras = np.zeros((n, EXTRA_LEN), np.int32)
        lib.jpeg_decode_coefs_batch(ptrs, lens, sel.ctypes.data, coef_p, qt_p, n,
                                    n_threads, rcs.ctypes.data, extras.ctypes.data)
        for (i, _, jc), rc, extra in zip(todo, rcs, extras):
            if rc != 0:
                out[i] = JpegError(int(rc))
                continue
            jc.past_end, jc.smoothing = bool(extra[0]), bool(extra[1])
            refused = jc.refusal(route)
            if refused is not None:
                out[i] = refused
    return out


def decode_coefs(data: bytes, route: str = "native") -> JpegCoefs:
    """One stream's coefficients; raises JpegError when `route` refuses it."""
    r = decode_coefs_batch([data], 1, route)[0]
    if isinstance(r, JpegError):
        raise r
    return r


def reconstruct(group: Sequence[JpegCoefs], device: Union[str, torch.device],
                scale: int = 8) -> torch.Tensor:
    """Same-layout streams -> (B, ceil(H*scale/8), ceil(W*scale/8), 3) u8
    BGR on `device`; `scale` 8 is the full decode."""
    first = group[0]
    coefs = [torch.from_numpy(np.stack([jc.coefs[c] for jc in group])).to(device)
             for c in range(len(first.factors))]
    qtabs = torch.from_numpy(np.stack([jc.qtabs.astype(np.int32) for jc in group])).to(device)
    return bgr_from_components(coefs, qtabs, first.factors, first.height, first.width,
                               scale=scale, color=first.color)


def frames_at(coefs: Sequence[JpegCoefs], device: Union[str, torch.device],
              hw: Tuple[int, int], scaled: bool = False) -> torch.Tensor:
    """Streams of any layouts -> (N, h, w, 3) u8 BGR on `device`, in order:
    each group of one layout and scale is reconstructed as one batch, then
    resized to `hw` with cv2's INTER_LINEAR (ops/resize) unless it is that
    size already. `scaled`: each stream decodes at the largest scale M/8
    whose larger side still covers 2*max(hw) (JAX's fast pooled decode,
    ServerConfig.ingest_scaled_decode); else at full size."""
    h, w = hw
    hint = 2 * max(h, w) if scaled else 0
    groups: dict = {}
    for i, jc in enumerate(coefs):
        m = pick_scale(jc.height, jc.width, hint)
        groups.setdefault((jc.layout, m), []).append(i)
    out = torch.empty((len(coefs), h, w, 3), dtype=torch.uint8, device=device)
    for (_, m), idx in groups.items():
        frames = reconstruct([coefs[i] for i in idx], device, scale=m)
        if frames.shape[1:3] != (h, w):
            frames = resize_bilinear_u8_cv2(frames, h, w)
        out[torch.tensor(idx, device=device)] = frames
    return out


# ------------------------------------------------------------ wire planes
#
# The wire planes of device-detect serving (ServerConfig.ingest_plane) carry
# eligible frames (YCbCr 4:2:0 at exactly the capture size, both sides
# multiples of 16, Cb and Cr on one quant table) as one batch buffer, a row
# per stream, which the host fills in one pooled call and the device tick
# reconstructs (ops/jpeg_decode.bgr_from_coefs_420 or bgr_from_ycbcr420).
# Progressive and truncated streams qualify, as in the JAX package
# (utils/native_ingest.decode_coefs_batch and decode_raw420_batch, through
# libjpeg): "coef" carries libjpeg's coefficients as they are, "ycbcr420"
# the samples of the block-smoothed ones where libjpeg smooths.

WIRE_PLANES = ("coef", "ycbcr420")


def wire_row_shape(plane: str, h: int, w: int) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, dtype) of one stream's row of a wire batch buffer:
    "coef": ((h/8)(w/8) * 3/2 + 2, 64) int16, the Y, Cb and Cr coefficient
    blocks in natural order, then the luma and chroma quant tables as
    uint16 bits; "ycbcr420": (h*w*3/2,) uint8, the Y plane, then Cb and
    Cr."""
    if plane not in WIRE_PLANES:
        raise ValueError(f"unknown wire plane {plane!r} (expected one of {WIRE_PLANES})")
    if h % 16 or w % 16:
        raise ValueError(f"the wire planes need sides divisible by 16, got {(h, w)}")
    if plane == "coef":
        return ((h // 8) * (w // 8) * 3 // 2 + 2, 64), np.dtype(np.int16)
    return (h * w * 3 // 2,), np.dtype(np.uint8)


def wire_buffer(plane: str, rows: int, h: int, w: int, pin_memory: bool = False
                ) -> torch.Tensor:
    """An uninitialised wire batch buffer of `rows` rows on the host
    (page-locked with `pin_memory`, for asynchronous copies to a GPU); its
    .numpy() shares the memory."""
    shape, _ = wire_row_shape(plane, h, w)
    return torch.empty((rows,) + shape, dtype=torch.int16 if plane == "coef" else torch.uint8,
                       pin_memory=pin_memory)


def wire_views(plane: str, buf, h: int, w: int) -> tuple:
    """Views (no copies) of a wire batch buffer, numpy or torch, of shape
    (R,) + row shape, as the wire step takes them: "coef" (coef_y (R, yb,
    64), coef_c (R, 2, yb/4, 64), qtab (R, 2, 64) int16 holding uint16
    bits) with yb = (h/8)(w/8); "ycbcr420" (y (R, h, w), c (R, 2, h/2,
    w/2))."""
    r = buf.shape[0]
    if plane == "coef":
        yb = (h // 8) * (w // 8)
        return (buf[:, :yb], buf[:, yb:yb * 3 // 2].reshape(r, 2, yb // 4, 64),
                buf[:, yb * 3 // 2:])
    return buf[:, :h * w].reshape(r, h, w), buf[:, h * w:].reshape(r, 2, h // 2, w // 2)


def decode_wire_into(plane: str, datas: Sequence[bytes], h: int, w: int, buf: np.ndarray,
                     n_threads: int = 0) -> np.ndarray:
    """Decode the streams' wire plane into rows 0..len(datas)-1 of `buf`
    (shape (R,) + row shape, R >= len(datas); e.g. a pinned buffer) in one
    pooled call (up to `n_threads` threads, 0 = one per core; the GIL is
    released while it runs). Returns ok (len(datas),) bool: True where the
    stream is eligible and decoded. Rows of the others, and rows past
    len(datas), keep what they held, except that their quant tables
    ("coef") are zeroed."""
    shape, dtype = wire_row_shape(plane, h, w)
    n = len(datas)
    if buf.shape[1:] != shape or buf.dtype != dtype or buf.shape[0] < n:
        raise ValueError(f"wire buffer {buf.shape} {buf.dtype} cannot hold {n} rows of "
                         f"{shape} {dtype}")
    if not buf.flags.c_contiguous:
        raise ValueError("the wire buffer must be C-contiguous")
    ok = np.zeros(n, np.int32)
    if n:
        fn = library().jpeg_wire_coefs_batch if plane == "coef" else (
            library().jpeg_wire_raw420_batch)
        fn((ctypes.c_char_p * n)(*datas), (ctypes.c_size_t * n)(*[len(d) for d in datas]),
           n, h, w, buf.ctypes.data, n_threads, ok.ctypes.data)
    if plane == "coef":
        buf[n:, -2:] = 0
    return ok.astype(bool)


def _wire_batch(plane, datas, h, w, n_threads, pad_to):
    buf = wire_buffer(plane, max(len(datas), pad_to), h, w).numpy()
    ok = decode_wire_into(plane, datas, h, w, buf, n_threads)
    return wire_views(plane, buf, h, w), ok


def decode_coefs_wire_batch(datas: Sequence[bytes], h: int, w: int, n_threads: int = 0,
                            pad_to: int = 0):
    """The "coef" wire plane of a tick's streams, with the contract of the
    JAX package's utils/native_ingest.decode_coefs_batch: (coef_y (R, yb,
    64) int16, coef_c (R, 2, yb/4, 64) int16, qtab (R, 2, 64) uint16, ok
    (N,) bool), R = max(N, pad_to); the rows of streams that are not
    eligible and the padded rows hold garbage, their quant tables zeros."""
    (coef_y, coef_c, qtab), ok = _wire_batch("coef", datas, h, w, n_threads, pad_to)
    return coef_y, coef_c, qtab.view(np.uint16), ok


def decode_raw420_batch(datas: Sequence[bytes], h: int, w: int, n_threads: int = 0,
                        pad_to: int = 0):
    """The "ycbcr420" wire plane, with the contract of the JAX package's
    utils/native_ingest.decode_raw420_batch: (y (R, h, w) uint8, c (R, 2,
    h/2, w/2) uint8 Cb then Cr, ok (N,) bool), R = max(N, pad_to); the
    samples of libjpeg's islow inverse DCT without upsampling."""
    (y, c), ok = _wire_batch("ycbcr420", datas, h, w, n_threads, pad_to)
    return y, c, ok


@functools.lru_cache(maxsize=None)
def log_refusal(reason: str) -> None:
    """Log why an image was refused, once per reason in a process."""
    logging.getLogger(__name__).warning("refusing images: %s", reason)


def idct_islow_host(coef: torch.Tensor, qtab: torch.Tensor) -> torch.Tensor:
    """ops/jpeg_decode.samples_islow_simd on the host in C (the same bytes):
    coef (B, nb, 64) int16 and qtab (B, 64) CPU tensors -> (B, nb, 64) int32."""
    c = np.ascontiguousarray(coef.numpy(), np.int16)
    q = np.ascontiguousarray(qtab.numpy().astype(np.uint16))
    out = np.empty(c.shape, np.uint8)
    library().jpeg_idct_islow_blocks(c.ctypes.data, q.ctypes.data, c.shape[0], c.shape[1],
                                     out.ctypes.data)
    return torch.from_numpy(out).to(torch.int32)


def decode_lossless(data: bytes) -> Tuple[np.ndarray, str]:
    """A lossless (SOF3) stream of 2- to 8-bit samples -> its (H, W, C) u8
    samples, each component replicated to the frame's size and shifted by
    its point transform, and its colour space (COLOR_SPACES; libjpeg-turbo
    3 takes a 3-component frame without a JFIF or Adobe marker as RGB).
    Raises JpegError."""
    lib = library()
    info = np.zeros(INFO_LEN, np.int32)
    rc = lib.jpeg_decode_lossless(data, len(data), info.ctypes.data, None)
    if rc == 0:
        out = np.empty((int(info[0]), int(info[1]), int(info[2])), np.uint8)
        rc = lib.jpeg_decode_lossless(data, len(data), info.ctypes.data, out.ctypes.data)
    if rc != 0:
        raise JpegError(rc)
    return out, COLOR_SPACES[int(info[15])]


def lossless_bgr(data: bytes) -> Optional[np.ndarray]:
    """cv2.imdecode(IMREAD_COLOR) of a lossless stream: RGB samples as
    BGR, CMYK converted as cv2 converts it; a grayscale, YCbCr or YCCK
    frame is refused, as cv2's libjpeg-turbo (3.1.2) converts none of them
    to BGR in lossless mode, and so is a cut stream. None (the reason
    logged once) when refused."""
    try:
        samples, color = decode_lossless(data)
    except JpegError as e:
        log_refusal(str(e))
        return None
    if color == "rgb":
        return np.ascontiguousarray(samples[..., ::-1])
    if color == "cmyk":
        planes = [torch.from_numpy(np.ascontiguousarray(samples[..., c]))[None] for c in range(4)]
        return planes_to_bgr(planes, "cmyk")[0].numpy()
    log_refusal(f"lossless {color} JPEG (cv2 converts none to BGR)")
    return None


def decode_jpeg(data: bytes, route: str = "native") -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 3) u8 BGR, libjpeg's default decode (on the
    cv2 route, a lossless stream as cv2 decodes it), on the CPU; None (the
    reason logged once) when `route` (ROUTES) refuses the stream. No EXIF
    orientation is applied."""
    try:
        jc = decode_coefs(data, route)
    except JpegError as e:
        if e.status == LOSSLESS and route == "cv2":
            return lossless_bgr(data)
        log_refusal(str(e))
        return None
    return reconstruct([jc], "cpu")[0].numpy()
