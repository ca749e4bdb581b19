"""JPEG 2000 decode as cv2 5.0's imdecode(..., IMREAD_COLOR) returns it, without
cv2 or OpenJPEG: cv2 decodes JPEG 2000 with its statically built OpenJPEG
2.5.3 (grfmt_jpeg2000_openjpeg.cpp), the whole image at full resolution and
in OpenJPEG's default strict mode, then turns OpenJPEG's int32 planes into
8-bit BGR. This follows it:

- cv2's two signatures: a JP2 file (its 12-byte signature box) and a raw
  codestream (FF 4F FF 51);
- the JP2 container as opj_jp2_read_header walks it: the signature and
  file-type boxes first, `jp2h` with `ihdr`, `colr`, `bpcc`, `pclr`,
  `cmap` and `cdef` (a misplaced one read once `jp2h` has been, skipped
  before), unknown boxes, 8-byte, XL and zero (to the end of the file)
  lengths, and `jp2c`, whose codestream runs to the end of the file;
- the codestream (csrc/jpeg2000.cpp): the main and tile-part headers,
  tier 2, tier 1, dequantisation, the inverse 5/3 and 9/7 DWT, RCT and
  ICT, the DC level shift and clamp, as OpenJPEG computes them;
- the JP2 colour post-processing (opj_jp2_check_color, opj_jp2_apply_pclr,
  opj_jp2_apply_cdef);
- cv2's header checks (1 to 4 components, none signed, a largest precision
  of 8 bits or more) and its conversion: every plane shifted right by the
  header's largest precision less 8 and cast to 8 bits; the colour space
  `colr` names: sRGB, an unknown space, an ICC profile or a raw codestream
  as RGB (three components or more, BGR from the first three), greyscale
  as the first plane in three channels, sYCC through cv2's YUV to BGR;
  CMYK, e-sYCC, one or two components in RGB, and any component that is
  subsampled or does not span the image refused.

A file cv2 refuses gives None. Refused by name (`NotPorted`), although
OpenJPEG decodes them: HTJ2K (Part 15) code-blocks and the capabilities
marker, the corresponding-profile marker, and Part 2's multiple component
transform markers.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from .host_build import build_host_library, csrc

SIGNATURES = (b"\x00\x00\x00\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51")
SRC = csrc("jpeg2000.cpp")
# -ffp-contract=off: the 9/7 path rounds every float32 step as OpenJPEG's does
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
             "-fno-strict-aliasing"]

# opj_jp2 states; an unknown box sets every bit (JP2_STATE_UNKNOWN = 0x7fffffff)
_SIGNATURE, _FILE_TYPE, _HEADER, _UNKNOWN = 0x1, 0x2, 0x4, 0x7FFFFFFF
_IMAGE_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")
# colr enumerated spaces: sRGB, greyscale, sYCC, e-sYCC, CMYK
_SRGB, _GRAY, _SYCC, _EYCC, _CMYK = 16, 17, 18, 24, 12

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p


class NotPorted(ValueError):
    """A JPEG 2000 file that cv2 decodes with a feature the port does not."""


class _Refused(Exception):
    """A file cv2 refuses."""


def library() -> ctypes.CDLL:
    """The loaded codestream decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_host_library(SRC, CXX_FLAGS, "jpeg2000"))
            lib.j2k_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32,
                                       ctypes.c_uint32]
            lib.j2k_decode.restype = _P
            lib.j2k_status.argtypes = [_P]
            lib.j2k_status.restype = ctypes.c_int
            lib.j2k_message.argtypes = [_P]
            lib.j2k_message.restype = ctypes.c_char_p
            lib.j2k_info.argtypes = [_P, _P]
            lib.j2k_info.restype = None
            lib.j2k_plane.argtypes = [_P, ctypes.c_int, _P]
            lib.j2k_plane.restype = None
            lib.j2k_free.argtypes = [_P]
            lib.j2k_free.restype = None
            _lib = lib
        return _lib


def is_jpeg2000(data: bytes) -> bool:
    """cv2's signature checks: a JP2 file or a raw codestream."""
    return data.startswith(SIGNATURES)


class _Comp:
    __slots__ = ("prec", "dx", "dy", "w", "h", "data")

    def __init__(self, prec, dx, dy, w, h, data):
        self.prec, self.dx, self.dy, self.w, self.h, self.data = prec, dx, dy, w, h, data


def _codestream(cs: bytes, ihdr: Tuple[int, int]) -> Tuple[List[_Comp], int]:
    """The components of a codestream, and the largest precision of its
    header; raises _Refused or NotPorted."""
    lib = library()
    h = lib.j2k_decode(cs, len(cs), ihdr[0], ihdr[1])
    try:
        status = lib.j2k_status(h)
        if status == 2:
            raise NotPorted(lib.j2k_message(h).decode())
        if status != 0:
            raise _Refused
        info = np.zeros(1 + 5 * 4, np.int64)
        lib.j2k_info(h, info.ctypes.data)
        comps = []
        for c in range(int(info[0])):
            prec, dx, dy, w, hh = (int(v) for v in info[1 + 5 * c:6 + 5 * c])
            plane = np.empty((hh, w), np.int32)
            lib.j2k_plane(h, c, plane.ctypes.data)
            comps.append(_Comp(prec, dx, dy, w, hh, plane))
        return comps, max(c.prec for c in comps)
    finally:
        lib.j2k_free(h)


# ------------------------------------------------------------ the JP2 boxes

class _Jp2:
    """What opj_jp2_read_header keeps of the boxes before the codestream."""

    def __init__(self):
        self.state = 0
        self.has_jp2h = self.has_ihdr = False
        self.ihdr: Optional[Tuple[int, int, int]] = None   # (w, h, numcomps)
        self.numcomps = 0
        self.has_colr = False
        self.enumcs = 0
        self.pclr: Optional[dict] = None
        self.cdef: Optional[List[Tuple[int, int, int]]] = None

    # the handlers of jp2h's boxes; False fails the read
    def ihdr_box(self, p: bytes) -> bool:
        if self.ihdr is not None:
            return True   # a second ihdr is ignored
        if len(p) != 14:
            return False
        h, w, nc = struct.unpack_from(">IIH", p)
        self.numcomps = nc
        if h < 1 or w < 1 or nc < 1 or nc - 1 >= 16384:
            return False
        self.ihdr = (w, h, nc)
        self.has_ihdr = True
        return True

    def colr_box(self, p: bytes) -> bool:
        if len(p) < 3:
            return False
        if self.has_colr:
            return True   # only the first counts
        meth = p[0]
        if meth == 1:
            if len(p) < 7:
                return False
            self.enumcs = struct.unpack_from(">I", p, 3)[0]
            self.has_colr = True
        elif meth == 2:
            self.has_colr = True
        return True

    def bpcc_box(self, p: bytes) -> bool:
        return len(p) == self.numcomps

    def pclr_box(self, p: bytes) -> bool:
        if self.pclr is not None or len(p) < 3:
            return False
        ne, npc = struct.unpack_from(">HB", p)
        if ne == 0 or ne > 1024 or npc == 0 or len(p) < 3 + npc:
            return False
        sizes = [(b & 0x7F) + 1 for b in p[3:3 + npc]]
        at = 3 + npc
        entries = np.zeros((ne, npc), np.int64)
        for j in range(ne):
            for i in range(npc):
                k = min((sizes[i] + 7) >> 3, 4)
                if len(p) < at + k:
                    return False
                entries[j, i] = int.from_bytes(p[at:at + k], "big")
                at += k
        self.pclr = {"sizes": sizes, "entries": entries.astype(np.uint32).view(np.int32),
                     "cmap": None}
        return True

    def cmap_box(self, p: bytes) -> bool:
        if self.pclr is None or self.pclr["cmap"] is not None:
            return False
        n = len(self.pclr["sizes"])
        if len(p) < 4 * n:
            return False
        self.pclr["cmap"] = [list(struct.unpack_from(">HBB", p, 4 * i)) for i in range(n)]
        return True

    def cdef_box(self, p: bytes) -> bool:
        if self.cdef is not None or len(p) < 2:
            return False
        n = struct.unpack_from(">H", p)[0]
        if n == 0 or len(p) < 2 + 6 * n:
            return False
        self.cdef = [list(struct.unpack_from(">HHH", p, 2 + 6 * i)) for i in range(n)]
        return True

    def image_box(self, kind: bytes, p: bytes) -> bool:
        return getattr(self, kind.decode() + "_box")(p)

    def jp2h_box(self, p: bytes) -> bool:
        if (self.state & _FILE_TYPE) != _FILE_TYPE:
            return False
        has_ihdr = False
        at, left = 0, len(p)
        while left > 0:
            if left < 8:
                return False
            length, kind = struct.unpack_from(">I4s", p, at)
            hdr = 8
            if length == 1:
                if left < 16:
                    return False
                hi, length = struct.unpack_from(">II", p, at + 8)
                hdr = 16
                if hi != 0 or length == 0:
                    return False
            elif length == 0:
                return False
            if length < hdr or length > left:
                return False
            if kind in _IMAGE_BOXES and not self.image_box(kind, p[at + hdr:at + length]):
                return False
            if kind == b"ihdr":
                has_ihdr = True
            at += length
            left -= length
        if not has_ihdr:
            return False
        self.state |= _HEADER
        self.has_jp2h = True
        return True


def _jp2_codestream(data: bytes) -> Tuple[_Jp2, int]:
    """Walks the boxes as opj_jp2_read_header_procedure does; returns what it
    kept and where the codestream starts (it runs to the end of the file)."""
    j = _Jp2()
    pos, n = 0, len(data)
    while True:
        if n - pos < 8:
            pos = n
            break
        length, kind = struct.unpack_from(">I4s", data, pos)
        pos += 8
        hdr = 8
        if length == 0:
            length = n - pos + 8
        elif length == 1:
            if n - pos < 8:
                pos = n
                break
            hi, length = struct.unpack_from(">II", data, pos)
            pos += 8
            hdr = 16
            if hi != 0:
                break   # "Cannot handle box sizes higher than 2^32": the walk ends
        if kind == b"jp2c":
            if not j.state & _HEADER:
                raise _Refused
            break
        if length == 0 or length < hdr:
            raise _Refused
        size = length - hdr
        handler = {b"jP  ": "jp", b"ftyp": "ftyp", b"jp2h": "jp2h"}.get(kind)
        if handler is None and kind in _IMAGE_BOXES:
            if j.state & _HEADER:
                handler = "image"
            else:   # an image box before jp2h is skipped
                j.state |= _UNKNOWN
                if size > n - pos:
                    raise _Refused
                pos += size
                continue
        if handler is None:
            if not j.state & _SIGNATURE or not j.state & _FILE_TYPE:
                raise _Refused
            j.state |= _UNKNOWN
            if size > n - pos:
                pos = n   # the walk ends at the end of the stream
                break
            pos += size
            continue
        if size > n - pos:
            raise _Refused
        p = data[pos:pos + size]
        pos += size
        if handler == "jp":
            ok = j.state == 0 and size == 4 and p == b"\r\n\x87\n"
            j.state |= _SIGNATURE
        elif handler == "ftyp":
            ok = j.state == _SIGNATURE and size >= 8 and (size - 8) % 4 == 0
            j.state |= _FILE_TYPE
        elif handler == "jp2h":
            ok = j.jp2h_box(p)
        else:
            ok = j.image_box(kind, p)
        if not ok:
            raise _Refused
    if not j.has_jp2h or not j.has_ihdr:
        raise _Refused
    return j, pos


def _check_color(j: _Jp2, numcomps: int) -> None:
    """opj_jp2_check_color (fixing a single-component palette's mapping as it does)."""
    if j.cdef is not None:
        nr = numcomps
        if j.pclr is not None and j.pclr["cmap"] is not None:
            nr = len(j.pclr["sizes"])
        for cn, _typ, asoc in j.cdef:
            if cn >= nr:
                raise _Refused
            if asoc != 65535 and asoc > 0 and asoc - 1 >= nr:
                raise _Refused
        for k in range(nr):
            if not any(cn == k for cn, _, _ in j.cdef):
                raise _Refused   # incomplete channel definitions
    if j.pclr is not None and j.pclr["cmap"] is not None:
        cmap = j.pclr["cmap"]
        nr = len(cmap)
        sane = all(cmp < numcomps for cmp, _, _ in cmap)
        used = [False] * nr
        for i, (_cmp, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= nr or (used[pcol] and mtyp == 1) or \
                    (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        for i in range(nr):
            if not used[i] and cmap[i][1] != 0:
                sane = False
        if sane and numcomps == 1 and not all(used):
            for i in range(nr):
                cmap[i][1], cmap[i][2] = 1, i
        if not sane:
            raise _Refused


def _apply_pclr(j: _Jp2, comps: List[_Comp]) -> List[_Comp]:
    sizes, entries, cmap = j.pclr["sizes"], j.pclr["entries"], j.pclr["cmap"]
    out: List[Optional[_Comp]] = [None] * len(cmap)
    for i, (cmp, mtyp, pcol) in enumerate(cmap):
        src = comps[cmp]
        if mtyp == 0:
            data = src.data
        else:
            data = entries[np.clip(src.data, 0, len(entries) - 1), pcol]
        out[i] = _Comp(sizes[i], src.dx, src.dy, src.w, src.h, data)
    return out


def _apply_cdef(cdef: List[List[int]], comps: List[_Comp]) -> None:
    info = [list(e) for e in cdef]
    n = len(comps)
    for i, (cn, typ, asoc) in enumerate(info):
        if cn >= n or asoc in (0, 65535):
            continue
        acn = asoc - 1
        if acn >= n:
            continue
        if cn != acn and typ == 0:
            comps[cn], comps[acn] = comps[acn], comps[cn]
            for e in info[i + 1:]:
                if e[0] == cn:
                    e[0] = acn
                elif e[0] == acn:
                    e[0] = cn


def _yuv_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(..., COLOR_YUV2BGR) on 8-bit planes (14-bit fixed point)."""
    y, u, v = (a.astype(np.int64) for a in (y, u, v))
    u, v = u - 128, v - 128
    b = y + ((u * 33292 + 8192) >> 14)
    g = y + ((u * -6472 + v * -9519 + 8192) >> 14)
    r = y + ((v * 18678 + 8192) >> 14)
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


def decode_jpeg2000(data: bytes) -> Optional[np.ndarray]:
    """cv2.imdecode(data, IMREAD_COLOR) of a JPEG 2000 file: (H, W, 3) u8 BGR,
    or None where cv2 refuses it. Raises NotPorted for a feature the port
    does not decode."""
    try:
        if data.startswith(SIGNATURES[0]):
            j, at = _jp2_codestream(data)
            comps, maxprec = _codestream(data[at:], j.ihdr[:2])
            space = {_SRGB: "srgb", _GRAY: "gray", _SYCC: "sycc", _EYCC: None,
                     _CMYK: None}.get(j.enumcs, "srgb")
            _check_color(j, len(comps))
            if j.pclr is not None and j.pclr["cmap"] is not None:
                comps = _apply_pclr(j, comps)
            if j.cdef is not None:
                _apply_cdef(j.cdef, comps)
        else:
            comps, maxprec = _codestream(data, (0, 0))
            space = "srgb"
    except _Refused:
        return None
    if space is None:
        return None
    h, w = comps[0].h, comps[0].w
    for c in comps:
        if c.dx != 1 or c.dy != 1 or c.w != w or c.h != h:
            return None
    shift = max(maxprec - 8, 0)

    def plane(c: _Comp) -> np.ndarray:
        return (c.data >> shift).astype(np.uint8)

    n = len(comps)
    if space == "gray":
        g = plane(comps[0])
        return np.stack([g, g, g], -1)
    if space == "sycc":
        if n < 3:
            return None
        return _yuv_to_bgr(plane(comps[0]), plane(comps[1]), plane(comps[2]))
    if n < 3:
        return None
    return np.stack([plane(comps[2]), plane(comps[1]), plane(comps[0])], -1)


def not_ported(data: bytes) -> Optional[str]:
    """The feature of a JPEG 2000 file cv2 reads and the port does not
    decode, or None."""
    try:
        decode_jpeg2000(data)
    except NotPorted as e:
        return str(e)
    return None

