"""JPEG decode without cv2 or libjpeg: the port's counterpart of the decode
half of real_time_video_deepfake_detection_tpu/utils/native_ingest.py.

The host runs only the entropy (Huffman) decode, in C++
(csrc/jpeg_entropy.cpp, bound with ctypes); the reconstruction runs in
torch on any device (ops/jpeg_decode.py). Together they equal libjpeg's
default decode, which is what cv2.imdecode and the JAX package's native
decode return, for every baseline stream the entropy decoder accepts; every
other stream (progressive, arithmetic-coded, 12-bit, CMYK, truncated,
corrupt, or not a JPEG at all) is refused with a reason.

The library is built with g++ at first use into
`<repo>/.build/jpeg_entropy_<hash of the source and flags>/`. If the build
fails, decoding raises: there is no other decoder below it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import logging
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..ops.jpeg_decode import bgr_from_components

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG_DIR, "csrc", "jpeg_entropy.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
INFO_LEN = 16   # kInfoLen in csrc/jpeg_entropy.cpp

STATUS = {-1: "not a JPEG stream (the port decodes JPEG only: PNG, BMP and other "
              "formats are refused)", -2: "truncated JPEG stream",
          -3: "corrupt JPEG stream",
          -4: "unsupported JPEG (only baseline/extended-sequential Huffman, "
              "8-bit, grayscale or YCbCr is decoded)",
          -5: "JPEG larger than 2^25 pixels"}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p


class JpegError(ValueError):
    """A stream the entropy decoder refused; `status` is its negative code."""

    def __init__(self, status: int):
        super().__init__(STATUS.get(status, f"JPEG decode status {status}"))
        self.status = status


def build() -> str:
    """Compile (when needed) and return the path of the shared library."""
    with open(SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(os.path.dirname(_PKG_DIR), ".build", f"jpeg_entropy_{digest}")
    lib_path = os.path.join(out_dir, "libjpeg_entropy.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {SRC} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib_path)   # atomic: a concurrent loader never sees half a file
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded entropy decoder (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.jpeg_info_len.restype = ctypes.c_int
            if lib.jpeg_info_len() != INFO_LEN:
                raise RuntimeError("csrc/jpeg_entropy.cpp and utils/jpeg_ingest.py "
                                   "disagree on the info layout")
            lib.jpeg_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t, _P]
            lib.jpeg_probe.restype = ctypes.c_int
            lib.jpeg_decode_coefs_batch.argtypes = [_P, _P, _P, _P, _P, ctypes.c_int,
                                                    ctypes.c_int, _P]
            lib.jpeg_decode_coefs_batch.restype = None
            _lib = lib
        return _lib


@dataclasses.dataclass
class JpegCoefs:
    """One stream's quantised coefficients, as csrc/jpeg_entropy.cpp lays
    them out: coefs[c] is component c's padded block grid (bh, bw, 64)
    int16 in natural order, qtabs (components, 64) uint16 natural order,
    factors[c] = (h, v) sampling factors."""
    height: int
    width: int
    factors: Tuple[Tuple[int, int], ...]
    coefs: Tuple[np.ndarray, ...]
    qtabs: np.ndarray

    @property
    def layout(self):
        """Streams with equal layouts reconstruct as one batch."""
        return (self.height, self.width, self.factors)


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
                           np.zeros((ncomp, 64), np.uint16))


def decode_coefs_batch(datas: Sequence[bytes], n_threads: int = 0
                       ) -> List[Union[JpegCoefs, JpegError]]:
    """Entropy-decode a tick's streams in one pooled call (up to `n_threads`
    threads, 0 = one per core; the GIL is released while it runs). Each
    entry is the stream's JpegCoefs or the JpegError that refused it."""
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
        lib.jpeg_decode_coefs_batch(ptrs, lens, sel.ctypes.data, coef_p, qt_p, n,
                                    n_threads, rcs.ctypes.data)
        for (i, _, _), rc in zip(todo, rcs):
            if rc != 0:
                out[i] = JpegError(int(rc))
    return out


def decode_coefs(data: bytes) -> JpegCoefs:
    """One stream's coefficients; raises JpegError when refused."""
    r = decode_coefs_batch([data], 1)[0]
    if isinstance(r, JpegError):
        raise r
    return r


def reconstruct(group: Sequence[JpegCoefs], device: Union[str, torch.device]) -> torch.Tensor:
    """Same-layout streams -> (B, H, W, 3) u8 BGR on `device`."""
    first = group[0]
    coefs = [torch.from_numpy(np.stack([jc.coefs[c] for jc in group])).to(device)
             for c in range(len(first.factors))]
    qtabs = torch.from_numpy(np.stack([jc.qtabs.astype(np.int32) for jc in group])).to(device)
    return bgr_from_components(coefs, qtabs, first.factors, first.height, first.width)


@functools.lru_cache(maxsize=None)
def log_refusal(reason: str) -> None:
    """Log why an image was refused, once per reason in a process."""
    logging.getLogger(__name__).warning("refusing images: %s", reason)


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> (H, W, 3) u8 BGR, libjpeg's default decode, on the CPU;
    None (the reason logged once) when the stream is refused."""
    try:
        jc = decode_coefs(data)
    except JpegError as e:
        log_refusal(str(e))
        return None
    return reconstruct([jc], "cpu")[0].numpy()
