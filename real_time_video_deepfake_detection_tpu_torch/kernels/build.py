"""Build and load the package's hand-written CUDA kernels.

Every `csrc/*.cu` source is compiled by its own `nvcc` process, all started
together, for sm_90a (Hopper) with a plain C interface, and the objects are
linked into one shared library under `<repo>/.build/torch_kernels/`, named
by a hash of the sources so an edited source never loads a stale build. The
library is loaded with ctypes. Nothing happens at import: the first call
that needs a kernel builds it, so the package imports on hosts without
`nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), ".build", "torch_kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the build this process ran

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double
# C entry points: name -> argument types (every one returns cudaError_t)
_SIGNATURES = {
    "clahe_luts": [_P, _P, _I, _I, _I, _I, _I, _D, _P],
    "clahe_apply": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    "preprocess_faces_f32": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "preprocess_faces_u8": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    "unique_hue_count": [_P, _P, _I, _I, _P],
}


DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), DEFAULT_NVCC):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _run_all(cmds):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    errors = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(c)}\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))


def build() -> str:
    """Compile (when needed) and return the path of the shared library."""
    global build_seconds
    sources = _sources()
    lib_path = os.path.join(BUILD_DIR, f"libtorch_kernels_{_digest(sources)}.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = _nvcc()
    t0 = time.time()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs = [os.path.join(BUILD_DIR, os.path.basename(s) + f".{os.getpid()}.o")
            for s in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(sources, objs)])
    tmp = lib_path + f".{os.getpid()}.tmp"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", tmp]])
    os.replace(tmp, lib_path)   # atomic: a concurrent loader never sees half a file
    for o in objs:
        os.remove(o)
    build_seconds = time.time() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device, *args) -> None:
    """Call C entry point `name` with `args` and the current stream of CUDA
    `device` (switching the current device only when it differs), and raise
    on a launch error. The host path of a wrapper's launch, kept short."""
    fn = getattr(_lib if _lib is not None else library(), name)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    check(err, name)


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
