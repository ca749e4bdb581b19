"""Builds the port's host C++ libraries (csrc/*.cpp) with g++ at first use.

Each library lands in `<repo>/.build/<stem>_<hash of the source and
flags>/lib<stem>.so`, so an edited source or flag list builds anew and a
stale library is never loaded. A failed build raises: no library of the
port has a fallback below it.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from typing import Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def csrc(name: str) -> str:
    """Path of a source file in the package's csrc/."""
    return os.path.join(_PKG_DIR, "csrc", name)


def build_host_library(src: str, flags: Sequence[str], stem: str) -> str:
    """Compile `src` with `g++ <flags>` (when needed) and return the path
    of the shared library. A library built with -march=native is also keyed
    by the host's name: a copy of the tree on another machine, whose CPU
    may lack the instructions it uses, builds its own."""
    key = " ".join(flags)
    if "-march=native" in flags:
        key += " " + platform.node()
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + key.encode()).hexdigest()[:16]
    out_dir = os.path.join(os.path.dirname(_PKG_DIR), ".build", f"{stem}_{digest}")
    lib_path = os.path.join(out_dir, f"lib{stem}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", *flags, src, "-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, lib_path)   # atomic: a concurrent loader never sees half a file
    return lib_path
