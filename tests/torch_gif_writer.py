"""A GIF writer for the port's GIF tests and fixtures
(tests/test_torch_image_formats.py, tools/make_torch_image_formats_fixtures.py):
frames of palette indices, global and local palettes, interlace, a
transparent index, offsets, and LZW codes with or without a clear code
when the table fills. numpy only."""

from __future__ import annotations

import struct

import numpy as np


def lzw(indices, min_size: int, clear_at_full: bool = True) -> bytes:
    """LZW codes of a GIF image: a clear code, the codes, the end code."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    table = {(i,): i for i in range(clear)}
    nxt, size = eoi + 1, min_size + 1
    codes = [(clear, size)]
    w = ()
    for k in indices:
        wk = w + (int(k),)
        if wk in table:
            w = wk
            continue
        codes.append((table[w], size))
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        elif clear_at_full:
            codes.append((clear, size))
            table = {(i,): i for i in range(clear)}
            nxt, size = eoi + 1, min_size + 1
        w = (int(k),)
    if w:
        codes.append((table[w], size))
    codes.append((eoi, size))
    bits = nb = 0
    out = bytearray()
    for c, s in codes:
        bits |= c << nb
        nb += s
        while nb >= 8:
            out.append(bits & 255)
            bits >>= 8
            nb -= 8
    if nb:
        out.append(bits & 255)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\0"


def color_table(pal) -> tuple:
    n = 2
    while n < len(pal):
        n *= 2
    t = np.zeros((n, 3), np.uint8)
    t[:len(pal)] = pal
    return t.tobytes(), n.bit_length() - 2


def gif(w, h, frames, gpal=None, version=b"GIF89a", bg=0) -> bytes:
    """frames: dicts of idx (h, w), x, y, lpal, interlace, trans, min_size,
    clear_at_full."""
    flags, gp = 0, b""
    if gpal is not None:
        gp, sz = color_table(gpal)
        flags = 0x80 | (7 << 4) | sz
    out = version + struct.pack("<HHBBB", w, h, flags, bg, 0) + gp
    if len(frames) > 1:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        t = f.get("trans")
        out += (b"\x21\xf9\x04" + bytes([(2 << 2) | (t is not None)]) + struct.pack("<H", 10)
                + bytes([t or 0]) + b"\0")
        idx = np.asarray(f["idx"], np.uint8)
        fh, fw = idx.shape
        lflags, lp = 0, b""
        if f.get("lpal") is not None:
            lp, sz = color_table(f["lpal"])
            lflags = 0x80 | sz
        rows = idx
        if f.get("interlace"):
            lflags |= 0x40
            rows = idx[list(range(0, fh, 8)) + list(range(4, fh, 8)) + list(range(2, fh, 4))
                       + list(range(1, fh, 2))]
        ms = f.get("min_size", 8)
        out += (b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), fw, fh, lflags)
                + lp + bytes([ms])
                + sub_blocks(lzw(rows.reshape(-1), ms, f.get("clear_at_full", True))))
    return out + b"\x3b"
