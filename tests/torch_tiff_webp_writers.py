"""Writers of TIFF and WebP files that cv2 cannot write, for the port's TIFF
and WebP tests and for tools/make_torch_tiff_webp_fixtures.py:

- `tiff_file`: a TIFF from a list of directory entries and the strip or
  tile data, either byte order, classic or BigTIFF (the first directory
  only);
- `lzw`, `lzw_tiff`: LZW as libtiff writes it, and an RGB TIFF as cv2
  writes it by default (LZW with the predictor, cv2's strip height);
- `lzw_compat`: old-style LZW (pre-5.0 libtiff's bit-reversed codes);
- `riff`, `chunk`, `vp8x`, `anmf`, `animation`, `image_chunks`: WebP
  containers built from the chunks cv2 writes;
- `cv2_tiff_writes`, `cv2_webp_writes`, `damaged`: seeded files cv2
  writes (cv2 imported when called) and their cut or byte-flipped copies;
- `libtiff_file` and `libwebp_file`: files written by the system's
  libtiff and libwebp through the C writers in tools/ (built with gcc into
  a temporary directory on first use; the fixture tool and the survey
  tool call them, the tests do not).
"""

from __future__ import annotations

import atexit
import os
import shutil
import struct
import subprocess
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 11: "f", 12: "d", 16: "Q"}


def tiff_file(entries: Sequence[Tuple[int, int, object]], blobs: Sequence[bytes],
              order: str = "<", big: bool = False) -> bytes:
    """Header, the blobs (each at an even offset), then the directory.
    An entry is (tag, type, values); values "OFFS" are the blobs' offsets,
    bytes are taken as they are, type 5 values are (numerator,
    denominator) pairs or floats (over 1000)."""
    head = 16 if big else 8
    offs, body = [], b""
    for b in blobs:
        offs.append(head + len(body))
        body += b + (b"\0" if len(b) % 2 else b"")
    ifd_at = head + len(body)
    ent_size, inline = (20, 8) if big else (12, 4)
    extra_at = ifd_at + (8 if big else 2) + len(entries) * ent_size + (8 if big else 4)
    ents, extra = b"", b""
    for tag, typ, vals in sorted(entries, key=lambda e: e[0]):
        if isinstance(vals, str) and vals == "OFFS":
            vals = offs
        if isinstance(vals, (bytes, bytearray)):
            raw, count = bytes(vals), len(vals)
        else:
            vals = list(vals)
            if typ == 5:
                flat: List[int] = []
                for v in vals:
                    flat += list(v) if isinstance(v, tuple) else [int(round(v * 1000)), 1000]
                raw = struct.pack(order + "I" * len(flat), *flat)
            else:
                raw = struct.pack(order + _FMT[typ] * len(vals), *vals)
            count = len(vals)
        if len(raw) <= inline:
            value = raw + b"\0" * (inline - len(raw))
        else:
            value = struct.pack(order + ("Q" if big else "I"), extra_at + len(extra))
            extra += raw + (b"\0" if len(raw) % 2 else b"")
        ents += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, count) + value
    mark = b"II" if order == "<" else b"MM"
    if big:
        hdr = mark + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at)
        ifd = struct.pack(order + "Q", len(entries)) + ents + struct.pack(order + "Q", 0)
    else:
        hdr = mark + struct.pack(order + "HI", 42, ifd_at)
        ifd = struct.pack(order + "H", len(entries)) + ents + struct.pack(order + "I", 0)
    return hdr + body + ifd + extra


def lzw(data: bytes, clear_first: bool = True, end: bool = True) -> bytes:
    """New-style LZW as libtiff's LZWEncode writes it: a clear code first,
    MSB-first codes, the width growing once the next free code passes its
    limit (the decoder's one-code-early change mirrors the entry it adds
    one code late), a clear when the table is full, an end code last."""
    out = bytearray()
    acc = nacc = 0
    table: Dict[int, int] = {}
    nbits, nxt = 9, 258

    def put(code: int):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    if clear_first:
        put(256)
    w = -1
    for c in data:
        if w < 0:
            w = c
            continue
        key = (w << 8) | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        put(w)
        table[key] = nxt
        nxt += 1
        if nxt > 4094:   # LZWEncode: the table is full
            put(256)
            table.clear()
            nbits, nxt = 9, 258
        elif nxt >= 1 << nbits:
            nbits += 1
        w = c
    if w >= 0:
        put(w)
    if end:
        put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


def lzw_tiff(rgb: np.ndarray) -> bytes:
    """An RGB image as cv2.imencode writes a TIFF by default: LZW with the
    horizontal predictor, in strips of max(1, 8192 // (3 * width)) rows."""
    h, w, _ = rgb.shape
    rows = max(1, 8192 // (3 * w))
    diff = rgb.astype(np.int16)
    diff[:, 1:] -= rgb[:, :-1]
    diff = (diff & 255).astype(np.uint8)
    strips = [lzw(diff[y:y + rows].tobytes()) for y in range(0, h, rows)]
    return tiff_file([(256, 4, [w]), (257, 4, [h]), (258, 3, [8, 8, 8]), (259, 3, [5]),
                      (262, 3, [2]), (277, 3, [3]), (278, 4, [rows]), (284, 3, [1]),
                      (317, 3, [2]), (273, 4, "OFFS"), (279, 4, [len(s) for s in strips])],
                     strips)


def lzw_compat(data: bytes) -> bytes:
    """Old-style LZW: LSB-first codes after a clear code, the width growing
    once the next free code passes the width's limit, a clear at 4094."""
    out = bytearray()
    acc = nacc = 0

    def put(code: int, nbits: int):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += nbits
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table: Dict[bytes, int] = {bytes([i]): i for i in range(256)}
    nbits, nxt = 9, 258
    put(256, nbits)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], nbits)
        table[wc] = nxt
        nxt += 1
        if nxt > (1 << nbits) and nbits < 12:
            nbits += 1
        if nxt >= 4094:
            put(256, nbits)
            table = {bytes([i]): i for i in range(256)}
            nbits, nxt = 9, 258
        w = bytes([c])
    if w:
        put(table[w], nbits)
    put(257, nbits)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


# ------------------------------------------------------------------- WebP

def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")


def riff(chunks: Sequence[bytes]) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def _le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def vp8x(w: int, h: int, flags: int) -> bytes:
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _le24(w - 1) + _le24(h - 1))


def anmf(x: int, y: int, w: int, h: int, duration: int, flags: int,
         chunks: Sequence[bytes]) -> bytes:
    return chunk(b"ANMF", _le24(x // 2) + _le24(y // 2) + _le24(w - 1) + _le24(h - 1)
                 + _le24(duration) + bytes([flags]) + b"".join(chunks))


def animation(w: int, h: int, frames: Sequence[bytes], background: int = 0xFFFFFFFF,
              loops: int = 0, alpha: bool = True) -> bytes:
    return riff([vp8x(w, h, 0x02 | (0x10 if alpha else 0)),
                 chunk(b"ANIM", struct.pack("<IH", background, loops))] + list(frames))


def image_chunks(webp: bytes) -> List[bytes]:
    """The ALPH, VP8 and VP8L chunks of a WebP file, padding included."""
    pos, out = 12, []
    while pos + 8 <= len(webp):
        n = struct.unpack_from("<I", webp, pos + 4)[0]
        if webp[pos:pos + 4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out.append(webp[pos:pos + 8 + n + (n & 1)])
        pos += 8 + n + (n & 1)
    return out


# --------------------------------------------------------- cv2's own files

def cv2_tiff_writes(comp: int, rng) -> List[bytes]:
    """Six TIFFs cv2 writes of random images under compression `comp`:
    BGR, gray, 16-bit and BGRA, smooth or noisy, with and without the
    predictor, the last in strips of 3 rows (8 for JPEG)."""
    import cv2
    out = []
    for i in range(6):
        h, w = int(rng.integers(1, 40)), int(rng.integers(1, 50))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 3 == 0:
            img = cv2.GaussianBlur(img, (5, 5), 2)
        src = (img, img[..., 0], img.astype(np.uint16) * 257,
               np.concatenate([img, img[..., :1]], 2))[i % 4]
        if comp == 7 and src.dtype == np.uint16:
            src = img
        params = [cv2.IMWRITE_TIFF_COMPRESSION, comp, cv2.IMWRITE_TIFF_PREDICTOR, 1 + i % 2]
        if i == 5:
            params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, 8 if comp == 7 else 3]   # JPEG: 8
        ok, buf = cv2.imencode(".tiff", src, params)
        assert ok
        out.append(buf.tobytes())
    return out


WEBP_KINDS = ("lossless", "lossy", "lossless_alpha", "lossy_alpha", "animation")


def cv2_webp_writes(kind: str, rng) -> List[bytes]:
    """Five WebPs cv2 writes of random images of `kind` (WEBP_KINDS),
    smooth or noisy, a fifth of the alpha transparent, lossy at qualities
    15-95."""
    import cv2
    out = []
    for i in range(5):
        h, w = int(rng.integers(1, 48)), int(rng.integers(1, 64))
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        if i % 2 == 0:
            img = cv2.GaussianBlur(img, (5, 5), 2)
        img[..., 3] = np.where(rng.random((h, w)) < 0.2, 0, 255)
        if kind == "animation":
            a = cv2.Animation()
            a.frames = [img, np.ascontiguousarray(img[::-1])]
            a.durations = [40, 40]
            ok, buf = cv2.imencodeanimation(".webp", a, [cv2.IMWRITE_WEBP_QUALITY, 100 - 20 * i])
        else:
            src = img if kind.endswith("alpha") else np.ascontiguousarray(img[..., :3])
            params = [] if kind.startswith("lossless") else [cv2.IMWRITE_WEBP_QUALITY, 15 + 20 * i]
            ok, buf = cv2.imencode(".webp", src, params)
        assert ok
        out.append(buf.tobytes())
    return out


def damaged(data: bytes, rng, j: int) -> bytes:
    """Copy j of `data`: cut short at a random length (even j), or with one
    to three bytes replaced at random places (odd j)."""
    m = bytearray(data)
    if j % 2 == 0:
        return bytes(m[:int(rng.integers(1, len(m)))])
    for _ in range(int(rng.integers(1, 4))):
        m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
    return bytes(m)


# ------------------------------------------------------------- C writers

_BUILT: Dict[str, str] = {}


def _writer(name: str, lib: str) -> str:
    if name not in _BUILT:
        d = tempfile.mkdtemp(prefix="torch_tiff_webp_writers_")
        atexit.register(shutil.rmtree, d, True)
        exe = os.path.join(d, name)
        subprocess.run(["gcc", "-O1", os.path.join(TOOLS, name + ".c"), "-o", exe, lib],
                       check=True)
        _BUILT[name] = exe
    return _BUILT[name]


def _pack_rows(a: np.ndarray, bps: int) -> bytes:
    """(rows, n) samples -> rows packed MSB first (bps < 8), or bytes."""
    if bps == 8:
        return a.astype(np.uint8).tobytes()
    if bps == 16:
        return a.astype("<u2").tobytes()
    per = 8 // bps
    rows, n = a.shape
    a = np.concatenate([a, np.zeros((rows, (-n) % per), a.dtype)], 1)
    a = a.reshape(rows, -1, per).astype(np.uint16)
    return (a << (np.arange(per - 1, -1, -1) * bps)).sum(-1).astype(np.uint8).tobytes()


def _ycbcr_block_rows(ycc: np.ndarray, hs: int, vs: int) -> List[np.ndarray]:
    """Packed YCbCr: per block row, each block's hs*vs luma samples then
    its Cb and Cr (the block's top-left chroma), edges replicated."""
    h, w, _ = ycc.shape
    hp, wp = -(-h // vs) * vs, -(-w // hs) * hs
    p = np.zeros((hp, wp, 3), np.uint8)
    p[:h, :w] = ycc
    p[h:, :w] = ycc[h - 1:h]
    p[:, w:] = p[:, w - 1:w]
    rows = []
    for by in range(0, hp, vs):
        rows.append(np.concatenate([np.concatenate([p[by:by + vs, bx:bx + hs, 0].reshape(-1),
                                                    p[by, bx, 1:]])
                                    for bx in range(0, wp, hs)]))
    return rows


def libtiff_file(tags: Sequence[Tuple[int, object]], img: np.ndarray, bps: int = 8,
                 rows_per_strip: int = 0, tile: Tuple[int, int] = (), planar: int = 1,
                 mode: str = "w", ycbcr: Tuple[int, int] = (), pages: Sequence[bytes] = ()
                 ) -> bytes:
    """img (H, W, S) samples written by the system libtiff with the fields
    `tags` ((tag, value or values), set in order after the geometry; a
    codec's own fields after the compression): in strips of
    rows_per_strip rows (0: one strip) or tiles of `tile` (w, h); planar
    2 writes the planes one after another; ycbcr (hs, vs) takes img as
    YCbCr and packs it in sampling blocks. `pages` are further spec lines
    (a "page" line, fields, a "chunks" line) whose data follows."""
    h, w, s = img.shape
    lines = [f"256 {w}", f"257 {h}", f"258 {bps}", f"277 {s}", f"284 {planar}"]
    for tag, vals in tags:
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        lines.append(f"{tag} " + " ".join(str(v) for v in vals))
    chunks: List[bytes] = []
    if ycbcr:
        hs, vs = ycbcr
        block_rows = _ycbcr_block_rows(img, hs, vs)
        r = rows_per_strip or h
        lines.append(f"278 {r}")
        for y in range(0, h, r):
            chunks.append(np.concatenate(block_rows[y // vs:-(-min(y + r, h) // vs)]).tobytes())
    elif tile:
        tw, th = tile
        lines += [f"322 {tw}", f"323 {th}"]
        hp, wp = -(-h // th) * th, -(-w // tw) * tw
        p = np.zeros((hp, wp, s), img.dtype)
        p[:h, :w] = img
        for plane in ([p[..., k:k + 1] for k in range(s)] if planar == 2 else [p]):
            for ty in range(0, hp, th):
                for tx in range(0, wp, tw):
                    chunks.append(_pack_rows(plane[ty:ty + th, tx:tx + tw].reshape(th, -1), bps))
    else:
        r = rows_per_strip or h
        lines.append(f"278 {r}")
        for plane in ([img[..., k:k + 1] for k in range(s)] if planar == 2 else [img]):
            for y in range(0, h, r):
                chunks.append(_pack_rows(plane[y:y + r].reshape(min(r, h - y), -1), bps))
    lines.append("chunks " + " ".join(str(len(c)) for c in chunks))
    data = b"".join(chunks)
    for page in pages:
        spec, extra = page
        lines += spec
        data += extra
    with tempfile.TemporaryDirectory() as d:
        spec_p, data_p, out = (os.path.join(d, n) for n in ("spec", "data", "out.tif"))
        with open(spec_p, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        with open(data_p, "wb") as fh:
            fh.write(data)
        subprocess.run([_writer("torch_tiff_writer", "-ltiff"), out, mode, spec_p, data_p],
                       check=True, capture_output=True)
        with open(out, "rb") as fh:
            return fh.read()


def libwebp_file(rgba: np.ndarray, **settings) -> bytes:
    """rgba (H, W, 4) encoded by the system libwebp with `settings`
    (tools/torch_webp_writer.c's keys)."""
    h, w, _ = rgba.shape
    with tempfile.TemporaryDirectory() as d:
        src, out = os.path.join(d, "rgba"), os.path.join(d, "out.webp")
        with open(src, "wb") as fh:
            fh.write(np.ascontiguousarray(rgba, np.uint8).tobytes())
        subprocess.run([_writer("torch_webp_writer", "-lwebp"), out, str(w), str(h), src]
                       + [f"{k}={v}" for k, v in settings.items()], check=True,
                       capture_output=True)
        with open(out, "rb") as fh:
            return fh.read()
