"""Write real_time_video_deepfake_detection_tpu_torch/ops/hershey.py: cv2's
drawing data, copied out of OpenCV 4.6's libopencv_imgproc.so, which the
port's ops/draw.py reads in place of cv2.

    python tools/extract_hershey.py [--lib PATH] [--out PATH]

What it copies, found by content (no hard offset):

  - HersheySimplex, the index table of FONT_HERSHEY_SIMPLEX (96 int32 in
    .rodata: the font's flags, then one glyph number per character from
    ' ' to '~'): the table whose flags are (9 + 12*16) + FONT_HAVE_GREEK
    and whose entries for ' ', '!' and '"' are 2199, 714 and 717;
  - the glyph strings those numbers name, out of g_HersheyGlyphs, an
    array of char pointers in .data.rel.ro: each pointer is an
    R_X86_64_RELATIVE relocation whose addend is its string's address.
    The array is found by the relocation that points at the glyph of 'A'
    (Hershey number 501, "I[RFJ[ RFZ[ MTWT");
  - the base tables of COLORMAP_JET (three arrays of 256 float32, blue,
    green and red 1024 bytes apart, red starting with 96 zeros and then
    1.5/255 and 5.5/255 as float32).

It needs pyelftools and the library (Debian's libopencv-imgproc406). It
prints the sha256 of the file it wrote; tests/test_torch_draw.py holds the
committed file to a fresh extraction.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import struct

import numpy as np

LIB = "/usr/lib/x86_64-linux-gnu/libopencv_imgproc.so.4.6.0"
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "real_time_video_deepfake_detection_tpu_torch", "ops", "hershey.py")

FONT_HAVE_GREEK = 16 << 8
SIMPLEX_FLAGS = (9 + 12 * 16) + FONT_HAVE_GREEK
GLYPH_A = (501, b"I[RFJ[ RFZ[ MTWT")
R_X86_64_RELATIVE = 8

HEADER = '''"""cv2's drawing data for ops/draw.py: FONT_HERSHEY_SIMPLEX and the base
tables of COLORMAP_JET, copied out of OpenCV 4.6's libopencv_imgproc.so by
tools/extract_hershey.py (rerun it to regenerate this file; do not edit).

SIMPLEX is cv2's HersheySimplex: SIMPLEX[0] holds the font's flags (base
line in bits 0-3, cap line in bits 4-7), SIMPLEX[c - 32 + 1] the glyph
number of the printable ASCII character c. GLYPHS maps each of those glyph
numbers to its string in cv2's g_HersheyGlyphs: two characters for the left
and right bearing, then strokes of point pairs, each coordinate a letter
offset from 'R', strokes separated by a space. JET_B, JET_G and JET_R are the float32 base values of cv2's Jet
colormap (each a float32 value, written exactly as a double).
"""

'''


def _find_all(data: bytes, pat: bytes):
    i = data.find(pat)
    while i >= 0:
        yield i
        i = data.find(pat, i + 1)


def extract(lib_path: str) -> str:
    from elftools.elf.elffile import ELFFile

    with open(lib_path, "rb") as fh:
        data = fh.read()
        elf = ELFFile(fh)
        relocs = {r["r_offset"]: r["r_addend"]
                  for r in elf.get_section_by_name(".rela.dyn").iter_relocations()
                  if r["r_info_type"] == R_X86_64_RELATIVE}
        rodata = elf.get_section_by_name(".rodata")
        ro_addr, ro_off, ro_size = rodata["sh_addr"], rodata["sh_offset"], rodata["sh_size"]

    def cstring(addr: int) -> bytes:
        off = addr - ro_addr + ro_off
        return data[off:data.index(b"\0", off)]

    tables = [np.frombuffer(data, np.int32, 96, i - 4)
              for i in _find_all(data, struct.pack("<3i", 2199, 714, 717))]
    tables = [t for t in tables if t[0] == SIMPLEX_FLAGS]
    if len(tables) != 1:
        raise SystemExit(f"expected one HersheySimplex table, found {len(tables)}")
    simplex = [int(v) for v in tables[0]]

    number, glyph = GLYPH_A
    hits = [off for off, addend in relocs.items()
            if ro_addr <= addend < ro_addr + ro_size and cstring(addend) == glyph]
    # a glyph string can be shared by several numbers (Greek Alpha draws as
    # A): the array is the base whose entries decode the whole table
    glyphs = None
    for hit in hits:
        base = hit - 8 * number
        try:
            cand = {k: cstring(relocs[base + 8 * k]).decode("ascii")
                    for k in sorted(set(simplex[1:]))}
        except KeyError:
            continue
        if cand[simplex[ord("A") - 32 + 1]] == glyph.decode() and \
                cand[simplex[1]] == "JZ":   # the space: no stroke, 16 units wide
            glyphs = cand
            break
    if glyphs is None:
        raise SystemExit("g_HersheyGlyphs not found through the relocations")

    red = data.find(struct.pack("<2f", 1.5 / 255, 5.5 / 255)) - 96 * 4
    if red < 2048 + 96 * 4:
        raise SystemExit("the Jet colormap tables were not found")
    jet = {name: np.frombuffer(data, np.float32, 256, red - k * 1024)
           for k, name in ((2, "JET_B"), (1, "JET_G"), (0, "JET_R"))}
    if not (jet["JET_B"][0] == np.float32(0.5) and jet["JET_R"][:96].max() == 0):
        raise SystemExit("the Jet colormap tables do not look like cv2's")

    out = [HEADER, "SIMPLEX = (\n"]
    for i in range(0, 96, 12):
        out.append("    " + ", ".join(str(v) for v in simplex[i:i + 12]) + ",\n")
    out.append(")\n\nGLYPHS = {\n")
    for k in sorted(glyphs):
        out.append(f"    {k}: {glyphs[k]!r},\n")
    out.append("}\n")
    for name, arr in jet.items():
        out.append(f"\n{name} = (\n")
        vals = [repr(float(v)) for v in arr]   # float32 values, exact in a double
        for i in range(0, 256, 4):
            out.append("    " + ", ".join(vals[i:i + 4]) + ",\n")
        out.append(")\n")
    return "".join(out)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--lib", default=LIB)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    text = extract(args.lib)
    with open(args.out, "w") as fh:
        fh.write(text)
    print(f"{args.out} sha256 {hashlib.sha256(text.encode()).hexdigest()}")


if __name__ == "__main__":
    main()
