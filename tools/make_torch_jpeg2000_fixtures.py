"""Write the fixtures of the port's JPEG 2000 decoder into
tests/data/torch_jpeg2000/, with digests.json: for every file, the sha256 and
shape of cv2.imdecode(..., IMREAD_COLOR), or null where cv2 refuses it, so
that a machine without cv2 (chip_smoke.py on the card's) holds the port's
decode to cv2's; "not_ported" marks the files the port refuses by name
(their reason), whatever cv2 makes of them.

    python tools/make_torch_jpeg2000_fixtures.py

The inputs, 83x41 frames of tools/make_torch_format_fixtures.frame:
- what cv2 5.0 writes itself: BGR at compressions 1000 (reversible), 500,
  100, 20 and 1, gray, BGRA and 16-bit;
- what Pillow writes through its OpenJPEG: raw codestreams, L, LA, RGBA
  and I;16, tiles (smaller than the image, of odd sizes, one pixel), the
  five progressions with layers, layers by rate and by quality, mct on both
  transforms and off, code-block and precinct sizes at their limits, one
  and six resolutions, PLT, a comment, and a signed image (refused);
- what the system libopenjp2 writes through tools/torch_jpeg2000_writer.c:
  each code-block style (bypass, reset, termall, vertical causal,
  predictable termination, segmentation symbols, all at once), SOP and EPH,
  POC, an ROI shift, tile-parts split by resolution, layer and component,
  PLT and TLM, 10- and 12-bit samples, and what cv2 refuses: subsampled
  components, an image offset;
- JP2 boxes built by hand around those codestreams: each colr method and
  enumerated space, a palette (pclr + cmap, 8-, 12- and 16-bit entries),
  channel definitions that reorder, XL and zero-length boxes, misplaced,
  missing and doubled boxes;
- codestreams edited by hand: cut short, an origin other than 0, and the
  features refused by name (HTJ2K code-blocks, the CAP marker);
- chip_smoke.py's decode-time inputs: the 720x405 and 1920x1080 frames of
  the JPEG fixtures, reversible and at cv2's compression 100.

Needs cv2 (5.0.0), Pillow, gcc and the system's libopenjp2.so.7;
deterministic from its seed.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_jpeg2000")
SEED = 23

from make_torch_format_fixtures import frame  # noqa: E402
from tests.torch_jpeg2000_writers import (  # noqa: E402
    FTYP_BOX, PROGRESSIONS, SIGNATURE_BOX, box, cdef, cmap, codestream_of, colr, cv2_file,
    ihdr, jp2, opj_file, pclr, pillow_file,
)

H, W = 41, 83
NOT_PORTED = {"j2k_htj2k_cblk_style_83x41.j2k": "HTJ2K (Part 15) code-blocks",
              "j2k_cap_marker_83x41.j2k": "HTJ2K (Part 15) capabilities marker (CAP)"}


def cv2_inputs(bgr: np.ndarray) -> dict:
    out = {}
    for q in (1000, 500, 100, 20, 1):
        out[f"j2k_cv2_q{q}_83x41.jp2"] = cv2_file(bgr, q)
    out["j2k_cv2_gray_q1000_83x41.jp2"] = cv2_file(bgr[..., 1], 1000)
    out["j2k_cv2_gray_q100_83x41.jp2"] = cv2_file(bgr[..., 1], 100)
    bgra = np.dstack([bgr, (bgr[..., 0] // 2 + 60).astype(np.uint8)])
    out["j2k_cv2_bgra_q1000_83x41.jp2"] = cv2_file(bgra, 1000)
    out["j2k_cv2_bgra_q50_83x41.jp2"] = cv2_file(bgra, 50)
    b16 = bgr.astype(np.uint16) * 257 + np.arange(W, dtype=np.uint16)[None, :, None]
    out["j2k_cv2_16bit_q1000_83x41.jp2"] = cv2_file(b16, 1000)
    out["j2k_cv2_16bit_gray_q300_83x41.jp2"] = cv2_file(b16[..., 2], 300)
    return out


def pillow_inputs(bgr: np.ndarray) -> dict:
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    rgba = np.dstack([rgb, (rgb[..., 1] // 3 + 100).astype(np.uint8)])
    out = {}

    def put(name, img, mode, **kw):
        size = "83x41" if img.shape[:2] == (H, W) else f"{img.shape[1]}x{img.shape[0]}"
        out[f"j2k_pil_{name}_{size}.{'j2k' if kw.get('no_jp2') else 'jp2'}"] = \
            pillow_file(img, mode, **kw)

    put("raw_lossless", rgb, "RGB", no_jp2=True)
    put("raw_lossy_layers", rgb, "RGB", no_jp2=True, irreversible=True,
        quality_mode="rates", quality_layers=[40, 15, 5])
    put("gray", rgb[..., 1], "L")
    put("gray_lossy", rgb[..., 1], "L", irreversible=True, quality_mode="dB",
        quality_layers=[30, 38])
    put("la", np.ascontiguousarray(rgba[..., 1::2]), "LA")
    put("rgba", rgba, "RGBA")
    put("rgba_lossy", rgba, "RGBA", irreversible=True, quality_mode="rates",
        quality_layers=[20])
    put("i16", (rgb[..., 0].astype(np.uint16) * 251), "I;16")
    put("i16_lossy", (rgb[..., 0].astype(np.uint16) * 251), "I;16", irreversible=True,
        quality_mode="rates", quality_layers=[10])
    put("tiles_32x16", rgb, "RGB", tile_size=(32, 16), num_resolutions=4)
    put("tiles_33x17_lossy", rgb, "RGB", tile_size=(33, 17), num_resolutions=4,
        irreversible=True, quality_mode="rates", quality_layers=[12, 3])
    put("tiles_1x1", rgb[:6, :7], "RGB", tile_size=(1, 1), num_resolutions=1)
    put("tiles_offset", rgb, "RGB", tile_size=(16, 16), tile_offset=(0, 0), num_resolutions=3)
    put("one_pixel", rgb[:1, :1], "RGB", num_resolutions=1)
    for prog in PROGRESSIONS:
        put(f"{prog.lower()}_layers_lossy", rgb, "RGB", progression=prog, irreversible=True,
            quality_mode="rates", quality_layers=[30, 10, 3], num_resolutions=5,
            precinct_size=(16, 16), codeblock_size=(8, 8))
        put(f"{prog.lower()}_lossless", rgb, "RGB", progression=prog, num_resolutions=4,
            precinct_size=(32, 32), codeblock_size=(16, 16))
    put("layers_rates", rgb, "RGB", quality_mode="rates", quality_layers=[50, 20, 8, 2])
    put("layers_db", rgb, "RGB", irreversible=True, quality_mode="dB",
        quality_layers=[25, 32, 40])
    put("mct_reversible", rgb, "RGB", mct=1)
    put("mct_irreversible", rgb, "RGB", mct=1, irreversible=True)
    put("mct_off_irreversible", rgb, "RGB", mct=0, irreversible=True)
    put("cblk_4x4", rgb, "RGB", codeblock_size=(4, 4))
    put("cblk_1024x4", rgb, "RGB", codeblock_size=(1024, 4), irreversible=True)
    put("cblk_4x1024", rgb, "RGB", codeblock_size=(4, 1024))
    put("precinct_2x2", rgb, "RGB", precinct_size=(2, 2), codeblock_size=(4, 4),
        num_resolutions=3)
    put("precinct_32768", rgb, "RGB", precinct_size=(32768, 32768))
    put("precinct_8x4_cblk_16", rgb, "RGB", precinct_size=(8, 4), codeblock_size=(16, 16),
        irreversible=True)
    put("numres_1", rgb, "RGB", num_resolutions=1)
    put("numres_6", rgb, "RGB", num_resolutions=6, irreversible=True)
    put("plt", rgb, "RGB", plt=True, irreversible=True, quality_mode="rates",
        quality_layers=[20, 5])
    put("comment", rgb, "RGB", comment="a comment marker")
    put("signed_refused", rgb, "RGB", signed=True)
    return out


def opj_inputs(bgr: np.ndarray) -> dict:
    rgb = bgr[..., ::-1]
    out = {}

    def put(name, img=rgb, prec=8, jp2_format=False, **kw):
        out[f"j2k_opj_{name}_83x41.{'jp2' if jp2_format else 'j2k'}"] = \
            opj_file(img, prec, jp2_format, **kw)

    for bit, name in ((1, "bypass"), (2, "reset"), (4, "termall"), (8, "vsc"),
                      (16, "pterm"), (32, "segsym")):
        put(f"style_{name}", mode=bit)
        put(f"style_{name}_lossy_layers", mode=bit, irreversible=1, rates=[30, 10, 3])
    put("style_all", mode=63, rates=[40, 12, 0])
    put("style_all_lossy", mode=63, irreversible=1, rates=[25, 6])
    put("sop", csty=2, rates=[20, 5, 1])
    put("eph", csty=4, rates=[20, 5, 1])
    put("sop_eph_lossy", csty=6, irreversible=1, rates=[30, 8, 2], prog="RPCL")
    put("roi_shift", roi=(0, 5))
    put("roi_shift_lossy", roi=(1, 8), irreversible=1, rates=[15])
    put("poc_two", poc="RLCP,0,0,1,3,3;LRCP,0,0,2,6,3", rates=[20, 1])
    put("poc_components", poc="CPRL,0,0,1,6,2;RPCL,0,2,1,6,3")
    for tp in "RLC":
        put(f"tile_parts_{tp}", tp=tp, rates=[30, 10, 2], tile=(48, 32), numres=3)
    put("plt_tlm", plt=1, tlm=1, tile=(40, 24), numres=3)
    put("prec10_gray", (rgb[..., 1].astype(np.int32) * 4 + 3), 10, True)
    put("prec12", (rgb.astype(np.int32) * 16 + 5), 12, True, irreversible=1, rates=[8])
    put("prec7_refused", rgb // 2, 7, True)
    put("subsampled_refused", subsampling=(2, 2))
    put("offset_refused", offset=(3, 5))
    return out


def _sizs(cs: bytes) -> int:
    return cs.index(b"\xff\x51")


def edited_inputs(bgr: np.ndarray, base: dict) -> dict:
    """Hand-built JP2 boxes around the codestreams, and edited codestreams."""
    rgb3 = codestream_of(base["j2k_pil_raw_lossless_83x41.j2k"])
    lossy3 = codestream_of(base["j2k_pil_raw_lossy_layers_83x41.j2k"])
    gray1 = codestream_of(base["j2k_pil_gray_83x41.jp2"])
    rgba4 = codestream_of(base["j2k_pil_rgba_83x41.jp2"])
    idx = (bgr[..., 2] >> 4).astype(np.uint8)
    idx1 = codestream_of(pillow_file(idx, "L", no_jp2=True))
    pal = np.stack([np.arange(16) * 16, 255 - np.arange(16) * 15, (np.arange(16) * 37) % 256], -1)
    three = [(0, 1, 0), (0, 1, 1), (0, 1, 2)]
    h3, h1, h4 = ihdr(W, H, 3), ihdr(W, H, 1), ihdr(W, H, 4)
    sig = SIGNATURE_BOX + FTYP_BOX
    out = {}

    def put(name, data):
        out[f"j2k_box_{name}_83x41.jp2"] = data

    for e, name in ((16, "srgb"), (17, "gray"), (18, "sycc"), (12, "cmyk_refused"),
                    (24, "esycc_refused"), (14, "cielab"), (99, "unknown")):
        put(f"colr_{name}", jp2(lossy3 if e == 18 else rgb3, [h3, colr(e)]))
    put("colr_gray_one_component", jp2(gray1, [h1, colr(17)]))
    put("colr_srgb_one_component_refused", jp2(gray1, [h1, colr(16)]))
    put("colr_icc", jp2(rgb3, [h3, colr(meth=2, icc=bytes(range(40)))]))
    put("colr_method3_then_gray", jp2(rgb3, [h3, colr(meth=3), colr(17)]))
    put("colr_two_first_counts", jp2(rgb3, [h3, colr(17), colr(16)]))
    put("colr_missing", jp2(rgb3, [h3]))
    put("pclr_rgb", jp2(idx1, [h1, colr(16), pclr(pal, [8, 8, 8]), cmap(three)]))
    put("pclr_12bit", jp2(idx1, [h1, colr(16), pclr(pal * 16, [12, 12, 12]), cmap(three)]))
    put("pclr_16bit", jp2(idx1, [h1, colr(16), pclr(pal * 257, [16, 16, 16]), cmap(three)]))
    put("pclr_short_palette", jp2(idx1, [h1, colr(16), pclr(pal[:5], [8, 8, 8]), cmap(three)]))
    put("pclr_gray", jp2(idx1, [h1, colr(17), pclr(pal[:, :1], [8]), cmap([(0, 1, 0)])]))
    put("pclr_cmap_fixed_up", jp2(idx1, [h1, colr(16), pclr(pal, [8, 8, 8]),
                                         cmap([(0, 0, 0)] * 3)]))
    put("pclr_direct_and_mapped", jp2(rgb3, [h3, colr(16), pclr(pal, [8, 8, 8]),
                                             cmap([(1, 0, 0), (0, 1, 1), (2, 0, 0)])]))
    put("pclr_without_cmap_refused", jp2(idx1, [h1, colr(16), pclr(pal, [8, 8, 8])]))
    put("pclr_bad_component_refused", jp2(idx1, [h1, colr(16), pclr(pal, [8, 8, 8]),
                                                 cmap([(0, 1, 0), (1, 1, 1), (0, 1, 2)])]))
    put("cmap_before_pclr_refused", jp2(idx1, [h1, colr(16), cmap(three),
                                               pclr(pal, [8, 8, 8])]))
    put("cdef_reversed", jp2(rgb3, [h3, colr(16), cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)])]))
    put("cdef_alpha_first", jp2(rgba4, [h4, colr(16), cdef([(0, 1, 0), (1, 0, 1), (2, 0, 2),
                                                            (3, 0, 3)])]))
    put("cdef_asoc_65535", jp2(rgb3, [h3, colr(16), cdef([(0, 0, 65535), (1, 0, 2),
                                                          (2, 0, 1)])]))
    put("cdef_incomplete_refused", jp2(rgb3, [h3, colr(16), cdef([(0, 0, 1), (1, 0, 2)])]))
    put("cdef_two_refused", jp2(rgb3, [h3, colr(16), cdef([(0, 0, 3), (1, 0, 2), (2, 0, 1)]),
                                       cdef([(0, 0, 1), (1, 0, 2), (2, 0, 3)])]))
    put("jp2c_xl", jp2(rgb3, [h3, colr(16)], jp2c_form="xl"))
    put("jp2c_zero_length", jp2(lossy3, [h3, colr(16)], jp2c_form="zero"))
    put("jp2h_xl", sig + box(b"jp2h", h3 + colr(16), "xl") + box(b"jp2c", rgb3))
    put("ihdr_xl", sig + box(b"jp2h", box(b"ihdr", h3[8:], "xl") + colr(16)) + box(b"jp2c", rgb3))
    put("res_and_unknown_in_jp2h", jp2(rgb3, [h3, colr(16), box(b"res ", box(b"resc", bytes(10))),
                                              box(b"abcd", b"xyz")]))
    put("xml_before_jp2h", jp2(rgb3, [h3, colr(16)], before=[box(b"xml ", b"<a/>")]))
    put("boxes_after_jp2c", jp2(rgb3, [h3, colr(16)], after=[box(b"xml ", b"<a/>"),
                                                              box(b"free", bytes(30))]))
    put("colr_before_jp2h_skipped", jp2(rgb3, [h3], before=[colr(17)]))
    put("colr_after_jp2h_read", sig + box(b"jp2h", h3) + colr(17) + box(b"jp2c", rgb3))
    put("bpcc", jp2(rgb3, [ihdr(W, H, 3, 255), box(b"bpcc", bytes([7, 7, 7])), colr(16)]))
    put("two_jp2h", sig + box(b"jp2h", h3 + colr(16)) + box(b"jp2h", h3 + colr(17))
        + box(b"jp2c", rgb3))
    put("ihdr_other_component_count", jp2(rgb3, [ihdr(W, H, 1), colr(16)]))
    put("ihdr_other_size_refused", jp2(rgb3, [ihdr(W + 1, H, 3), colr(16)]))
    put("ihdr_missing_refused", jp2(rgb3, [colr(16)]))
    put("jp2h_missing_refused", sig + box(b"jp2c", rgb3))
    put("ftyp_twice_refused", SIGNATURE_BOX + FTYP_BOX + FTYP_BOX + box(b"jp2h", h3 + colr(16))
        + box(b"jp2c", rgb3))
    put("ftyp_missing_refused", SIGNATURE_BOX + box(b"jp2h", h3 + colr(16)) + box(b"jp2c", rgb3))
    put("jp2h_trailing_bytes_refused", jp2(rgb3, [h3, colr(16), b"\0\0\0\0"]))
    put("no_eoc_refused", jp2(rgb3[:-2], [h3, colr(16)]))

    def raw(name, data):
        out[f"j2k_{name}_83x41.j2k"] = data

    raw("trailing_bytes", rgb3 + b"trailing bytes")

    # main-header marker segments inserted after QCD (or COD)
    def seg(marker, payload):
        return struct.pack(">HH", marker, len(payload) + 2) + payload

    def after(cs, marker, blob):
        i = cs.index(struct.pack(">H", marker))
        return cs[:i + 2 + struct.unpack_from(">H", cs, i + 2)[0]] + blob + \
            cs[i + 2 + struct.unpack_from(">H", cs, i + 2)[0]:]

    cod = rgb3.index(b"\xff\x52")
    spcod = bytearray(rgb3[cod + 9:cod + 2 + struct.unpack_from(">H", rgb3, cod + 2)[0]])
    spcod[1] -= 1   # comp 2's code-blocks half as wide
    raw("coc_code_blocks", after(rgb3, 0xFF52, seg(0xFF53, bytes([2, 0]) + bytes(spcod))))
    qcd = lossy3.index(b"\xff\x5c")
    sqcd = bytearray(lossy3[qcd + 4:qcd + 2 + struct.unpack_from(">H", lossy3, qcd + 2)[0]])
    sqcd[0] = (sqcd[0] & 0x1F) | (1 << 5)   # one guard bit
    raw("qcc_guard_bits", after(lossy3, 0xFF5C, seg(0xFF5D, bytes([1]) + bytes(sqcd))))
    raw("rgn_main_header", after(lossy3, 0xFF5C, seg(0xFF5E, bytes([0, 0, 3]))))
    raw("poc_main_header", after(rgb3, 0xFF5C, seg(0xFF5F, bytes([0, 0, 0, 1, 3, 3, 1,
                                                                  0, 0, 0, 2, 33, 3, 0]))))
    raw("tlm_malformed", after(rgb3, 0xFF5C, seg(0xFF55, bytes([0, 0x20]) + bytes(6))))
    # tile-parts re-cut by hand from a tiled codestream (OpenJPEG's look-ahead
    # for a TNsot one short runs once, at the first complete tile, when that
    # tile came in several parts)
    tiled = codestream_of(base["j2k_pil_tiles_32x16_83x41.jp2"])
    parts, at = [], tiled.index(b"\xff\x90")
    head = tiled[:at]
    while tiled[at:at + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", tiled, at + 6)[0]
        parts.append(tiled[at + 12:at + psot])   # SOD and the data
        at += psot

    def sot(tile, body, part, num):
        return b"\xff\x90" + struct.pack(">HHIBB", 10, tile, 12 + len(body), part, num) + body

    def split(tile, num, n=3):
        return b"".join(sot(tile, b"\xff\x93", p, num) for p in range(n - 1)) + \
            sot(tile, parts[tile], n - 1, num)

    rest = b"".join(sot(t, parts[t], 0, 1) for t in range(2, len(parts))) + b"\xff\xd9"
    raw("tile_parts_tnsot_one_short", head + split(0, 2) + sot(1, parts[1], 0, 1) + rest)
    raw("tile_parts_tnsot_zero", head + split(0, 0) + split(1, 0) + rest)
    raw("tile_parts_one_short_after_single_refused",
        head + sot(0, parts[0], 0, 1) + split(1, 2) + rest)
    raw("tile_parts_cut_after_first_tile_refused", head + split(0, 3) + b"\xff\x90")
    raw("tile_parts_single_cut_after_first_tile", head + sot(0, parts[0], 0, 1) + b"\xff\x90")
    raw("eoc_replaced_by_sot", rgb3[:-2] + b"\xff\x90")
    for frac in (30, 60, 99):
        raw(f"cut_{frac}_refused", lossy3[:len(lossy3) * frac // 100])
    s = _sizs(rgb3) + 4   # the SIZ segment's parameters
    siz = bytearray(rgb3)
    x1, y1 = struct.unpack_from(">II", siz, s + 2)
    struct.pack_into(">IIII", siz, s + 2, x1 + 2, y1 + 1, 2, 1)
    raw("origin_refused", bytes(siz))
    # COD's code-block style byte: the HT bit
    c = rgb3.index(b"\xff\x52") + 4
    ht = bytearray(rgb3)
    ht[c + 8] |= 0x40
    raw("htj2k_cblk_style", bytes(ht))
    at = rgb3.index(b"\xff\x52")
    raw("cap_marker", rgb3[:at] + b"\xff\x50" + struct.pack(">HIH", 8, 0x00020000, 0)
        + rgb3[at:])
    return out


def timing_inputs() -> dict:
    out = {}
    for name, jpg in (("720x405", "torch_jpeg/frame_720x405_q85_420.jpg"),
                      ("1920x1080", "torch_formats/prog_420_1920x1080.jpg")):
        img = cv2.imread(os.path.join(REPO, "tests", "data", jpg), cv2.IMREAD_COLOR)
        out[f"j2k_timing_lossless_{name}.jp2"] = cv2_file(img, 1000)
        out[f"j2k_timing_q100_{name}.jp2"] = cv2_file(img, 100)
    return out


def digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def main():
    os.makedirs(OUT, exist_ok=True)
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    rng = np.random.default_rng(SEED)
    bgr = frame(H, W, rng)
    files = {**cv2_inputs(bgr), **pillow_inputs(bgr), **opj_inputs(bgr)}
    files.update(edited_inputs(bgr, files))
    files.update(timing_inputs())
    digests = {}
    for name, data in sorted(files.items()):
        with open(os.path.join(OUT, name), "wb") as fh:
            fh.write(data)
        try:
            img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error:
            img = None
        digests[name] = {"cv2": digest(img), "bytes": len(data)}
        if name in NOT_PORTED:
            digests[name]["not_ported"] = NOT_PORTED[name]
        if "refused" in name:
            assert img is None, name
        print(f"{name:56s} {len(data):8d} bytes  cv2 {None if img is None else img.shape}")
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "inputs": digests}, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    main()
