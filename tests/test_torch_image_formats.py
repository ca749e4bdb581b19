"""The port's PxM, PAM, PFM, Sun raster, Radiance HDR and GIF decoders
(utils/pxm.py, utils/sunras.py, utils/hdr.py, utils/gif.py, their loops in
csrc/image_host.cpp) on JAX's cv2 route, against cv2 5.0:

- every fixture of tests/data/torch_image_formats (tools/make_torch_image_
  formats_fixtures.py) through utils/image_decode.cv2_route, equal byte for
  byte to cv2.imdecode(..., IMREAD_COLOR) and to the committed digest, and
  decode_frame equal to the JAX server's _decode_frame;
- hand-made cases of each decoder's rules (ASCII rescaling and clipping,
  16-bit samples, P1 digits, comments, PAM's header and bit mode, PFM's
  scale, byte order and rounding, Sun raster colormaps and the types cv2
  refuses, HDR headers, run lengths and rounding ties, GIF palettes,
  background, transparency, interlace and the structure cv2 checks), each
  against cv2;
- seeded files cv2 writes, and byte-flipped and cut copies of them (GIF:
  clean streams only; see utils/gif.py on the malformed LZW streams cv2
  5.0 reads), against cv2;
- unported_format still naming OpenEXR and AVIF and none of these,
  WebP, TIFF and JPEG 2000 decoded;
- /analyze on the single-stream app, the host-prep app and the
  device-detect app against the JAX apps (status, and every field within
  test_torch_http's tolerance; a gray PFM, which cv2 returns with one
  channel, by status only);
- the training loader against JAX's on a dataset whose .png files hold a
  PPM, a GIF and a Sun raster.
Torch stays on one thread.
"""

import hashlib
import json
import os
import shutil
import struct

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu.serving import multi as JM
from real_time_video_deepfake_detection_tpu.serving import server as JS
from real_time_video_deepfake_detection_tpu.train import data as JD
import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.core.config import ServerConfig as JSC
from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig as TSC
from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.serving import server as TS
from real_time_video_deepfake_detection_tpu_torch.train import data as TD
from real_time_video_deepfake_detection_tpu_torch.utils import gif, hdr, pxm, sunras
from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_http import (  # noqa: F401 (fixtures)
    _cfgs, _post, _same_response, jnp_lab, models, ssd,
)
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_image_formats")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["inputs"]
FIXTURES = sorted(DIGESTS)
CAPTURE = (240, 320)


def _data(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def _cv2(data: bytes):
    """cv2.imdecode(data, IMREAD_COLOR); None where it refuses or raises."""
    try:
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except cv2.error:
        return None


def _same(got, want, what=""):
    if want is None:
        assert got is None, what
    else:
        assert got is not None and got.shape == want.shape, (what, None if got is None else
                                                             got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=str(what))


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_equals_cv2(name):
    data = _data(name)
    want = _cv2(data)
    assert _digest(want) == DIGESTS[name]["cv2"]
    _same(ID.cv2_route(data), want, name)
    _same(ID.decode_frame(data), JS._decode_frame(data), name)


# ------------------------------------------------------------ hand-made cases

def _pam(w, h, depth, maxval, tupl, data, magic=b"P7\n"):
    head = b"WIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (w, h, depth, maxval)
    return magic + head + (b"TUPLTYPE " + tupl + b"\n" if tupl else b"") + b"ENDHDR\n" + \
        bytes(data)


def _ras(w, h, depth, kind, maptype, cmap, data):
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind, maptype,
                       len(cmap)) + bytes(cmap) + bytes(data)


def _hdr(head, w, h, px):
    return head + b"\n\n-Y %d +X %d\n" % (h, w) + bytes(px)


def _pfm(magic, w, h, scale, values, order="<f4"):
    return magic + b"%d %d\n%s\n" % (w, h, scale) + np.array(values, order).tobytes()


def _lzw_bits(codes):
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


def _gif(w, h, idx, gpal=None, lpal=None, ms=2, x=0, y=0, bg=0, exts=b"", interlace=False,
         trans=None, codes=None, version=b"GIF89a", trailer=b"\x3b"):
    """A one-image GIF; `codes` (code, width) pairs replace the literal
    codes written for `idx` (a clear code before each, as a reset keeps the
    widths fixed)."""
    idx = np.asarray(idx, np.uint8)
    fh, fw = idx.shape
    flags, gp = 0, b""
    if gpal is not None:
        n = len(gpal)
        flags = 0x80 | (n.bit_length() - 2)
        gp = np.asarray(gpal, np.uint8).tobytes()
    out = version + struct.pack("<HHBBB", w, h, flags, bg, 0) + gp + exts
    if trans is not None:
        out += b"\x21\xf9\x04\x01\x00\x00" + bytes([trans]) + b"\x00"
    lflags, lp = (0x40 if interlace else 0), b""
    if lpal is not None:
        lflags |= 0x80 | (len(lpal).bit_length() - 2)
        lp = np.asarray(lpal, np.uint8).tobytes()
    rows = idx
    if interlace:
        rows = idx[list(range(0, fh, 8)) + list(range(4, fh, 8)) + list(range(2, fh, 4))
                   + list(range(1, fh, 2))]
    clear = 1 << ms
    if codes is None:   # each pixel a literal behind a clear: widths stay ms + 1
        codes = []
        for k in rows.reshape(-1):
            codes += [(clear, ms + 1), (int(k), ms + 1)]
        codes.append((clear + 1, ms + 1))
    data = _lzw_bits(codes)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255)) + b"\0"
    return out + b"\x2c" + struct.pack("<HHHHB", x, y, fw, fh, lflags) + lp + bytes([ms]) + \
        blocks + trailer


def _cases():
    rng = np.random.default_rng(4)
    f32 = lambda *v: np.array(v, "<f4").tobytes()   # noqa: E731
    pal4 = rng.integers(0, 256, (4, 3))
    idx23 = rng.integers(0, 4, (2, 3))
    cases = {
        # PBM / PGM / PPM
        "pgm_ascii_rescaled": b"P2\n2 1\n100\n50 100\n",
        "pgm_binary_kept": b"P5\n2 1\n100\n" + bytes([50, 100]),
        "pgm_ascii_16bit": b"P2\n2 1\n1000\n333 1000\n",
        "pgm_binary_16bit": b"P5\n2 1\n1000\n" + bytes([1, 77, 3, 232]),
        "pgm_ascii_clipped": b"P2\n2 1\n100\n150 20\n",
        "pbm_ascii": b"P1\n3 1\n1 0 1\n",
        "pbm_ascii_digits": b"P1\n3 1\n12 0 ",
        "pbm_binary_rows": b"P4\n10 2\n" + bytes([0xFF, 0xC0, 0x0F, 0x00]),
        "ppm_ascii_rgb": b"P3\n1 1\n255\n10 20 30\n",
        "ppm_16bit_clipped": b"P3\n1 1\n1000\n333 1000 2000 ",
        "pgm_spaces": b"P5 2 1 255 " + bytes([7, 8]),
        "pgm_comment": b"P5\n# comment\n2 1\n255\n" + bytes([7, 8]),
        "pgm_comment_glued": b"P5\n2#c\n 1\n255\n" + bytes([7, 8]),
        "pgm_comment_in_data": b"P2\n2 1\n255\n7 #x\r8 ",
        "pgm_no_trailing_space": b"P2\n2 1\n255\n7 8",
        "pgm_short": b"P5\n2 1\n255\n" + bytes([7]),
        "pgm_two_spaces": b"P5\n2 1\n255  " + bytes([7, 8]),
        "pgm_maxval_0": b"P5\n1 1\n0\n" + bytes([7]),
        "pgm_maxval_65536": b"P2\n1 1\n65536\n7\n",
        "pgm_number_too_big": b"P2\n1 1\n255\n99999999999 ",
        "pgm_signature_comment": b"P5#c\n1 1 255 " + bytes([7]),
        # PAM
        "pam_rgb_unswapped": _pam(2, 1, 3, 255, b"RGB", [1, 2, 3, 4, 5, 6]),
        "pam_gray_maxval100": _pam(2, 1, 1, 100, b"GRAYSCALE", [50, 100]),
        "pam_bits": _pam(10, 2, 1, 1, b"BLACKANDWHITE",
                         [0xFF, 0xC0] + [0] * 8 + [0x0F, 0x01] + [7] * 8),
        "pam_rgb_bits": _pam(3, 1, 3, 1, b"RGB", [0b10110011] + [0] * 8),
        "pam_rgb16": _pam(2, 1, 3, 65535, b"RGB", range(1, 13)),
        "pam_gray16": _pam(2, 1, 1, 65535, b"GRAYSCALE", [1, 2, 3, 4]),
        "pam_no_tupltype_16bit": _pam(2, 1, 1, 65535, None, [1, 2, 3, 4]),
        "pam_no_tupltype_depth4": _pam(2, 1, 4, 255, None, range(1, 9)),
        "pam_gray_depth3": _pam(2, 1, 3, 255, b"GRAYSCALE", range(1, 7)),
        "pam_crlf": b"P7\r\nWIDTH 2\r\nHEIGHT 1\r\nDEPTH 1\r\nMAXVAL 255\r\nENDHDR\r\n" +
                    bytes([5, 6]),
        "pam_magic_space": _pam(2, 1, 1, 255, None, [5, 6], magic=b"P7 "),
        "pam_field_twice": b"P7\nWIDTH 3\nWIDTH 1\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n" +
                           bytes([1, 2, 3]),
        "pam_unknown_field": b"P7\nWIDTH 1\nFOO 3\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n" +
                             bytes([1, 2, 3]),
        "pam_bad_number": b"P7\nWIDTH 1x\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nENDHDR\n" +
                          bytes([1, 2, 3]),
        "pam_comments": b"P7\n#hi\nWIDTH 2\n# c\nHEIGHT 1\nDEPTH 1\nMAXVAL 255\nENDHDR\n" +
                        bytes([5, 6]),
        "pam_lowercase_tupltype": _pam(1, 1, 3, 255, b"rgb", [5, 6, 7]),
        "pam_short": _pam(2, 1, 1, 255, None, [5]),
        # PFM
        "pfm_rounding": _pfm(b"PF\n", 1, 1, b"-1.0", [0.5, 1.5, 2.5]),
        "pfm_saturation": _pfm(b"PF\n", 1, 1, b"-1", [0.853, 1.7, 300.0]),
        "pfm_scale2": _pfm(b"PF\n", 1, 1, b"-2.0", [0.853, 1.7, 300.0]),
        "pfm_scale3": _pfm(b"PF\n", 1, 1, b"-3", [3.0, 7.5, 1.5]),
        "pfm_big_endian": _pfm(b"PF\n", 1, 1, b"1.0", [0.853, 1.7, -3.0], ">f4"),
        "pfm_nan_inf": b"PF\n1 1\n-1\n" + f32(np.nan, np.inf, -np.inf),
        "pfm_out_of_int": b"PF\n1 1\n-1\n" + f32(3e9, -3e9, 255.5),
        "pfm_rows_bottom_up": b"PF\n1 2\n-1\n" + f32(1, 2, 3, 4, 5, 6),
        "pfm_gray": b"Pf\n2 2\n-1.0\n" + f32(1, 2, 3, 4),
        "pfm_scale_0": _pfm(b"PF\n", 1, 1, b"0", [1, 2, 3]),
        "pfm_token_junk": b"PF\n1x 1\n-1.0x\n" + f32(1.4, 2.6, 3.5),
        "pfm_token_high_byte": b"PF\n2\xd2 1\n-1\n" + f32(1, 2, 3, 4, 5, 6),
        "pfm_crlf": b"PF\r\n1 1\n-1.0\n" + f32(1, 2, 3),
        "pfm_short": b"PF\n1 1\n-1\n" + f32(1, 2),
        # Sun raster
        "ras24_std": _ras(2, 1, 24, 1, 0, b"", [1, 2, 3, 4, 5, 6]),
        "ras24_odd_width_padding": _ras(1, 2, 24, 1, 0, b"", [1, 2, 3, 0, 4, 5, 6, 0]),
        "ras32": _ras(2, 1, 32, 1, 0, b"", range(1, 9)),
        "ras8_gray": _ras(3, 2, 8, 1, 0, b"", [1, 2, 3, 99, 4, 5, 6, 99]),
        "ras8_colormap": _ras(3, 1, 8, 1, 1, bytes(range(256)) + bytes(range(255, -1, -1)) +
                              bytes([7] * 256), [10, 20, 30, 0]),
        "ras8_short_colormap": _ras(2, 1, 8, 1, 1, bytes(range(200, 255)) + bytes(range(244)),
                                    [1, 5]),
        "ras8_colormap_299": _ras(2, 1, 8, 1, 1, bytes(range(256)) + bytes(range(43)),
                                  [1, 5]),
        "ras1_gray": _ras(10, 1, 1, 1, 0, b"", [0xA5, 0xC0]),
        "ras1_colormap": _ras(10, 1, 1, 1, 1, [10, 200, 20, 100, 30, 50], [0xA5, 0xC0]),
        "ras1_colormap_3": _ras(8, 1, 1, 1, 1, [10, 20, 30], [0xF0, 0]),
        "ras1_colormap_too_long": _ras(8, 1, 1, 1, 1, range(9), [0xF0, 0]),
        "ras_rle": _ras(4, 1, 8, 2, 0, b"", [0x80, 2, 9, 5]),
        "ras_rgb": _ras(2, 1, 24, 3, 0, b"", [1, 2, 3, 4, 5, 6]),
        "ras_type_4": _ras(1, 1, 24, 4, 0, b"", [1, 2, 3, 0]),
        "ras_colormap_type_2": _ras(1, 1, 8, 1, 2, bytes(768), [1, 0]),
        "ras_nomap_length": struct.pack(">8I", 0x59A66A95, 1, 1, 8, 2, 1, 0, 3) +
                            bytes([1, 2, 3, 7, 0]),
        "ras_depth_4": _ras(2, 1, 4, 1, 0, b"", [0x12, 0]),
        "ras_short": _ras(2, 2, 24, 1, 0, b"", range(7)),
        # Radiance HDR
        "hdr_radiance": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe", 2, 1,
                             [218, 128, 2, 128, 0, 0, 0, 0]),
        "hdr_rgbe": _hdr(b"#?RGBE\nFORMAT=32-bit_rle_rgbe", 2, 1, [218, 128, 2, 128, 0, 0, 0, 0]),
        "hdr_ties": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe", 2, 1,
                         [128, 1, 255, 128, 128, 3, 7, 136]),
        "hdr_exposure_comment": _hdr(b"#?RADIANCE\n# c\nEXPOSURE=2.0\nFORMAT=32-bit_rle_rgbe",
                                     2, 1, [9, 8, 7, 140, 1, 2, 3, 100]),
        "hdr_other_program": _hdr(b"#?FOO\nFORMAT=32-bit_rle_rgbe", 2, 1, [1] * 8),
        "hdr_no_format": _hdr(b"#?RADIANCE\nEXPOSURE=1.0", 2, 1, [1] * 8),
        "hdr_xyze": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_xyze", 2, 1, [1] * 8),
        "hdr_plus_y": b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n+Y 1 +X 2\n" + bytes(8),
        "hdr_short": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe", 2, 2, [1] * 8),
        "hdr_rle_runs": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe", 8, 1,
                             [2, 2, 0, 8] + [136, 200] + [2, 5, 6] + [134, 7] + [8] + list(range(8))
                             + [136, 130]),
        "hdr_rle_bad_width": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe", 8, 1,
                                  [2, 2, 0, 9] + [136, 200] * 4),
        "hdr_rle_then_flat": _hdr(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe", 8, 2,
                                  [2, 2, 0, 8] + [136, 50] * 4 + list(range(1, 33))),
        # GIF
        "gif_global": _gif(3, 2, idx23, gpal=pal4),
        "gif87a": _gif(3, 2, idx23, gpal=pal4, version=b"GIF87a"),
        "gif_local": _gif(3, 2, idx23, gpal=pal4, lpal=pal4[::-1]),
        "gif_local_only": _gif(3, 2, idx23, lpal=pal4),
        "gif_no_palette": _gif(4, 1, [[0, 1, 2, 3]]),
        "gif_interlace": _gif(3, 9, rng.integers(0, 4, (9, 3)), gpal=pal4, interlace=True),
        "gif_background_transparent": _gif(4, 3, [[0, 1], [2, 3]], gpal=pal4, x=1, y=1, bg=2,
                                           trans=0),
        "gif_local_background_black": _gif(3, 2, [[0, 1]], lpal=pal4, x=1, y=1, bg=2),
        "gif_background_past_palette": _gif(3, 2, [[0, 1]], gpal=pal4, x=1, y=1, bg=9),
        "gif_index_past_local_palette": _gif(3, 2, idx23 + 4, gpal=np.concatenate([pal4, pal4]),
                                             ms=3, lpal=pal4[::-1]),
        "gif_index_past_both_palettes": _gif(3, 2, idx23 + 4, ms=3, lpal=pal4),
        "gif_image_past_screen": _gif(2, 1, [[0, 1, 2]], gpal=pal4),
        "gif_no_trailer": _gif(3, 2, idx23, gpal=pal4, trailer=b""),
        "gif_stray_byte": _gif(3, 2, idx23, gpal=pal4, exts=b"\x00"),
        "gif_comment": _gif(3, 2, idx23, gpal=pal4, exts=b"\x21\xfe\x02ab\x03cde\x00"),
        "gif_netscape": _gif(3, 2, idx23, gpal=pal4,
                             exts=b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"),
        "gif_app_other": _gif(3, 2, idx23, gpal=pal4,
                              exts=b"\x21\xff\x0bXMP DataXMP\x03\x01\x00\x00\x00"),
        "gif_app_short": _gif(3, 2, idx23, gpal=pal4, exts=b"\x21\xff\x05abcde\x00"),
        "gif_control_5": _gif(3, 2, idx23, gpal=pal4, exts=b"\x21\xf9\x05" + bytes(6)),
        "gif_disposal_7": _gif(3, 2, idx23, gpal=pal4, exts=b"\x21\xf9\x04\x1c\x00\x00\x00\x00"),
        "gif_min_size_1": _gif(3, 2, idx23 % 2, gpal=pal4[:2], ms=1),
        "gif_min_size_9": _gif(3, 2, idx23, gpal=pal4, ms=9),
        "gif_no_end_code": _gif(3, 2, idx23, gpal=pal4, codes=[(4, 3), (1, 3), (2, 3), (0, 3),
                                                                (3, 4), (2, 4), (1, 4)]),
        "gif_early_end_code": _gif(3, 2, idx23, gpal=pal4, codes=[(4, 3), (1, 3), (5, 3)]),
        "gif_bad_code": _gif(3, 2, idx23, gpal=pal4, codes=[(4, 3), (7, 3), (5, 3)]),
    }
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_cv2(name):
    data = CASES[name]
    _same(ID.cv2_route(data), _cv2(data), name)


def _writes(kind: str, rng):
    """Files cv2 writes of random images of kind `kind`."""
    out = []
    for i in range(12):
        h, w = int(rng.integers(1, 30)), int(rng.integers(1, 40))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if i % 4 == 0:
            img[:] = img[:1, :1]
        gray = img[..., 0] if i % 3 else img
        ext, src, params = {
            "pgm": (".pgm", img[..., 0], [cv2.IMWRITE_PXM_BINARY, i % 2]),
            "ppm": (".ppm", img, [cv2.IMWRITE_PXM_BINARY, i % 2]),
            "pbm": (".pbm", img[..., 1], [cv2.IMWRITE_PXM_BINARY, i % 2]),
            "pam": (".pam", gray, []),
            "pfm": (".pfm", img.astype(np.float32) / 97, []),
            "ras": (".ras", gray, []),
            "hdr": (".hdr", (img.astype(np.float32) / 97) ** 2,
                    [cv2.IMWRITE_HDR_COMPRESSION, i % 2]),
            "gif": (".gif", img, []),
        }[kind]
        ok, buf = cv2.imencode(ext, src, params)
        assert ok
        out.append(buf.tobytes())
    return out


@pytest.mark.parametrize("kind", ["pgm", "ppm", "pbm", "pam", "pfm", "ras", "hdr", "gif"])
def test_random_files_and_damage_equal_cv2(kind):
    """Seeded files cv2 writes, and copies cut short or with bytes replaced
    (not for GIF, whose malformed LZW streams cv2 reads differently)."""
    rng = np.random.default_rng(["pgm", "ppm", "pbm", "pam", "pfm", "ras", "hdr",
                                 "gif"].index(kind))
    for k, data in enumerate(_writes(kind, rng)):
        _same(ID.cv2_route(data), _cv2(data), (kind, k))
        if kind == "gif":
            continue
        for j in range(8):
            m = bytearray(data)
            if j % 2 == 0:
                m = m[:int(rng.integers(1, len(m)))]
            else:
                for _ in range(int(rng.integers(1, 4))):
                    m[int(rng.integers(0, len(m)))] = int(rng.integers(0, 256))
            _same(ID.cv2_route(bytes(m)), _cv2(bytes(m)), (kind, k, j))


def test_gif_lzw_round_trips_a_full_table():
    """A 256-colour frame whose codes fill the 4096-entry table, written
    with a clear code at the full table and without one (the table then
    takes no more entries), equals cv2's decode."""
    from tests.torch_gif_writer import gif as write_gif
    rng = np.random.default_rng(7)
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, (120, 160))
    for clear in (True, False):
        data = write_gif(160, 120, [dict(idx=idx, clear_at_full=clear)], gpal=pal)
        want = _cv2(data)
        np.testing.assert_array_equal(want, pal[idx][..., ::-1].astype(np.uint8))
        _same(gif.decode_gif(data), want)


def test_signatures_of_the_formats_still_unported():
    """WebP, TIFF and JPEG 2000 are decoded now (tests/test_torch_webp.py,
    tests/test_torch_tiff.py, tests/test_torch_jpeg2000.py); AVIF, which
    cv2 reads, and OpenEXR, which this cv2 build does not read either, are
    still refused by their signatures."""
    for data in (b"\x76\x2f\x31\x01\x02", b"\x00\x00\x00\x1cftypavif"):
        assert ID.unported_format(data)
    for data in (b"\x00\x00\x00\x0cjP  \r\n\x87\n", b"\xff\x4f\xff\x51\x00"):
        assert not ID.unported_format(data) and ID.cv2_route(data) is None
    decoded = {"torch_tiff_webp": ("webp_cv2_q50_83x41.webp", "webp_cv2_lossless_83x41.webp",
                                   "tiff_cv2_lzw_83x41.tif", "tiff_bigtiff_be_83x41.tif"),
               "torch_jpeg2000": ("j2k_cv2_q1000_83x41.jp2", "j2k_pil_raw_lossless_83x41.j2k")}
    for folder, names in decoded.items():
        for name in names:
            with open(os.path.join(os.path.dirname(DATA), folder, name), "rb") as fh:
                data = fh.read()
            assert not ID.unported_format(data) and ID.cv2_route(data) is not None, name
    for name in FIXTURES:
        assert not ID.unported_format(_data(name)), name
    assert pxm.is_pxm(b"P6\n") and pxm.is_pam(b"P7\n") and pxm.is_pfm(b"Pf\n")
    assert hdr.SIGNATURES and sunras.SIGNATURE == b"\x59\xa6\x6a\x95"


# ------------------------------------------------------------------- the apps

APP_INPUTS = ["p1_ascii_83x41.pbm", "p2_comment_maxval100_83x41.pgm", "p6_16bit_83x41.ppm",
              "pam_blackandwhite_83x41.pam", "pam_rgb16_83x41.pam",
              "pfm_bigendian_scale2_83x41.pfm", "ras8_colormap_83x41.ras",
              "ras_rle_refused_83x41.ras", "hdr_rle_cv2_83x41.hdr", "hdr_xyze_refused_83x41.hdr",
              "gif_transparent_offset_83x41.gif", "gif_interlaced_83x41.gif",
              "gif_index_past_palette_refused_83x41.gif", "pfm_gray_83x41.pfm"]
GRAY_PFM = "pfm_gray_83x41.pfm"


def _check(rj, rt, name, mode=None):
    if name == GRAY_PFM:   # cv2's one channel: JAX analyses the 2-D array as it is
        assert (rt.status_code, rj.status_code) == (200, 200)
        return
    _same_response(rj, rt, (mode, name))


def test_single_stream_analyze_equals_jax(models, jnp_lab):
    spec_j, pj, spec_t = models
    cj, ct = _cfgs()
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j),
                       JSC(min_request_interval=0.0))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(min_request_interval=0.0))
    codes = []
    for k in APP_INPUTS:   # the gray PFM last: the trackers' states stay equal before it
        rj, rt = _post(ja, "/analyze", _data(k)), _post(ta, "/analyze", _data(k))
        _check(rj, rt, k)
        codes.append(rt.status_code)
    assert codes.count(400) == 3


@pytest.mark.parametrize("mode", ["host_prep", "device_detect"])
def test_batched_app_equals_jax(models, ssd, jnp_lab, mode):
    spec_j, pj, spec_t = models
    skw = dict(max_streams=4, max_batch=4, batch_timeout_ms=2.0, min_request_interval=0.0)
    if mode == "device_detect":
        cj, ct = _cfgs(clahe_device=True)
        skw.update(device_detect=True, detect_capture_hw=CAPTURE)
        ekw_j, ekw_t = dict(ssd_net=ssd[0].net), dict(ssd_net=ssd[1].net)
    else:
        cj, ct = _cfgs(face_backend="heuristic")
        ekw_j, ekw_t = {}, {}
    je = JM.MultiStreamEngine(cj, JSC(**skw), params=pj, spec=spec_j, **ekw_j)
    te = TM.MultiStreamEngine(ct, TSC(**skw), params=params_from_jax(pj), spec=spec_t,
                              device="cpu", **ekw_t)
    ja, ta = JM.create_batched_app(je, je.server_cfg), TM.create_batched_app(te, te.server_cfg)
    try:
        for k in APP_INPUTS:
            _check(_post(ja, "/analyze", _data(k), stream_id="f"),
                   _post(ta, "/analyze", _data(k), stream_id="f"), k, mode)
    finally:
        je.shutdown()
        te.shutdown()


def test_loader_reads_misnamed_files_as_jax(tmp_path):
    """.png files that hold a PPM, a GIF, a Sun raster and an HDR: cv2.imread
    goes by content, and so does the port's loader."""
    root = tmp_path / "ds"
    files = {"real": ["p6_83x41.ppm", "gif_cv2_83x41.gif", "p3_ascii_83x41.ppm"],
             "fake": ["ras24_cv2_83x41.ras", "hdr_rle_cv2_83x41.hdr", "pam_rgb_cv2_83x41.pam"]}
    for split in ("train", "val"):
        for label, names in files.items():
            d = root / split / label
            os.makedirs(d)
            for name in names:
                shutil.copy(os.path.join(DATA, name), d / (name.split(".")[0] + ".png"))
    for split, kw in (("train", dict(shuffle=True, balanced=True)),
                      ("val", dict(shuffle=False, drop_last=False))):
        jl = JD.BatchLoader(JD.DeepfakeDataset(str(root), split, 32), 4, seed=3, num_workers=2,
                            **kw)
        tl = TD.BatchLoader(TD.DeepfakeDataset(str(root), split, 32), 4, seed=3, num_workers=2,
                            **kw)
        assert jl.ds.samples == tl.ds.samples and len(jl) == len(tl) > 0
        for (xj, yj), (xt, yt) in zip(jl, tl):
            np.testing.assert_array_equal(xt.numpy(), xj)
            np.testing.assert_array_equal(yt, yj)
