"""The port's WebP decoder (utils/webp.py; csrc/webp_lossless.cpp for VP8L,
csrc/vp8.cpp for VP8) on JAX's cv2 route, against cv2 5.0 (its bundled
libwebp):

- every WebP fixture of tests/data/torch_tiff_webp (tools/make_torch_tiff_
  webp_fixtures.py) through utils/image_decode.cv2_route, equal byte for
  byte to cv2.imdecode(..., IMREAD_COLOR) and to the committed digest
  (None where cv2 refuses), and decode_frame equal to the JAX server's
  _decode_frame, and to cv2.imread of the file;
- hand-made containers from cv2's chunks: VP8X flags and metadata chunks,
  the ALPH chunk's header bits, raw and cut alpha, two ALPH chunks in
  either order, unknown chunks, RIFF sizes, raw bitstreams, animations
  with offsets, blending, a background colour, a frame past the canvas;
- seeded files cv2 writes (lossless, lossy at several qualities, with
  alpha, animated), and byte-flipped and cut copies of them, against cv2;
- /analyze on the single-stream, host-prep and device-detect apps against
  the JAX apps (status, and every field within test_torch_http's
  tolerance);
- the training loader against JAX's on .png files that hold WebPs.
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
from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
from real_time_video_deepfake_detection_tpu_torch.utils import webp
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_http import (  # noqa: F401 (fixtures)
    _cfgs, _post, _same_response, jnp_lab, models, ssd,
)
from tests.torch_tiff_webp_writers import (
    WEBP_KINDS, animation, anmf, chunk, cv2_webp_writes, damaged, image_chunks, riff, vp8x,
)
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_tiff_webp")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["inputs"]
FIXTURES = sorted(k for k in DIGESTS if k.endswith(".webp"))
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
def test_fixture_equals_cv2(name, tmp_path):
    data = _data(name)
    want = _cv2(data)
    assert _digest(want) == DIGESTS[name]["cv2"]
    _same(ID.cv2_route(data), want, name)
    _same(ID.decode_frame(data), JS._decode_frame(data), name)
    path = str(tmp_path / "f.webp")
    shutil.copy(os.path.join(DATA, name), path)
    _same(ID.cv2_route(data, from_file=True), cv2.imread(path, cv2.IMREAD_COLOR), name)
    assert not ID.unported_format(data)


# ------------------------------------------------------------ hand-made cases

def _cases():
    rng = np.random.default_rng(22)
    h, w = 20, 30
    bgra = cv2.GaussianBlur(rng.integers(0, 256, (h, w, 4), np.uint8), (5, 5), 2)
    bgra[:6, :9, 3] = 0
    bgr = np.ascontiguousarray(bgra[..., :3])
    lossy = image_chunks(cv2.imencode(".webp", bgra, [cv2.IMWRITE_WEBP_QUALITY, 70])[1]
                         .tobytes())
    alph, vp8 = lossy
    lossless = image_chunks(cv2.imencode(".webp", bgra)[1].tobytes())[0]
    plain = image_chunks(cv2.imencode(".webp", bgr, [cv2.IMWRITE_WEBP_QUALITY, 60])[1]
                         .tobytes())[0]
    damaged = bytearray(alph)
    for k in range(12, len(damaged), 3):
        damaged[k] ^= 0x5A
    damaged = bytes(damaged)

    def alph_with_header(byte):
        return alph[:8] + bytes([byte]) + alph[9:]

    raw_alpha = chunk(b"ALPH", bytes([0]) + rng.integers(0, 256, h * w, np.uint8).tobytes())
    raw_short = chunk(b"ALPH", bytes([0]) + bytes(h * w - 1))
    cut_alpha = chunk(b"ALPH", alph[8:8 + 40])
    simple = riff([plain])
    out = {
        "vp8x_lossy_alpha": riff([vp8x(w, h, 0x10), alph, vp8]),
        "vp8x_lossless": riff([vp8x(w, h, 0x10), lossless]),
        "vp8x_no_alpha_flag": riff([vp8x(w, h, 0), alph, vp8]),
        "vp8x_invalid_flag_bit": riff([vp8x(w, h, 0x11), alph, vp8]),
        "vp8x_metadata": riff([vp8x(w, h, 0x3c), chunk(b"ICCP", bytes(21)), alph, vp8,
                               chunk(b"EXIF", b"MM\x00*" + bytes(9)), chunk(b"XMP ", b"<x/>")]),
        "vp8x_unknown_chunks": riff([vp8x(w, h, 0x10), chunk(b"ABCD", bytes(3)), alph,
                                     chunk(b"ZZZZ", b"z"), vp8, chunk(b"TAIL", bytes(2))]),
        "vp8x_wrong_canvas": riff([vp8x(w + 1, h, 0x10), alph, vp8]),
        "vp8x_size_11": riff([chunk(b"VP8X", bytes([0x10, 0, 0, 0]) + struct.pack("<I", w - 1)[:3]
                                    + struct.pack("<I", h - 1)[:3] + b"x"), alph, vp8]),
        "vp8x_only": riff([vp8x(w, h, 0x10)]),
        "alph_reserved_bits": riff([vp8x(w, h, 0x10), alph_with_header(alph[8] | 0x40), vp8]),
        "alph_preprocessing_2": riff([vp8x(w, h, 0x10), alph_with_header(alph[8] | 0x20), vp8]),
        "alph_method_2": riff([vp8x(w, h, 0x10), alph_with_header((alph[8] & ~3) | 2), vp8]),
        "alph_raw": riff([vp8x(w, h, 0x10), raw_alpha, vp8]),
        "alph_raw_short": riff([vp8x(w, h, 0x10), raw_short, vp8]),
        "alph_raw_short_no_flag": riff([vp8x(w, h, 0), raw_short, vp8]),
        "alph_cut": riff([vp8x(w, h, 0x10), cut_alpha, vp8]),
        "alph_damaged": riff([vp8x(w, h, 0x10), damaged, vp8]),
        "alph_damaged_then_good": riff([vp8x(w, h, 0x10), damaged, alph, vp8]),
        "alph_good_then_damaged": riff([vp8x(w, h, 0x10), alph, damaged, vp8]),
        "alph_after_image": riff([vp8x(w, h, 0x10), vp8, alph]),
        "alph_only": riff([vp8x(w, h, 0x10), alph]),
        "alph_empty": riff([vp8x(w, h, 0x10), chunk(b"ALPH", b"\x00"), vp8]),
        "two_images": riff([vp8x(w, h, 0x10), alph, vp8, vp8]),
        "simple_trailing_chunk": riff([plain, chunk(b"EXIF", bytes(6))]),
        "simple_trailing_bytes": simple + b"tail bytes",
        "riff_size_plus_2": simple[:4] + struct.pack("<I", len(simple) - 6) + simple[8:] + b"xy",
        "riff_size_minus_1": simple[:4] + struct.pack("<I", len(simple) - 9) + simple[8:],
        "riff_size_minus_2": simple[:4] + struct.pack("<I", len(simple) - 10) + simple[8:],
        "riff_size_too_large": simple[:4] + struct.pack("<I", len(simple)) + simple[8:],
        "riff_not_webp": simple[:8] + b"WAVE" + simple[12:],
        "chunk_size_past_riff": simple[:16] + struct.pack("<I", len(simple)) + simple[20:],
        "raw_vp8l": lossless[8:] + bytes(30),
        "raw_vp8": plain[8:] + bytes(30),
        "short_31_bytes": simple[:31],
        "vp8_bad_start_code": simple[:23] + b"\x9e" + simple[24:],
        "vp8_not_key_frame": simple[:20] + bytes([simple[20] | 1]) + simple[21:],
        "vp8_not_shown": simple[:20] + bytes([simple[20] & ~0x10]) + simple[21:],
        "vp8_partition_0_too_long": simple[:20] + bytes([simple[20] | 0xE0, 0xFF, 0xFF])
        + simple[23:],
        "vp8l_version_1": riff([lossless[:12] + bytes([lossless[12] | 0x20]) + lossless[13:]]),
        "vp8l_size_differs": riff([lossless[:9] + bytes([(lossless[9] + 1) & 255])
                                   + lossless[10:]]),
        "animation_offset": animation(w + 20, h + 10,
                                      [anmf(8, 4, w, h, 50, 0, [alph, vp8]),
                                       anmf(0, 0, w, h, 50, 0, [alph, vp8])],
                                      background=0xFF102030),
        "animation_blend_no_alpha_flag": animation(w + 20, h + 10, [anmf(20, 10, w, h, 50, 2,
                                                                          [plain])], alpha=False),
        "animation_lossless_dispose": animation(w + 2, h + 2,
                                                [anmf(2, 2, w, h, 50, 1, [lossless])]),
        "animation_past_canvas": animation(w + 2, h + 2, [anmf(4, 0, w, h, 50, 0, [lossless])]),
        "animation_frame_size_differs": animation(w + 20, h + 10, [anmf(0, 0, w - 4, h, 50, 0,
                                                                        [plain])]),
        "animation_without_anim": riff([vp8x(w, h, 0x12), anmf(0, 0, w, h, 50, 0, [plain])]),
        "animation_no_frames": animation(w, h, []),
        "animation_damaged_alpha": animation(w, h, [anmf(0, 0, w, h, 50, 0, [damaged, vp8])]),
        "animation_image_outside_anmf": animation(w, h, [plain]),
        "animation_flag_without_frames_chunk": riff([vp8x(w, h, 0x12),
                                                     chunk(b"ANIM", bytes(6)), alph, vp8]),
    }
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_cv2(name):
    data = CASES[name]
    _same(ID.cv2_route(data), _cv2(data), name)


@pytest.mark.parametrize("kind", WEBP_KINDS)
def test_random_files_and_damage_equal_cv2(kind):
    """Seeded files cv2 writes, and copies cut short or with bytes replaced
    anywhere in them."""
    rng = np.random.default_rng(WEBP_KINDS.index(kind) + 220)
    for k, data in enumerate(cv2_webp_writes(kind, rng)):
        _same(ID.cv2_route(data), _cv2(data), (kind, k))
        for j in range(12):
            m = damaged(data, rng, j)
            _same(ID.cv2_route(m), _cv2(m), (kind, k, j))


def test_signature_is_cv2s():
    simple = _data("webp_cv2_q50_83x41.webp")
    assert webp.is_webp(simple) and not webp.is_webp(simple[:31])
    assert not webp.is_webp(b"RIFF" + bytes(28)) and not webp.is_webp(b"\x89PNG" + bytes(40))


def test_large_frames_equal_cv2():
    """A 1280x720 frame, lossy (with alpha) and lossless: many macroblock
    rows, partitions and Huffman groups."""
    rng = np.random.default_rng(7)
    img = cv2.resize(rng.integers(0, 256, (36, 64, 4), np.uint8), (1280, 720),
                     interpolation=cv2.INTER_CUBIC)
    img[200:260, 300:500, 3] = 40
    for data in (cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, 85])[1].tobytes(),
                 cv2.imencode(".webp", img[..., :3])[1].tobytes()):
        _same(webp.decode_webp(data), _cv2(data))


# ------------------------------------------------------------------- the apps

APP_INPUTS = ["webp_cv2_lossless_83x41.webp", "webp_cv2_q50_83x41.webp",
              "webp_cv2_bgra_q80_83x41.webp", "webp_vp8l_palette16_83x41.webp",
              "webp_vp8_filter0_sharp5_83x41.webp", "webp_cv2_animation_q60_83x41.webp",
              "webp_animation_offset_lossless_83x41.webp", "webp_alph_damaged_refused_83x41.webp",
              "webp_riff_size_short_refused_83x41.webp"]


def test_single_stream_analyze_equals_jax(models, jnp_lab):
    spec_j, pj, spec_t = models
    cj, ct = _cfgs()
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j),
                       JSC(min_request_interval=0.0))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(min_request_interval=0.0))
    codes = []
    for k in APP_INPUTS:
        rj, rt = _post(ja, "/analyze", _data(k)), _post(ta, "/analyze", _data(k))
        _same_response(rj, rt, k)
        codes.append(rt.status_code)
    assert codes.count(400) == 2


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
            _same_response(_post(ja, "/analyze", _data(k), stream_id="w"),
                           _post(ta, "/analyze", _data(k), stream_id="w"), (mode, k))
    finally:
        je.shutdown()
        te.shutdown()


def test_loader_reads_misnamed_webps_as_jax(tmp_path):
    """.png files that hold WebPs (a damaged one among them, which both
    loaders substitute): cv2.imread goes by content, and so does the
    port's loader."""
    root = tmp_path / "ds"
    files = {"real": ["webp_cv2_lossless_83x41.webp", "webp_cv2_q90_83x41.webp",
                      "webp_alph_damaged_refused_83x41.webp"],
             "fake": ["webp_cv2_bgra_q80_83x41.webp", "webp_vp8l_palette4_83x41.webp",
                      "webp_cv2_animation_lossless_83x41.webp"]}
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
