"""The port's TIFF decoder (utils/tiff.py, its loops in csrc/tiff.cpp) on
JAX's cv2 route, against cv2 5.0 (libtiff 4.7.1's RGBA read):

- every TIFF fixture of tests/data/torch_tiff_webp (tools/make_torch_tiff_
  webp_fixtures.py) through utils/image_decode.cv2_route, equal byte for
  byte to cv2.imdecode(..., IMREAD_COLOR) and to the committed digest
  (None where cv2 refuses), and decode_frame equal to the JAX server's
  _decode_frame; the fixtures cv2 reads and the port refuses by name
  (CIELab, CCITT fax 4) refused with their reason;
- hand-made files of libtiff's rules (early and missing end codes, a
  stream without its clear code, short strips, estimated byte counts,
  defaults, YCbCr blocks cut by the scanline size, refusals), each against
  cv2;
- seeded files cv2 writes under each compression, and byte-flipped and
  cut copies of them, against cv2;
- /analyze on the single-stream, host-prep and device-detect apps against
  the JAX apps (status, and every field within test_torch_http's
  tolerance);
- every fixture read as cv2.imread reads a file (the loader's route);
- the training loader against JAX's on .png files that hold TIFFs.
Torch stays on one thread.
"""

import hashlib
import json
import os
import shutil

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
from real_time_video_deepfake_detection_tpu_torch.utils import tiff
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_http import (  # noqa: F401 (fixtures)
    _cfgs, _post, _same_response, jnp_lab, models, ssd,
)
from tests.torch_tiff_webp_writers import cv2_tiff_writes, damaged, lzw, lzw_compat, tiff_file
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_tiff_webp")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["inputs"]
FIXTURES = sorted(k for k in DIGESTS if k.endswith(".tif"))
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
    e = DIGESTS[name]
    assert _digest(want) == e["cv2"]
    if "not_ported" in e:   # cv2 reads it; the port refuses it by name
        assert want is not None
        with pytest.raises(tiff.NotPorted, match=e["not_ported"]):
            tiff.decode_tiff(data)
        assert ID.cv2_route(data) is None and ID.unported_format(data)
        return
    _same(ID.cv2_route(data), want, name)
    _same(ID.decode_frame(data), JS._decode_frame(data), name)
    assert not ID.unported_format(data)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_read_from_file_equals_imread(name, tmp_path):
    """cv2.imread of the file (libtiff maps it): the loader's route."""
    if "not_ported" in DIGESTS[name]:
        return
    path = str(tmp_path / "f.tif")
    shutil.copy(os.path.join(DATA, name), path)
    _same(ID.cv2_route(_data(name), from_file=True), cv2.imread(path, cv2.IMREAD_COLOR), name)


# ------------------------------------------------------------ hand-made cases

def _strips(w, h, spp, bps, strips, rps, comp=1, photo=2, extra=(), order="<", counts=None,
            offsets="OFFS"):
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp), (259, 3, [comp]),
               (277, 3, [spp]), (278, 4, [rps]), (273, 4, offsets),
               (279, 4, counts if counts is not None else [len(s) for s in strips])]
    if photo is not None:
        entries.append((262, 3, [photo]))
    return tiff_file(entries + list(extra), strips, order)


def _cases():
    rng = np.random.default_rng(22)
    img = rng.integers(0, 256, (13, 21, 3), np.uint8)
    raw = img.tobytes()
    rows = [img[y:y + 5].tobytes() for y in range(0, 13, 5)]
    lzw_rows = [lzw(r) for r in rows]
    ycc = rng.integers(0, 256, 4 * 4 + 2, np.uint8).tobytes()
    cmap = list(rng.integers(0, 65536, 768))
    return {
        "lzw": _strips(21, 13, 3, 8, lzw_rows, 5, comp=5),
        "lzw_no_clear_code": _strips(21, 13, 3, 8, [lzw(r, clear_first=False) for r in rows], 5,
                                     comp=5),
        "lzw_no_end_code": _strips(21, 13, 3, 8, [lzw(r, end=False) for r in rows], 5, comp=5),
        "lzw_early_end_code": _strips(21, 13, 3, 8, [lzw(r[:100]) for r in rows], 5, comp=5),
        "lzw_cut": _strips(21, 13, 3, 8, [s[:len(s) // 2] for s in lzw_rows], 5, comp=5),
        "lzw_cut_predictor": _strips(21, 13, 3, 8, [s[:len(s) // 2] for s in lzw_rows], 5,
                                     comp=5, extra=[(317, 3, [2])]),
        "lzw_compat_two_strips": _strips(21, 13, 3, 8, [lzw_compat(r) for r in rows], 5, comp=5),
        "lzw_compat_then_new": _strips(21, 13, 3, 8, [lzw_compat(rows[0])] + lzw_rows[1:], 5,
                                       comp=5),
        "lzw_new_then_compat": _strips(21, 13, 3, 8, lzw_rows[:1] + [lzw_compat(r)
                                                                     for r in rows[1:]], 5,
                                       comp=5),
        "packbits_short": _strips(21, 13, 3, 8, [b"\x7f" + r[:128] for r in rows], 5,
                                  comp=32773),
        "packbits_runs": _strips(21, 13, 3, 8, [bytes([0x81, 7]) * 3 + b"\x80" * 2 + bytes(
            [0x02, 1, 2, 3]) + bytes([0xa0, 9]) * 12 for _ in rows], 5, comp=32773),
        "none_short_strip": _strips(21, 13, 3, 8, [rows[0], rows[1][:100], rows[2]], 5),
        "none_one_strip_no_counts": tiff_file([(256, 4, [21]), (257, 4, [13]), (258, 3, [8] * 3),
                                               (262, 3, [2]), (277, 3, [3]), (273, 4, "OFFS")],
                                              [raw]),
        "none_one_strip_bogus_count": _strips(21, 13, 3, 8, [raw], 13, counts=[0]),
        "none_one_strip_short_count": _strips(21, 13, 3, 8, [raw], 13, counts=[500]),
        "none_offset_past_end": _strips(21, 13, 3, 8, rows, 5, counts=[len(rows[0])] * 2 + [9999]),
        "no_photometric": _strips(21, 13, 3, 8, rows, 5, photo=None),
        "palette_without_colormap": _strips(21, 13, 1, 8, [r[:105] for r in rows], 5, photo=3),
        "palette_8bit_two_samples": _strips(21, 13, 2, 8, [r[:210] for r in rows], 5, photo=3,
                                            extra=[(320, 3, cmap)]),
        "rgb_four_samples_no_extra": _strips(21, 13, 4, 8, [raw + raw[:273]], 13),
        "rgb_unassociated_alpha": _strips(21, 13, 4, 8, [raw + raw[:273]], 13,
                                          extra=[(338, 3, [2])]),
        "gray_three_samples": _strips(21, 13, 3, 8, rows, 5, photo=1),
        "bits_per_sample_differ": tiff_file([(256, 4, [21]), (257, 4, [13]), (258, 3, [8, 8, 16]),
                                             (262, 3, [2]), (277, 3, [3]), (278, 4, [13]),
                                             (273, 4, "OFFS"), (279, 4, [len(raw)])], [raw]),
        "orientation_9": _strips(21, 13, 3, 8, rows, 5, extra=[(274, 3, [9])]),
        "rows_per_strip_0": _strips(21, 13, 3, 8, rows, 0),
        "rows_per_strip_past_height": _strips(21, 13, 3, 8, [raw], 100),
        "cmyk_inkset_2": _strips(21, 13, 4, 8, [raw + raw[:273]], 13, photo=5,
                                 extra=[(332, 3, [2])]),
        "cmyk_16bit": _strips(21, 13, 4, 16, [raw * 3], 13, photo=5),
        "ycbcr44_width1": _strips(1, 4, 3, 8, [ycc], 4, photo=6, extra=[(530, 3, [4, 4])]),
        "ycbcr22_odd": _strips(3, 3, 3, 8, [rng.integers(0, 256, 24, np.uint8).tobytes()], 3,
                               photo=6, extra=[(530, 3, [2, 2])]),
        "ycbcr24_refused": _strips(4, 4, 3, 8, [bytes(40)], 4, photo=6,
                                   extra=[(530, 3, [2, 4])]),
        "ycbcr_refbw_zero_range": _strips(4, 4, 3, 8, [rng.integers(0, 256, 48, np.uint8)
                                                       .tobytes()], 4, photo=6,
                                          extra=[(530, 3, [1, 1]),
                                                 (532, 5, [(5, 1), (5, 1), (128, 1), (9, 1),
                                                           (100, 1), (300, 1)])]),
        "big_endian_16bit": _strips(21, 13, 3, 16, [raw * 2], 13, order=">"),
        "predictor_3_refused": _strips(21, 13, 3, 8, lzw_rows, 5, comp=5, extra=[(317, 3, [3])]),
        "float_samples": _strips(21, 13, 1, 32, [raw + bytes(273)], 13, photo=1,
                                 extra=[(339, 3, [3])]),
        "signed_16bit": _strips(21, 13, 1, 16, [raw[:546]], 13, photo=1, extra=[(339, 3, [2])]),
        "bits_12_refused": _strips(21, 13, 1, 12, [raw[:410]], 13, photo=1),
        "webp_compression_refused": _strips(21, 13, 3, 8, rows, 5, comp=50001),
        # horAcc8's "(cc%stride)!=0": a YCbCr 4x2 row of 10 bytes, stride 3
        "ycbcr42_predictor_row_size": _strips(5, 4, 3, 8, [lzw(bytes(range(20)))], 4, comp=5,
                                              photo=6, extra=[(530, 3, [4, 2]), (317, 3, [2])]),
        # TileOffsets after StripOffsets: both fill one field, the later wins
        "tile_offsets_in_a_stripped_file": _strips(21, 13, 3, 8, rows, 5,
                                                   extra=[(324, 4, [1, 2, 3])]),
        "no_byte_counts_two_strips": tiff_file([(256, 4, [21]), (257, 4, [13]),
                                                (258, 3, [8] * 3), (259, 3, [5]), (262, 3, [2]),
                                                (277, 3, [3]), (278, 4, [5]), (273, 4, "OFFS")],
                                               lzw_rows),
        "no_byte_counts_one_strip": tiff_file([(256, 4, [21]), (257, 4, [13]), (258, 3, [8] * 3),
                                               (259, 3, [5]), (262, 3, [2]), (277, 3, [3]),
                                               (273, 4, "OFFS")], [lzw(raw)]),
        "byte_counts_past_strip_count": _strips(21, 13, 3, 8, [rows[0] + rows[1] + rows[2]], 13,
                                                counts=[len(raw), 5]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_equals_cv2(name):
    data = CASES[name]
    _same(ID.cv2_route(data), _cv2(data), name)


@pytest.mark.parametrize("comp", [1, 5, 7, 8, 32773, 32946])
def test_random_files_and_damage_equal_cv2(comp):
    """Seeded files cv2 writes, and copies cut short or with bytes replaced
    anywhere in them."""
    rng = np.random.default_rng(comp)
    for k, data in enumerate(cv2_tiff_writes(comp, rng)):
        _same(ID.cv2_route(data), _cv2(data), (comp, k))
        for j in range(10):
            m = damaged(data, rng, j)
            _same(ID.cv2_route(m), _cv2(m), (comp, k, j))


def test_signatures():
    assert tiff.is_tiff(b"II*\x00\x08\x00") and tiff.is_tiff(b"MM\x00*\x00")
    assert tiff.is_tiff(b"II+\x00") and tiff.is_tiff(b"MM\x00+")
    assert not tiff.is_tiff(b"II*") and not tiff.is_tiff(b"IM*\x00")


# ------------------------------------------------------------------- the apps

APP_INPUTS = ["tiff_cv2_lzw_pred_83x41.tif", "tiff_cv2_jpeg_83x41.tif",
              "tiff_jpeg_ycbcr420_83x41.tif", "tiff_palette4_map16_83x41.tif",
              "tiff_ycbcr22_83x41.tif", "tiff_cmyk_planar_83x41.tif",
              "tiff_gray16_miniswhite_tiles_83x41.tif", "tiff_orientation6_tiles_83x41.tif",
              "tiff_rgba16_unassoc_83x41.tif", "tiff_zstd_refused_83x41.tif",
              "tiff_gray2_refused_83x41.tif"]
NOT_PORTED = [k for k in FIXTURES if "not_ported" in DIGESTS[k]]


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
    for k in NOT_PORTED:   # refused by name: JAX's cv2 reads them
        assert _post(ta, "/analyze", _data(k)).status_code == 400


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
            _same_response(_post(ja, "/analyze", _data(k), stream_id="t"),
                           _post(ta, "/analyze", _data(k), stream_id="t"), (mode, k))
    finally:
        je.shutdown()
        te.shutdown()


def test_loader_reads_misnamed_tiffs_as_jax(tmp_path):
    """.png files that hold TIFFs: cv2.imread goes by content, and so does
    the port's loader (an orientation of 5-8 cv2.imread refuses; 16x16
    uncompressed tiles it reads from the mapped file)."""
    root = tmp_path / "ds"
    files = {"real": ["tiff_cv2_lzw_83x41.tif", "tiff_ycbcr42_83x41.tif",
                      "tiff_orientation5_83x41.tif", "tiff_tiles_none_refused_83x41.tif"],
             "fake": ["tiff_cv2_deflate_pred_16bit_83x41.tif", "tiff_palette8_map8_83x41.tif",
                      "tiff_jpeg_rgb_83x41.tif"]}
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
