"""The port's JPEG 2000 decoder (utils/jpeg2000.py, csrc/jpeg2000.cpp) on
JAX's cv2 route, against cv2 5.0 (its OpenJPEG 2.5.3):

- every fixture of tests/data/torch_jpeg2000 (tools/make_torch_jpeg2000_
  fixtures.py) through utils/image_decode.cv2_route, equal byte for byte to
  cv2.imdecode(..., IMREAD_COLOR) and to the committed digest (None where
  cv2 refuses), decode_frame equal to the JAX server's _decode_frame, and
  the file equal to cv2.imread; the features refused by name refused with
  their reason;
- seeded files Pillow and cv2 write with random settings (most of them
  lossy 9/7 with layers), and cut and byte-flipped copies of them;
- /analyze on the single-stream, host-prep and device-detect apps against
  the JAX apps (status, and every field within test_torch_http's
  tolerance), and the stated difference: a file refused by name is a 400;
- the training loader against JAX's on .png files that hold JPEG 2000.
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
from real_time_video_deepfake_detection_tpu_torch.utils import jpeg2000
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_http import (  # noqa: F401 (fixtures)
    _cfgs, _post, _same_response, jnp_lab, models, ssd,
)
from tests.torch_jpeg2000_writers import damaged, random_cv2_file, random_pillow_file
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg2000")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["inputs"]
FIXTURES = sorted(k for k in DIGESTS if "not_ported" not in DIGESTS[k])
NOT_PORTED = sorted(k for k in DIGESTS if "not_ported" in DIGESTS[k])
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


@pytest.fixture(autouse=True, scope="module")
def _quiet_cv2():
    level = cv2.utils.logging.getLogLevel()
    cv2.utils.logging.setLogLevel(cv2.utils.logging.LOG_LEVEL_SILENT)
    yield
    cv2.utils.logging.setLogLevel(level)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_equals_cv2(name, tmp_path):
    data = _data(name)
    want = _cv2(data)
    assert _digest(want) == DIGESTS[name]["cv2"]
    got = ID.cv2_route(data)
    _same(got, want, name)
    _same(ID.decode_frame(data), JS._decode_frame(data), name)
    path = str(tmp_path / name)
    shutil.copy(os.path.join(DATA, name), path)
    _same(ID.cv2_route(data, from_file=True), cv2.imread(path, cv2.IMREAD_COLOR), name)
    assert not ID.unported_format(data)


@pytest.mark.parametrize("name", NOT_PORTED)
def test_refused_by_name(name):
    """HTJ2K code-blocks and the CAP marker: OpenJPEG decodes them, the port
    names them (ROADMAP, Stated differences)."""
    data = _data(name)
    with pytest.raises(jpeg2000.NotPorted, match=DIGESTS[name]["not_ported"].split(" (")[0]):
        jpeg2000.decode_jpeg2000(data)
    assert ID.cv2_route(data) is None and ID.unported_format(data)


KINDS = [("pillow", s) for s in range(6)] + [("cv2", s) for s in range(2)]


@pytest.mark.parametrize("kind,seed", KINDS)
def test_random_files_and_damage_equal_cv2(kind, seed):
    """Seeded files of random settings, and copies cut short or with bytes
    replaced anywhere in them."""
    rng = np.random.default_rng(2300 + seed + (100 if kind == "cv2" else 0))
    write = random_pillow_file if kind == "pillow" else random_cv2_file
    n = 0
    while n < 10:
        try:
            data = write(rng)
        except (OSError, ValueError, RuntimeError, SystemError):
            continue   # settings the writer refuses
        n += 1
        _same(jpeg2000.decode_jpeg2000(data), _cv2(data), (kind, seed, n))
        for j in range(8):
            m = damaged(data, rng, j)
            _same(ID.cv2_route(m), _cv2(m), (kind, seed, n, j))


def test_signatures_are_cv2s():
    jp2 = _data("j2k_cv2_q1000_83x41.jp2")
    raw = _data("j2k_pil_raw_lossless_83x41.j2k")
    assert jpeg2000.is_jpeg2000(jp2) and jpeg2000.is_jpeg2000(raw)
    assert not jpeg2000.is_jpeg2000(jp2[:11]) and not jpeg2000.is_jpeg2000(b"\xff\x4f\xff\x52")
    for short in (jp2[:12], raw[:4], raw[:40]):
        assert ID.cv2_route(short) is None and _cv2(short) is None


# ------------------------------------------------------------------- the apps

APP_INPUTS = ["j2k_cv2_q1000_83x41.jp2", "j2k_cv2_q100_83x41.jp2", "j2k_cv2_gray_q100_83x41.jp2",
              "j2k_pil_raw_lossy_layers_83x41.j2k", "j2k_pil_rgba_lossy_83x41.jp2",
              "j2k_box_pclr_rgb_83x41.jp2", "j2k_box_colr_sycc_83x41.jp2",
              "j2k_opj_style_all_lossy_83x41.j2k", "j2k_cut_60_refused_83x41.j2k",
              "j2k_pil_signed_refused_83x41.jp2"]


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
    # the stated difference: cv2 decodes the CAP marker's file, the port refuses it by name
    cap = _data("j2k_cap_marker_83x41.j2k")
    assert _post(ja, "/analyze", cap).status_code == 200
    assert _post(ta, "/analyze", cap).status_code == 400


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
            _same_response(_post(ja, "/analyze", _data(k), stream_id="j"),
                           _post(ta, "/analyze", _data(k), stream_id="j"), (mode, k))
    finally:
        je.shutdown()
        te.shutdown()


def test_loader_reads_misnamed_jpeg2000_as_jax(tmp_path):
    """.png files that hold JPEG 2000 (a cut one among them, which both
    loaders substitute): cv2.imread goes by content, and so does the port's
    loader."""
    root = tmp_path / "ds"
    files = {"real": ["j2k_cv2_q1000_83x41.jp2", "j2k_pil_layers_db_83x41.jp2",
                      "j2k_cut_30_refused_83x41.j2k"],
             "fake": ["j2k_cv2_bgra_q50_83x41.jp2", "j2k_pil_raw_lossy_layers_83x41.j2k",
                      "j2k_box_cdef_reversed_83x41.jp2"]}
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
