"""The one-call host prep of host-prep serving (utils/native_prep.prep_frame,
csrc/prep_host.cpp) against the JAX package's (utils/native_ingest.
prep_frame, native/ingest.cpp) byte for byte: the analysis frame, the face
box and the aligned face, on every committed JPEG fixture (progressive and
truncated ones too) and on seeded synthetic JPEGs of other sizes and
samplings; each stage against its Python counterpart (decode_jpeg,
resize_analysis, detect_heuristic, preprocess_face_quality with the
native Lab rung, the resize aligner); and the engine's route: analyze_jpeg
takes the one call under the JAX engine's eligibility rule and answers as
analyze does with the native rung, and takes decode -> analyze otherwise."""

import os

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu.utils import native_ingest as JN
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
from real_time_video_deepfake_detection_tpu_torch.models.heuristic_face import detect_heuristic
from real_time_video_deepfake_detection_tpu_torch.models.mtcnn import (
    MTCNNAligner, init_random_mtcnn,
)
from real_time_video_deepfake_detection_tpu_torch.pipeline import detector as t_detector
from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import (
    _ResizeAligner, preprocess_face_quality,
)
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.utils.host_resize import resize_analysis
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
from real_time_video_deepfake_detection_tpu_torch.utils.native_prep import prep_frame
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import small_specs

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
REFUSED = ("progressive_720x405_q85.jpg", "truncated_720x405_q85.jpg")
FIXTURES = sorted(n for n in os.listdir(DATA) if n.endswith(".jpg") and n not in REFUSED)
HAAR_DIR = os.path.join(os.path.dirname(DATA), "torch_haar")


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _synthetic_jpeg(seed: int) -> bytes:
    """A seeded frame of odd size with a skin-coloured ellipse, JPEG-coded
    at one of three samplings, with restart markers on some."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(90, 300)), int(rng.integers(90, 300))
    yy, xx = np.mgrid[:h, :w]
    f = 100 + 40 * np.sin(xx / 13.0 + seed) * np.cos(yy / 19.0)
    f = np.repeat((f + rng.integers(-10, 11, (h, w)))[..., None], 3, axis=2)
    cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.35, 0.65) * w
    m = ((xx - cx) / (0.22 * w)) ** 2 + ((yy - cy) / (0.3 * h)) ** 2 <= 1.0
    f[m] = np.array([120, 150, 205]) + rng.integers(-12, 13, (int(m.sum()), 3))
    img = np.clip(f, 0, 255).astype(np.uint8)
    sampling = (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    params = [cv2.IMWRITE_JPEG_QUALITY, int(rng.integers(60, 96)),
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[seed % 3]]
    if seed % 4 == 1:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _python_route(data: bytes, analysis_hw=(256, 256)):
    """The same prep as the engine's analyze with the native Lab rung."""
    frame = decode_jpeg(data)
    small = resize_analysis(frame, *analysis_hw)
    faces = detect_heuristic(frame)
    if not faces:
        return small, None, None
    x, y, w, h = faces[0]
    crop = preprocess_face_quality(frame[y:y + h, x:x + w], lab_backend="native")
    return small, _ResizeAligner()(crop).astype(np.uint8), faces[0]


def _assert_same(got, want):
    assert got is not None and want is not None
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == (None if want[2] is None else tuple(int(v) for v in want[2]))
    if want[1] is None:
        assert got[1] is None
    else:
        assert got[1].dtype == np.uint8 and got[1].shape == want[1].shape
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", FIXTURES)
def test_prep_frame_equals_jax_on_the_fixtures(name):
    data = _read(name)
    _assert_same(prep_frame(data, (256, 256), 160), JN.prep_frame(data, (256, 256), 160))


def test_the_fixtures_hold_faces():
    boxes = [prep_frame(_read(n))[2] for n in FIXTURES]
    assert sum(b is not None for b in boxes) >= 10


@pytest.mark.parametrize("seed", range(8))
def test_prep_frame_equals_jax_on_synthetic_jpegs(seed):
    data = _synthetic_jpeg(seed)
    for hw, align in (((256, 256), 160), ((64, 80), 96)):
        got = prep_frame(data, hw, align)
        _assert_same(got, JN.prep_frame(data, hw, align))
    assert got[2] is not None   # the ellipse is found


@pytest.mark.parametrize("name", FIXTURES + ["synthetic"])
def test_prep_frame_stages_equal_the_python_route(name):
    data = _synthetic_jpeg(11) if name == "synthetic" else _read(name)
    _assert_same(prep_frame(data, (256, 256), 160), _python_route(data))


@pytest.mark.parametrize("name", REFUSED + ("not a jpeg",))
def test_prep_frame_decodes_what_jax_prep_decodes(name):
    """Progressive and truncated streams prepare as JAX's prep_frame
    prepares them (libjpeg pads the truncated one); what it refuses, the
    port refuses."""
    data = b"\x89PNG not a jpeg" if name == "not a jpeg" else _read(name)
    want = JN.prep_frame(data)
    if want is None:
        assert decode_jpeg(data) is None and prep_frame(data) is None
    else:
        _assert_same(prep_frame(data), want)
        _assert_same(prep_frame(data), _python_route(data))
    with pytest.raises(ValueError):
        prep_frame(_read(FIXTURES[0]), (0, 256))


# ---------------------------------------------------------------- the engine

def _engine(cfg_kw=None, server_kw=None, **kw):
    _, spec_t = small_specs()
    cfg = TDC(forensic=TFC(analysis_size=(64, 64)), model_input_size=64,
              **({"face_backend": "heuristic"} if cfg_kw is None else cfg_kw))
    return TM.MultiStreamEngine(cfg, TSC(max_streams=2, max_batch=2, min_request_interval=0.0,
                                         **(server_kw or {})),
                                spec=spec_t, device="cpu", **kw)


class _Spy:
    def __init__(self, monkeypatch, engine):
        self.calls = {"prep_frame": 0, "analyze": 0}
        prep, analyze = TM.prep_frame, engine.analyze

        def counted_prep(*a, **kw):
            self.calls["prep_frame"] += 1
            return prep(*a, **kw)

        def counted_analyze(*a, **kw):
            self.calls["analyze"] += 1
            return analyze(*a, **kw)
        monkeypatch.setattr(TM, "prep_frame", counted_prep)
        monkeypatch.setattr(engine, "analyze", counted_analyze)


def test_engine_takes_the_one_call_route_and_answers_as_analyze(monkeypatch):
    """The heuristic rung, the resize aligner and host CLAHE: one call per
    request, and the same responses as analyze with the native Lab rung."""
    one, two = _engine(), _engine()
    try:
        assert one._native_prep_eligible()
        spy = _Spy(monkeypatch, one)
        monkeypatch.setattr(t_detector, "_LAB_BACKEND", "native")
        names = ["frame_720x405_q85_420.jpg", "gray_319x241_q85.jpg", "s422_319x241_q85.jpg",
                 "frame_640x480_q85_420.jpg"]
        faces = 0
        for name in names:
            got = one.analyze_jpeg(_read(name), "s")
            want = two.analyze(decode_jpeg(_read(name)), "s")
            for k in ("processing_time_ms", "device"):
                got.pop(k, None)
                want.pop(k, None)
            assert got == want, name
            faces += "face_bbox" in got
        assert faces == 3
        assert spy.calls == {"prep_frame": len(names), "analyze": 0}
        # a stream both routes refuse answers 400
        assert one.analyze_jpeg(b"\xff\xd8\xff corrupt", "s") == {
            "error": "Invalid image format", "status": 400}
    finally:
        one.shutdown()
        two.shutdown()


@pytest.fixture(scope="module")
def ssd_net(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return CaffeNet(proto, cm)


@pytest.mark.parametrize("case", ["clahe_device", "haar_rung", "mtcnn_aligner", "device_detect"])
def test_engine_outside_the_rule_decodes_then_analyzes(case, monkeypatch, ssd_net):
    kw, cfg_kw, server_kw = {}, {"face_backend": "heuristic"}, {}
    if case == "clahe_device":
        cfg_kw["clahe_device"] = True
    elif case == "haar_rung":
        monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
        cfg_kw = {}   # the ladder resolves to the cascade
    elif case == "mtcnn_aligner":
        kw["aligner"] = MTCNNAligner(init_random_mtcnn(0), device="cpu")
    else:
        server_kw = {"device_detect": True, "detect_capture_hw": (240, 320)}
        kw["ssd_net"] = ssd_net
    engine = _engine(cfg_kw, server_kw, **kw)
    try:
        assert not engine._native_prep_eligible()
        if case == "haar_rung":
            assert engine.face_detector.backend == "haar_native"
        spy = _Spy(monkeypatch, engine)
        r = engine.analyze_jpeg(_read("frame_720x405_q85_420.jpg"), "s")
        assert r["success"], r
        assert spy.calls["prep_frame"] == 0
        assert spy.calls["analyze"] == (0 if case == "device_detect" else 1)
    finally:
        engine.shutdown()
