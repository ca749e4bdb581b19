"""The port's `haar_native` face rung against the JAX package's, on the CPU:
the parsed cascade, the grey conversion, group_rectangles, the raw windows
of both packages' numpy and native evaluators (all four must be equal), the
pyramid resize of the port's C++ evaluator against resize_gray_linear at
every level, the boxes on the committed fixtures (tests/data/torch_haar/
expected.json, written by tools/make_torch_haar_fixtures.py from the JAX
rung), the ladder's resolution with the XML and without it, and that a
failed build of csrc/haar.cpp raises instead of degrading."""

import json
import os
import threading

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu.models import haar_cascade as JH
from real_time_video_deepfake_detection_tpu.pipeline import faces as JF
from real_time_video_deepfake_detection_tpu.utils.native_haar import NativeHaar as JNative
from real_time_video_deepfake_detection_tpu_torch.models import haar_cascade as TH
from real_time_video_deepfake_detection_tpu_torch.pipeline import faces as TF
from real_time_video_deepfake_detection_tpu_torch.utils import native_haar as TN
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg

TESTS = os.path.dirname(os.path.abspath(__file__))
HAAR_DIR = os.path.join(TESTS, "data", "torch_haar")
JPEG_DIR = os.path.join(TESTS, "data", "torch_jpeg")
XML = os.path.join(HAAR_DIR, TH.CASCADE_XML)
with open(os.path.join(HAAR_DIR, "expected.json")) as _fh:
    EXPECTED = json.load(_fh)


def _frame(name):
    """A fixture decoded by the port's decoder (checked equal to cv2's), or
    the seeded noise frame."""
    if name == "noise":
        n = EXPECTED["noise"]
        return np.random.default_rng(n["seed"]).integers(0, 256, n["shape"], dtype=np.uint8)
    path = os.path.join(HAAR_DIR if name == "grace_hopper.jpg" else JPEG_DIR, name)
    with open(path, "rb") as fh:
        data = fh.read()
    bgr = decode_jpeg(data)
    assert np.array_equal(bgr, cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    return bgr


@pytest.fixture(scope="module")
def cascades():
    return JH.HaarCascade.from_xml(XML), TH.HaarCascade.from_xml(XML)


@pytest.fixture(scope="module")
def hopper_gray():
    return TH.bgr_to_gray_u8(_frame("grace_hopper.jpg"))


def test_parsed_cascade_equals_jax(cascades):
    jc, tc = cascades
    assert (tc.win_w, tc.win_h) == (jc.win_w, jc.win_h) == (24, 24)
    assert len(tc.stages) == len(jc.stages) == 25
    assert sum(s.node_thresh.size for s in tc.stages) == 2913
    for a, b in zip(jc.stages, tc.stages):
        assert a.threshold == b.threshold
        for f in ("rects", "weights", "node_thresh", "leaf0", "leaf1"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("shape", [(64, 64, 3), (37, 91, 3), (1, 1, 3)])
def test_gray_equals_jax(shape):
    bgr = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(TH.bgr_to_gray_u8(bgr), JH.bgr_to_gray_u8(bgr))


def _rect_sets():
    rng = np.random.default_rng(5)
    sets = [("empty", [], 5), ("single", [(10, 20, 30, 30)], 0),
            ("single_dropped", [(10, 20, 30, 30)], 5),
            ("nested", [(100, 100, 200, 200)] * 10 + [(150, 150, 40, 40)] * 5, 3),
            ("nested_small_strong", [(100, 100, 200, 200)] * 4 + [(150, 150, 40, 40)] * 9, 3)]
    for k in range(6):
        n = int(rng.integers(1, 60))
        centers = rng.integers(0, 400, (3, 2))
        rects = []
        for _ in range(n):
            cx, cy = centers[rng.integers(0, 3)] + rng.integers(-6, 7, 2)
            s = int(rng.integers(24, 90))
            rects.append((int(cx), int(cy), s, s + int(rng.integers(-2, 3))))
        sets.append((f"random{k}", rects, int(rng.integers(0, 6))))
    return sets


@pytest.mark.parametrize("name,rects,threshold", _rect_sets(),
                         ids=[s[0] for s in _rect_sets()])
def test_group_rectangles_equals_jax(name, rects, threshold):
    assert TH.group_rectangles(rects, threshold) == JH.group_rectangles(rects, threshold)


def test_raw_windows_of_the_four_evaluators_equal_on_the_photograph(cascades, hopper_gray):
    jc, tc = cascades
    want = sorted(JNative(jc).detect_raw(hopper_gray))
    assert len(want) == EXPECTED["frames"]["grace_hopper.jpg"]["raw_windows"]
    assert sorted(jc.detect_raw(hopper_gray)) == want
    assert sorted(tc.detect_raw(hopper_gray)) == want
    assert sorted(tc.native().detect_raw(hopper_gray)) == want


@pytest.mark.parametrize("shape", [(150, 180), (200, 180)])
def test_raw_windows_of_the_four_evaluators_equal_on_noise(cascades, shape):
    jc, tc = cascades
    g = np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    want = sorted(JNative(jc).detect_raw(g))
    assert sorted(jc.detect_raw(g)) == want
    assert sorted(tc.detect_raw(g)) == want
    assert sorted(tc.native().detect_raw(g)) == want


def test_native_pyramid_resize_equals_resize_gray_linear(hopper_gray):
    """Every level of the photograph's pyramid, byte for byte, plus exact 2x
    (the area path) and identity."""
    g = hopper_gray
    h, w = g.shape
    factor, levels = 1.0, 0
    while round(w / factor) > 24 and round(h / factor) > 24:
        dh, dw = int(np.rint(h / factor)), int(np.rint(w / factor))
        assert np.array_equal(TN.resize_gray(g, dh, dw), TH.resize_gray_linear(g, dh, dw)), (dh, dw)
        factor *= 1.1
        levels += 1
    assert levels == 32
    for dh, dw in ((300, 256), (600, 512)):
        assert np.array_equal(TN.resize_gray(g, dh, dw), TH.resize_gray_linear(g, dh, dw))


def test_pyramid_follows_cv2_where_the_jax_native_resize_differs(cascades, hopper_gray):
    """The known difference from the JAX package's C++ evaluator, which keeps
    the resize residual in double: on the photograph stretched (nearest
    neighbour) to 616x592, its level at factor 1.1**27 (window 315) differs
    from cv2's, and it misses one raw window and moves the box. The port's
    C++ evaluator gives the JAX numpy evaluator's windows (cv2's pyramid)."""
    jc, tc = cascades
    g = hopper_gray[np.arange(616) * 600 // 616][:, np.arange(592) * 512 // 592]
    want = sorted(jc.detect_raw(g))
    assert len(want) == 16
    assert sorted(tc.native().detect_raw(g)) == want
    jax_native = sorted(JNative(jc).detect_raw(g))
    assert set(want) - set(jax_native) == {(157, 79, 315, 315)}
    assert set(jax_native) <= set(want)
    assert TH.group_rectangles(want, 5) == [(177, 94, 260, 260)]
    assert JH.group_rectangles(jax_native, 5) == [(179, 95, 256, 256)]


@pytest.mark.parametrize("name", sorted(EXPECTED["frames"]))
def test_native_boxes_equal_the_jax_rung_on_every_fixture(name, monkeypatch):
    monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
    bgr = _frame(name)
    want = EXPECTED["frames"][name]
    assert list(bgr.shape) == want["shape"]
    cascade = TH.default_cascade()
    assert len(cascade.native().detect_raw(TH.bgr_to_gray_u8(bgr))) == want["raw_windows"]
    assert [list(b) for b in TH.detect_haar_native(bgr)] == want["boxes"]


def test_detect_haar_native_equals_jax_on_the_photograph(monkeypatch):
    monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
    monkeypatch.setattr(JH, "_cascade", None)
    bgr = _frame("grace_hopper.jpg")
    boxes = TH.detect_haar_native(bgr)
    assert boxes == JH.detect_haar_native(bgr) == [(154, 105, 222, 222)]
    jc, tc = JH.HaarCascade.from_xml(XML), TH.HaarCascade.from_xml(XML)
    gray = TH.bgr_to_gray_u8(bgr)
    assert tc.detect_multiscale(gray) == jc.detect_multiscale(gray) == boxes


def test_ladder_resolves_to_haar_native_with_the_xml(monkeypatch):
    monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
    monkeypatch.setattr(JH, "_cascade", None)
    jd, td = JF.FaceDetector(), TF.FaceDetector(device="cpu")
    assert td.backend == jd.backend == "haar_native"
    bgr = _frame("grace_hopper.jpg")
    before = TN.calls
    assert td(bgr) == jd(bgr) == [(154, 105, 222, 222)]
    assert TN.calls > before
    assert TF.FaceDetector(backend="heuristic").backend == "heuristic"
    assert TF.FaceDetector(backend="haar_native").backend == "haar_native"
    with pytest.warns(RuntimeWarning, match="unavailable"):
        assert TF.FaceDetector(backend="haar").backend == "haar_native"


def test_ladder_resolves_to_heuristic_without_the_xml(monkeypatch, tmp_path):
    """The JAX rung on a host with no cascade XML: both packages take the
    heuristic."""
    monkeypatch.setenv("HAARCASCADE_DIR", str(tmp_path))
    monkeypatch.setattr(JH, "_XML_SEARCH_PATHS", ())
    monkeypatch.setattr(TH, "_XML_SEARCH_PATHS", ())
    assert TH.find_cascade_xml() is None and JH.find_cascade_xml() is None
    assert TF.FaceDetector().backend == JF.FaceDetector().backend == "heuristic"
    with pytest.warns(RuntimeWarning, match="unavailable"):
        assert TF.FaceDetector(backend="haar_native").backend == "heuristic"


def test_failed_build_raises_instead_of_degrading(monkeypatch, tmp_path):
    broken = tmp_path / "haar.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
    monkeypatch.setattr(TN, "SRC", str(broken))
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TH, "_cascade", None)
    det = TF.FaceDetector(device="cpu")
    assert det.backend == "haar_native"
    bgr = _frame("frame_640x480_q85_420.jpg")
    with pytest.raises(RuntimeError, match="building"):
        det(bgr)
    with pytest.raises(RuntimeError, match="building"):
        TH.HaarCascade.from_xml(XML).detect_multiscale(bgr)
    # the numpy evaluator is only ever asked for by name
    assert TH.HaarCascade.from_xml(XML).detect_multiscale(bgr, use_native=False) == [
        tuple(b) for b in EXPECTED["frames"]["frame_640x480_q85_420.jpg"]["boxes"]]


def test_concurrent_detections_agree_and_are_all_counted(monkeypatch):
    """The engine's request threads call the cascade at once: the cascade
    loads once, every thread gets the same boxes, and no call goes
    uncounted."""
    monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
    monkeypatch.setattr(TH, "_cascade", None)
    bgr = _frame("frame_640x480_q85_420.jpg")[::2, ::2].copy()
    want = TH.detect_haar_native(bgr)
    n_threads, n_calls = 12, 3
    results, errors = [], []
    barrier = threading.Barrier(n_threads)

    def work():
        try:
            barrier.wait(timeout=60)
            for _ in range(n_calls):
                results.append(TH.detect_haar_native(bgr))
        except Exception as e:   # reported below
            errors.append(e)

    before = TN.calls
    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert results == [want] * (n_threads * n_calls)
    assert TN.calls - before == n_threads * n_calls
