"""The port's HTTP front end against the JAX package's, on the CPU, with
the small EfficientNet spec and the same carried parameters
(utils/convert.params_from_jax): the single-stream app (serving/server.
create_app over DeepfakeDetector) and the batched app (serving/multi.
create_batched_app) in host-prep and device-detect mode (the synthetic SSD
at channels (8, 8, 16, 16), 240x320 captures), fed the committed JPEG
fixtures. Same status codes and JSON keys; integer, string and bbox fields
equal; probabilities within TOL = 1e-5 (measured: float rounding only). The
deviations are the documented ones: /health and /stats name the device
"cpu" (the JAX app "cpu:0"). Progressive and truncated JPEGs, PNG and BMP
get the JAX app's responses (its libjpeg route, then its cv2 route). Also the engine's stream table (isolation, LRU
eviction, invalid requests never evict, atomic admit, eviction clears the
rate stamp, stale requests fail), the multipart parser against the JAX
one, the threaded server over real sockets (64 clients at once), the
single-stream pieces (TemporalTracker, analyze_frame, classify_batch) and
main()'s flag checks.
The host-side face CLAHE of both sides is pinned to the jnp Lab rung, and
the single-stream app is also compared unpinned (both take cv2's 8-bit
conversion; the port computes it without cv2), and with the face ladder
unpinned, where both resolve to the haar_native cascade."""

import dataclasses
import io
import os
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC, ServerConfig as JSC,
)
from real_time_video_deepfake_detection_tpu.kernels.preproc import preprocess_faces_pallas
from real_time_video_deepfake_detection_tpu.models import backbones as JBK
from real_time_video_deepfake_detection_tpu.models.ssd_res10 import SSDRes10 as JSSD
from real_time_video_deepfake_detection_tpu.ops import forensics as JF
from real_time_video_deepfake_detection_tpu.pipeline import classify as JCL
from real_time_video_deepfake_detection_tpu.serving import multi as JM
from real_time_video_deepfake_detection_tpu.serving import server as JS
from real_time_video_deepfake_detection_tpu.state import forensic_state as JFS
from real_time_video_deepfake_detection_tpu.state import tracker as JT
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.ops import forensics as TF
from real_time_video_deepfake_detection_tpu_torch.pipeline import classify as TCL
from real_time_video_deepfake_detection_tpu_torch.pipeline import detector as t_detector
from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.serving import server as TS
from real_time_video_deepfake_detection_tpu_torch.serving.wsgi import Request
from real_time_video_deepfake_detection_tpu_torch.state import forensic_state as TFS
from real_time_video_deepfake_detection_tpu_torch.state import tracker as TT
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import assert_same, small_models, small_specs

TOL = 1e-5
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
CAPTURE = (240, 320)
FACE_FRAMES = ["frame_720x405_q85_420.jpg", "frame_640x480_q85_420.jpg",
               "frame_405x720_q85_420.jpg"]
OTHER = ["gray_319x241_q85.jpg", "q50_720x405_420.jpg", "tiny_33x17_q85_420.jpg",
         "s422_319x241_q85.jpg", "restart_319x241_q85.jpg", "optimized_319x241_q85.jpg",
         "one_1x1_q85_420.jpg", "s444_319x241_q85.jpg", "q95_720x405_420.jpg"]


def _read(name):
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _post(app, path, frame=None, stream_id=None, header_sid=None):
    """POST a multipart body (file field `frame`, form field `stream_id`),
    optionally with an X-Stream-Id header."""
    b = "tb0417"
    body = b""
    if frame is not None:
        body += (f'--{b}\r\nContent-Disposition: form-data; name="frame"; '
                 f'filename="f.jpg"\r\n\r\n').encode() + frame + b"\r\n"
    if stream_id is not None:
        body += (f'--{b}\r\nContent-Disposition: form-data; name="stream_id"'
                 f'\r\n\r\n{stream_id}\r\n').encode()
    body += f"--{b}--\r\n".encode()
    environ = {"REQUEST_METHOD": "POST", "PATH_INFO": path,
               "CONTENT_TYPE": f"multipart/form-data; boundary={b}",
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    if header_sid is not None:
        environ["HTTP_X_STREAM_ID"] = header_sid
    return app.dispatch(Request(environ))


def _get(app, path, header_sid=None):
    environ = {"REQUEST_METHOD": "GET", "PATH_INFO": path, "CONTENT_LENGTH": "0",
               "wsgi.input": io.BytesIO(b"")}
    if header_sid is not None:
        environ["HTTP_X_STREAM_ID"] = header_sid
    return app.dispatch(Request(environ))


def _same_response(rj, rt, what, skip=("processing_time_ms",)):
    assert rt.status_code == rj.status_code, (what, rj.get_json(), rt.get_json())
    a, b = rj.get_json(), rt.get_json()
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in set(a) - set(skip):
        if isinstance(a[k], float):
            assert b[k] == pytest.approx(a[k], abs=TOL), (what, k)
        else:
            assert b[k] == a[k], (what, k)
    return b


@pytest.fixture(scope="module")
def models():
    spec_j, spec_t = small_specs()
    _, pj, _ = small_models(seed=9)
    return spec_j, pj, spec_t


def _cfgs(**kw):
    kw = dict(model_input_size=64, **kw)
    return (JDC(forensic=JFC(analysis_size=(64, 64)), **kw).with_threshold(0.55),
            TDC(forensic=TFC(analysis_size=(64, 64)), **kw).with_threshold(0.55))


@pytest.fixture()
def jnp_lab(monkeypatch):
    """Both host-side Lab ladders pinned to their jnp rung."""
    monkeypatch.setattr(j_detector, "_LAB_BACKEND", "jnp")
    monkeypatch.setattr(t_detector, "_LAB_BACKEND", "jnp")


def test_single_stream_app_matches_jax(models, jnp_lab):
    _single_stream_matches_jax(models)


def test_single_stream_app_matches_jax_unpinned(models):
    """Both ladders unpinned: the JAX one resolves to cv2 where cv2 is
    installed, the port's takes its cv2 rung, computed without cv2."""
    assert j_detector._resolve_lab_backend() == "cv2"
    assert t_detector._LAB_BACKEND == "cv2"
    _single_stream_matches_jax(models)


HAAR_DIR = os.path.join(os.path.dirname(DATA), "torch_haar")


def test_single_stream_app_matches_jax_with_the_haar_rung(models, monkeypatch):
    """face_backend "auto" in both packages, the cascade XML found: both
    ladders resolve to haar_native (the JAX one has no cv2 cascade, the
    port no cv2), and the photograph and two capture frames get the same
    answers, boxes included."""
    monkeypatch.setenv("HAARCASCADE_DIR", HAAR_DIR)
    spec_j, pj, spec_t = models
    cj, ct = _cfgs()
    assert cj.face_backend == ct.face_backend == "auto"
    scfg = dict(min_request_interval=0.0)
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j), JSC(**scfg))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(**scfg))
    assert ja.detector.face_detector.backend == "haar_native"
    assert ta.detector.face_detector.backend == "haar_native"
    with open(os.path.join(HAAR_DIR, "grace_hopper.jpg"), "rb") as fh:
        photo = fh.read()
    seq = [("grace_hopper.jpg", photo)] + [(n, _read(n)) for n in (
        "frame_640x480_q85_420.jpg", "frame_720x405_q85_420.jpg")]
    boxes = {}
    for i, (name, data) in enumerate(seq * 2):
        r = _same_response(_post(ja, "/analyze", data), _post(ta, "/analyze", data), (i, name))
        boxes[name] = (r["faces_detected"], r.get("face_bbox"))
    assert boxes == {"grace_hopper.jpg": (1, {"x": 154, "y": 105, "width": 222, "height": 222}),
                     "frame_640x480_q85_420.jpg": (1, {"x": 192, "y": 82, "width": 264,
                                                       "height": 264}),
                     "frame_720x405_q85_420.jpg": (0, None)}
    assert r["frame_count"] == 2 * len(seq)


def _single_stream_matches_jax(models):
    spec_j, pj, spec_t = models
    cj, ct = _cfgs(face_backend="heuristic")
    scfg = dict(min_request_interval=0.0)
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j), JSC(**scfg))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(**scfg))
    seq = FACE_FRAMES + OTHER + FACE_FRAMES
    modes = []
    for i, name in enumerate(seq):
        r = _same_response(_post(ja, "/analyze", _read(name)), _post(ta, "/analyze", _read(name)),
                           (i, name))
        modes.append(r["analysis_mode"])
    assert modes.count("face+frame") >= 4 and "frame_only" in modes
    assert r["confidence_level"] != "UNCERTAIN" and r["frame_count"] == len(seq)
    device_fields = ("processing_time_ms", "device")
    _same_response(_get(ja, "/stats"), _get(ta, "/stats"), "stats", skip=device_fields)
    assert _get(ta, "/stats").get_json()["device"] == "cpu"
    h = _same_response(_get(ja, "/health"), _get(ta, "/health"), "health", skip=device_fields)
    assert h["gpu_name"] is None and h["frame_count"] == len(seq)
    _same_response(_post(ja, "/reset"), _post(ta, "/reset"), "reset")
    _same_response(_get(ja, "/stats"), _get(ta, "/stats"), "stats after reset", skip=device_fields)
    for body in (None, b"not an image"):
        _same_response(_post(ja, "/analyze", body), _post(ta, "/analyze", body), body)
    for path, code in (("/nope", 404), ("/analyze", 405)):
        assert _get(ta, path).status_code == _get(ja, path).status_code == code


def _png_bmp_progressive_truncated():
    img = np.random.default_rng(1).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    return [cv2.imencode(".png", img)[1].tobytes(), cv2.imencode(".bmp", img)[1].tobytes(),
            _read("progressive_720x405_q85.jpg"), _read("truncated_720x405_q85.jpg")]


def test_single_stream_decodes_png_bmp_progressive_truncated_as_jax(models):
    spec_j, pj, spec_t = models
    cj, ct = _cfgs()
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j),
                       JSC(min_request_interval=0.0))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(min_request_interval=0.0))
    for i, data in enumerate(_png_bmp_progressive_truncated()):
        r = _same_response(_post(ja, "/analyze", data), _post(ta, "/analyze", data), i)
        assert "error" not in r
    assert ta.detector.frame_count == 4


def test_single_stream_rate_limit_matches_jax(models):
    spec_j, pj, spec_t = models
    cj, ct = _cfgs()
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j),
                       JSC(min_request_interval=10.0))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(min_request_interval=10.0))
    data = _read("tiny_33x17_q85_420.jpg")
    for app in (ja, ta):
        assert _post(app, "/analyze", data).status_code == 200
        r = _post(app, "/analyze", data)
        assert r.status_code == 429 and r.get_json()["error"] == "Rate limited"
        assert 0 <= r.get_json()["retry_after_ms"] <= 10000


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return JSSD.from_caffemodel(cm, proto), TSSD.from_caffemodel(cm, proto, device="cpu")


@pytest.mark.parametrize("mode", ["host_prep", "device_detect"])
def test_batched_app_matches_jax(models, ssd, jnp_lab, monkeypatch, mode):
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
        names = FACE_FRAMES + ["gray_319x241_q85.jpg", "s422_319x241_q85.jpg"]
        seq = [(names[i % len(names)], sid, via) for i, (sid, via) in enumerate(
            [("a", "form"), ("b", "header"), (None, None), ("a", "form"), ("b", "form"),
             ("a", "header"), (None, None), ("a", "form"), ("b", "header")])]
        faces = 0
        for i, (name, sid, via) in enumerate(seq):
            kw = {"stream_id": sid} if via == "form" else {"header_sid": sid}
            r = _same_response(_post(ja, "/analyze", _read(name), **kw),
                               _post(ta, "/analyze", _read(name), **kw), (i, name, sid))
            faces += "face_bbox" in r
        assert faces >= 3
        assert r["frame_count"] == 3   # stream b's third frame: streams are isolated
        skip = ("processing_time_ms", "device")
        for sid in ("a", "b", "default", "never-seen"):
            _same_response(_get(ja, "/stats", sid), _get(ta, "/stats", sid), ("stats", sid), skip)
        _same_response(_get(ja, "/health"), _get(ta, "/health"), "health", skip)
        assert set(_get(ta, "/metrics").get_json()) == set(_get(ja, "/metrics").get_json())
        _same_response(_post(ja, "/reset", stream_id="a"), _post(ta, "/reset", stream_id="a"),
                       "reset a")
        for sid in ("a", "b"):
            _same_response(_get(ja, "/stats", sid), _get(ta, "/stats", sid), ("reset", sid), skip)
        for body in (None, b"not an image", b"\xff\xd8 not a jpeg either"):
            _same_response(_post(ja, "/analyze", body, stream_id="c"),
                           _post(ta, "/analyze", body, stream_id="c"), body)
        for i, data in enumerate(_png_bmp_progressive_truncated()):
            r = _same_response(_post(ja, "/analyze", data, stream_id="d"),
                               _post(ta, "/analyze", data, stream_id="d"), ("formats", i))
            assert "error" not in r
        if mode == "device_detect":
            # a failed header scan: the client dims come from the pooled decode
            data = _read("frame_720x405_q85_420.jpg")
            want = _post(ta, "/analyze", data, stream_id="e").get_json()
            monkeypatch.setattr(TM, "_jpeg_dims", lambda d: None)
            got = _post(ta, "/analyze", data, stream_id="f").get_json()
            assert got.get("face_bbox") == want.get("face_bbox") is not None
    finally:
        je.shutdown()
        te.shutdown()


@pytest.fixture(scope="module")
def engine(models):
    _, _, spec_t = models
    e = TM.MultiStreamEngine(_cfgs(face_backend="heuristic")[1],
                             TSC(max_streams=3, max_batch=4, batch_timeout_ms=2.0,
                                 min_request_interval=0.0), spec=spec_t, device="cpu")
    yield e
    e.shutdown()


def test_stream_table_eviction_and_invalid_requests(engine):
    app = TM.create_batched_app(engine, engine.server_cfg)
    engine.reset()
    data = _read("tiny_33x17_q85_420.jpg")
    for sid in ("x", "x", "y"):
        assert _post(app, "/analyze", data, stream_id=sid).status_code == 200
    assert engine.frame_count("x") == 2 and engine.frame_count("y") == 1
    with engine.lock:
        before = dict(engine.slot_of)
    for i in range(engine.n_slots + 4):   # invalid requests never allocate a slot
        assert _post(app, "/analyze", None, stream_id=f"garbage-{i}").status_code == 400
    with engine.lock:
        assert dict(engine.slot_of) == before
    for sid in ("z", "w"):   # a 4th stream evicts the least recently used, "x"
        assert _post(app, "/analyze", data, stream_id=sid).status_code == 200
    assert len(engine.slot_of) == engine.n_slots and "x" not in engine.slot_of
    assert engine.frame_count("w") == 1
    # a request parked while its stream was evicted fails with 409
    slot = engine.slot_for("w")
    live = TM._Pending(stream_slot=slot, stream_id="w")
    stale = TM._Pending(stream_slot=slot, stream_id="x")
    assert engine._drop_stale([live, stale]) == [live]
    assert stale.event.is_set() and stale.result["status"] == 409


def test_rate_windows_admit_atomically_and_eviction_clears_them(models):
    _, _, spec_t = models
    e = TM.MultiStreamEngine(_cfgs()[1], TSC(max_streams=2, max_batch=2, batch_timeout_ms=2.0,
                                             min_request_interval=10.0),
                             spec=spec_t, device="cpu")
    try:
        results, barrier = [], threading.Barrier(8)

        def first_request():
            barrier.wait(timeout=30)
            results.append(e.admit("burst"))

        threads = [threading.Thread(target=first_request) for _ in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=30) for t in threads]
        assert not any(t.is_alive() for t in threads)
        assert len({s for s, _ in results}) == 1
        retries = [r for _, r in results]
        assert retries.count(None) == 1
        assert all(0 < r <= 10000 for r in retries if r is not None)
        s = e.slot_for("other")
        assert e.rate_limited(s) is None and e.rate_limited(s) is not None
        s_new = e.slot_for("third")   # evicts the LRU stream and its stamp
        assert e.rate_limited(s_new) is None
    finally:
        e.shutdown()


def test_temporal_tracker_matches_jax():
    kw = dict(window_size=12, high_confidence_threshold=0.6, voting_window=5,
              detection_threshold=0.5)
    jt, tt = JT.TemporalTracker(**kw), TT.TemporalTracker(**kw, device="cpu")
    rng = np.random.default_rng(2)
    probs = list(rng.uniform(0.55, 0.95, 14)) + [None, 0.5] + list(rng.uniform(0, 1, 9))
    for i, p in enumerate(probs):
        jt.update(p)
        tt.update(p)
        for getter in ("get_temporal_average", "get_weighted_average", "get_stability_score",
                       "detect_anomalies"):
            assert getattr(tt, getter)() == pytest.approx(getattr(jt, getter)(), abs=1e-6), (i, getter)
        assert tt.get_confidence_level() == jt.get_confidence_level()
        assert tt.current_verdict == jt.current_verdict
        assert tt.get_voting_stats() == jt.get_voting_stats()
        assert tt.history_length == jt.history_length
        assert (tt.should_trigger_forensic_analysis(now=100.0 + i)
                == jt.should_trigger_forensic_analysis(now=100.0 + i)), i
    tt.reset()
    jt.reset()
    assert tt.history_length == jt.history_length == 0
    assert tt.get_weighted_average() == jt.get_weighted_average() == 0.0


def test_analyze_frame_matches_jax_on_full_and_fast_ticks():
    fc, tc = JFC(analysis_size=(64, 64)), TFC(analysis_size=(64, 64))
    js, ts = JFS.forensic_state_init(fc), TFS.forensic_state_init_batch(1, tc)
    step = jax.jit(JF.analyze_frame, static_argnums=(3,))
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[:64, :64]
    for t in range(7):
        f = 120 + 60 * np.sin(xx / 6.0 + t) * np.cos(yy / 9.0)
        frame = np.clip(f[..., None] + rng.integers(-20, 21, (64, 64, 3)), 0, 255).astype(np.uint8)
        full = t % 3 == 0
        rj, js = step(jnp.asarray(frame), js, jnp.asarray(full), fc)
        rt, ts = TF.analyze_frame(torch.from_numpy(frame), ts, full, tc)
        assert set(rt) == set(rj)
        for k in rj:
            assert_same(np.asarray(rj[k]), rt[k], 1e-6, f"frame {t} {k}")
        for f_ in dataclasses.fields(js):
            assert_same(np.asarray(getattr(js, f_.name))[None], getattr(ts, f_.name), 1e-6,
                        f"frame {t} state {f_.name}")


@pytest.mark.parametrize("pallas_preproc", [False, True], ids=["plain", "preproc_kernel"])
def test_classify_batch_matches_jax(pallas_preproc):
    spec_j, pj, model = small_models(seed=4)
    faces = np.random.default_rng(6).uniform(0, 255, (3, 160, 160, 3)).astype(np.float32)
    if pallas_preproc:   # the Pallas kernel in interpret mode, as the JAX tests run it
        x = preprocess_faces_pallas(jnp.asarray(faces), 64, interpret=True)
        want = jax.nn.sigmoid(JBK.forward(pj, x, spec_j)[:, 0])
    else:
        want = JCL.classify_batch(pj, jnp.asarray(faces), spec_j, 64)
    got = TCL.classify_batch(model, torch.from_numpy(faces), 64, pallas_preproc=pallas_preproc)
    assert_same(np.asarray(want), got, TOL, "probabilities")
    for h, w, p in ((79, 200, 0.95), (80, 80, 0.5), (200, 20, -0.2)):
        assert TCL.apply_small_face_heuristic(p, h, w) == JCL.apply_small_face_heuristic(p, h, w)


@pytest.mark.parametrize("argv,want", [
    (["--weights", "w.npz"], "--weights"), (["--mtcnn-weights", "d"], "--mtcnn-weights"),
    (["--mtcnn-device"], "--mtcnn-device"),
    (["--clip-head", "h.npz", "--batched"], "--clip-head h.npz"),
    (["--ingest-plane", "coef"], "--ingest-plane"),
    (["--scaled-decode", "--device-detect"], "--batched"), (["--device-detect"], "--batched"),
    (["--device-detect", "--batched"], "--ssd-weights"),
    (["--device-detect", "--batched", "--ssd-weights", "x.caffemodel",
      "--face-backend", "haar"], "cannot honor"),
])
def test_main_flag_checks_exit(argv, want):
    with pytest.raises(SystemExit, match=want.replace("-", "[-]")):
        TS.main(argv)


@pytest.mark.parametrize("argv,backbone,window", [
    (["--clip-window", "8"], "b0", 8), (["--backbone", "vit_b16", "--clip-window", "8"],
                                        "vit_b16", 8),
    (["--backbone", "xception"], "xception", 0)])
def test_main_serves_config5_flags(argv, backbone, window, monkeypatch):
    """--clip-window and the ViT and Xception backbones serve (BASELINE
    config 5): the batched engine gets the backbone's spec and the window,
    in clip mode clip_feature_dim follows the backbone, and one posted frame is answered
    (with the clip ring's count in clip mode)."""
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    seen = {}

    class FakeServer:   # serve_forever posts one frame, then stops as Ctrl-C would
        def __init__(self, app):
            self.app = app

        def serve_forever(self):
            seen["app"] = self.app
            seen["r"] = _post(self.app, "/analyze", _read(FACE_FRAMES[0]), header_sid="s")
            raise KeyboardInterrupt

    monkeypatch.setattr(TS, "make_server", lambda host, port, app, *a, **kw: FakeServer(app))
    TS.main(argv + ["--device", "cpu", "--batched", "--max-streams", "2", "--max-batch", "2",
                    "--face-backend", "heuristic"])
    engine = seen["app"].engine
    spec = backbones.make(backbone)
    assert engine.spec == spec and engine.cfg.clip_window == window
    if window:
        assert engine.cfg.clip_feature_dim == backbones.feature_dim(spec)
    r = seen["r"].get_json()
    assert seen["r"].status_code == 200 and r["success"], r
    assert ("clip_frames" in r) == (window > 0)


def _mtcnn_weights(tmp_path):
    """init_random_mtcnn(5) with ±3 class heads, saved as facenet's three
    files; returns the directory."""
    from real_time_video_deepfake_detection_tpu_torch.models.mtcnn import init_random_mtcnn
    d = tmp_path / "mtcnn"
    d.mkdir()
    for net, sd in init_random_mtcnn(5).items():
        head = {"pnet": "conv4_1", "rnet": "dense5_1", "onet": "dense6_1"}[net]
        sd[f"{head}.bias"] = torch.tensor([-3.0, 3.0])
        torch.save(sd, d / f"{net}.pt")
    return str(d)


@pytest.mark.parametrize("argv,want", [
    (["--mtcnn-device", "--device-detect", "--batched", "--ssd-weights", "x.caffemodel"],
     "--mtcnn-device requires --device-detect and --mtcnn-weights"),
    (["--mtcnn-device", "--mtcnn-weights", "MTCNN"], "--mtcnn-device requires"),
    (["--mtcnn-weights", "EVIL"], "--mtcnn-weights .*evil.pt"),
])
def test_main_mtcnn_flag_checks_exit(argv, want, tmp_path):
    """JAX's checks of --mtcnn-device; weights that need a full unpickle
    are refused with the flag named."""
    import argparse
    evil = tmp_path / "evil.pt"
    torch.save({"pnet.conv1.weight": argparse.Namespace(boom=1)}, evil)
    paths = {"MTCNN": _mtcnn_weights(tmp_path), "EVIL": str(evil)}
    argv = [paths.get(a, a) for a in argv]
    with pytest.raises(SystemExit, match=want.replace("-", "[-]")):
        TS.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_main_serves_with_the_mtcnn_aligner(batched, tmp_path, monkeypatch):
    """--mtcnn-weights loads the MTCNN aligner into the app (single-stream
    DeepfakeDetector or the host-prep engine), and a served frame goes
    through it: the photograph of tests/data/torch_haar, whose face the
    default detector ladder (the haar cascade) finds."""
    from real_time_video_deepfake_detection_tpu_torch.models import mtcnn as TMT
    monkeypatch.setenv("HAARCASCADE_DIR", os.path.join(os.path.dirname(DATA), "torch_haar"))
    calls = []
    detect = TMT.MTCNNAligner.detect
    monkeypatch.setattr(TMT.MTCNNAligner, "detect",
                        lambda self, face: calls.append(face.shape) or detect(self, face))
    seen = {}

    class FakeServer:   # serve_forever posts one frame, then stops as Ctrl-C would
        def __init__(self, app):
            self.app = app

        def serve_forever(self):
            seen["app"] = self.app
            with open(os.path.join(os.path.dirname(DATA), "torch_haar", "grace_hopper.jpg"),
                      "rb") as fh:
                seen["r"] = _post(self.app, "/analyze", fh.read(), header_sid="s")
            raise KeyboardInterrupt

    monkeypatch.setattr(TS, "make_server", lambda host, port, app, *a, **kw: FakeServer(app))
    argv = ["--device", "cpu", "--mtcnn-weights", _mtcnn_weights(tmp_path)]
    if batched:
        TS.main(argv + ["--batched", "--max-streams", "2", "--max-batch", "2"])
        aligner = seen["app"].engine.aligner
    else:
        with pytest.raises(KeyboardInterrupt):
            TS.main(argv)
        aligner = seen["app"].detector.aligner
    assert isinstance(aligner, TMT.MTCNNAligner) and aligner.device.type == "cpu"
    r = seen["r"].get_json()
    assert seen["r"].status_code == 200 and r["success"], r
    assert r["faces_detected"] >= 1 and len(calls) == 1, (r, calls)


def test_device_strings_and_engine_reject_unported_decode_options():
    """Every decode option is ported: the engine takes the scaled decode
    (tests/test_torch_scaled_decode.py holds it to JAX's)."""
    assert TS._device_strings("cpu") == ("cpu", None)
    e = TM.MultiStreamEngine(TDC(), TSC(ingest_scaled_decode=True, max_streams=2,
                                        max_batch=2), device="cpu")
    e.shutdown()
    assert e.server_cfg.ingest_scaled_decode


def _multipart(boundary, payload, quoted=False, nl="\r\n"):
    head = (f'--{boundary}{nl}Content-Disposition: form-data; name="frame"; '
            f'filename="f.bin"{nl}{nl}').encode()
    ctype = f'multipart/form-data; boundary={boundary!r}'.replace("'", '"') if quoted else (
        f"multipart/form-data; boundary={boundary}")
    return ctype, head + payload + f"{nl}--{boundary}--{nl}".encode()


_B = "bnd417"
_HEAD = 'Content-Disposition: form-data; name="frame"; filename="f.bin"\r\n\r\n'
_BODIES = [
    # payload bytes survive exactly, their own trailing CR/LF included
    *[_multipart(_B, p) for p in (b"\r\nstarts and ends with newlines\r\n", b"x\n", b"\r",
                                   b"\n\n\n", b"plain", b"\x89PNG\r\n\x1a\nDATA\n")],
    _multipart(_B, b"tail\n", nl="\n"),                      # bare-LF generator
    _multipart("xy,z:q=7", b"FRAMEBYTES", quoted=True),      # quoted boundary, comma
    # malformed bodies parse to an empty or partial file set, never raise
    ("multipart/form-data", b"--x\r\njunk"),
    (f"multipart/form-data; boundary={_B}", b"complete garbage, no delimiter"),
    (f"multipart/form-data; boundary={_B}", f"--{_B}\r\n".encode()),
    (f"multipart/form-data; boundary={_B}", f"--{_B}\r\nContent-Disposition: form-data".encode()),
    (f"multipart/form-data; boundary={_B}",
     f"--{_B}\r\nContent-Disposition: form-data\r\n\r\npayload\r\n--{_B}--\r\n".encode()),
    (f"multipart/form-data; boundary={_B}", (f"--{_B}\r\n" + _HEAD).encode() + b"payload"),
    (f"multipart/form-data; boundary={_B}", f"--{_B}--\r\n".encode()),
    (f"multipart/form-data; boundary={_B}", b""),
]


@pytest.mark.parametrize("case", range(len(_BODIES)))
def test_multipart_parsing_matches_jax(case):
    from real_time_video_deepfake_detection_tpu.serving.wsgi import Request as JRequest
    ctype, body = _BODIES[case]
    parsed = []
    for cls in (JRequest, Request):
        r = cls({"REQUEST_METHOD": "POST", "PATH_INFO": "/analyze", "CONTENT_TYPE": ctype,
                 "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)})
        parsed.append((r.files, r.form, r.body))
    assert parsed[1] == parsed[0]


@pytest.mark.parametrize("length", ["-5", "-1", "banana", ""])
def test_bad_content_length_reads_nothing(length):
    class NoReadToEof(io.BytesIO):
        def read(self, n=-1):
            assert n is not None and n >= 0, "read to EOF on a request body"
            return super().read(n)

    r = Request({"REQUEST_METHOD": "POST", "PATH_INFO": "/analyze",
                 "CONTENT_TYPE": "application/json", "CONTENT_LENGTH": length,
                 "wsgi.input": NoReadToEof(b"leftover bytes")})
    assert r.body == b""


def test_server_takes_a_burst_of_connections(engine):
    """The port's threaded server over real sockets on 127.0.0.1, 64 clients
    at once, each request held 50 ms (a route added here): no connection is
    reset. socketserver's default listen backlog of 5 resets some."""
    import time
    import urllib.error
    import urllib.request
    from wsgiref.simple_server import WSGIRequestHandler

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    app = TM.create_batched_app(engine, engine.server_cfg)

    @app.route("/slow", methods=["POST"])
    def slow(req):
        time.sleep(0.05)
        return TS.jsonify({"bytes": len(req.body)})

    httpd = TS.make_server("127.0.0.1", 0, app, handler_class=Quiet)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    codes, errors = [], []
    requests = ([(url + "/slow", b"x" * 30000)] * 4
                + [(url + "/health", None), (url + "/analyze", b"")])

    def client():
        for target, body in requests:
            req = urllib.request.Request(target, data=body,
                                         method="GET" if body is None else "POST")
            try:
                with opener.open(req, timeout=60) as r:
                    codes.append(r.status)
            except urllib.error.HTTPError as e:
                codes.append(e.code)
            except OSError as e:
                errors.append(repr(e))

    try:
        clients = [threading.Thread(target=client) for _ in range(64)]
        [c.start() for c in clients]
        [c.join(timeout=120) for c in clients]
        assert not any(c.is_alive() for c in clients)
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=30)
    assert not errors, errors[:3]
    assert sorted(codes) == [200] * (64 * 5) + [400] * 64
