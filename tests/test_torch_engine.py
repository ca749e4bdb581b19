"""Port parity: the port's MultiStreamEngine against the JAX package's, both
on the CPU with the small EfficientNet spec and the same carried
parameters, heuristic face detection, 2 streams x 11 frames (one stream with
a face). The responses carry the same keys, verdict sequence, analysis mode,
face box and faces_detected, and probabilities within 1e-5. Both engines'
host-side face CLAHE is pinned to the jnp Lab rung."""

import dataclasses
import threading

import numpy as np
import pytest

import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC, ServerConfig as JSC,
)
from real_time_video_deepfake_detection_tpu.serving.multi import (
    MultiStreamEngine as JEngine,
)
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.pipeline import detector as t_detector
from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
    MultiStreamEngine as TEngine,
)
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.torch_port_util import small_models, small_specs

N_FRAMES = 11
PROB_KEYS = ("fake_probability", "frame_forensic_probability", "real_probability",
             "temporal_average", "stability_score", "face_probability")


def _frame(stream: str, t: int) -> np.ndarray:
    rng = np.random.default_rng(1000 * t + len(stream))
    yy, xx = np.mgrid[:240, :320]
    f = 110 + 50 * np.sin(xx / 17.0 + t / 3.0) * np.cos(yy / 23.0)
    f = np.repeat((f + rng.integers(-8, 9, (240, 320)))[..., None], 3, axis=2)
    if stream == "face":
        m = ((xx - 160 - 2 * t) / 60.0) ** 2 + ((yy - 120) / 80.0) ** 2 <= 1.0
        f[m] = np.array([140, 160, 210]) + rng.integers(-5, 6, (int(m.sum()), 3))
    return np.clip(f, 0, 255).astype(np.uint8)


def _drive(engine):
    out = {"face": [], "plain": []}

    def client(sid):
        for t in range(N_FRAMES):
            out[sid].append(engine.analyze(_frame(sid, t), sid))

    threads = [threading.Thread(target=client, args=(s,)) for s in out]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    return out


def test_engine_responses_match_jax(monkeypatch):
    monkeypatch.setattr(j_detector, "_LAB_BACKEND", "jnp")
    monkeypatch.setattr(t_detector, "_LAB_BACKEND", "jnp")
    spec_j, spec_t = small_specs()
    _, pj, _ = small_models(seed=5)
    # a 64x64 analysis frame and classifier input keep the CPU ticks short;
    # the face crop stays the aligner's 160x160
    kw = dict(face_backend="heuristic", model_input_size=64)
    fj, ft = JFC(analysis_size=(64, 64)), TFC(analysis_size=(64, 64))
    skw = dict(max_streams=8, max_batch=8, min_request_interval=0.0)
    je = JEngine(dataclasses.replace(JDC(forensic=fj).with_threshold(0.55), **kw), JSC(**skw),
                 params=pj, spec=spec_j)
    te = TEngine(dataclasses.replace(TDC(forensic=ft).with_threshold(0.55), **kw), TSC(**skw),
                 params=params_from_jax(pj), spec=spec_t, device="cpu")
    try:
        rj, rt = _drive(je), _drive(te)
    finally:
        je.shutdown()
        te.shutdown()
    for sid in rj:
        assert len(rt[sid]) == N_FRAMES
        for t, (a, b) in enumerate(zip(rj[sid], rt[sid])):
            assert set(a) == set(b), (sid, t)
            for k in a:
                if k in PROB_KEYS:
                    assert b[k] == pytest.approx(a[k], abs=1e-5), (sid, t, k)
                elif k != "processing_time_ms":
                    assert b[k] == a[k], (sid, t, k)
    assert all(r["analysis_mode"] == "face+frame" for r in rt["face"])
    assert all(r["analysis_mode"] == "frame_only" for r in rt["plain"])
    assert rt["face"][-1]["confidence_level"] != "UNCERTAIN"
    assert [r["frame_count"] for r in rt["plain"]] == list(range(1, N_FRAMES + 1))


@pytest.fixture(scope="module")
def engine():
    _, spec_t = small_specs()
    e = TEngine(TDC(face_backend="heuristic", forensic=TFC(analysis_size=(64, 64))),
                TSC(max_streams=2, max_batch=2),
                spec=spec_t, device="cpu")
    yield e
    e.shutdown()


def test_engine_stream_table_stats_and_reset(engine):
    r = engine.analyze(_frame("plain", 0), "a")
    assert r["frame_count"] == 1 and r["confidence_level"] == "UNCERTAIN"
    engine.analyze(_frame("plain", 1), "b")
    stats = engine.stream_stats(engine.slot_for("a"))
    assert stats["frame_count"] == 1 and stats["voting"]["total_frames"] == 1
    assert engine.frame_count("b") == 1
    engine.analyze(_frame("plain", 2), "c")          # evicts the LRU stream "a"
    assert "a" not in engine.slot_of and engine.frame_count("c") == 1
    engine.reset("c")
    assert engine.frame_count("c") == 0 and engine.frame_count("b") == 1
    assert set(engine.metrics) == {"ticks", "frames_total", "ewma_tick_latency_ms",
                                   "ewma_host_prep_ms", "ewma_batch_size",
                                   "max_batch_seen"}
    # the port's own decoder refuses a stream that is only a JPEG header
    assert engine.analyze_jpeg(b"\xff\xd8", "b") == {"error": "Invalid image format",
                                                      "status": 400}


def test_engine_admit_rate_limits_a_stream(engine):
    slot, retry = engine.admit("rate")
    assert retry is None and engine.slot_for("rate") == slot
    again, retry = engine.admit("rate")   # well inside min_request_interval
    assert again == slot and 0 < retry <= engine.server_cfg.min_request_interval * 1000


@pytest.mark.parametrize("server_kw,cfg_kw", [
    ({"device_detect": True}, {"ssd_bf16": True}), ({"ingest_scaled_decode": True}, {}),
    ({"device_detect": True}, {"mtcnn_device": True}), ({}, {"mtcnn_device": True}),
    ({}, {"clip_window": 8})])
def test_engine_unported_modes_raise(server_kw, cfg_kw):
    """The scaled decode is still refused. The SSD in bf16 and in-tick MTCNN
    are ported (tests/test_torch_mtcnn_tick.py): the engine now raises JAX's
    ValueErrors for what they lack, the SSD's weights and the MTCNN aligner.
    Clip attention is ported (tests/test_torch_clip_tick.py): the engine
    takes clip_feature_dim from the backbone and its responses carry
    clip_probability and clip_frames."""
    ported = {"ssd_bf16": "SSD weights", "mtcnn_device": "requires an MTCNNAligner"}
    for k, match in ported.items():
        if k in cfg_kw and server_kw.get("device_detect"):
            with pytest.raises(ValueError, match=match):
                TEngine(TDC(**cfg_kw), TSC(**server_kw), device="cpu")
            return
    if "clip_window" in cfg_kw:
        _, spec_t = small_specs()
        e = TEngine(TDC(forensic=TFC(analysis_size=(32, 32)), face_backend="heuristic",
                        model_input_size=64, **cfg_kw),
                    TSC(max_streams=2, max_batch=2), spec=spec_t, device="cpu")
        try:
            r = e.analyze(_frame("face", 0), "s")
        finally:
            e.shutdown()
        assert e.cfg.clip_feature_dim == spec_t.head_filters
        assert tuple(e.states.clip.feats.shape) == (3, 8, spec_t.head_filters)
        assert r["clip_frames"] == 1 and 0.0 <= r["clip_probability"] <= 1.0
        assert r["confidence_level"] == "UNCERTAIN"
        return
    if cfg_kw == {"mtcnn_device": True}:
        # outside device detect the flag is inert, as in the JAX engine
        _, spec_t = small_specs()
        e = TEngine(TDC(forensic=TFC(analysis_size=(32, 32)), **cfg_kw),
                    TSC(max_streams=2, max_batch=2), spec=spec_t, device="cpu")
        e.shutdown()
        return
    with pytest.raises(NotImplementedError):
        TEngine(TDC(**cfg_kw), TSC(**server_kw), device="cpu")


@pytest.mark.parametrize("plane", ["coef", "ycbcr420"])
def test_engine_wire_plane_needs_device_detect(plane):
    """As the JAX engine: the wire planes finish the decode inside the
    device-detect tick."""
    for eng, dc, sc in ((JEngine, JDC, JSC), (TEngine, TDC, TSC)):
        kw = {} if eng is JEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match="device_detect"):
            eng(dc(), sc(ingest_plane=plane), **kw)
