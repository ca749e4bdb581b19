"""Port parity of device-detect serving on the CPU: the capture-to-verdict
tick (serving/batcher.make_device_step_detect) against the JAX tick at
bucket 8 over three ticks, with clahe_device off and on, and the port's
MultiStreamEngine in device-detect mode against the JAX engine, an
off-size frame's face_bbox in client coordinates included. Small
EfficientNet spec with carried parameters, a small synthetic SSD
(channels (8, 8, 16, 16), decisive), 240x320 captures, 64x64 analysis
frames and classifier input.

Boxes, flags, face counts, verdicts and frame counts must be equal; floats
within TOL = 1e-5. Measured on the CPU: at most 6e-8 (float rounding), with
clahe_device off and on. (With clahe_device the JAX tick's batched CLAHE
differs from the oracle the port computes by one step on under 1% of face
pixels; the small classifier's probability does not move by more.)"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC, ServerConfig as JSC,
)
from real_time_video_deepfake_detection_tpu.models.ssd_res10 import SSDRes10 as JSSD
from real_time_video_deepfake_detection_tpu.serving import batcher as JB
from real_time_video_deepfake_detection_tpu.serving.multi import (
    MultiStreamEngine as JEngine,
)
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
    MultiStreamEngine as TEngine,
)
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import assert_same, jax_state_leaves, small_models, small_specs

TOL = 1e-5
CAPTURE = (240, 320)
EXACT = ("face_bbox", "has_face", "faces_detected", "verdict", "frame_count",
         "full_forensic")


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return (JSSD.from_caffemodel(cm, proto),
            TSSD.from_caffemodel(cm, proto, device="cpu"))


def _cfgs(clahe):
    kw = dict(model_input_size=64, clahe_device=clahe, detection_threshold=0.5)
    return (JDC(**kw, forensic=JFC(analysis_size=(64, 64))),
            TDC(**kw, forensic=TFC(analysis_size=(64, 64))))


def _frames(n, seed):
    """Capture frames with a textured background; the synthetic SSD finds
    a face on most of them."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:CAPTURE[0], :CAPTURE[1]]
    base = 110 + 60 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    f = base[None, ..., None] + r.integers(-40, 41, (n,) + CAPTURE + (3,))
    return np.clip(f, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("clahe", [False, True], ids=["host_order", "clahe_device"])
def test_detect_tick_matches_jax(ssd, clahe):
    jssd, tssd = ssd
    spec_j, pj, model = small_models(seed=6)
    cj, ct = _cfgs(clahe)
    jstep = JB.make_device_step_detect(jssd.net, spec_j, cj)
    tstep = TB.make_device_step_detect(tssd.net, model, ct)
    n_slots, b = 6, 8
    sj = JB.init_stream_states(n_slots + 1, cj)
    st = TB.init_stream_states(n_slots + 1, ct)
    rng = np.random.default_rng(11)
    faces = 0
    for t in range(3):
        frames = _frames(b, 20 + t)
        active = np.arange(b) < 6
        slot_idx = np.full(b, n_slots, np.int32)
        slot_idx[:6] = rng.permutation(n_slots)
        oj, sj = jstep(pj, jnp.asarray(frames), jnp.asarray(active),
                       jnp.asarray(slot_idx), sj)
        ot, st = tstep(*map(torch.from_numpy, (frames, active, slot_idx)), st)
        assert set(ot) == set(oj)
        for k in oj:
            assert_same(oj[k], ot[k], 0 if k in EXACT else TOL, f"tick {t} {k}")
        for i, (a, b_) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st))):
            assert_same(a, b_, TOL, f"tick {t} state leaf {i}")
        faces += int(ot["has_face"].sum())
    assert faces >= 6, "the synthetic SSD found too few faces for the test to bite"


def _drive(engine, frames):
    return [engine.analyze(f, sid) for sid, f in frames]


def test_engine_device_detect_matches_jax(ssd):
    jssd, tssd = ssd
    spec_j, pj, _ = small_models(seed=7)
    _, spec_t = small_specs()
    cj, ct = _cfgs(True)
    skw = dict(max_streams=4, max_batch=8, batch_timeout_ms=2.0, min_request_interval=0.0,
               device_detect=True, detect_capture_hw=CAPTURE)
    je = JEngine(cj, JSC(**skw), params=pj, spec=spec_j, ssd_net=jssd.net)
    te = TEngine(ct, TSC(**skw), params=params_from_jax(pj), spec=spec_t,
                 device="cpu", ssd_net=tssd.net)
    caps = _frames(4, 40)
    # an exact-2x nearest upsample conforms back to the same capture frame,
    # so its face_bbox must come back doubled in the client's coordinates
    big = np.repeat(np.repeat(caps[1], 2, axis=0), 2, axis=1)
    seq = [("a", caps[0]), ("b", caps[1]), ("a", caps[2]), ("big", big),
           ("a", caps[3]), ("b", caps[0])]
    try:
        rj, rt = _drive(je, seq), _drive(te, seq)
    finally:
        je.shutdown()
        te.shutdown()
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert set(a) == set(b), i
        for k in set(a) - {"processing_time_ms"}:
            if isinstance(a[k], float):
                assert b[k] == pytest.approx(a[k], abs=TOL), (i, k)
            else:
                assert b[k] == a[k], (i, k)
    assert sum("face_bbox" in r for r in rt) >= 3
    fb, fs = rt[3].get("face_bbox"), rt[1].get("face_bbox")
    assert fb is not None and fs is not None
    assert fb == {k: 2 * v for k, v in fs.items()}
    assert [r["frame_count"] for r in rt] == [1, 1, 2, 1, 3, 2]


def test_engine_device_detect_needs_ssd_weights():
    _, spec_t = small_specs()
    with pytest.raises(ValueError, match="SSD weights"):
        TEngine(_cfgs(False)[1], TSC(device_detect=True), spec=spec_t, device="cpu")


def test_engine_device_detect_runs_the_clahe_stage(ssd, monkeypatch):
    """With clahe_device the tick's faces go through kernels/clahe.clahe_u8
    (the plain versions on the CPU), once per tick."""
    from real_time_video_deepfake_detection_tpu_torch.kernels import clahe as KC
    calls = []
    real = KC.clahe_u8
    monkeypatch.setattr(KC, "clahe_u8", lambda x: calls.append(x.shape) or real(x))
    _, tssd = ssd
    _, spec_t = small_specs()
    te = TEngine(_cfgs(True)[1],
                 TSC(max_streams=2, max_batch=2, device_detect=True, detect_capture_hw=CAPTURE,
                     min_request_interval=0.0), spec=spec_t, device="cpu", ssd_net=tssd.net)
    try:
        n0 = len(calls)
        te.analyze(_frames(1, 50)[0], "x")
        assert len(calls) == n0 + 1 and calls[-1] == (2, 160, 160)
    finally:
        te.shutdown()
