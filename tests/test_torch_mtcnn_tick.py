"""Port parity of MTCNN alignment in serving, on the CPU, against the JAX
package: the detect tick with DetectorConfig.mtcnn_device (the P/R/O
cascade in the tick, with clahe_device off and on) against JAX's
make_device_step_detect; an O-Net rejection falling to forensic-only through
the engine; the host-prep engine with an MTCNNAligner (align_box_multiple
rounding included) against the JAX engine; JAX's configuration errors; and
the detect tick with the SSD in bf16 against JAX's.

Small EfficientNet spec with carried parameters, a small synthetic SSD
(channels (8, 8, 16, 16), decisive), 240x320 captures, 64x64 analysis
frames and classifier input, the cascade on the 160x160 crop with caps
(32, 8, 4). The cascade's weights are JAX's init_random_mtcnn(5) with ±3
class-head biases, carried across: their scores do not saturate, so few of
P-Net's top probabilities tie (at ±5 most do).

Tolerances: boxes, flags, counts, verdicts and frame counts equal; the
probabilities of face rows within 1e-5, as JAX's own
test_mtcnn_device_tick_matches_composed_host_ops holds its tick. With
ssd_bf16 both packages run the SSD in bfloat16, each with its own
convolutions and elementwise rounding: has_face, the verdicts and the boxes
of face rows are equal, and the probabilities of face rows within
BF16_PROB. faces_detected counts the ~45 boxes of a frame whose bf16
confidence exceeds 0.5, and a box at the threshold can fall either way: it
is held within BF16_COUNT (measured on the CPU: 4 of 16 frames differ by
one box, whether the port rounds after each layer or once per chain of
elementwise layers; PERF.md)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC, ServerConfig as JSC,
)
from real_time_video_deepfake_detection_tpu.models import mtcnn as JM
from real_time_video_deepfake_detection_tpu.models.ssd_res10 import SSDRes10 as JSSD
from real_time_video_deepfake_detection_tpu.serving import batcher as JB
from real_time_video_deepfake_detection_tpu.serving.multi import (
    MultiStreamEngine as JEngine,
)
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models import mtcnn as TM
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.pipeline import detector as t_detector
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.serving import multi as t_multi
from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
    MultiStreamEngine as TEngine,
)
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
from real_time_video_deepfake_detection_tpu_torch.utils.convert import (
    mtcnn_state_dicts_from_jax, params_from_jax,
)
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.test_torch_engine import _frame as _engine_frame
from tests.torch_port_util import assert_same, jax_state_leaves, small_models, small_specs

TOL = 1e-5
BF16_PROB = 1e-3
BF16_COUNT = 1
CAPTURE = (240, 320)
CAPS = (32, 8, 4)
EXACT = ("face_bbox", "has_face", "faces_detected", "verdict", "frame_count",
         "full_forensic")


def _mtcnn_tree(accept=True):
    """JAX init_random_mtcnn(5) as numpy with ±3 class heads; O-Net's
    reversed when not `accept`."""
    p = jax.tree.map(np.asarray, JM.init_random_mtcnn(5))
    b = np.asarray([-3.0, 3.0], np.float32)
    p["pnet"]["conv4_1"]["b"] = b
    p["rnet"]["dense5_1"]["b"] = b
    p["onet"]["dense6_1"]["b"] = b if accept else -b
    return p


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return (JSSD.from_caffemodel(cm, proto),
            TSSD.from_caffemodel(cm, proto, device="cpu"))


def _cfgs(**kw):
    kw = dict(model_input_size=64, detection_threshold=0.5, mtcnn_tick_caps=CAPS, **kw)
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


def _run_ticks(jstep, tstep, pj, cfgs, n_ticks, b=8, n_slots=6):
    """Both ticks on the same frames; yields (tick, JAX out, port out) with
    the states compared after each tick."""
    sj = JB.init_stream_states(n_slots + 1, cfgs[0])
    st = TB.init_stream_states(n_slots + 1, cfgs[1])
    rng = np.random.default_rng(11)
    for t in range(n_ticks):
        frames = _frames(b, 20 + t)
        active = np.arange(b) < n_slots
        slot_idx = np.full(b, n_slots, np.int32)
        slot_idx[:n_slots] = rng.permutation(n_slots)
        oj, sj = jstep(pj, jnp.asarray(frames), jnp.asarray(active), jnp.asarray(slot_idx), sj)
        ot, st = tstep(*map(torch.from_numpy, (frames, active, slot_idx)), st)
        for i, (a, b_) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st))):
            assert_same(a, b_, TOL, f"tick {t} state leaf {i}")
        yield t, oj, ot


@pytest.mark.parametrize("clahe", [False, True], ids=["no_clahe", "clahe_device"])
def test_mtcnn_device_tick_matches_jax(ssd, clahe):
    jssd, tssd = ssd
    spec_j, pj, model = small_models(seed=6)
    cj, ct = _cfgs(clahe_device=clahe, mtcnn_device=True)
    tree = _mtcnn_tree()
    jstep = JB.make_device_step_detect(jssd.net, spec_j, cj, jax.tree.map(jnp.asarray, tree))
    tstep = TB.make_device_step_detect(tssd.net, model, ct,
                                       TM.build_nets(mtcnn_state_dicts_from_jax(tree), "cpu"))
    accepted = 0
    for t, oj, ot in _run_ticks(jstep, tstep, pj, (cj, ct), 2):
        assert set(ot) == set(oj)
        hf = np.array(oj["has_face"])
        for k in oj:
            a, b = np.array(oj[k]), ot[k]
            if k == "face_probability":   # meaningful on face rows only
                a, b = a[hf], b[torch.from_numpy(hf)]
            assert_same(a, b, 0 if k in EXACT else TOL, f"tick {t} {k}")
        accepted += int(hf.sum())
    assert accepted >= 2, "no SSD face passed the cascade: the test would be inert"


def test_mtcnn_device_onet_reject_falls_to_forensic(ssd):
    """An O-Net rejection downgrades the stream to forensic-only (the
    reference's `mtcnn(img) is None`), though the SSD found a box."""
    _, tssd = ssd
    _, spec_t = small_specs()
    _, ct = _cfgs(clahe_device=True, mtcnn_device=True)
    aligner = TM.MTCNNAligner(mtcnn_state_dicts_from_jax(_mtcnn_tree(accept=False)),
                              device="cpu")
    te = TEngine(ct, TSC(max_streams=2, max_batch=2, batch_timeout_ms=2.0,
                         min_request_interval=0.0, device_detect=True,
                         detect_capture_hw=CAPTURE),
                 spec=spec_t, device="cpu", ssd_net=tssd.net, aligner=aligner)
    try:
        frames = _frames(3, 30)
        det = TB.make_device_step_detect(tssd.net, te.model, dataclasses.replace(
            ct, mtcnn_device=False))
        out, _ = det(torch.from_numpy(frames), torch.ones(3, dtype=torch.bool),
                     torch.full((3,), 2, dtype=torch.int32), TB.init_stream_states(3, ct))
        assert bool(out["has_face"].all()), "the SSD must find the faces"
        for i, f in enumerate(frames):
            r = te.analyze(f, f"s{i}")
            assert r["analysis_mode"] == "frame_only"
            assert "face_probability" not in r and r["faces_detected"] >= 1
            assert r["fake_probability"] == pytest.approx(r["frame_forensic_probability"])
    finally:
        te.shutdown()


def test_host_prep_engine_with_mtcnn_matches_jax(monkeypatch):
    """The host-prep engines with an MTCNN aligner, heuristic detection
    and align_box_multiple 32 (the crop rounded up, clipped to the frame):
    the same responses."""
    monkeypatch.setattr(j_detector, "_LAB_BACKEND", "jnp")
    monkeypatch.setattr(t_detector, "_LAB_BACKEND", "jnp")
    spec_j, spec_t = small_specs()
    _, pj, _ = small_models(seed=5)
    tree = _mtcnn_tree()
    kw = dict(face_backend="heuristic", model_input_size=64)
    skw = dict(max_streams=4, max_batch=4, min_request_interval=0.0, align_box_multiple=32)
    je = JEngine(dataclasses.replace(JDC(forensic=JFC(analysis_size=(64, 64))), **kw),
                 JSC(**skw), params=pj, spec=spec_j,
                 aligner=JM.MTCNNAligner(jax.tree.map(jnp.asarray, tree)))
    te = TEngine(dataclasses.replace(TDC(forensic=TFC(analysis_size=(64, 64))), **kw),
                 TSC(**skw), params=params_from_jax(pj), spec=spec_t, device="cpu",
                 aligner=TM.MTCNNAligner(mtcnn_state_dicts_from_jax(tree), device="cpu"))
    assert te._faces_dtype == np.float32
    seq = [("face", _engine_frame("face", t)) for t in range(4)] + [
        ("plain", _engine_frame("plain", 0))]
    try:
        rj = [je.analyze(f, sid) for sid, f in seq]
        rt = [te.analyze(f, sid) for sid, f in seq]
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
    faces = [r for r in rt if r["analysis_mode"] == "face+frame"]
    assert faces, "no frame passed the cascade: the test would be inert"
    # the rounded crop: width and height multiples of 32 unless clipped
    for r in faces:
        box = r["face_bbox"]
        assert box["width"] % 32 == 0 or box["x"] + box["width"] == 320
        assert box["height"] % 32 == 0 or box["y"] + box["height"] == 240


def test_mtcnn_configuration_errors_match_jax(ssd):
    jssd, tssd = ssd
    spec_j, spec_t = small_specs()
    _, pj, _ = small_models(seed=5)
    tree = _mtcnn_tree()
    jal = JM.MTCNNAligner(jax.tree.map(jnp.asarray, tree))
    tal = TM.MTCNNAligner(mtcnn_state_dicts_from_jax(tree), device="cpu")
    cases = [
        # clahe_device with the host MTCNN aligner
        (dict(clahe_device=True), {}, "clahe_device requires the resize aligner"),
        # a plain MTCNN aligner in device-detect mode
        (dict(), dict(device_detect=True), "pairs with the resize aligner"),
    ]
    for cfg_kw, s_kw, match in cases:
        cj, ct = _cfgs(**cfg_kw)
        skw = dict(max_streams=2, max_batch=2, detect_capture_hw=CAPTURE, **s_kw)
        with pytest.raises(ValueError, match=match):
            JEngine(cj, JSC(**skw), params=pj, spec=spec_j, aligner=jal, ssd_net=jssd.net)
        with pytest.raises(ValueError, match=match):
            TEngine(ct, TSC(**skw), spec=spec_t, device="cpu", aligner=tal, ssd_net=tssd.net)
    # mtcnn_device without an MTCNN aligner
    cj, ct = _cfgs(mtcnn_device=True)
    skw = dict(max_streams=2, max_batch=2, device_detect=True, detect_capture_hw=CAPTURE)
    with pytest.raises(ValueError, match="requires an MTCNNAligner"):
        JEngine(cj, JSC(**skw), params=pj, spec=spec_j, ssd_net=jssd.net)
    with pytest.raises(ValueError, match="requires an MTCNNAligner"):
        TEngine(ct, TSC(**skw), spec=spec_t, device="cpu", ssd_net=tssd.net)
    with pytest.raises(ValueError, match="mtcnn_nets"):
        TB.make_device_step_detect(tssd.net, None, ct)


def test_mtcnn_device_tick_runs_the_aligners_modules(ssd, monkeypatch):
    """With mtcnn_device the engine hands the aligner's own P/R/O modules
    to every tick (no second copy of the weights), and refuses an aligner
    on another device."""
    _, tssd = ssd
    _, spec_t = small_specs()
    _, ct = _cfgs(mtcnn_device=True)
    aligner = TM.MTCNNAligner(mtcnn_state_dicts_from_jax(_mtcnn_tree()), device="cpu")
    handed = []

    def recording(net, model, cfg, mtcnn_nets=None):
        handed.append(mtcnn_nets)
        return TB.make_device_step_detect(net, model, cfg, mtcnn_nets)

    monkeypatch.setattr(t_multi, "make_device_step_detect", recording)
    skw = dict(max_streams=2, max_batch=2, device_detect=True, detect_capture_hw=CAPTURE)
    te = TEngine(ct, TSC(**skw), spec=spec_t, device="cpu", ssd_net=tssd.net, aligner=aligner)
    te.shutdown()
    assert handed and all(n is aligner.nets for n in handed)
    aligner.device = torch.device("cuda", 1)
    with pytest.raises(ValueError, match="on the engine's device"):
        TEngine(ct, TSC(**skw), spec=spec_t, device="cpu", ssd_net=tssd.net, aligner=aligner)


def test_ssd_bf16_tick_matches_jax(ssd):
    jssd, tssd = ssd
    spec_j, pj, model = small_models(seed=6)
    cj, ct = _cfgs(clahe_device=True, ssd_bf16=True)
    jstep = JB.make_device_step_detect(jssd.net, spec_j, cj)
    tstep = TB.make_device_step_detect(tssd.net, model, ct)
    faces = 0
    for t, oj, ot in _run_ticks(jstep, tstep, pj, (cj, ct), 2):
        hf = np.asarray(oj["has_face"])
        for k in ("has_face", "verdict", "frame_count"):
            assert_same(oj[k], ot[k], 0, f"tick {t} {k}")
        np.testing.assert_array_equal(ot["face_bbox"].numpy()[hf], np.asarray(oj["face_bbox"])[hf])
        count_diff = np.abs(ot["faces_detected"].numpy() - np.asarray(oj["faces_detected"]))
        assert count_diff.max() <= BF16_COUNT, (t, count_diff)
        for k in ("face_probability", "fake_probability"):
            a, b = np.asarray(oj[k])[hf], ot[k].numpy()[hf]
            assert np.abs(a - b).max(initial=0) <= BF16_PROB, (t, k, np.abs(a - b).max())
        faces += int(hf.sum())
    assert faces >= 4, "the bf16 SSD found too few faces for the test to bite"
    # the tick runs a bf16 copy; the SSD it was given stays float32
    assert all(b.dtype == torch.float32 for b in tssd.net.buffers())
