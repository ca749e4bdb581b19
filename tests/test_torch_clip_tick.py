"""Port parity of clip-attention serving (BASELINE config 5) on the CPU: the
serving tick in clip mode (serving/batcher, DetectorConfig.clip_window > 0)
against the JAX tick with the small EfficientNet and the tiny ViT of
tests/torch_port_util.py, the detect tick in clip mode, the bf16 tick, and
the port's MultiStreamEngine against the JAX engine with the tiny ViT.

Tolerances: clip_probability and every other float within TOL = 1e-5 in
float32; verdicts, clip_frames, frame counts and the ring's counts and
positions exactly, its features within TOL. The bf16 tick: verdicts and
integers exactly, floats within BF16_TOL = 5e-3 (measured on the CPU: at
most 3.0e-4 with the small EfficientNet and 8.9e-4 with the tiny ViT; the
two packages round bf16 matmuls, norms and activations apart), and the
ring's features (bf16 values cast to float32) within one bf16 ulp of the
largest, 2^-7 of it (measured: at most 0.0078 with features up to 1.57,
EfficientNet, and 0.0039 up to 1.08, ViT).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
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
import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models import vit as TV
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.pipeline import detector as t_detector
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
    MultiStreamEngine as TEngine,
)
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import (
    assert_same, clip_head_models, jax_state_leaves, small_models, vit_models,
)

TOL = 1e-5
BF16_TOL = 5e-3
EXACT = ("face_bbox", "has_face", "faces_detected", "verdict", "frame_count",
         "full_forensic", "clip_frames")


def _backbone(name: str, seed: int):
    """(spec_j, params_j, port module, feature dim)."""
    if name == "vit_tiny":
        spec_j, pj, model = vit_models(seed=seed)
        return spec_j, pj, model, 64
    spec_j, pj, model = small_models(seed=seed)
    return spec_j, pj, model, 32


def _clip_setup(name: str, seed: int, **kw):
    """JAX and port configs in clip mode (window 6, min frames 2) and the
    params of each tick: {"backbone", "clip_head"} on both sides."""
    spec_j, pj, model, fdim = _backbone(name, seed)
    kw = dict(model_input_size=64, detection_threshold=0.5, clip_window=6,
              clip_min_frames=2, clip_feature_dim=fdim, **kw)
    cj = JDC(**kw, forensic=JFC(analysis_size=(64, 64)))
    ct = TDC(**kw, forensic=TFC(analysis_size=(64, 64)))
    hj, head = clip_head_models(JB.clip_head_spec(cj), seed + 100)
    return (spec_j, cj, {"backbone": pj, "clip_head": hj}, ct,
            {"backbone": model, "clip_head": head})


def _run_compact_ticks(name: str, bf16: bool = False):
    spec_j, cj, pj, ct, mt = _clip_setup(name, 4, bf16_inference=bf16, mtcnn_image_size=40)
    n_slots, b = 4, 4
    sj = JB.init_stream_states(n_slots + 1, cj)
    st = TB.init_stream_states(n_slots + 1, ct)
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[:64, :64]
    diffs, seen = [0.0], {"frames": [], "verdicts": []}
    tol = BF16_TOL if bf16 else TOL
    for t in range(8):
        scene = 120 + 60 * np.sin((xx + t) / 5.0)[..., None] * np.ones(3)
        frames = np.clip(scene[None] + rng.normal(0, 8, (b, 64, 64, 3)), 0, 255)
        frames = frames.astype(np.uint8)
        faces = rng.integers(0, 256, (b, 40, 40, 3), dtype=np.uint8)
        has_face = rng.random(b) < 0.85
        face_hw = rng.integers(40, 200, (b, 2)).astype(np.int32)
        active = rng.random(b) < 0.9
        active[0] = True
        slot_idx = np.where(active, rng.permutation(n_slots)[:b], n_slots).astype(np.int32)
        args = (frames, faces, has_face, face_hw, active, slot_idx)
        oj, sj = JB.device_step_compact(spec_j, cj, pj, *map(jnp.asarray, args), sj)
        ot, st = TB.device_step_compact(mt, ct, *map(torch.from_numpy, args), st)
        assert set(ot) == set(oj) and "clip_probability" in ot
        for k in oj:
            assert_same(oj[k], ot[k], 0 if k in EXACT else tol, f"tick {t} {k}")
            if k not in EXACT:
                diffs.append(float(np.abs(np.asarray(oj[k]) - ot[k].numpy()).max()))
        leaves = list(zip(jax_state_leaves(sj), tree_leaves(st), strict=True))
        for i, (a, b_) in enumerate(leaves[:-3] + leaves[-2:]):
            assert_same(a, b_, tol, f"tick {t} state leaf {i}")
        # the ring's features: in bf16 inference bf16 values, within one
        # bf16 ulp (2^-7 relative) of the largest feature
        ring_j, ring_t = leaves[-3]
        ring_tol = 2.0 ** -7 * float(np.abs(ring_j).max()) if bf16 else TOL
        np.testing.assert_allclose(ring_t.numpy(), ring_j, rtol=0, atol=ring_tol,
                                   err_msg=f"tick {t} ring")
        seen["frames"] += ot["clip_frames"][active].tolist()
        seen["verdicts"] += ot["verdict"][active].tolist()
    return max(diffs), seen


@pytest.mark.parametrize("name", ["b0_small", "vit_tiny"])
def test_clip_tick_matches_jax(name):
    """device_step_compact over 8 ticks, slot indices, face / no-face
    mixes and inactive pads; the ring wraps on some stream."""
    _, seen = _run_compact_ticks(name)
    assert max(seen["frames"]) == 6                 # a full ring that wrapped
    assert -1 in seen["verdicts"] and {0, 1} & set(seen["verdicts"])


@pytest.mark.parametrize("name", ["b0_small", "vit_tiny"])
def test_clip_tick_bf16_matches_jax(name):
    diff, seen = _run_compact_ticks(name, bf16=True)
    assert diff <= BF16_TOL and {0, 1} & set(seen["verdicts"])


def test_clip_head_spec_and_ring_shapes():
    """clip_head_spec follows the config; the ring is (N, 1, 1) when clip
    mode is off, as in the JAX states."""
    for window, fdim, shape in ((0, 384, (3, 1, 1)), (64, 768, (3, 64, 768))):
        cfg = TDC(clip_window=window, clip_feature_dim=fdim)
        assert tuple(TB.init_stream_states(3, cfg).clip.feats.shape) == shape
        jspec, tspec = JB.clip_head_spec(JDC(clip_window=window, clip_feature_dim=fdim)), \
            TB.clip_head_spec(cfg)
        assert dataclasses.asdict(jspec) == dataclasses.asdict(tspec)
    st = TB.init_stream_states(2, TDC(clip_window=4, clip_feature_dim=8))
    st.clip.n += 3
    st.clip.feats += 1.0
    out = TB.reset_streams(st, torch.tensor([True, False]))
    assert out.clip.n.tolist() == [0, 3] and float(out.clip.feats[0].abs().sum()) == 0.0


CAPTURE = (240, 320)


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return (JSSD.from_caffemodel(cm, proto),
            TSSD.from_caffemodel(cm, proto, device="cpu"))


def _captures(n, seed):
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:CAPTURE[0], :CAPTURE[1]]
    base = 110 + 60 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    f = base[None, ..., None] + r.integers(-40, 41, (n,) + CAPTURE + (3,))
    return np.clip(f, 0, 255).astype(np.uint8)


def test_detect_tick_clip_mode_matches_jax(ssd):
    """The capture-to-verdict tick with clahe_device and clip mode, bucket 8
    over four ticks."""
    jssd, tssd = ssd
    spec_j, cj, pj, ct, mt = _clip_setup("b0_small", 6, clahe_device=True)
    jstep = JB.make_device_step_detect(jssd.net, spec_j, cj)
    tstep = TB.make_device_step_detect(tssd.net, mt, ct)
    n_slots, b = 6, 8
    sj = JB.init_stream_states(n_slots + 1, cj)
    st = TB.init_stream_states(n_slots + 1, ct)
    rng = np.random.default_rng(11)
    for t in range(4):
        frames = _captures(b, 20 + t)
        active = np.arange(b) < 6
        slot_idx = np.full(b, n_slots, np.int32)
        slot_idx[:6] = rng.permutation(n_slots)
        oj, sj = jstep(pj, jnp.asarray(frames), jnp.asarray(active),
                       jnp.asarray(slot_idx), sj)
        ot, st = tstep(*map(torch.from_numpy, (frames, active, slot_idx)), st)
        assert set(ot) == set(oj) and "clip_frames" in ot
        for k in oj:
            assert_same(oj[k], ot[k], 0 if k in EXACT else TOL, f"tick {t} {k}")
        for i, (a, b_) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st), strict=True)):
            assert_same(a, b_, TOL, f"tick {t} state leaf {i}")
    assert int(st.clip.n.max()) >= 2, "too few faces for the clip verdict to decide"


def _frame(stream: str, t: int) -> np.ndarray:
    """320x240 BGR; the "face" stream carries a skin-toned ellipse the
    heuristic detector finds."""
    rng = np.random.default_rng(1000 * t + len(stream))
    yy, xx = np.mgrid[:240, :320]
    f = 110 + 50 * np.sin(xx / 17.0 + t / 3.0) * np.cos(yy / 23.0)
    f = np.repeat((f + rng.integers(-8, 9, (240, 320)))[..., None], 3, axis=2)
    if stream == "face":
        m = ((xx - 160 - 2 * t) / 60.0) ** 2 + ((yy - 120) / 80.0) ** 2 <= 1.0
        f[m] = np.array([140, 160, 210]) + rng.integers(-5, 6, (int(m.sum()), 3))
    return np.clip(f, 0, 255).astype(np.uint8)


def test_engine_clip_mode_matches_jax(monkeypatch):
    """Host-prep engines with the tiny ViT and clip_window 6: the port infers
    clip_feature_dim from the backbone, answers the JAX engine's responses
    (clip_probability and clip_frames included) on the same frames, and
    /reset of a stream clears its ring."""
    monkeypatch.setattr(j_detector, "_LAB_BACKEND", "jnp")
    monkeypatch.setattr(t_detector, "_LAB_BACKEND", "jnp")
    spec_j, pj, model = vit_models(seed=5)
    kw = dict(face_backend="heuristic", model_input_size=64, clip_window=6,
              clip_min_frames=3)
    cj = dataclasses.replace(JDC(forensic=JFC(analysis_size=(64, 64))).with_threshold(0.5),
                             **kw)
    ct = dataclasses.replace(TDC(forensic=TFC(analysis_size=(64, 64))).with_threshold(0.5),
                             **kw)
    hj, head = clip_head_models(JB.clip_head_spec(dataclasses.replace(cj, clip_feature_dim=64)),
                                seed=105)
    skw = dict(max_streams=4, max_batch=4, min_request_interval=0.0)
    je = JEngine(cj, JSC(**skw), params=pj, spec=spec_j, clip_head_params=hj)
    te = TEngine(ct, TSC(**skw), params=params_from_jax(pj, model),
                 spec=TV.ViTSpec(**dataclasses.asdict(spec_j)), device="cpu",
                 clip_head_params=params_from_jax(hj, head))
    try:
        assert te.cfg.clip_feature_dim == je.cfg.clip_feature_dim == 64
        seq = [(sid, t) for t in range(5) for sid in ("face", "plain")]
        rj = [je.analyze(_frame(sid, t), sid) for sid, t in seq]
        rt = [te.analyze(_frame(sid, t), sid) for sid, t in seq]
        te.reset("face")
        after = te.analyze(_frame("face", 5), "face")
    finally:
        je.shutdown()
        te.shutdown()
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert set(a) == set(b) and "clip_probability" in b, i
        for k in set(a) - {"processing_time_ms"}:
            if isinstance(a[k], float):
                assert b[k] == pytest.approx(a[k], abs=TOL), (i, k)
            else:
                assert b[k] == a[k], (i, k)
    face = [r for (sid, _), r in zip(seq, rt) if sid == "face"]
    assert [r["clip_frames"] for r in face] == [1, 2, 3, 4, 5]
    assert [r["confidence_level"] for r in face][:2] == ["UNCERTAIN"] * 2
    assert face[-1]["confidence_level"] in ("REAL", "FAKE")
    assert all(r["clip_frames"] == 0 for (sid, _), r in zip(seq, rt) if sid == "plain")
    assert after["clip_frames"] == 1 and after["frame_count"] == 1
