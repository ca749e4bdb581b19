"""Port parity of the stream-sharded ticks on the CPU: the port's
make_sharded_device_step over a CPU mesh of 4 against JAX's over 4 of the
8 virtual devices (tests/conftest.py), 16 streams over three ticks with the
preproc, hue and CLAHE kernels' flags on; make_sharded_device_step_detect
over a mesh of 2 in its bgr form with clahe_device, its coef wire form and
with the MTCNN cascade in the tick (caps (16, 4, 2)); the serving tick in
clip mode (window 8) over a mesh of 2; a stream count that does not divide
by the mesh; and the mesh helpers.

Small EfficientNet spec with carried parameters, the synthetic SSD at
channels (8, 16, 32, 64) (the JAX dryrun's, decisive), 240x320 captures,
64x64 analysis frames and classifier input. Tolerances are those of JAX's
test_sharded_serving_tick_matches_single_device (tests/test_multi_stream.py):
floats within TOL = 2e-5; verdicts, boxes, flags and counts exactly; state
leaves within TOL. The JAX Pallas preproc kernel runs in interpret mode, as
tests/test_pallas_kernels.py runs it; the port's wrappers take their plain
versions on CPU tensors. Torch runs on one thread (beside the other test
workers its thread pool only contends)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.kernels.preproc as j_preproc
from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC,
)
from real_time_video_deepfake_detection_tpu.models import mtcnn as JM
from real_time_video_deepfake_detection_tpu.models.ssd_res10 import SSDRes10 as JSSD
from real_time_video_deepfake_detection_tpu.parallel.mesh import make_mesh as jax_mesh
from real_time_video_deepfake_detection_tpu.serving import batcher as JB
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC,
)
from real_time_video_deepfake_detection_tpu_torch.models import mtcnn as TM
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as TP
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
from real_time_video_deepfake_detection_tpu_torch.utils.convert import (
    mtcnn_state_dicts_from_jax,
)
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import (
    assert_same, clip_head_models, jax_state_leaves, small_models,
)
from tests.torch_train_util import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

TOL = 2e-5
CAPTURE = (240, 320)
EXACT = ("face_bbox", "has_face", "faces_detected", "verdict", "frame_count",
         "full_forensic", "clip_frames")


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(j_preproc, "preprocess_faces_pallas", functools.partial(
        j_preproc.preprocess_faces_pallas, interpret=True))


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=1,
                                channels=(8, 16, 32, 64), decisive=True)
    return (JSSD.from_caffemodel(cm, proto),
            TSSD.from_caffemodel(cm, proto, device="cpu"))


def _cfgs(**kw):
    kw = {**dict(model_input_size=64, mtcnn_image_size=64, detection_threshold=0.5,
                 use_pallas_preproc=True, use_pallas_color=True), **kw}
    return (JDC(**kw, forensic=JFC(analysis_size=(64, 64))),
            TDC(**kw, forensic=TFC(analysis_size=(64, 64))))


def _compare(oj, sj, outs, states, what):
    """JAX's sharded outputs and states against the port's shards, gathered."""
    ot, st = TP.gather(outs), TP.gather(states)
    assert set(ot) == set(oj), what
    for k in oj:
        assert_same(np.asarray(oj[k]), ot[k], 0 if k in EXACT else TOL, f"{what} {k}")
    for i, (a, b) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st))):
        assert_same(a, b, TOL, f"{what} state leaf {i}")
    return ot


def _host_inputs(rng, n, t, face=64):
    yy, xx = np.mgrid[:64, :64]
    scene = 120 + 60 * np.sin((xx + t) / 5.0)[..., None] * np.ones(3)
    frames = np.clip(scene[None] + rng.normal(0, 8, (n, 64, 64, 3)), 0, 255).astype(np.uint8)
    faces = rng.integers(0, 256, (n, face, face, 3), dtype=np.uint8)
    has_face = rng.random(n) < 0.7
    face_hw = rng.integers(40, 200, (n, 2)).astype(np.int32)
    active = rng.random(n) < 0.85
    return frames, faces, has_face, face_hw, active


def test_sharded_tick_matches_jax_on_a_mesh_of_4():
    spec_j, pj, model = small_models(seed=4)
    cj, ct = _cfgs(clahe_device=True)
    n = 16
    jstep = JB.make_sharded_device_step(jax_mesh(4), spec_j, cj)
    tmesh = TP.make_mesh(4, "cpu")
    tstep = TB.make_sharded_device_step(tmesh, model, ct)
    sj = JB.init_stream_states(n, cj)
    st = TP.shard_batch(tmesh, TB.init_stream_states(n, ct))
    rng = np.random.default_rng(9)
    for t in range(3):
        args = _host_inputs(rng, n, t)
        oj, sj = jstep(pj, *map(jnp.asarray, args), sj)
        outs, st = tstep(*map(torch.from_numpy, args), st)
        assert len(outs) == len(st) == 4 and all(o["verdict"].shape == (4,) for o in outs)
        _compare(oj, sj, outs, st, f"tick {t}")
    assert int(np.asarray(sj.frame_count).max()) >= 2


def _captures(n, seed):
    """Capture frames with a textured background; the synthetic SSD finds
    a face on most of them."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:CAPTURE[0], :CAPTURE[1]]
    base = 110 + 60 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    f = base[None, ..., None] + r.integers(-40, 41, (n,) + CAPTURE + (3,))
    return np.clip(f, 0, 255).astype(np.uint8)


def _coef_plane(frames):
    """The coef wire plane of the frames' q85 4:2:0 JPEGs."""
    datas = [cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 85])[1].tobytes()
             for f in frames]
    y, c, q, ok = J.decode_coefs_wire_batch(datas, *CAPTURE)
    assert ok.all()
    return [y, c, q]


def _mtcnn_tree():
    """JAX init_random_mtcnn(5) as numpy with ±3 class heads: scores that do
    not saturate (tests/test_torch_mtcnn_tick.py)."""
    p = jax.tree.map(np.asarray, JM.init_random_mtcnn(5))
    b = np.asarray([-3.0, 3.0], np.float32)
    p["pnet"]["conv4_1"]["b"] = b
    p["rnet"]["dense5_1"]["b"] = b
    p["onet"]["dense6_1"]["b"] = b
    return p


@pytest.mark.parametrize("form", ["bgr_clahe", "coef", "mtcnn"])
def test_sharded_detect_tick_matches_jax_on_a_mesh_of_2(ssd, form):
    jssd, tssd = ssd
    spec_j, pj, model = small_models(seed=6)
    kw = {"bgr_clahe": dict(clahe_device=True), "coef": {},
          "mtcnn": dict(clahe_device=True, mtcnn_device=True, mtcnn_tick_caps=(16, 4, 2),
                        mtcnn_image_size=160)}[form]
    cj, ct = _cfgs(**kw)
    wire = dict(wire="coef", capture_hw=CAPTURE) if form == "coef" else {}
    tree = _mtcnn_tree() if form == "mtcnn" else None
    jstep = JB.make_sharded_device_step_detect(
        jax_mesh(2), jssd.net, spec_j, cj,
        None if tree is None else jax.tree.map(jnp.asarray, tree), **wire)
    tmesh = TP.Mesh(("cpu", "cpu"))
    tstep = TB.make_sharded_device_step_detect(
        tmesh, tssd.net, model, ct,
        None if tree is None else TM.build_nets(mtcnn_state_dicts_from_jax(tree), "cpu"),
        **wire)
    n = 8
    sj = JB.init_stream_states(n, cj)
    st = TB.init_stream_states(n, ct)
    faces = 0
    for t in range(2):
        frames = _captures(n, 20 + t)
        inputs = _coef_plane(frames) if form == "coef" else [frames]
        active = np.arange(n) != 3
        oj, sj = jstep(pj, *map(jnp.asarray, inputs), jnp.asarray(active), sj)
        outs, st = tstep(*map(torch.from_numpy, inputs + [active]), st)
        ot = _compare(oj, sj, outs, st, f"{form} tick {t}")
        faces += int(ot["has_face"].sum())
    assert faces >= 4, "the synthetic SSD (and cascade) passed too few faces to bite"


def test_sharded_clip_tick_matches_jax_on_a_mesh_of_2():
    spec_j, pj, model = small_models(seed=5)
    cj, ct = _cfgs(clip_window=8, clip_min_frames=2, clip_feature_dim=32)
    hj, head = clip_head_models(JB.clip_head_spec(cj), 105)
    jstep = JB.make_sharded_device_step(jax_mesh(2), spec_j, cj)
    tstep = TB.make_sharded_device_step(["cpu", "cpu"], {"backbone": model, "clip_head": head},
                                        ct)
    n = 8
    sj = JB.init_stream_states(n, cj)
    st = TB.init_stream_states(n, ct)
    rng = np.random.default_rng(3)
    for t in range(4):
        args = _host_inputs(rng, n, t)
        oj, sj = jstep({"backbone": pj, "clip_head": hj}, *map(jnp.asarray, args), sj)
        outs, st = tstep(*map(torch.from_numpy, args), st)
        ot = _compare(oj, sj, outs, st, f"clip tick {t}")
    assert "clip_probability" in ot and int(ot["clip_frames"].max()) >= 2


def test_sharded_steps_refuse_a_stream_count_that_does_not_divide(ssd):
    _, _, model = small_models(seed=1)
    _, ct = _cfgs()
    step = TB.make_sharded_device_step(TP.make_mesh(4, "cpu"), model, ct)
    z = torch.zeros
    with pytest.raises(ValueError, match="does not divide"):
        step(z((6, 64, 64, 3), dtype=torch.uint8), z((6, 64, 64, 3)),
             z(6, dtype=torch.bool), z((6, 2), dtype=torch.int32),
             z(6, dtype=torch.bool), TB.init_stream_states(6, ct))
    dstep = TB.make_sharded_device_step_detect(["cpu"] * 4, ssd[1].net, model, ct)
    with pytest.raises(ValueError, match="does not divide"):
        dstep(torch.from_numpy(_captures(2, 0)), z(2, dtype=torch.bool),
              TB.init_stream_states(2, ct))


def test_mesh_helpers():
    m = TP.make_mesh(3, "cpu")
    assert m.devices == (torch.device("cpu"),) * 3 and m.distinct == (torch.device("cpu"),)
    assert len(TP.make_mesh(device="cpu")) == 1
    _, _, model = small_models(seed=1)
    # a module already on the device serves it; a dict is replicated leaf by leaf
    assert TP.replicated(m, model) == {torch.device("cpu"): model}
    assert TP.replicated(m, {"a": model, "b": None})[torch.device("cpu")]["a"] is model
    x = torch.arange(12).view(6, 2)
    shards = TP.shard_batch(m, x)
    assert [s.tolist() for s in shards] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    assert torch.equal(TP.gather(shards), x)
    assert torch.equal(TP.gather([{"k": s} for s in shards])["k"], x)
    _, ct = _cfgs()
    st = TB.init_stream_states(6, ct)
    st.frame_count += torch.arange(6, dtype=torch.int32)
    parts = TP.shard_batch(m, st)
    assert [p.frame_count.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5]]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(TP.gather(parts)),
                                                 tree_leaves(st)))
    with pytest.raises(ValueError):
        TP.Mesh(())
    assert TP.world_size() == 1 and TP.rank() == 0
