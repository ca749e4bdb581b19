"""Port parity: the serving tick (serving/batcher.device_step_compact)
against the JAX tick over 10 ticks — small EfficientNet spec with carried
parameters, 4 slots plus the dummy row, mixed active / has_face / face_hw,
a calibrator, and the preproc and color kernel flags off and on. The JAX
Pallas preproc kernel runs in interpret mode on the CPU (as
tests/test_pallas_kernels.py runs it); the port takes its plain versions.
Every output key and state leaf: integers exactly, floats within 1e-5."""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import real_time_video_deepfake_detection_tpu.kernels.preproc as j_preproc
from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC,
)
from real_time_video_deepfake_detection_tpu.serving import batcher as JB
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC,
)
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves

from tests.torch_port_util import assert_same, jax_state_leaves, small_models

KNOTS = ((0.0, 0.3, 0.6, 1.0), (0.0, 0.2, 0.7, 1.0))


@pytest.mark.parametrize("pallas_preproc,pallas_color", [(False, False), (True, True)])
def test_tick_matches_jax_over_ten_ticks(monkeypatch, pallas_preproc, pallas_color):
    monkeypatch.setattr(j_preproc, "preprocess_faces_pallas", functools.partial(
        j_preproc.preprocess_faces_pallas, interpret=True))
    spec_j, pj, model = small_models(seed=4)
    kw = dict(use_pallas_preproc=pallas_preproc, use_pallas_color=pallas_color,
              model_input_size=64, mtcnn_image_size=40, calibrator_knots=KNOTS,
              detection_threshold=0.5)
    cj = JDC(**kw, forensic=JFC(analysis_size=(64, 64)))
    ct = TDC(**kw, forensic=TFC(analysis_size=(64, 64)))
    n_slots, b = 4, 4
    sj = JB.init_stream_states(n_slots + 1, cj)
    st = TB.init_stream_states(n_slots + 1, ct)
    rng = np.random.default_rng(9)
    yy, xx = np.mgrid[:64, :64]
    for t in range(10):
        scene = 120 + 60 * np.sin((xx + t) / 5.0)[..., None] * np.ones(3)
        frames = np.clip(scene[None] + rng.normal(0, 8, (b, 64, 64, 3)), 0, 255)
        frames = frames.astype(np.uint8)
        faces = rng.integers(0, 256, (b, 40, 40, 3), dtype=np.uint8)
        has_face = rng.random(b) < 0.6
        face_hw = rng.integers(40, 200, (b, 2)).astype(np.int32)
        active = rng.random(b) < 0.8
        active[0] = True
        slot_idx = np.where(active, rng.permutation(n_slots)[:b], n_slots).astype(np.int32)
        args = (frames, faces, has_face, face_hw, active, slot_idx)
        oj, sj = JB.device_step_compact(spec_j, cj, pj, *map(jnp.asarray, args), sj)
        ot, st = TB.device_step_compact(model, ct, *map(torch.from_numpy, args), st)
        assert set(ot) == set(oj)
        for k in oj:
            assert_same(oj[k], ot[k], 1e-5, f"tick {t} {k}")
        for i, (a, b_) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st))):
            assert_same(a, b_, 1e-5, f"tick {t} state leaf {i}")
    assert int(np.asarray(sj.frame_count).max()) >= 5


def test_interp_matches_jnp_interp():
    xp = np.array([0.0, 0.3, 0.3, 0.6, 1.0], np.float32)   # a zero-width interval
    fp = np.array([0.0, 0.2, 0.5, 0.7, 1.0], np.float32)
    x = np.concatenate([np.linspace(-0.5, 1.5, 101), xp]).astype(np.float32)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = TB.interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_reset_streams_zeroes_only_masked_rows():
    st = TB.init_stream_states(3, TDC(forensic=TFC(analysis_size=(32, 32))))
    st.frame_count += 5
    st.tracker.n_votes += 2
    out = TB.reset_streams(st, torch.tensor([True, False, True]))
    assert out.frame_count.tolist() == [0, 5, 0]
    assert out.tracker.n_votes.tolist() == [0, 2, 0]


@pytest.mark.parametrize("field,value", [("clip_window", 4), ("ssd_bf16", True),
                                         ("mtcnn_device", True)])
def test_unported_tick_options_raise(field, value, tmp_path):
    """Each option is ported now. clip_window (tests/test_torch_clip_tick.py
    holds it to JAX): the tick takes {"backbone", "clip_head"}, pushes a face
    frame into its stream's ring and stays UNCERTAIN below clip_min_frames.
    The detect tick's options (tests/test_torch_mtcnn_tick.py): mtcnn_device
    raises JAX's error without the cascade's nets, and ssd_bf16 builds its
    tick on a bfloat16 copy of the SSD, leaving the SSD it was given in
    float32."""
    cfg = dataclasses.replace(TDC(forensic=TFC(analysis_size=(32, 32))), **{field: value})
    if field == "mtcnn_device":
        with pytest.raises(ValueError, match="requires mtcnn_nets"):
            TB.make_device_step_detect(None, None, cfg)
        return
    if field == "ssd_bf16":
        from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
        from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import (
            res10_class_ssd)
        net = CaffeNet(*res10_class_ssd(str(tmp_path), seed=0, channels=(8, 8, 16, 16)))
        assert callable(TB.make_device_step_detect(net, None, cfg))
        assert all(b.dtype == torch.float32 for b in net.buffers())
        return
    from real_time_video_deepfake_detection_tpu_torch.models.temporal_head import (
        TemporalHead)
    _, _, model = small_models(seed=4)
    cfg = dataclasses.replace(cfg, model_input_size=64, clip_feature_dim=32)
    head = TemporalHead(TB.clip_head_spec(cfg), torch.Generator().manual_seed(1)).eval()
    st = TB.init_stream_states(2, cfg)
    assert tuple(st.clip.feats.shape) == (2, 4, 32)
    z = torch.zeros
    out, st = TB.device_step_compact(
        {"backbone": model, "clip_head": head}, cfg, z((1, 32, 32, 3), dtype=torch.uint8),
        torch.full((1, 160, 160, 3), 128, dtype=torch.uint8), torch.tensor([True]),
        torch.tensor([[200, 200]], dtype=torch.int32), torch.tensor([True]),
        torch.tensor([0]), st)
    assert out["clip_frames"].tolist() == [1] and st.clip.n.tolist() == [1, 0]
    assert out["verdict"].tolist() == [-1] and torch.isfinite(out["clip_probability"]).all()
