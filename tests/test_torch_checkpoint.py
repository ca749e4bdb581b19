"""Checkpoints across the two packages on the CPU: the JAX trainer's .npz
(params alone and a resume TrainState) read by the port without JAX, the
closed unpickler, the reference-shaped and ImageNet-shaped .pth
converters, the port's own resume round trip, DeepfakeDetector
(weights_path=) and the server's --weights / --clip-head."""

from __future__ import annotations

import copy
import pickle
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.core.config import DetectorConfig as JDC
from real_time_video_deepfake_detection_tpu.core.config import TrainConfig as JTC
from real_time_video_deepfake_detection_tpu.models import backbones as JB
from real_time_video_deepfake_detection_tpu.models import efficientnet as JE
from real_time_video_deepfake_detection_tpu.models import temporal_head as JH
from real_time_video_deepfake_detection_tpu.pipeline.detector import DeepfakeDetector as JDet
from real_time_video_deepfake_detection_tpu.train import checkpoint as JCK
from real_time_video_deepfake_detection_tpu.train import steps as JS
from real_time_video_deepfake_detection_tpu.utils import torch_convert as JTCV
from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig as TDC
from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
from real_time_video_deepfake_detection_tpu_torch.models import efficientnet as TE
from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector as TDet
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.serving import server as TS
from real_time_video_deepfake_detection_tpu_torch.train import checkpoint as TCK
from real_time_video_deepfake_detection_tpu_torch.train import steps as TST
from real_time_video_deepfake_detection_tpu_torch.utils import torch_convert as TTCV
from real_time_video_deepfake_detection_tpu_torch.utils import weights as TW
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.torch_port_util import HEAD_DIMS, jax_params, small_specs
from tests.torch_train_util import BIG, fixture_crops, one_torch_thread, small_effnet  # noqa: F401

X64 = np.random.default_rng(0).normal(0, 1, (3, 64, 64, 3)).astype(np.float32)


def _logits_close(model, params_j, spec_j, x=X64, tol=1e-6):
    fwd = jax.jit(partial(JB.forward, spec=spec_j))
    want = np.asarray(fwd(jax.tree.map(jnp.asarray, params_j), jnp.asarray(x)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def test_jax_params_npz_and_resume_trainstate_load_without_jax(tmp_path):
    spec_j, spec_t, pj, model = small_effnet(2)
    pj2 = jax_params(spec_j, 5, HEAD_DIMS)
    best = str(tmp_path / "best_model.npz")
    JCK.save_checkpoint(best, jax.tree.map(jnp.asarray, pj),
                        {"epoch": 4, "val_acc": 0.75, "val_f1": 0.7, "config": {"lr": 3e-4}})
    cfg = JTC(image_size=32, batch_size=4)
    tx = JS.make_optimizer(cfg, 10, spec=spec_j)
    st = JS.init_train_state(jax.tree.map(jnp.asarray, pj), cfg, 10, tx=tx)
    st = JS.TrainState(st.params, st.opt_state, jax.tree.map(jnp.asarray, pj2), st.step, st.rng)
    resume = str(tmp_path / "resume_checkpoint.npz")
    JCK.save_checkpoint(resume, st, {"epoch": 1, "best": {"f1": 0.5}, "args": {"lr": 3e-4}},
                        jax_rng_key=st.rng)

    m = TE.EfficientNet(spec_t, head_dims=HEAD_DIMS)
    sd, meta = TCK.params_from_jax_npz(best, m)
    m.load_state_dict(sd)
    _logits_close(m, pj, spec_j)
    assert meta["epoch"] == 4 and meta["config"] == {"lr": 3e-4}
    sd, meta = TCK.params_from_jax_npz(resume, m)          # serving: the EMA weights
    m.load_state_dict(sd)
    _logits_close(m, pj2, spec_j)
    assert meta["best"] == {"f1": 0.5}
    sd, _ = TCK.params_from_jax_npz(resume, m, part="params")   # --warm-start
    m.load_state_dict(sd)
    _logits_close(m, pj, spec_j)
    # a file of another model does not map
    other = TE.EfficientNet(TE.EfficientNetSpec.make("b0"))
    with pytest.raises(ValueError, match="leaves"):
        TCK.params_from_jax_npz(best, other)
    # the flattening order is jax.tree_util's
    names = TCK.jax_leaf_order(m.state_dict().keys())
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", None))) for k in p)
             for p, _ in jax.tree_util.tree_flatten_with_path(pj)[0]]
    assert names == paths


def test_meta_with_a_foreign_global_is_refused(tmp_path):
    class Evil:
        def __reduce__(self):
            return (print, ("owned",))
    blob = pickle.dumps({"n_leaves": 0, "metadata": Evil()})
    path = tmp_path / "evil.npz"
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(blob, np.uint8))
    with pytest.raises(pickle.UnpicklingError, match="builtins.print"):
        TCK.read_jax_npz(str(path))
    # numpy's reconstructors pass (the JAX trainer's RNG capture)
    ok = pickle.dumps({"n_leaves": 0, "rng_numpy": np.random.get_state(), "v": np.float64(2)})
    with open(path, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(ok, np.uint8))
    _, meta = TCK.read_jax_npz(str(path))
    assert meta["v"] == 2.0 and meta["rng_numpy"][0] == "MT19937"


def _save_pth(path, sd: dict, **meta):
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in sd.items()}, **meta}, path)


def test_reference_pth_converts_like_jax(tmp_path):
    spec_j, spec_t = small_specs()
    path = str(tmp_path / "best_model.pth")
    _save_pth(path, JTCV.make_reference_shaped_state_dict(spec_j, seed=3), epoch=7,
              val_acc=0.81, rng_numpy=np.random.get_state())
    pj, meta_j = JTCV.load_checkpoint(path, spec_j)
    sd, meta_t = TTCV.load_checkpoint(path, spec_t)
    assert meta_t == meta_j == {"epoch": 7, "val_acc": 0.81}
    m = TE.EfficientNet(spec_t)
    m.load_state_dict(sd)
    _logits_close(m, jax.tree.map(np.asarray, pj), spec_j)
    # and the port's synthetic file converts in JAX to the same model
    sd2 = TTCV.make_reference_shaped_state_dict(spec_t, seed=4)
    pj2 = JTCV.convert_state_dict(sd2, spec_j)
    m.load_state_dict(TTCV.convert_state_dict(sd2, spec_t))
    _logits_close(m, jax.tree.map(np.asarray, pj2), spec_j)


@pytest.mark.parametrize("schema", ["effnet_pytorch", "timm"])
def test_imagenet_pth_converts_like_jax(tmp_path, schema):
    spec_j = JE.EfficientNetSpec.make("b0")
    spec_t = TE.EfficientNetSpec.make("b0")
    path = str(tmp_path / f"efficientnet-b0-{schema}.pth")
    sd = JTCV.make_imagenet_shaped_state_dict(spec_j, seed=1, schema=schema)
    assert set(sd) == set(TTCV.make_imagenet_shaped_state_dict(spec_t, 1, schema))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    assert TTCV.detect_state_dict_schema(sd) == schema
    pj = jax.tree.map(np.asarray, JTCV.load_imagenet_checkpoint(path, spec_j, jax.random.PRNGKey(0)))
    got = TTCV.load_imagenet_checkpoint(path, spec_t, torch.Generator().manual_seed(0))
    # the backbone is the file's, the head a fresh draw of each package's
    fresh = TE.EfficientNet(spec_t, generator=torch.Generator().manual_seed(0)).state_dict()
    for k, v in got.items():
        if k.startswith("fc."):
            assert torch.equal(v, fresh[k])
    pj["fc"] = jax.tree.map(np.asarray, JTCV.convert_state_dict(
        TTCV.export_state_dict(got, spec_t), spec_j)["fc"])
    m = TE.EfficientNet(spec_t)
    m.load_state_dict(got)
    _logits_close(m, pj, spec_j, X64[:2, :32, :32])


def test_port_resume_round_trip_is_bit_identical(tmp_path):
    _, spec_t, _, model = small_effnet(4)
    cfg = TrainConfig(image_size=32, batch_size=4, lr=1e-3)
    imgs = torch.from_numpy(fixture_crops(4, BIG, seed=2))
    labels = torch.tensor([0.0, 1.0, 1.0, 0.0])

    def fresh():
        m = copy.deepcopy(model)
        return TST.init_train_state(m, spec_t, cfg, total_steps=8, seed=11)

    straight = fresh()
    for _ in range(4):
        TST.fused_train_step(straight, imgs, labels)
    first = fresh()
    for _ in range(2):
        TST.fused_train_step(first, imgs, labels)
    path = str(tmp_path / "resume_checkpoint.pt")
    TCK.save_checkpoint(path, {**first.state_dict(), "rng": TCK.host_rng_state(),
                               "metadata": {"epoch": 0}})
    resumed = fresh()
    ckpt = TCK.load_checkpoint(path)
    resumed.load_state_dict(ckpt)
    TCK.restore_host_rng_state(ckpt["rng"])
    for _ in range(2):
        TST.fused_train_step(resumed, imgs, labels)
    assert resumed.step == straight.step == 4 and resumed.count == straight.count
    for a, b in ((resumed.model.state_dict(), straight.model.state_dict()),
                 (resumed.ema, straight.ema)):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    sa, sb = resumed.optimizer.state_dict()["state"], straight.optimizer.state_dict()["state"]
    for i in sa:
        assert all(torch.equal(sa[i][k], sb[i][k]) for k in sa[i])
    with pytest.raises(ValueError, match="not a checkpoint"):
        torch.save({"model": {}}, str(tmp_path / "x.pt"))
        TCK.load_checkpoint(str(tmp_path / "x.pt"))


FACES = [np.random.default_rng(s).integers(0, 256, shape, dtype=np.uint8)
         for s, shape in ((1, (120, 100, 3)), (2, (90, 130, 3)))]


def test_detector_weights_path_matches_jax(tmp_path):
    spec_j, spec_t, pj, model = small_effnet(6)
    pj_full = jax_params(spec_j, 6)           # the default (512, 256, 1) head
    npz = str(tmp_path / "best_model.npz")
    JCK.save_checkpoint(npz, jax.tree.map(jnp.asarray, pj_full), {"epoch": 2, "val_acc": 0.6})
    pth = str(tmp_path / "best_model.pth")
    _save_pth(pth, JTCV.export_state_dict(jax.tree.map(jnp.asarray, pj_full), spec_j), epoch=5)
    pt = str(tmp_path / "best_model.pt")
    m = TE.EfficientNet(spec_t)
    TCK.save_checkpoint(pt, {"params": params_from_jax(pj_full, m),
                             "metadata": {"epoch": 9, "val_acc": 0.5, "val_f1": 0.4}})
    for path, meta in ((npz, {"epoch": 2, "val_acc": 0.6}), (pth, {"epoch": 5}),
                       (pt, {"epoch": 9, "val_acc": 0.5})):
        jd = JDet(JDC(model_input_size=64), params=None if path != pt else jax.tree.map(
            jnp.asarray, pj_full), weights_path=None if path == pt else path, spec=spec_j)
        td = TDet(TDC(model_input_size=64), weights_path=path, spec=spec_t, device="cpu")
        assert td.model_loaded and td.checkpoint_meta == meta
        if path != pt:
            assert jd.checkpoint_meta == meta
        for face in FACES:
            assert td._single_prediction(face) == pytest.approx(jd._single_prediction(face),
                                                                abs=1e-5)
    # a missing file falls back to seeded weights, as in the JAX package
    assert not TDet(TDC(), weights_path=str(tmp_path / "none.npz"), spec=spec_t,
                    device="cpu").model_loaded


def test_weights_and_clip_head_reach_the_engine(tmp_path, monkeypatch):
    spec_j = JE.EfficientNetSpec.make("b0")
    shapes = jax.eval_shape(lambda k: JE.init_params(k, spec_j), jax.random.PRNGKey(0))
    pj = jax.tree.map(lambda s: np.random.default_rng(0).normal(0, 0.05, s.shape)
                      .astype(np.float32), shapes)
    w = str(tmp_path / "best_model.npz")
    JCK.save_checkpoint(w, jax.tree.map(jnp.asarray, pj), {"epoch": 1})
    hspec = JH.TemporalHeadSpec(feature_dim=1280, window=8)
    hj = JH.init_params(jax.random.PRNGKey(3), hspec)
    h = str(tmp_path / "clip_head.npz")
    JCK.save_checkpoint(h, hj, {"hspec": {"window": 8}})

    seen = {}

    class Spy(TM.MultiStreamEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["engine"] = self

    class FakeServer:
        def __init__(self, app):
            self.app = app

        def serve_forever(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(TM, "MultiStreamEngine", Spy)
    monkeypatch.setattr(TS, "make_server", lambda host, port, app, *a, **kw: FakeServer(app))
    monkeypatch.setattr(TS, "serve", lambda host, port, det: seen.setdefault("det", det))
    TS.main(["--device", "cpu", "--batched", "--max-streams", "2", "--max-batch", "2",
             "--face-backend", "heuristic", "--weights", w, "--clip-window", "8",
             "--clip-head", h])
    e = seen["engine"]
    want = params_from_jax(pj, e.model)
    assert all(torch.equal(v, want[k]) for k, v in e.model.state_dict().items())
    head = e.tick_model["clip_head"]
    want = params_from_jax(jax.tree.map(np.asarray, hj), head)
    assert all(torch.equal(v, want[k]) for k, v in head.state_dict().items())
    TS.main(["--device", "cpu", "--face-backend", "heuristic", "--weights", w])
    det = seen["det"]
    assert det.model_loaded
    assert torch.equal(det.model.state_dict()["fc.fc3.w"], torch.from_numpy(pj["fc"]["fc3"]["w"]))
    # the port's own files load through the same flags
    pt = str(tmp_path / "best_model.pt")
    TCK.save_checkpoint(pt, {"params": det.model.state_dict(), "metadata": {}})
    assert all(torch.equal(v, det.model.state_dict()[k])
               for k, v in TW.load_params_any(pt, TE.EfficientNetSpec.make("b0")).items())
    with pytest.raises(SystemExit, match="--clip-head"):
        TS.main(["--device", "cpu", "--batched", "--clip-window", "4", "--clip-head", h])
