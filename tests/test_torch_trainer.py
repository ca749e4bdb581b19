"""The port's trainer on the CPU: main over a dataset of the JPEG fixtures
(files, the log's keys, resume, early stop, the calibrator), the loader's
batches against the JAX package's BatchLoader (cv2) bit for bit, an
unported format named, the CLI's flags and defaults against the JAX
parser, the clip-head trainer from the JAX head's parameters, and the
device rule (CUDA unless --device cpu; a rank per card when several are
usable)."""

from __future__ import annotations

import argparse
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.models import temporal_head as JH
from real_time_video_deepfake_detection_tpu.train import clip_head as JCH
from real_time_video_deepfake_detection_tpu.train import data as JD
from real_time_video_deepfake_detection_tpu.train import trainer as JT
from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
from real_time_video_deepfake_detection_tpu_torch.models import temporal_head as TH
from real_time_video_deepfake_detection_tpu_torch.train import checkpoint as TCK
from real_time_video_deepfake_detection_tpu_torch.train import clip_head as TCH
from real_time_video_deepfake_detection_tpu_torch.train import data as TD
from real_time_video_deepfake_detection_tpu_torch.train import trainer as TT
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.weights import read_state_dict

from tests.torch_train_util import JPEG_DIR, one_torch_thread, small_effnet  # noqa: F401

BASELINE = ("frame_640x480_q85_420.jpg", "frame_720x405_q85_420.jpg", "q50_640x480_420.jpg",
            "q50_720x405_420.jpg", "q95_640x480_420.jpg", "q95_720x405_420.jpg")
LOG_KEYS = {"epoch", "train_loss", "train_acc", "epoch_seconds", "val_loss", "val_acc",
            "val_real_acc", "val_fake_acc", "val_precision", "val_recall", "val_f1", "val_auc"}


def _dataset(root, extra=()) -> str:
    """train/{real,fake} and val/{real,fake} of copies of the baseline
    fixtures (+ `extra` fixtures under train/fake)."""
    for split in ("train", "val"):
        for i, label in enumerate(("real", "fake")):
            d = os.path.join(root, split, label)
            os.makedirs(d)
            for j, name in enumerate(BASELINE[i::2] + BASELINE[1 - i::2][:1]):
                shutil.copy(os.path.join(JPEG_DIR, name), os.path.join(d, f"{j}_{name}"))
    for name in extra:
        shutil.copy(os.path.join(JPEG_DIR, name), os.path.join(root, "train", "fake", name))
    return str(root)


def _argv(ds, out, *more):
    return ["--dataset", ds, "--output-dir", out, "--device", "cpu", "--image-size", "32",
            "--batch-size", "4", "--num-workers", "2", *more]


def test_main_trains_resumes_and_stops_early(tmp_path):
    ds, out = _dataset(tmp_path / "ds"), str(tmp_path / "out")
    r = TT.main(_argv(ds, out, "--epochs", "2", "--bn-momentum", "0.2"))
    assert sorted(os.listdir(out)) == ["best_model.pt", "resume_checkpoint.pt",
                                       "training_log.json"]
    with open(os.path.join(out, "training_log.json")) as f:
        log = json.load(f)
    assert [e["epoch"] for e in log] == [0, 1] and all(set(e) == LOG_KEYS for e in log)
    best = TCK.load_checkpoint(os.path.join(out, "best_model.pt"))
    assert best["metadata"]["epoch"] == r["best"]["epoch"]
    assert best["metadata"]["config"]["image_size"] == 32
    # the best file holds the EMA weights with the live statistics
    assert set(best["params"]) == set(r["state"].model.state_dict())
    # a third epoch resumes from the checkpoint, then fits the calibrator
    r3 = TT.main(_argv(ds, out, "--epochs", "3", "--bn-momentum", "0.2", "--fit-calibrator"))
    assert [e["epoch"] for e in r3["log"]] == [0, 1, 2]
    assert r3["state"].step == 3 * 2
    assert os.path.exists(os.path.join(out, "calibrator.pkl"))
    sd, meta = read_state_dict(os.path.join(out, "resume_checkpoint.pt"), r3["state"].model)
    assert meta["epoch"] == 2
    assert all(torch.equal(sd[k], v) for k, v in r3["state"].ema_state_dict().items())
    # early stop with patience 1: the run ends at the first epoch whose F1
    # does not beat the best before it
    r4 = TT.main(_argv(ds, str(tmp_path / "out2"), "--epochs", "4", "--patience", "1"))
    f1 = [e["val_f1"] for e in r4["log"]]
    stop = next((i for i in range(1, 4) if f1[i] <= max(f1[:i])), 3)
    assert len(f1) == stop + 1


def test_loader_batches_equal_jax_loader(tmp_path):
    ds = _dataset(tmp_path / "ds", extra=("truncated_720x405_q85.jpg",))
    for split, kw in (("train", dict(shuffle=True, balanced=True)),
                      ("val", dict(shuffle=False, drop_last=False))):
        jl = JD.BatchLoader(JD.DeepfakeDataset(ds, split, 32), 4, seed=3, num_workers=2, **kw)
        tl = TD.BatchLoader(TD.DeepfakeDataset(ds, split, 32), 4, seed=3, num_workers=2, **kw)
        assert len(jl) == len(tl) > 0
        assert jl.ds.samples == tl.ds.samples
        n = 0
        for (xj, yj), (xt, yt) in zip(jl, tl):
            np.testing.assert_array_equal(xt.numpy(), xj)
            np.testing.assert_array_equal(yt, yj)
            n += 1
        assert n == len(tl)


def test_unported_image_raises_naming_the_file(tmp_path):
    """A format cv2 reads and the port does not (AVIF, under a .png name)
    raises; a progressive JPEG, and a WebP and a JPEG 2000 file under .png
    names (decoded since those formats were ported), load as the JAX loader
    loads them."""
    import cv2
    ds = _dataset(tmp_path / "ds", extra=("progressive_720x405_q85.jpg",))
    tds, jds = TD.DeepfakeDataset(ds, "train", 32), JD.DeepfakeDataset(ds, "train", 32)
    i = [p for p, _ in tds.samples].index(os.path.join(tds.dir, "fake",
                                                       "progressive_720x405_q85.jpg"))
    np.testing.assert_array_equal(tds.load_image(i), jds.load_image(i))
    webp = cv2.imencode(".webp", np.full((40, 40, 3), 77, np.uint8))[1].tobytes()
    with open(os.path.join(ds, "train", "fake", "webp.png"), "wb") as fh:
        fh.write(webp)
    tds, jds = TD.DeepfakeDataset(ds, "train", 32), JD.DeepfakeDataset(ds, "train", 32)
    i = [p for p, _ in tds.samples].index(os.path.join(tds.dir, "fake", "webp.png"))
    np.testing.assert_array_equal(tds.load_image(i), jds.load_image(i))
    jp2 = cv2.imencode(".jp2", np.full((40, 40, 3), 99, np.uint8))[1].tobytes()
    with open(os.path.join(ds, "train", "fake", "jp2.png"), "wb") as fh:
        fh.write(jp2)
    tds, jds = TD.DeepfakeDataset(ds, "train", 32), JD.DeepfakeDataset(ds, "train", 32)
    i = [p for p, _ in tds.samples].index(os.path.join(tds.dir, "fake", "jp2.png"))
    np.testing.assert_array_equal(tds.load_image(i), jds.load_image(i))
    avif = cv2.imencode(".avif", np.zeros((40, 40, 3), np.uint8))[1].tobytes()
    with open(os.path.join(ds, "train", "fake", "avif.png"), "wb") as fh:
        fh.write(avif)
    loader = TD.BatchLoader(TD.DeepfakeDataset(ds, "train", 32), 16, shuffle=False,
                            drop_last=False, num_workers=2)
    with pytest.raises(TD.UnsupportedImage, match="avif.png"):
        for _ in loader:
            pass
    # a damaged file is replaced by another sample, as in the JAX loader
    ds2 = TD.DeepfakeDataset(_dataset(tmp_path / "ds2", extra=("truncated_720x405_q85.jpg",)),
                             "train", 32)
    i = [p for p, _ in ds2.samples].index(os.path.join(ds2.dir, "fake",
                                                        "truncated_720x405_q85.jpg"))
    with pytest.raises(OSError):
        ds2.load_image(i)
    assert TD.BatchLoader(ds2, 4, shuffle=False)._safe_load(i).shape == (52, 52, 3)


def _actions(parser):
    return {a.dest: (a.default, a.type, a.choices, a.nargs, a.const, a.required)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_cli_flags_and_defaults_equal_jax_parser(monkeypatch):
    seen = {}

    def parse(self, argv=None):
        seen["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(SystemExit):
        JT.main(["--dataset", "x"])
    jax_actions = _actions(seen["parser"])
    monkeypatch.undo()
    port = _actions(TT.build_parser())
    assert set(port) == set(jax_actions) | {"device"}
    for dest, want in jax_actions.items():
        assert port[dest] == want, dest
    assert port["device"][0] is None


def test_cli_hyperparameter_flags_reach_config(monkeypatch):
    """The JAX package's test_trainer_cli_hyperparameter_flags_reach_config
    and test_trainer_defaults_match_reference_cli, on the port."""
    captured = {}

    def fake_train(args):
        captured["args"] = args
        return {}
    monkeypatch.setattr(TT, "train", fake_train)
    TT.main(["--dataset", "x", "--weight-decay", "0.01", "--dropout", "0.4",
             "--label-smoothing", "0.05", "--mixup-alpha", "0.7", "--cutmix-alpha", "0.9",
             "--focal-gamma", "3.0", "--focal-alpha", "0.5", "--ema-decay", "0.99",
             "--backbone-lr-mult", "0.2", "--freeze-frac", "0.25", "--clip-norm", "2.0",
             "--patience", "3", "--epochs", "7", "--bn-momentum", "0.15", "--bf16"])
    a = captured["args"]
    assert (a.weight_decay, a.dropout, a.label_smoothing) == (0.01, 0.4, 0.05)
    assert (a.mixup_alpha, a.cutmix_alpha) == (0.7, 0.9)
    assert (a.focal_gamma, a.focal_alpha, a.ema_decay) == (3.0, 0.5, 0.99)
    assert (a.backbone_lr_mult, a.freeze_frac, a.clip_norm) == (0.2, 0.25, 2.0)
    assert (a.patience, a.epochs, a.bn_momentum, a.bf16) == (3, 7, 0.15, True)
    d = TrainConfig()
    assert (d.epochs, d.batch_size, d.lr) == (20, 32, 3e-4)
    assert (d.weight_decay, d.head_dropout) == (0.05, 0.5)
    assert (d.label_smoothing, d.mixup_alpha, d.cutmix_alpha) == (0.1, 0.3, 0.3)
    assert (d.focal_gamma, d.focal_alpha) == (2.0, 0.25)
    assert (d.ema_decay, d.early_stop_patience) == (0.999, 5)
    assert d.bn_momentum is None and d.bf16_compute is False


def test_clip_head_training_matches_jax(tmp_path):
    spec_j, _, pj, model = small_effnet(8)
    clips = np.random.default_rng(2).integers(0, 256, (2, 3, 40, 40, 3), dtype=np.uint8)
    fj = np.asarray(JCH.extract_clip_features(jax.tree.map(jnp.asarray, pj), spec_j,
                                              jnp.asarray(clips), batch_frames=4))
    ft = TCH.extract_clip_features(model, torch.from_numpy(clips), batch_frames=4)
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0, atol=1e-5 * np.abs(fj).max())

    hspec = JH.TemporalHeadSpec(feature_dim=16, dim=32, depth=1, heads=2, window=8)
    key = jax.random.PRNGKey(4)
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (12, 8, 16)).astype(np.float32)
    labels = (rng.random(12) > 0.5).astype(np.float32)
    _, log_j = JCH.train_clip_head(key, jnp.asarray(feats), jnp.asarray(labels), hspec,
                                   epochs=5, batch_size=12)
    head0 = TH.TemporalHead(TH.TemporalHeadSpec(feature_dim=16, dim=32, depth=1, heads=2,
                                                window=8))
    init = params_from_jax(jax.tree.map(np.asarray, JH.init_params(key, hspec)), head0)
    head, log_t = TCH.train_clip_head(torch.from_numpy(feats), torch.from_numpy(labels),
                                      head0.spec, epochs=5, batch_size=12, init=init)
    for a, b in zip(log_t, log_j):
        assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"]), (a, b)
        assert a["acc"] == pytest.approx(b["acc"], abs=1e-6)
    path = str(tmp_path / "clip_head.pt")
    TCH.save_head(head, path, log_t)
    sd, _ = read_state_dict(path, TH.TemporalHead(head.spec))
    assert all(torch.equal(sd[k], v) for k, v in head.state_dict().items())


def test_trainer_needs_cuda_unless_given_the_cpu(tmp_path, monkeypatch):
    ds = _dataset(tmp_path / "ds")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.main(["--dataset", ds, "--output-dir", str(tmp_path / "o")])
    # with several usable cards it spawns one nccl rank per card (JAX's
    # rule: the largest count up to --num-devices that divides the batch);
    # tests/test_torch_dp_train.py runs the ranks on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    spawned = []

    def spawn(fn, devices, args=(), **kw):
        spawned.append((fn, [str(d) for d in devices], args[0].batch_size, kw))
        return [{"best": {}, "log": [], "state": None}] + [None] * (len(devices) - 1)

    monkeypatch.setattr(TT.mesh, "spawn", spawn)
    TT.main(["--dataset", ds, "--output-dir", str(tmp_path / "o")])
    TT.main(["--dataset", ds, "--output-dir", str(tmp_path / "o"), "--num-devices", "2"])
    TT.main(["--dataset", ds, "--output-dir", str(tmp_path / "o"), "--batch-size", "6"])
    assert [(fn, d, b) for fn, d, b, _ in spawned] == [
        (TT._train_rank, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"], 32),
        (TT._train_rank, ["cuda:0", "cuda:1"], 32),
        (TT._train_rank, ["cuda:0", "cuda:1", "cuda:2"], 6)]
    assert all(kw.get("backend") is None for *_, kw in spawned)   # nccl on CUDA
