"""The port's video tools against the JAX package on the CPU: the clip-head
trainer's frame sampling (`_clip_from_video`, `_build_split`) and its CLI
end to end, face-crop pre-extraction (`data_tools/face_extract.py`) and
the DFDC zip processor (`data_tools/dfdc_process.py`).

Videos are Motion-JPEG AVIs written by cv2's CAP_OPENCV_MJPEG writer; the
JAX side reads them as it always does, through cv2.VideoCapture(path) (the
default FFmpeg backend, whose decode the port's reader reproduces). The
JAX face extractor globs *.mp4, the port's *.avi: each video is written
under both names, with the same bytes."""

import json
import os
import shutil
import zipfile

import cv2
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.data_tools.dfdc_process as j_dfdc
import real_time_video_deepfake_detection_tpu.data_tools.face_extract as j_fe
import real_time_video_deepfake_detection_tpu.train.clip_head as j_ch
from real_time_video_deepfake_detection_tpu.pipeline.faces import FaceDetector as JFaceDetector
from real_time_video_deepfake_detection_tpu.train.checkpoint import save_checkpoint as j_save
import real_time_video_deepfake_detection_tpu_torch.data_tools.dfdc_process as t_dfdc
import real_time_video_deepfake_detection_tpu_torch.data_tools.face_extract as t_fe
import real_time_video_deepfake_detection_tpu_torch.train.clip_head as t_ch
from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig, ServerConfig
from real_time_video_deepfake_detection_tpu_torch.models import backbones
from real_time_video_deepfake_detection_tpu_torch.pipeline.faces import FaceDetector
from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine
from real_time_video_deepfake_detection_tpu_torch.serving.server import _load_clip_head
from real_time_video_deepfake_detection_tpu_torch.train.checkpoint import save_checkpoint
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_analyze import face_frames, plain_frames, write_avi
from tests.torch_port_util import small_models
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """root/{train,val}/{real,fake}/ of AVIs (faces, frames without one, a
    short video and a file that is not a video); the same files under
    faces/{real,fake}/ as *.avi and *.mp4 for the face extractors."""
    root = tmp_path_factory.mktemp("videos")
    vids = {
        ("train", "real", "a.avi"): face_frames(12),
        ("train", "real", "b.avi"): plain_frames(9, seed=1),
        ("train", "fake", "c.avi"): face_frames(14)[::-1],
        ("train", "fake", "d.avi"): face_frames(3),     # shorter than the window
        ("val", "real", "e.avi"): plain_frames(10, seed=2),
        ("val", "fake", "f.avi"): face_frames(11)[2:],
    }
    for (split, label, name), frames in vids.items():
        d = root / split / label
        d.mkdir(parents=True, exist_ok=True)
        write_avi(d / name, frames)
    (root / "train" / "real" / "notes.txt").write_text("not a video")
    faces = root / "faces"
    for label, k in (("real", 0), ("fake", 1)):
        (faces / label).mkdir(parents=True)
        for i in range(7):   # 7 a class: one goes to the 15% validation split
            frames = [np.roll(f, 3 * i, 1) for f in face_frames(8 + i)][k:]
            path = write_avi(faces / label / f"v{i}.avi", frames)
            shutil.copy(path, faces / label / f"v{i}.mp4")
    return root


@pytest.mark.parametrize("t,crop", [(6, 48), (4, 160)])
def test_clip_from_video_equals_jax(tree, t, crop):
    jfd, tfd = JFaceDetector(), FaceDetector()
    for name in ("train/real/a.avi", "train/real/b.avi", "train/fake/c.avi",
                 "train/fake/d.avi", "train/real/notes.txt"):
        path = str(tree / name)
        want = j_ch._clip_from_video(path, t, jfd, crop)
        got = t_ch._clip_from_video(path, t, tfd, crop)
        if want is None:
            assert got is None and name.endswith(".txt")
            continue
        assert got.shape == (t, crop, crop, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_build_split_equals_jax(tree):
    jfd, tfd = JFaceDetector(), FaceDetector()
    for split in ("train", "val", "missing"):
        want = j_ch._build_split(str(tree), split, 5, jfd, 48)
        got = t_ch._build_split(str(tree), split, 5, tfd, 48)
        if want[0] is None:
            assert got == (None, None) and split == "missing"
            continue
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == np.float32


def test_clip_head_main_trains_and_serves(tree, tmp_path):
    """Full-size B0 features of 48 px crops, then the saved head answers
    through the batched engine's --clip-head loader."""
    out = str(tmp_path / "head.pt")
    res = t_ch.main(["--videos", str(tree), "--clip-window", "6", "--epochs", "4",
                     "--batch-size", "4", "--crop-size", "48", "--out", out, "--device", "cpu"])
    assert res["saved"] == out and res["val_n"] == 2 and "val_acc" in res
    assert np.isfinite(res["train_log_tail"][-1]["loss"]) and len(res["train_log_tail"]) == 3
    meta = torch.load(out, weights_only=True)["metadata"]
    assert meta["hspec"]["window"] == 6 and meta["hspec"]["feature_dim"] == 1280
    assert meta["backbone"] == "b0" and meta["epochs"] == 4
    spec = backbones.make("b0")
    cfg = DetectorConfig(clip_window=6)
    head = _load_clip_head(out, cfg, spec)
    eng = MultiStreamEngine(cfg, ServerConfig(max_streams=2), clip_head_params=head,
                            spec=spec, device="cpu")
    try:
        for f in face_frames(2):
            r = eng.analyze(f, "s0")
    finally:
        eng.shutdown()
    assert "clip_probability" in r and 0.0 <= r["clip_probability"] <= 1.0


def test_clip_head_main_refusals(tmp_path, monkeypatch):
    with pytest.raises(SystemExit, match="no usable videos"):
        t_ch.main(["--videos", str(tmp_path), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_ch.main(["--videos", str(tmp_path)])


def test_backbone_weights_load_as_the_jax_cli_reads_them(tmp_path):
    spec_j, pj, model = small_models(seed=4)
    npz = str(tmp_path / "best.npz")
    j_save(npz, pj, {"epoch": 2})
    fresh = backbones.build_model(model.spec)
    sd = t_ch.load_backbone_params(npz, fresh)
    want = params_from_jax(pj, fresh)
    assert set(sd) == set(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    pt = str(tmp_path / "best.pt")
    save_checkpoint(pt, {"params": want, "metadata": {}})
    assert all(torch.equal(t_ch.load_backbone_params(pt, fresh)[k], want[k]) for k in want)


def _tree_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_preextract_equals_jax(tree, tmp_path):
    """The same draws, crops and split: the same file names, and each
    crop's JPEG the same bytes (cv2.imwrite at quality 95)."""
    want = j_fe.preextract(str(tree / "faces"), str(tmp_path / "jax"), frames_per_video=2)
    got = t_fe.preextract(str(tree / "faces"), str(tmp_path / "port"), frames_per_video=2,
                          device="cpu")
    assert got == want and got["real"] > 0 and got["fake"] > 0
    a, b = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(a) == sorted(b) and any(k.startswith("val") for k in a)
    for k in a:
        assert a[k] == b[k], k
    # resume by existence: a second run skips the videos whose first crop is
    # there (the balancing may have deleted some, as in the JAX tool)
    want = j_fe.preextract(str(tree / "faces"), str(tmp_path / "jax"), frames_per_video=2)
    got = t_fe.preextract(str(tree / "faces"), str(tmp_path / "port"), 2, device="cpu")
    assert got == want
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")


def test_extract_crops_and_largest_face_equal_jax(tree):
    import random
    path = str(tree / "faces" / "fake" / "v2.avi")
    jfd, tfd = JFaceDetector(), FaceDetector()
    want = j_fe.extract_crops(path, jfd, random.Random(5), max_frames=4, size=200)
    got = t_fe.extract_crops(path, tfd, random.Random(5), max_frames=4, size=200)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    frame = face_frames(1)[0]
    assert t_fe.largest_face_with_margin(frame, tfd) == j_fe.largest_face_with_margin(frame, jfd)
    assert t_fe.extract_crops(str(tree / "train/real/notes.txt"), tfd, random.Random(0)) == []


def test_face_extract_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_fe.main(["--videos", str(tmp_path), "--output", str(tmp_path / "o")])


def _synthetic_zip(path):
    meta = {f"{n}.mp4": {"label": "REAL" if n in "ab" else "FAKE"}
            for n in "abcdefg"}
    meta["missing.mp4"] = {"label": "FAKE"}
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("dfdc_train_part_3/metadata.json", json.dumps(meta))
        for i, n in enumerate("abcdefg"):
            size = 500 if n == "c" else 2000 + 37 * i   # c is too small to keep
            zf.writestr(f"dfdc_train_part_3/{n}.mp4", bytes([i]) * size)
        zf.writestr("dfdc_train_part_3/readme.txt", "x")


def test_dfdc_process_zip_equals_jax(tmp_path, monkeypatch, capsys):
    trees = {}
    for name, mod in (("jax", j_dfdc), ("port", t_dfdc)):
        cwd = tmp_path / name
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        _synthetic_zip(cwd / "dfdc_train_part_3.zip")
        mod.process_zip("dfdc_train_part_3.zip")
        assert not (cwd / "dfdc_train_part_3.zip").exists()   # deleted without --keep-zip
        mod.process_zip("dfdc_train_part_3.zip")   # done already: a no-op
        mod.show_status()
        trees[name] = _tree_bytes(cwd)
    assert trees["port"] == trees["jax"]
    assert sum(k.startswith("dataset/dfdc_videos/") for k in trees["port"]) >= 2
    assert t_dfdc.detect_part_index("x/DFDC_part-12.zip") == 12
    with pytest.raises(ValueError):
        t_dfdc.detect_part_index("nothing.zip")
