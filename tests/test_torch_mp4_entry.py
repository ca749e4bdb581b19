"""The entry points that read video, on H.264 Constrained Baseline and
High mp4s, against the JAX package on the CPU: face-crop pre-extraction
(`extract_crops`, `preextract`), the clip-head trainer's sampling
(`_clip_from_video`) and cli/analyze.py on one video (predict with its
overlay) and on several (the batched engine).

The JAX side reads the same files through cv2.VideoCapture's default
(FFmpeg) backend, the port through utils/video.VideoReader (utils/h264.py):
the frames, and the seeks' landings, are cv2's. Videos: the fixtures of
tests/data/torch_h264 (the face photograph moving as
tests/test_torch_analyze.face_frames moves it, a scene without a face, the
640x360 clip), their High counterparts of tests/data/torch_h264_high
(CABAC, B-pyramid, weighted prediction, 8x8 transforms) and
tests/data/torch_mp4's Baseline and High files. Floats of the summaries
within tests/test_torch_analyze.TOL.
"""

import json
import os
import random
import shutil

import cv2
import numpy as np
import pytest

import real_time_video_deepfake_detection_tpu.cli.analyze as j_analyze
import real_time_video_deepfake_detection_tpu.data_tools.face_extract as j_fe
import real_time_video_deepfake_detection_tpu.models.backbones as j_backbones
import real_time_video_deepfake_detection_tpu.train.clip_head as j_ch
from real_time_video_deepfake_detection_tpu.pipeline.faces import FaceDetector as JFaceDetector
import real_time_video_deepfake_detection_tpu_torch.cli.analyze as t_analyze
import real_time_video_deepfake_detection_tpu_torch.data_tools.face_extract as t_fe
import real_time_video_deepfake_detection_tpu_torch.models.backbones as t_backbones
import real_time_video_deepfake_detection_tpu_torch.train.clip_head as t_ch
from real_time_video_deepfake_detection_tpu_torch.pipeline.faces import FaceDetector
from real_time_video_deepfake_detection_tpu_torch.utils import video

from tests.test_torch_analyze import assert_close, hershey_jax, weights  # noqa: F401
from tests.test_torch_video_tools import _tree_bytes
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FACE = os.path.join(DATA, "torch_h264", "cb_face_272x320.mp4")
PLAIN = os.path.join(DATA, "torch_h264", "cb_plain_272x320.mp4")
CLIP = os.path.join(DATA, "torch_h264", "cb_640x360.mp4")
SMALL = os.path.join(DATA, "torch_mp4", "baseline_160x96.mp4")
HFACE = os.path.join(DATA, "torch_h264_high", "hi_face_272x320.mp4")
HPLAIN = os.path.join(DATA, "torch_h264_high", "hi_plain_272x320.mp4")
HCLIP = os.path.join(DATA, "torch_h264_high", "hi_640x360.mp4")
HSMALL = os.path.join(DATA, "torch_mp4", "high_160x96.mp4")


@pytest.mark.parametrize("path", [FACE, HFACE])
def test_fixture_faces_are_found(path):
    """The haar_native rung finds the face in the face clips' frames, as
    the entry points below rely on."""
    r, fd = video.VideoReader(path), FaceDetector()
    ok, frame = r.read()
    assert ok and len(fd(frame)) == 1


@pytest.mark.parametrize("path, n, size", [(FACE, 4, 200), (FACE, 15, 224), (PLAIN, 3, 96),
                                           (CLIP, 4, 224), (SMALL, 5, 64), (HFACE, 4, 200),
                                           (HFACE, 15, 224), (HPLAIN, 3, 96), (HCLIP, 4, 224),
                                           (HSMALL, 5, 64)])
def test_extract_crops_equals_jax(path, n, size):
    jfd, tfd = JFaceDetector(), FaceDetector()
    want = j_fe.extract_crops(path, jfd, random.Random(5), max_frames=n, size=size)
    got = t_fe.extract_crops(path, tfd, random.Random(5), max_frames=n, size=size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if path in (FACE, HFACE):
        assert len(got) >= 4   # crops found: the comparison is not vacuous


@pytest.mark.parametrize("face, plain, clip, small", [(FACE, PLAIN, CLIP, SMALL),
                                                     (HFACE, HPLAIN, HCLIP, HSMALL)])
def test_preextract_equals_jax(tmp_path, face, plain, clip, small):
    """videos/{real,fake}/*.mp4: the face clip under several names, the
    scene without a face, the 640x360 clip and the 160x96 file (Baseline,
    then High): the same crops, names and split as the JAX tool's, byte for
    byte."""
    videos = tmp_path / "videos"
    for label, extra in (("real", [plain, small]), ("fake", [clip])):
        (videos / label).mkdir(parents=True)
        for i in range(4):
            shutil.copy(face, videos / label / f"face{i}.mp4")
        for p in extra:
            shutil.copy(p, videos / label / os.path.basename(p))
    want = j_fe.preextract(str(videos), str(tmp_path / "jax"), frames_per_video=3)
    got = t_fe.preextract(str(videos), str(tmp_path / "port"), frames_per_video=3,
                          device="cpu")
    assert got == want and got["real"] > 0 and got["fake"] > 0
    a, b = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("path", [FACE, PLAIN, CLIP, SMALL, HFACE, HCLIP, HSMALL])
@pytest.mark.parametrize("t, crop", [(6, 48), (16, 96)])
def test_clip_from_video_equals_jax(path, t, crop):
    """Uniform seeks over the 5-95% span: cv2's landings, cv2's frames."""
    want = j_ch._clip_from_video(path, t, JFaceDetector(), crop)
    got = t_ch._clip_from_video(path, t, FaceDetector(), crop)
    assert got.shape == want.shape == (t, crop, crop, 3)
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def cli_env(monkeypatch, weights):  # noqa: F811
    """Both CLIs build the small spec; the JAX side reads through cv2's
    FFmpeg backend, its writer records the annotated frames, and the
    port's writer records its frames before they are encoded."""
    spec_j, spec_t, _ = weights
    monkeypatch.setattr(j_backbones, "make", lambda name, *a, **k: spec_j)
    monkeypatch.setattr(t_backbones, "make", lambda name, *a, **k: spec_t)
    written = {"jax": [], "port": []}

    class JaxWriter:
        def __init__(self, path, fourcc, fps, size):
            self.fps, self.size = fps, size

        def write(self, frame):
            written["jax"].append(frame.copy())

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", JaxWriter)
    port_write = video.VideoWriter.write

    def record(self, frame):
        written["port"].append(frame.copy())
        port_write(self, frame)

    monkeypatch.setattr(video.VideoWriter, "write", record)
    return written


@pytest.fixture(scope="module")
def npz(tmp_path_factory, weights):  # noqa: F811
    from real_time_video_deepfake_detection_tpu.train.checkpoint import save_checkpoint
    path = str(tmp_path_factory.mktemp("mp4_cli") / "small.npz")
    save_checkpoint(path, weights[2], {"epoch": 1})
    return path


@pytest.mark.parametrize("face", [FACE, HFACE])
def test_analyze_single_matches_jax(npz, cli_env, hershey_jax, tmp_path, face):  # noqa: F811
    jj, tj = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_analyze.main([face, "--weights", npz, "--json", jj, "--max-frames", "6",
                    "--output", str(tmp_path / "jax.mp4")])
    t_analyze.main([face, "--weights", npz, "--json", tj, "--max-frames", "6",
                    "--output", str(tmp_path / "port.avi"), "--device", "cpu"])
    with open(jj) as a, open(tj) as b:
        want, got = json.load(a), json.load(b)
    assert_close(got, want)
    assert got["summary"]["frames"] == 6 and got["frames"][0]["faces_detected"] == 1
    assert len(cli_env["jax"]) == len(cli_env["port"]) == 6
    assert hershey_jax["jax"] == hershey_jax["port"]
    for j_frame, t_frame in zip(cli_env["jax"], cli_env["port"]):
        np.testing.assert_array_equal(t_frame, j_frame)
    r = video.VideoReader(str(tmp_path / "port.avi"))
    # the AVI keeps the mp4's fps (cv2's 12.923...) as a rate over 1000
    assert r.frame_count == 6 and abs(r.fps - video.VideoReader(face).fps) < 1e-3


def _frames_read(path):
    """The frames cv2 reads from a fixture, by its digests."""
    for sub in ("torch_h264", "torch_h264_high"):
        with open(os.path.join(DATA, sub, "digests.json")) as fh:
            files = json.load(fh)["files"]
        key = os.path.relpath(path, os.path.join(DATA, sub))
        key = key if not key.startswith("..") else "torch_mp4/" + os.path.basename(path)
        if key in files:
            return len(files[key]["read"])
    raise KeyError(path)


@pytest.mark.parametrize("paths", [[FACE, PLAIN, SMALL], [HFACE, HPLAIN, HSMALL]])
def test_analyze_multi_matches_jax(npz, cli_env, tmp_path, paths):
    """Three mp4s batched: the face clip, the scene without a face and the
    160x96 file (47 frames of 48: the discarded one is not read), Baseline
    then High."""
    jj, tj = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_analyze.main(paths + ["--weights", npz, "--json", jj])
    t_analyze.main(paths + ["--weights", npz, "--json", tj, "--device", "cpu"])
    with open(jj) as a, open(tj) as b:
        want, got = json.load(a), json.load(b)
    assert got["frames_total"] == want["frames_total"] == sum(_frames_read(p) for p in paths)
    assert paths[0] != FACE or got["frames_total"] == 14 + 9 + 47
    for g, w in zip(got["videos"], want["videos"]):
        assert_close(g, w)
    assert 1 <= got["max_batch_seen"] <= 3 and got["engine_ticks"] >= 1


def test_analyze_refuses_high_profile_with_the_reason():
    """High decodes since MBAFF is what stays refused: the interlaced file."""
    with pytest.raises(SystemExit, match=r"High profile \(profile_idc 100\) with field or MBAFF"):
        t_analyze.main([os.path.join(DATA, "torch_h264_high", "hi_mbaff_160x96.mp4"), "--device",
                        "cpu"])
