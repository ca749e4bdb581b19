"""The port's library entry point and offline analyzer against the JAX
package on the CPU: DeepfakeDetector.predict with its overlay,
cli/analyze.main on one video (--json, --output, --gradcam) and on several
(the batched engine), and the pipeline/faces helpers.

Both packages see the same frames (a photograph with a face, which the
haar_native rung finds, and frames without one) and the same parameters:
the small EfficientNet of tests/torch_port_util.py, handed to both CLIs as
a JAX .npz through --weights (their `backbones.make` returns that spec).
JAX reads the videos as it always does, with cv2.VideoCapture(path): the
default FFmpeg backend, whose Motion-JPEG decode (libavcodec, libswscale)
the port's reader reproduces.

cv2 5.0 draws FONT_HERSHEY_SIMPLEX with its TrueType engine; the port
draws cv2 4.x's Hershey strokes (held to OpenCV 4.6 in
tests/test_torch_draw.py). Here the JAX side's cv2.putText and
cv2.getTextSize are the Hershey ones, so that the whole annotated frame is
compared byte for byte wherever the two label strings are equal.
Probabilities within TOL = 1e-5, as tests/test_torch_http.py holds them.
Torch runs on one thread here (tests/torch_train_util.one_torch_thread):
beside the other test workers its thread pool made these tests ~10x
slower.
"""

import json

import cv2
import numpy as np
import pytest

import real_time_video_deepfake_detection_tpu.cli.analyze as j_analyze
import real_time_video_deepfake_detection_tpu.models.backbones as j_backbones
import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
import real_time_video_deepfake_detection_tpu.pipeline.faces as j_faces
from real_time_video_deepfake_detection_tpu.core.config import DetectorConfig as JDC
from real_time_video_deepfake_detection_tpu.train.checkpoint import save_checkpoint as j_save
import real_time_video_deepfake_detection_tpu_torch.cli.analyze as t_analyze
import real_time_video_deepfake_detection_tpu_torch.models.backbones as t_backbones
import real_time_video_deepfake_detection_tpu_torch.pipeline.detector as t_detector
import real_time_video_deepfake_detection_tpu_torch.pipeline.faces as t_faces
from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig as TDC
from real_time_video_deepfake_detection_tpu_torch.ops import draw
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader

from tests.torch_port_util import small_models, small_specs

_CAPTURE = cv2.VideoCapture   # cv2's own, which the CLI fixture patches
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-5
PHOTO = "tests/data/torch_haar/grace_hopper.jpg"
H, W = 320, 272


def face_frames(n):
    """The photograph moving 2 px down and 1 px right a frame (wrapping
    round); the cascade finds the face in each."""
    img = cv2.resize(cv2.imread(PHOTO), (W, H), interpolation=cv2.INTER_AREA)
    return [np.ascontiguousarray(np.roll(img, (2 * i, i), (0, 1))) for i in range(n)]


def plain_frames(n, seed=0):
    """Smooth gradients and soft noise: no face for any rung."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:H, :W]
    out = []
    for i in range(n):
        f = np.stack([(yy + 5 * i) % 256, (xx // 2 + 40) % 256, ((yy + xx) // 3) % 256], -1)
        out.append(np.clip(f + rng.normal(0, 6, f.shape), 0, 255).astype(np.uint8))
    return out


def write_avi(path, frames, fps=12.0):
    wr = cv2.VideoWriter(str(path), cv2.CAP_OPENCV_MJPEG, cv2.VideoWriter_fourcc(*"MJPG"),
                         fps, (W, H))
    for f in frames:
        wr.write(f)
    wr.release()
    return str(path)


def assert_close(got, want, path="result"):
    """Equal structure and values; floats within TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.fixture
def hershey_jax(monkeypatch):
    """The JAX side's cv2 text calls draw the Hershey font; both sides'
    label strings are recorded."""
    texts = {"jax": [], "port": []}
    hershey = draw.put_text

    def put_text(img, text, org, font, scale, color, thickness=1, *a, **k):
        texts["jax"].append(text)
        return hershey(img, text, org, scale, color, thickness)

    def get_text_size(text, font, scale, thickness):
        return draw.get_text_size(text, scale, thickness)

    def port_put_text(img, text, *a, **k):
        texts["port"].append(text)
        return hershey(img, text, *a, **k)

    monkeypatch.setattr(cv2, "putText", put_text)
    monkeypatch.setattr(cv2, "getTextSize", get_text_size)
    monkeypatch.setattr(draw, "put_text", port_put_text)
    return texts


@pytest.fixture(scope="module")
def weights():
    spec_j, spec_t = small_specs()
    _, pj, _ = small_models(seed=9)
    return spec_j, spec_t, pj


@pytest.mark.parametrize("kind", ["face", "no_face"])
def test_predict_matches_jax(weights, hershey_jax, kind):
    spec_j, spec_t, pj = weights
    jd = j_detector.DeepfakeDetector(JDC(model_input_size=64), params=pj, spec=spec_j)
    td = t_detector.DeepfakeDetector(TDC(model_input_size=64), params=params_from_jax(pj),
                                     spec=spec_t, device="cpu")
    frames = face_frames(6) if kind == "face" else plain_frames(6)
    compared = 0
    for i, frame in enumerate(frames):
        n_jax, n_port = len(hershey_jax["jax"]), len(hershey_jax["port"])
        want = jd.predict(frame)
        got = td.predict(frame)
        assert_close(got[3], want[3], f"frame {i}")
        assert got[1] == want[1]
        assert (got[2] is None) == (want[2] is None)
        if got[2] is not None:
            np.testing.assert_array_equal(got[2], want[2])
        assert got[3]["faces_detected"] == (1 if kind == "face" else 0)
        labels_j, labels_t = hershey_jax["jax"][n_jax:], hershey_jax["port"][n_port:]
        assert len(labels_j) == len(labels_t) > 0
        if labels_j == labels_t:
            np.testing.assert_array_equal(got[0], want[0], err_msg=f"frame {i}")
            compared += 1
        np.testing.assert_array_equal(frame, frames[i])   # the input is not drawn on
    assert td.frame_count == jd.frame_count == 6
    assert compared >= 5


def test_box_color_and_legacy_shims(monkeypatch):
    assert t_detector.DeepfakeDetector.get_box_color("FAKE") == (0, 0, 255)
    assert t_detector.DeepfakeDetector.get_box_color("REAL") == (0, 255, 0)
    monkeypatch.setattr(t_detector, "_default_detector", None)
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_detector.get_default_detector()

    calls = []

    class Fake:
        def predict(self, frame):
            calls.append(frame)
            return "annotated", True, None, {"frame_count": 1}

    monkeypatch.setattr(t_detector, "_default_detector", Fake())
    assert t_detector.predict("f") == "annotated"
    assert t_detector.predict_with_forensics("g") == ("annotated", True, None,
                                                      {"frame_count": 1})
    assert calls == ["f", "g"]


# ---------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def videos(tmp_path_factory, weights):
    spec_j, _, pj = weights
    d = tmp_path_factory.mktemp("analyze")
    npz = str(d / "small.npz")
    j_save(npz, pj, {"epoch": 1})
    return {"face": write_avi(d / "face.avi", face_frames(5)),
            "plain": write_avi(d / "plain.avi", plain_frames(4, seed=3)),
            "npz": npz, "dir": d}


@pytest.fixture
def cli_env(monkeypatch, weights):
    """Both CLIs build the small spec; JAX reads with cv2's default backend
    and its writer (cv2's own) records the annotated frames as it writes
    them; the port's writer records its frames before they are encoded."""
    spec_j, spec_t, _ = weights
    monkeypatch.setattr(j_backbones, "make", lambda name, *a, **k: spec_j)
    monkeypatch.setattr(t_backbones, "make", lambda name, *a, **k: spec_t)
    written = {"jax": [], "port": []}

    real_writer = cv2.VideoWriter

    class JaxWriter:
        def __init__(self, path, fourcc, fps, size):
            self.fps, self.size = fps, size
            self.real = real_writer(path, fourcc, fps, size)

        def write(self, frame):
            written["jax"].append(frame.copy())
            self.real.write(frame)

        def release(self):
            self.real.release()

    monkeypatch.setattr(cv2, "VideoWriter", JaxWriter)
    from real_time_video_deepfake_detection_tpu_torch.utils import video
    port_write = video.VideoWriter.write

    def record(self, frame):
        written["port"].append(frame.copy())
        port_write(self, frame)

    monkeypatch.setattr(video.VideoWriter, "write", record)
    return written


@pytest.mark.parametrize("ext", [".mp4", ".avi"])
def test_analyze_single_matches_jax(videos, cli_env, hershey_jax, tmp_path, ext):
    jj, tj = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_out, t_out = str(tmp_path / ("jax" + ext)), str(tmp_path / ("port" + ext))
    j_analyze.main([videos["face"], "--weights", videos["npz"], "--json", jj,
                    "--max-frames", "4", "--output", j_out])
    t_analyze.main([videos["face"], "--weights", videos["npz"], "--json", tj,
                    "--max-frames", "4", "--output", t_out, "--device", "cpu"])
    with open(jj) as a, open(tj) as b:
        want, got = json.load(a), json.load(b)
    assert_close(got, want)
    assert got["summary"]["frames"] == 4 and got["frames"][0]["faces_detected"] == 1
    # the annotated frames, then the --output files: cv2's mp4v bytes
    assert len(cli_env["jax"]) == len(cli_env["port"]) == 4
    assert hershey_jax["jax"] == hershey_jax["port"]
    for j_frame, t_frame in zip(cli_env["jax"], cli_env["port"]):
        np.testing.assert_array_equal(t_frame, j_frame)
    with open(j_out, "rb") as a, open(t_out, "rb") as b:
        assert b.read() == a.read()
    reader, cap = VideoReader(t_out), _CAPTURE(j_out, cv2.CAP_FFMPEG)
    assert reader.frame_count == 4 and reader.fps == 12.0
    for _ in range(4):
        (ok, back), (ok_c, want_back) = reader.read(), cap.read()
        assert ok and ok_c
        np.testing.assert_array_equal(back, want_back)


def test_analyze_gradcam_matches_jax(videos, cli_env, hershey_jax, tmp_path):
    """The heatmaps are floats of two libraries: within 2 levels inside the
    face boxes (a level of the u8 heatmap moves JET by up to 4, then x0.4),
    exact outside."""
    for main, dev in ((j_analyze.main, []), (t_analyze.main, ["--device", "cpu"])):
        main([videos["face"], "--weights", videos["npz"], "--max-frames", "2", "--gradcam",
              "--output", str(tmp_path / "o.avi")] + dev)
    assert len(cli_env["jax"]) == len(cli_env["port"]) == 2
    assert hershey_jax["jax"] == hershey_jax["port"]
    reader, fd = VideoReader(videos["face"]), t_faces.FaceDetector()
    for i, (a, b) in enumerate(zip(cli_env["port"], cli_env["jax"])):
        frame = reader.read()[1]
        diff = np.abs(a.astype(int) - b.astype(int))
        inside = np.zeros(diff.shape[:2], bool)
        (x, y, w, h), = fd(frame)
        inside[y:y + h, x:x + w] = True
        assert diff[~inside].max() == 0, f"frame {i}"
        assert diff[inside].max() <= 2, f"frame {i}"
        blended = a[y + 5:y + h - 5, x + 5:x + w - 5] != frame[y + 5:y + h - 5, x + 5:x + w - 5]
        assert blended.mean() > 0.5   # a heatmap was blended over the face


def test_analyze_multi_matches_jax(videos, cli_env, tmp_path, capsys):
    paths = [videos["face"], videos["plain"], str(tmp_path / "missing.avi")]
    jj, tj = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_analyze.main(paths + ["--weights", videos["npz"], "--json", jj])
    t_analyze.main(paths + ["--weights", videos["npz"], "--json", tj, "--device", "cpu"])
    with open(jj) as a, open(tj) as b:
        want, got = json.load(a), json.load(b)
    assert got["frames_total"] == want["frames_total"] == 9
    for g, w in zip(got["videos"][:2], want["videos"][:2]):
        assert_close(g, w)
    assert want["videos"][2]["error"] == "cannot open"
    assert got["videos"][2]["error"].startswith("cannot open: cannot read")
    assert 1 <= got["max_batch_seen"] <= 3 and got["engine_ticks"] >= 1


def test_analyze_refusals(videos, tmp_path):
    with pytest.raises(SystemExit, match="single-video only"):
        t_analyze.main([videos["face"], videos["plain"], "--output", "x.avi",
                        "--device", "cpu"])
    with pytest.raises(SystemExit, match="camera capture is not supported"):
        t_analyze.main(["0", "--device", "cpu"])
    junk = tmp_path / "clip.mp4"   # no video: cv2.VideoWriter's mp4v files now open
    junk.write_bytes(b"not a video at all" * 10)
    with pytest.raises(SystemExit, match="Motion-JPEG AVI"):
        t_analyze.main([str(junk), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--weights"):
        t_analyze.main([videos["face"], "--weights", str(tmp_path / "none.npz"),
                        "--device", "cpu"])


def test_analyze_refuses_cuda_without_a_card(videos, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_analyze.main([videos["face"]])


# ------------------------------------------------------- pipeline/faces.py

def test_face_helpers_match_jax(monkeypatch):
    frame = face_frames(1)[0]
    faces_j, crops_j = j_faces.detect_and_extract_faces(frame, padding=10)
    faces_t, crops_t = t_faces.detect_and_extract_faces(frame, padding=10)
    assert faces_t == faces_j and len(faces_t) == 1
    for a, b in zip(crops_t, crops_j):
        np.testing.assert_array_equal(a, b)
    assert t_faces.detect_bounding_box(frame) == j_faces.detect_bounding_box(frame) == faces_t
    for box, pad in (((-5, 250, 40, 40), 7), ((300, -3, 30, 10), 0), ((10, 20, 5, 6), 50)):
        np.testing.assert_array_equal(t_faces.extract_face_region(frame, box, pad),
                                      j_faces.extract_face_region(frame, box, pad))
    boxes = faces_t + [(-10, -10, 40, 30), (300, 250, 40, 40)]
    for color, th in (((0, 255, 0), 2), ((10, 20, 250), 3), ((255, 0, 0), 1)):
        got = t_faces.draw_bounding_boxes(frame, boxes, color, th)
        np.testing.assert_array_equal(got, j_faces.draw_bounding_boxes(frame, boxes, color, th))
    assert (got != frame).any()
