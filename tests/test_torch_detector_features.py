"""The detector's off-path features in the port against the JAX package on
the CPU: the frequency maps (ops/freq_features.py), GradCAM
(models/gradcam.py), the cv2-exact augmentations of test-time augmentation
(ops/warp.py, held to cv2 5.0's warpAffine bit for bit), and
DeepfakeDetector with `use_tta` and `enable_gradcam` against the JAX
detector on the small EfficientNet of tests/torch_port_util.py.

Tolerances: the DCT pair within 1e-5 (float32 matmuls, as the JAX package's
own test holds it to cv2.dct); the frequency maps within 1e-4 (float32 FFT
and DCT of different libraries, then min-max normalised); the GradCAM
heatmap within 1e-4 (the map's float32 rounding, magnified by the min-max
normalisation); the detector's probability within TOL = 1e-5, as the other
port tests of the detector."""

import random

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.core.config import DetectorConfig as JDC
from real_time_video_deepfake_detection_tpu.models.gradcam import gradcam as j_gradcam
from real_time_video_deepfake_detection_tpu.ops import freq_features as JFF
from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig as TDC
from real_time_video_deepfake_detection_tpu_torch.models.gradcam import gradcam
from real_time_video_deepfake_detection_tpu_torch.ops import freq_features as TFF
from real_time_video_deepfake_detection_tpu_torch.ops import warp
from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.torch_port_util import small_models, small_specs, vit_models

TOL = 1e-5
DATA = "tests/data/torch_jpeg"


def _face_crops():
    """BGR face crops of the 720x405 and 640x480 fixtures (the boxes the
    heuristic finds there), and one of odd size from the 405x720 frame."""
    out = []
    for name, (x, y, w, h) in (("frame_720x405_q85_420.jpg", (300, 110, 121, 160)),
                               ("frame_640x480_q85_420.jpg", (250, 130, 140, 181)),
                               ("frame_405x720_q85_420.jpg", (120, 250, 97, 131))):
        img = cv2.imread(f"{DATA}/{name}")
        out.append(np.ascontiguousarray(img[y:y + h, x:x + w]))
    return out


# ---------------------------------------------------------------- frequency

@pytest.mark.parametrize("shape", [(64, 48), (31, 57)])
def test_dct2_and_idct2_match_jax_and_cv2(shape):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    d = TFF.dct2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(d, cv2.dct(x), rtol=0, atol=1e-5)
    np.testing.assert_allclose(d, np.asarray(JFF.dct2(jnp.asarray(x))), rtol=0, atol=1e-5)
    back = TFF.idct2(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(back, np.asarray(JFF.idct2(jnp.asarray(d))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["bgr", "gray", "constant"])
def test_frequency_features_match_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "bgr":
        img = rng.integers(0, 256, (300, 260, 3), np.uint8)
    elif kind == "gray":
        img = rng.integers(0, 256, (97, 131), np.uint8)
    else:   # a flat image: both maps hit the min-max guard
        img = np.full((120, 100, 3), 77, np.uint8)
    got = TFF.compute_frequency_features(torch.from_numpy(img), size=96).numpy()
    want = np.asarray(JFF.compute_frequency_features(jnp.asarray(img), size=96))
    assert got.shape == (2, 96, 96) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------------------ GradCAM

def test_gradcam_matches_jax_and_leaves_no_gradient():
    spec_j, pj, model = small_models(seed=1)
    x = np.random.default_rng(5).standard_normal((3, 64, 64, 3)).astype(np.float32)
    want = np.asarray(j_gradcam(pj, jnp.asarray(x), spec_j))
    with torch.no_grad():   # autograd is switched on inside
        got = gradcam(model, torch.from_numpy(x)).numpy()
    assert got.shape == (3, 64, 64)
    assert got.min() >= 0.0 and got.max() <= 1.0 and (got.max(axis=(1, 2)) > 0.5).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------------- the augmentations

def _warp_cases(seed: int, n: int):
    rng = np.random.default_rng(seed)
    for k in range(n):
        h, w = int(rng.integers(2, 180)), int(rng.integers(2, 180))
        if k % 2:   # odd and even sizes alike
            h, w = h | 1, w & ~1 or 2
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        angle = (3.0, -3.0)[k % 2] if k < 4 else float(rng.uniform(-3, 3))
        alpha = (0.9, 1.1)[k % 2] if k < 8 else float(rng.uniform(0.9, 1.1))
        yield img, bool(k % 3 == 0), alpha, angle


@pytest.mark.parametrize("seed", range(8))
def test_augmentations_equal_cv2(seed):
    """8 x 30 cases: sizes from 2 to 179 on each side, odd and even; angles
    across +-3 degrees and exactly +-3; flips both ways; alpha exactly 0.9
    and 1.1 and between."""
    for img, flip, alpha, angle in _warp_cases(seed, 30):
        h, w = img.shape[:2]
        want = cv2.flip(img, 1) if flip else img
        got = warp.flip_horizontal(img) if flip else img
        np.testing.assert_array_equal(got, want)
        want = cv2.convertScaleAbs(want, alpha=alpha, beta=0)
        got = warp.convert_scale_abs(got, alpha)
        np.testing.assert_array_equal(got, want)
        m = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        np.testing.assert_array_equal(warp.rotation_matrix_2d((w / 2, h / 2), angle, 1.0), m)
        np.testing.assert_array_equal(warp.warp_affine_linear(got, m, (w, h)),
                                      cv2.warpAffine(want, m, (w, h)), err_msg=str((h, w, angle)))


def test_warp_affine_other_sizes_and_matrices_equal_cv2():
    """Output sizes other than the input's, a translation and a scale."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (77, 90, 3), np.uint8)
    for m, dsize in ((cv2.getRotationMatrix2D((45.0, 38.5), 2.0, 1.0), (64, 100)),
                     (np.array([[1.0, 0.0, 3.25], [0.0, 1.0, -7.5]]), (90, 77)),
                     (cv2.getRotationMatrix2D((10.0, 10.0), -1.0, 0.8), (33, 48))):
        np.testing.assert_array_equal(warp.warp_affine_linear(img, m, dsize),
                                      cv2.warpAffine(img, m, dsize))


# ----------------------------------------------------------------- detector

@pytest.fixture(scope="module")
def detectors():
    """Makes a JAX detector and a port detector with the same small
    EfficientNet parameters, at 64 px."""
    spec_j, spec_t = small_specs()
    _, pj, _ = small_models(seed=9)

    def make(seed=0, **kw):
        jd = j_detector.DeepfakeDetector(JDC(model_input_size=64), params=pj, spec=spec_j, **kw)
        td = DeepfakeDetector(TDC(model_input_size=64), params=params_from_jax(pj), spec=spec_t,
                              device="cpu", seed=seed, **kw)
        return jd, td
    return make


@pytest.mark.parametrize("seed", [0, 7])
def test_tta_matches_jax(detectors, seed):
    """The JAX detector draws from the global `random`, the port's from its
    own random.Random(seed): the same stream, so the whole averaged
    probability is held, flips, scales and rotations included."""
    jd, td = detectors(use_tta=True, num_tta_augmentations=4)
    seen = {"jax": [], "port": []}

    def spy(det, key):
        predict = det._single_prediction

        def run(face):
            seen[key].append(face.copy())
            return predict(face)
        det._single_prediction = run

    spy(jd, "jax")
    spy(td, "port")
    td._tta_rng.seed(seed)
    random.seed(seed)
    for face in _face_crops():
        want = jd.analyze_face(face)
        got = td.analyze_face(face)
        assert got[0] is not None and got[2] is None
        assert abs(got[0] - want[0]) <= TOL and got[0] == got[1]
    # every face the classifier saw, augmented ones included, byte for byte
    assert len(seen["port"]) == len(seen["jax"]) == 12
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    # the streams advanced alike: 3 faces x 3 augmentations x 3 draws
    assert td._tta_rng.random() == random.random()


def test_tta_port_seed_gives_the_stream_of_random_seed(detectors):
    _, td = detectors(use_tta=True, num_tta_augmentations=2, seed=123)
    random.seed(123)
    assert [td._tta_rng.random() for _ in range(5)] == [random.random() for _ in range(5)]


def test_gradcam_detector_matches_jax(detectors):
    jd, td = detectors(enable_gradcam=True)
    assert td.last_gradcams == [] and td.use_tta is False
    for face in _face_crops():
        want = jd.analyze_face(face)
        got = td.analyze_face(face)
        assert abs(got[0] - want[0]) <= TOL
        assert got[2].shape == (64, 64) and want[2].shape == (64, 64)
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-4)


def test_gradcam_of_a_vit_backbone_is_none():
    spec_j, pj, model = vit_models(seed=2)
    td = DeepfakeDetector(TDC(model_input_size=64), params=model.state_dict(), spec=model.spec,
                          device="cpu", enable_gradcam=True)
    jd = j_detector.DeepfakeDetector(JDC(model_input_size=64), params=pj, spec=spec_j,
                                     enable_gradcam=True)
    face = _face_crops()[0]
    got, want = td.analyze_face(face), jd.analyze_face(face)
    assert got[2] is None and want[2] is None
    assert abs(got[0] - want[0]) <= TOL
