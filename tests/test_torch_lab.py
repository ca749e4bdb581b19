"""The host Lab ladder of the port's face-quality CLAHE against its
references, on all 2^24 u8 triples: the `cv2` rung (ops/lab_u8.py, integer
tables rebuilt without cv2) equal to cv2.cvtColor's COLOR_BGR2LAB and
COLOR_LAB2BGR, the `native` rung (csrc/lab_host.cpp) equal to the JAX
package's native pair; the `jnp` rung's op-by-op pair equal to the JAX jnp
functions called outside jit, as the JAX host path calls them; then
preprocess_face_quality equal to the JAX one rung for rung on seeded crops
of several sizes, and unpinned equal to the JAX ladder's default (cv2
wherever cv2 is installed). 0 differing bytes everywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.ops import color as j_color
from real_time_video_deepfake_detection_tpu.utils import native_ingest as NI
from real_time_video_deepfake_detection_tpu_torch.ops import color as t_color
from real_time_video_deepfake_detection_tpu_torch.ops import lab_u8
from real_time_video_deepfake_detection_tpu_torch.pipeline import detector as t_detector
from real_time_video_deepfake_detection_tpu_torch.utils import native_lab

CROP_SHAPES = [(1, 1), (7, 13), (40, 33), (160, 160), (231, 187)]


@pytest.fixture(scope="module")
def cube():
    """Every u8 triple once, as a (4096, 4096, 3) image."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, (v >> 8) & 255, v & 255], axis=-1).astype(np.uint8).reshape(
        4096, 4096, 3)


@pytest.mark.parametrize("direction", ["BGR2LAB", "LAB2BGR"])
def test_cv2_rung_equals_cv2_on_every_triple(cube, direction):
    cv2 = pytest.importorskip("cv2")
    ours = lab_u8.bgr_to_lab_u8_cv2 if direction == "BGR2LAB" else lab_u8.lab_to_bgr_u8_cv2
    want = cv2.cvtColor(cube, getattr(cv2, f"COLOR_{direction}"))
    got = ours(cube)
    assert got.dtype == np.uint8 and got.shape == cube.shape
    assert int((got != want).any(-1).sum()) == 0


@pytest.mark.parametrize("direction", ["bgr2lab", "lab2bgr"])
def test_native_rung_equals_the_jax_native_rung_on_every_triple(cube, direction):
    if NI.get_lib() is None:
        pytest.skip("the JAX package's native library does not load here")
    want = getattr(NI, f"{direction}_native")(cube)
    got = getattr(native_lab, f"{direction}_native")(cube)
    assert int((got != want).any(-1).sum()) == 0


@pytest.mark.parametrize("fn", ["rgb_to_lab_u8", "lab_to_rgb_u8"])
def test_jnp_rung_equals_the_jax_functions_called_eagerly(cube, fn):
    """The JAX host path calls the jnp pair outside jit, where it rounds op
    by op; every 17th triple meets every value of each channel."""
    part = cube.reshape(-1, 3)[::17]
    want = np.asarray(getattr(j_color, fn)(jnp.asarray(part)))
    got = getattr(t_color, fn + "_op_by_op")(torch.from_numpy(part)).numpy()
    assert int((got != want).any(-1).sum()) == 0


def _crops():
    rng = np.random.default_rng(17)
    out = []
    for h, w in CROP_SHAPES:
        yy, xx = np.mgrid[:h, :w]
        smooth = 90 + 70 * np.sin(xx / 9.0)[..., None] * np.cos(yy / 11.0)[..., None]
        skin = smooth + np.array([10, 30, 80]) + rng.integers(-25, 26, (h, w, 3))
        out += [np.clip(skin, 0, 255).astype(np.uint8),
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8)]
    return out


@pytest.mark.parametrize("rung", t_detector.LAB_BACKENDS)
def test_preprocess_face_quality_equals_jax_rung_for_rung(rung):
    if rung == "cv2":
        pytest.importorskip("cv2")
    if rung == "native" and NI.get_lib() is None:
        pytest.skip("the JAX package's native library does not load here")
    for crop in _crops():
        want = j_detector.preprocess_face_quality(crop, lab_backend=rung)
        got = t_detector.preprocess_face_quality(crop, lab_backend=rung)
        assert got.dtype == np.uint8 and got.shape == crop.shape
        assert np.array_equal(got, want), (rung, crop.shape)


def test_unpinned_default_equals_the_jax_default():
    pytest.importorskip("cv2")
    assert j_detector._resolve_lab_backend() == "cv2"
    for crop in _crops():
        assert np.array_equal(t_detector.preprocess_face_quality(crop),
                              j_detector.preprocess_face_quality(crop)), crop.shape
    with pytest.raises(ValueError, match="lab_backend"):
        t_detector.preprocess_face_quality(_crops()[0], lab_backend="skimage")
