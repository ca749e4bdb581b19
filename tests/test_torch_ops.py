"""Port parity: the cv2-exact image ops of
real_time_video_deepfake_detection_tpu_torch.ops against the JAX package's,
bit for bit, on the same numpy inputs, the Lab pair included (its powers
and cube root are glibc's powf, emulated in ops/powf.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.ops import clahe as JC
from real_time_video_deepfake_detection_tpu.ops import color as JCol
from real_time_video_deepfake_detection_tpu.ops import filters as JFi
from real_time_video_deepfake_detection_tpu.ops import jpeg as JJ
from real_time_video_deepfake_detection_tpu.ops import resize as JR
from real_time_video_deepfake_detection_tpu_torch.ops import clahe as TC
from real_time_video_deepfake_detection_tpu_torch.ops import color as TCol
from real_time_video_deepfake_detection_tpu_torch.ops import filters as TFi
from real_time_video_deepfake_detection_tpu_torch.ops import jpeg as TJ
from real_time_video_deepfake_detection_tpu_torch.ops import resize as TR

rng = np.random.default_rng(71)


def _smooth(shape, seed):
    """Textured u8 images with real edges (random noise has no structure
    for Canny's hysteresis to follow)."""
    r = np.random.default_rng(seed)
    h, w = shape[-3], shape[-2]
    yy, xx = np.mgrid[:h, :w]
    base = 128 + 90 * np.sin(xx / 7.0 + r.random() * 6) * np.cos(yy / 11.0)
    img = base[..., None] + r.normal(0, 6, shape)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("fn", ["bgr_to_gray_u8", "bgr_to_hsv_u8"])
def test_color_conversions_bit_exact(fn):
    x = rng.integers(0, 256, (2, 96, 80, 3), dtype=np.uint8)
    want = np.asarray(jax.vmap(getattr(JCol, fn))(jnp.asarray(x)))
    got = getattr(TCol, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lab_round_trip_close_to_jnp_rung():
    """Both conversions over the whole RGB cube (every u8 triple, also read
    as a Lab triple) against the JITTED JAX functions, the form the serving
    tick runs: no triple differs in either direction. Torch runs on one
    thread (as in test_torch_powf's full-range test)."""
    fwd, inv = jax.jit(JCol.rgb_to_lab_u8), jax.jit(JCol.lab_to_rgb_u8)
    chunk = 1 << 20
    off_fwd = off_inv = 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for s in range(0, 1 << 24, chunk):
            i = np.arange(s, s + chunk)
            x = np.stack([i >> 16, (i >> 8) & 255, i & 255], -1).astype(np.uint8)
            t = torch.from_numpy(x)
            off_inv += int((TCol.lab_to_rgb_u8(t).numpy() != np.asarray(inv(x))).any(-1).sum())
            off_fwd += int((TCol.rgb_to_lab_u8(t).numpy() != np.asarray(fwd(x))).any(-1).sum())
    finally:
        torch.set_num_threads(threads)
    assert (off_fwd, off_inv) == (0, 0)


def test_srgb_linear_table_is_the_jitted_jax_function():
    c = np.arange(256, dtype=np.uint8)
    want = np.asarray(jax.jit(
        lambda c: JCol._srgb_to_linear(c.astype(jnp.float32) / 255.0))(c))
    np.testing.assert_array_equal(TCol._SRGB_TO_LINEAR.numpy(), want)


@pytest.mark.parametrize("dst", [(256, 256), (300, 300), (240, 320), (480, 640)])
def test_resize_u8_cv2_bit_exact(dst):
    x = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)   # (240,320): exact 2x
    want = np.asarray(JR.resize_bilinear_u8_cv2(jnp.asarray(x), *dst))
    got = TR.resize_bilinear_u8_cv2(torch.from_numpy(x), *dst).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_resize_f32_bit_exact(dtype):
    x = rng.integers(0, 256, (160, 160, 3)).astype(dtype)
    want = np.asarray(JR.resize_bilinear_f32(jnp.asarray(x), 224, 224))
    got = TR.resize_bilinear_f32(torch.from_numpy(x), 224, 224).numpy()
    np.testing.assert_array_equal(got, want)


def test_resize_tables_are_the_jax_tables():
    for src, dst in ((640, 300), (480, 256), (160, 224), (97, 31)):
        for a, b in zip(JR._linear_tables(src, dst), TR._linear_tables(src, dst)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(JR._linear_tables_f32(src, dst), TR._linear_tables_f32(src, dst)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["canny", "laplacian4", "gaussian_blur5_f32"])
def test_filters_bit_exact(name):
    g = np.concatenate([_smooth((1, 72, 88, 1), 5)[..., 0],
                        rng.integers(0, 256, (1, 72, 88), dtype=np.uint8)])
    if name == "gaussian_blur5_f32":
        g = g.astype(np.float32)
    want = np.stack([np.asarray(getattr(JFi, name)(jnp.asarray(f))) for f in g])
    got = getattr(TFi, name)(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "canny":
        assert (got[0] > 0).any() and (got[0] == 0).any()


def test_sobel_bit_exact():
    g = _smooth((64, 64, 1), 6)[..., 0]
    for a, b in zip(JFi.sobel3_dx_dy(jnp.asarray(g)), TFi.sobel3_dx_dy(torch.from_numpy(g))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("smooth", [False, True])
def test_jpeg_roundtrip_q90_bit_exact(smooth):
    x = (_smooth((64, 96, 3), 9) if smooth
         else rng.integers(0, 256, (64, 96, 3), dtype=np.uint8))
    want = np.asarray(jax.jit(JJ.jpeg_roundtrip_bgr, static_argnums=1)(jnp.asarray(x), 90))
    got = TJ.jpeg_roundtrip_bgr(torch.from_numpy(x[None]), 90).numpy()[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(64, 64), (50, 70), (160, 160)])
def test_clahe_numpy_bit_exact(shape):
    x = _smooth(shape + (1,), 11)[..., 0]
    np.testing.assert_array_equal(TC.clahe_u8_numpy(x), JC.clahe_u8_numpy(x))
