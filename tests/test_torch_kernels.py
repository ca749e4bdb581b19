"""The port's kernel modules on the CPU: each plain version against the JAX
Pallas kernel run in interpret mode (as tests/test_pallas_kernels.py runs
it) and against the plain JAX path; the wrappers take their plain versions
for CPU tensors without counting a launch; the modules import on a host
with no nvcc. The comparison of each CUDA kernel with its plain version
needs a card (marked `cuda`; chip_smoke.py runs the same checks there)."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.kernels.color_stats import (
    color_scores_batch as j_color_scores_batch, unique_hue_count_pallas,
)
from real_time_video_deepfake_detection_tpu.kernels.preproc import preprocess_faces_pallas
from real_time_video_deepfake_detection_tpu.pipeline.classify import (
    preprocess_aligned as j_preprocess_aligned,
)
from real_time_video_deepfake_detection_tpu_torch.kernels import build, color_stats, preproc
from real_time_video_deepfake_detection_tpu_torch.pipeline.classify import preprocess_aligned

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
rng = np.random.default_rng(81)


def _hue_frames():
    every = (np.arange(256 * 256) % 180).astype(np.uint8).reshape(256, 256)
    return np.concatenate([
        rng.integers(0, 180, (3, 256, 256), dtype=np.uint8),
        rng.integers(40, 47, (1, 256, 256), dtype=np.uint8),     # 7 hues
        np.full((1, 256, 256), 77, np.uint8), every[None],
        np.zeros((1, 256, 256), np.uint8)])


@pytest.mark.parametrize("shape", [(3, 160, 160, 3), (2, 96, 128, 3)])
def test_preprocess_plain_matches_pallas_and_aligned(shape):
    faces = rng.random(shape, dtype=np.float32) * 255
    pallas = np.asarray(preprocess_faces_pallas(jnp.asarray(faces), interpret=True))
    ref = np.stack([np.asarray(j_preprocess_aligned(jnp.asarray(f))) for f in faces])
    got = preproc.preprocess_faces(torch.from_numpy(faces)).numpy()
    assert got.shape == (shape[0], 224, 224, 3)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(preprocess_aligned(torch.from_numpy(faces)).numpy(),
                               ref, rtol=0, atol=1e-5)


# The shapes the Hopper kernel's layout is sensitive to: source rows of 384
# B (u8) and 1,536 B (f32) staged with 16-byte copies, rows of 210 and 840 B
# staged element by element, and an output row of 675 floats (no float4)
_EDGE_FACES = [((2, 96, 128, 3), 224), ((3, 50, 70, 3), 224), ((2, 40, 56, 3), 225)]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,out_size", _EDGE_FACES)
def test_preprocess_plain_edge_shapes_match_pallas(shape, out_size, dtype):
    faces = (rng.random(shape, dtype=np.float32) * 256).astype(dtype)
    pallas = np.asarray(preprocess_faces_pallas(jnp.asarray(faces), out_size, interpret=True))
    ref = np.stack([np.asarray(j_preprocess_aligned(jnp.asarray(f), out_size)) for f in faces])
    got = preproc.preprocess_faces_plain(torch.from_numpy(faces), out_size).numpy()
    assert got.shape == (shape[0], out_size, out_size, 3)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_preprocess_u8_input_same_values():
    faces = rng.integers(0, 256, (2, 160, 160, 3), dtype=np.uint8)
    a = preproc.preprocess_faces(torch.from_numpy(faces)).numpy()
    b = preproc.preprocess_faces(torch.from_numpy(faces.astype(np.float32))).numpy()
    np.testing.assert_array_equal(a, b)


def test_unique_hue_plain_matches_pallas_and_numpy():
    hues = _hue_frames()
    pallas = np.asarray(unique_hue_count_pallas(jnp.asarray(hues), interpret=True))
    got = color_stats.unique_hue_count(torch.from_numpy(hues)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, [len(np.unique(h)) for h in hues])
    assert got[-4:].tolist() == [7.0, 1.0, 180.0, 1.0]


# The inputs the Hopper kernel's cluster layout is sensitive to: hw not a
# multiple of 16, hw below one block's share, one frame, and values
# 180..255 (only 180 counts)
_HUE_EDGE = {"3x50x70": (3, 50, 70), "2x4x5": (2, 4, 5), "1x256x256": (1, 256, 256),
             "180_255": (2, 76, 76)}


def _hue_edge_frames(case):
    shape = _HUE_EDGE[case]
    if case == "180_255":
        return (np.arange(np.prod(shape)) % 76 + 180).astype(np.uint8).reshape(shape)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("case", list(_HUE_EDGE))
def test_unique_hue_plain_edge_shapes_match_pallas_and_numpy(case):
    hues = _hue_edge_frames(case)
    pallas = np.asarray(unique_hue_count_pallas(jnp.asarray(hues), interpret=True))
    got = color_stats.unique_hue_count_plain(torch.from_numpy(hues)).numpy()
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, [(np.unique(h) < 181).sum() for h in hues])
    if case == "180_255":
        assert got.tolist() == [1.0, 1.0]


def test_color_scores_batch_matches_jax():
    frames = np.concatenate([
        rng.integers(0, 256, (2, 256, 256, 3), dtype=np.uint8),
        np.full((1, 256, 256, 3), 128, np.uint8),
        np.clip(rng.normal(120, 10, (1, 256, 256, 3)), 0, 255).astype(np.uint8)])
    want = np.asarray(j_color_scores_batch(jnp.asarray(frames), interpret=True))
    got = color_stats.color_scores_batch(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cpu_calls_leave_launch_counters_at_zero():
    p0, c0 = preproc.launches, color_stats.launches
    preproc.preprocess_faces(torch.zeros((1, 32, 32, 3)), 48)
    color_stats.unique_hue_count(torch.zeros((1, 16, 16), dtype=torch.uint8))
    assert (preproc.launches, color_stats.launches) == (p0, c0)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        preproc.preprocess_faces(torch.zeros((1, 8, 8, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        preproc.preprocess_faces(torch.zeros((1, 8, 8)))
    with pytest.raises(TypeError):
        color_stats.unique_hue_count(torch.zeros((1, 8, 8)))


def test_kernel_modules_import_without_nvcc():
    env = dict(os.environ, PATH="/nonexistent", PYTHONPATH=REPO)
    env.pop("NVCC", None)
    code = ("import shutil; assert shutil.which('nvcc') is None\n"
            "from real_time_video_deepfake_detection_tpu_torch.kernels import "
            "build, color_stats, preproc\n"
            "assert build._lib is None\n")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_missing_nvcc_raises(monkeypatch):
    """No silent fallback: a kernel that cannot be built is an error."""
    monkeypatch.setenv("NVCC", "/nonexistent/nvcc")
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    faces = torch.from_numpy(rng.integers(0, 256, (8, 160, 160, 3), dtype=np.uint8)).cuda()
    n0 = preproc.launches
    got = preproc.preprocess_faces(faces)
    assert preproc.launches == n0 + 1
    assert float((got - preproc.preprocess_faces_plain(faces)).abs().max()) <= 1e-4
    hues = torch.from_numpy(_hue_frames()).cuda()
    assert torch.equal(color_stats.unique_hue_count(hues),
                       color_stats.unique_hue_count_plain(hues))


@pytest.mark.cuda
@pytest.mark.parametrize("odd_base", [False, True])
@pytest.mark.parametrize("case", list(_HUE_EDGE))
def test_cuda_unique_hue_edge_shapes(case, odd_base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    hues = torch.from_numpy(_hue_edge_frames(case)).cuda()
    if odd_base:   # a base at an odd byte offset
        hues = torch.empty(1 + hues.numel(), dtype=torch.uint8,
                           device="cuda")[1:].view(hues.shape).copy_(hues)
    n0 = color_stats.launches
    got = color_stats.unique_hue_count(hues)
    assert color_stats.launches == n0 + 1
    assert torch.equal(got, color_stats.unique_hue_count_plain(hues))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  [(np.unique(h) < 181).sum() for h in hues.cpu().numpy()])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape,out_size", _EDGE_FACES)
def test_cuda_preprocess_edge_shapes(shape, out_size, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    faces = torch.from_numpy((rng.random(shape, dtype=np.float32) * 256).astype(dtype)).cuda()
    got = preproc.preprocess_faces(faces, out_size)
    want = preproc.preprocess_faces_plain(faces, out_size)
    assert float((got - want).abs().max()) <= 1e-4
