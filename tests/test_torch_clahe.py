"""The port's batched CLAHE (ops/clahe.clahe_u8_batch, the plain version of
the two kernels in csrc/clahe.cu) and its kernel wrappers
(kernels/clahe.py) on the CPU, against the JAX package: the numpy oracle
clahe_u8_numpy and _lut_for_tile (exactly), the jitted batched
clahe_u8_batch and the Pallas kernels in interpret mode (within the steps
stated per test; both round differently from the oracle). The comparison
of the CUDA kernels with the plain versions needs a card (marked `cuda`;
chip_smoke.py runs the same checks there)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.kernels.clahe import (
    clahe_luts_pallas, clahe_u8_pallas,
)
from real_time_video_deepfake_detection_tpu.ops import clahe as JC
from real_time_video_deepfake_detection_tpu_torch.kernels import clahe as KC
from real_time_video_deepfake_detection_tpu_torch.ops import clahe as TC


def _faces(n, h, w, seed):
    """Half random planes, half smooth face-like ones (a lit oval over a
    gradient, with noise)."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = [r.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(n - n // 2)]
    for _ in range(n // 2):
        oval = ((xx - w / 2) / (0.35 * w)) ** 2 + ((yy - h / 2) / (0.45 * h)) ** 2 <= 1
        f = 60 + 0.4 * yy + 90 * oval + r.normal(0, 6, (h, w)) + r.uniform(-30, 30)
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(out)


def _tile_luts(img, tiles=8, clip_limit=2.0):
    th, tw = img.shape[0] // tiles, img.shape[1] // tiles
    clip = max(int(clip_limit * th * tw / 256), 1)
    return np.stack([JC._lut_for_tile(np.bincount(
        img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw].ravel(), minlength=256
    ).astype(np.int64), clip, th * tw) for ty in range(tiles) for tx in range(tiles)])


@pytest.mark.parametrize("shape", [(160, 160), (96, 128)])
def test_plain_luts_equal_lut_for_tile(shape):
    imgs = _faces(4, *shape, seed=1)
    got = TC.clahe_luts_batch(torch.from_numpy(imgs)).numpy()
    assert got.shape == (4, 64, 256) and got.dtype == np.float32
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(got[i], _tile_luts(img))


@pytest.mark.parametrize("shape", [(160, 160), (96, 128)])
def test_plain_clahe_equals_numpy_oracle(shape):
    imgs = np.concatenate([_faces(4, *shape, seed=2),
                           np.full((1,) + shape, 128, np.uint8)])
    got = TC.clahe_u8_batch(torch.from_numpy(imgs)).numpy()
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(got[i], JC.clahe_u8_numpy(img))


def _edge_planes():
    """The planes the Hopper LUT kernel is sensitive to: constant ones (one
    bin holds the whole tile: every atomic on one bin, the largest clip excess and
    residual) at 160x160, and (40, 56) planes whose 7-pixel tile rows cannot
    be read as 32-bit words."""
    const = np.stack([np.full((160, 160), v, np.uint8) for v in (0, 77, 128, 255)])
    narrow = np.concatenate([_faces(2, 40, 56, seed=8), np.full((1, 40, 56), 200, np.uint8)])
    return const, narrow


@pytest.mark.parametrize("which", [0, 1])
def test_plain_luts_and_clahe_on_edge_planes(which):
    imgs = _edge_planes()[which]
    luts = TC.clahe_luts_batch(torch.from_numpy(imgs)).numpy()
    out = TC.clahe_u8_batch(torch.from_numpy(imgs)).numpy()
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(luts[i], _tile_luts(img))
        np.testing.assert_array_equal(out[i], JC.clahe_u8_numpy(img))


def test_plain_clahe_short_wide_tiles_equals_numpy_oracle():
    """(2, 24, 200): tiles 3 rows high and 25 wide, the odd tile sizes at
    which the Hopper apply kernel's band of rows spans its tile rows."""
    imgs = torch.from_numpy(_faces(2, 24, 200, seed=9))
    got = TC.clahe_apply_batch(imgs, TC.clahe_luts_batch(imgs)).numpy()
    for i, img in enumerate(imgs.numpy()):
        np.testing.assert_array_equal(got[i], JC.clahe_u8_numpy(img))


def _apply_numpy(img, lut, tiles=8):
    """clahe_u8_numpy's blend of (tiles², 256) LUTs, in numpy f32 with every
    operation rounded on its own, for any f32 LUT."""
    def axis(n, t):
        f = (np.arange(n, dtype=np.float32) * np.float32(1.0 / t)
             - np.float32(0.5)).astype(np.float32)
        lo = np.floor(f)
        return (np.clip(lo, 0, tiles - 1).astype(int), np.clip(lo + 1, 0, tiles - 1).astype(int),
                (f - lo).astype(np.float32))
    (y1, y2, ya), (x1, x2, xa) = axis(img.shape[0], img.shape[0] // tiles), axis(
        img.shape[1], img.shape[1] // tiles)
    cell = lut.reshape(tiles, tiles, 256)
    v = img.astype(int)
    ixa, iya = np.float32(1) - xa, (np.float32(1) - ya)[:, None]
    top = cell[y1[:, None], x1[None], v] * ixa + cell[y1[:, None], x2[None], v] * xa
    bot = cell[y2[:, None], x1[None], v] * ixa + cell[y2[:, None], x2[None], v] * xa
    return np.clip(np.rint(top * iya + bot * ya[:, None]), 0, 255).astype(np.uint8)


def _random_luts(n, fractional, seed):
    """(n, 64, 256) f32 LUTs that do not come from clahe_luts, some entries
    outside 0..255."""
    luts = np.random.default_rng(seed).uniform(-16, 272, (n, 64, 256)).astype(np.float32)
    return luts if fractional else np.round(luts)


@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("shape", [(160, 160), (24, 200)])
def test_plain_apply_takes_any_f32_lut(shape, fractional):
    imgs = _faces(3, *shape, seed=10)
    luts = _random_luts(len(imgs), fractional, seed=12)
    got = TC.clahe_apply_batch(torch.from_numpy(imgs), torch.from_numpy(luts)).numpy()
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(got[i], _apply_numpy(img, luts[i]))


def test_axis_fracs_are_the_jax_quadrant_fracs():
    ya, xa = JC._quadrant_fracs(160, 128, 8)
    fy, fx = TC.axis_fracs(160, 20), TC.axis_fracs(128, 16)
    want_y = np.broadcast_to(fy.reshape(8, 2, 10)[:, None, :, None, :, None],
                             (8, 8, 2, 2, 10, 8)).reshape(64, 4, 80)
    want_x = np.broadcast_to(fx.reshape(8, 2, 8)[None, :, None, :, None, :],
                             (8, 8, 2, 2, 10, 8)).reshape(64, 4, 80)
    np.testing.assert_array_equal(ya, want_y)
    np.testing.assert_array_equal(xa, want_x)


def test_close_to_jitted_jax_batch():
    """The JAX batched form divides in integers (missing ties the oracle's
    f64 product makes) and may contract its lerp: at most 1 step on under 1%
    of pixels."""
    imgs = _faces(6, 160, 160, seed=3)
    want = np.asarray(jax.jit(JC.clahe_u8_batch)(jnp.asarray(imgs)))
    got = TC.clahe_u8_batch(torch.from_numpy(imgs)).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_luts_close_to_pallas_luts():
    """The TPU kernel rounds cdf*255/area in f32: LUT entries at most 1 step
    apart."""
    imgs = _faces(2, 160, 160, seed=4)
    got = TC.clahe_luts_batch(torch.from_numpy(imgs)).numpy()
    for i, img in enumerate(imgs):
        want = np.asarray(clahe_luts_pallas(jnp.asarray(img), interpret=True))
        assert np.abs(got[i] - want).max() <= 1


def test_close_to_pallas_clahe():
    """The TPU kernel's f32 LUTs and per-quadrant weight products: at most 1
    step on under 2% of pixels."""
    img = _faces(1, 160, 160, seed=5)[0]
    want = np.asarray(jax.jit(lambda v: clahe_u8_pallas(v, interpret=True))(jnp.asarray(img)))
    got = TC.clahe_u8_batch(torch.from_numpy(img[None])).numpy()[0]
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.02


def test_wrappers_on_cpu_take_plain_versions_without_counting():
    before = dict(KC.launches)
    imgs = torch.from_numpy(_faces(2, 96, 128, seed=6))
    luts = KC.clahe_luts(imgs)
    assert torch.equal(luts, TC.clahe_luts_batch(imgs))
    assert torch.equal(KC.clahe_apply(imgs, luts), TC.clahe_apply_batch(imgs, luts))
    assert torch.equal(KC.clahe_u8(imgs), TC.clahe_u8_batch(imgs))
    assert KC.launches == before


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        KC.clahe_luts(torch.zeros((1, 16, 16)))
    with pytest.raises(ValueError):
        KC.clahe_luts(torch.zeros((1, 20, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        KC.clahe_apply(torch.zeros((1, 16, 16), dtype=torch.uint8), torch.zeros((1, 64, 255)))


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    imgs = torch.from_numpy(_faces(8, 160, 160, seed=7)).cuda()
    n0 = dict(KC.launches)
    luts = KC.clahe_luts(imgs)
    out = KC.clahe_apply(imgs, luts)
    assert KC.launches == {k: v + 1 for k, v in n0.items()}
    assert torch.equal(luts, TC.clahe_luts_batch(imgs))
    assert torch.equal(out, TC.clahe_apply_batch(imgs, luts))
    want = np.stack([JC.clahe_u8_numpy(i) for i in imgs.cpu().numpy()])
    np.testing.assert_array_equal(out.cpu().numpy(), want)


def _odd_base(x):
    """A copy of CUDA u8 planes whose base lies at an odd byte offset."""
    return torch.empty(1 + x.numel(), dtype=x.dtype, device=x.device)[1:].view(x.shape).copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("odd_base", [False, True])
@pytest.mark.parametrize("shape", [(2, 24, 200), (1, 160, 160), (3, 40, 56), (2, 16, 2056)])
def test_cuda_clahe_on_edge_shapes(shape, odd_base):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    imgs = torch.from_numpy(_faces(*shape, seed=13)).cuda()
    if odd_base:
        imgs = _odd_base(imgs)
    n0 = dict(KC.launches)
    luts = KC.clahe_luts(imgs)
    out = KC.clahe_apply(imgs, luts)
    assert KC.launches == {k: v + 1 for k, v in n0.items()}
    assert torch.equal(luts, TC.clahe_luts_batch(imgs))
    assert torch.equal(out, TC.clahe_apply_batch(imgs, luts))
    want = np.stack([JC.clahe_u8_numpy(i) for i in imgs.cpu().numpy()])
    np.testing.assert_array_equal(out.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("fractional", [False, True])
@pytest.mark.parametrize("shape", [(160, 160), (24, 200)])
def test_cuda_apply_takes_any_f32_lut(shape, fractional):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    imgs = torch.from_numpy(_faces(3, *shape, seed=10)).cuda()
    luts = torch.from_numpy(_random_luts(3, fractional, seed=12)).cuda()
    assert torch.equal(KC.clahe_apply(imgs, luts), TC.clahe_apply_batch(imgs, luts))
    # a LUT base that is not 16-byte aligned
    odd = torch.empty(1 + luts.numel(), device="cuda")[1:].view(luts.shape).copy_(luts)
    assert torch.equal(KC.clahe_apply(imgs, odd), TC.clahe_apply_batch(imgs, odd))


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1])
def test_cuda_luts_on_edge_planes(which):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs these checks on the card)")
    imgs = torch.from_numpy(_edge_planes()[which]).cuda()
    luts = KC.clahe_luts(imgs)
    assert torch.equal(luts, TC.clahe_luts_batch(imgs))
    want = np.stack([JC.clahe_u8_numpy(i) for i in imgs.cpu().numpy()])
    np.testing.assert_array_equal(KC.clahe_apply(imgs, luts).cpu().numpy(), want)
