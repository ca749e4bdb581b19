"""The port's emulation of glibc's powf (ops/powf.py) against the jitted JAX
functions the Lab conversion calls (XLA lowers jnp.cbrt and jnp.power to the
host's powf), against libm's powf itself, and its exact float64 FMA against
exact rational arithmetic. The jitted functions are glibc's FMA build of
powf on an x86-64 host with FMA; on a CPU without FMA they would differ."""

import ctypes
import ctypes.util
import math
import struct
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu_torch.ops import powf as P
from real_time_video_deepfake_detection_tpu_torch.ops.color import _cbrt

# every f32 in the cube root's range in the Lab conversion (t > 0.008856,
# and X/Xn, Y, Z/Zn of a u8 RGB triple stay below 1.01)
_LO = int(np.float32(0.008856).view(np.uint32))
_HI = int(np.float32(1.01).view(np.uint32))


def _libm_powf():
    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    fn = libm.powf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float, ctypes.c_float]
    return fn


def test_cbrt_equals_jitted_jnp_cbrt_on_every_f32_of_the_lab_range():
    """All 57,683,693 f32 in [0.008856, 1.01], in chunks: the emulation
    equals jax.jit(jnp.cbrt) on every one; the float64 torch.pow rounded to
    f32 (the port's cube root before the emulation) differs on 37,775.
    Torch runs on one thread here: beside other test workers, the thread
    pool's hand-offs on the emulation's many short passes cost minutes."""
    assert _HI - _LO + 1 == 57_683_693
    cbrt = jax.jit(jnp.cbrt)
    e = float(np.float32(1.0 / 3.0))
    chunk = 1 << 20
    emulated_off = pow_off = 0
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for s in range(_LO, _HI + 1, chunk):
            x = np.arange(s, min(s + chunk, _HI + 1), dtype=np.uint32).view(np.float32)
            want = np.asarray(cbrt(x))
            t = torch.from_numpy(x)
            emulated_off += int((_cbrt(t).numpy() != want).sum())
            pow_off += int((torch.pow(t.double(), e).float().numpy() != want).sum())
    finally:
        torch.set_num_threads(threads)
    assert emulated_off == 0
    assert pow_off == 37_775


@pytest.mark.parametrize("e,lo,hi", [
    (1.0 / 2.4, 0.0031308, 1.0),            # _linear_to_srgb_u8
    (2.4, (0.04045 + 0.055) / 1.055, 1.0),   # _srgb_to_linear_table
])
def test_powers_equal_jitted_jnp_power(e, lo, hi):
    rng = np.random.default_rng(17)
    x = np.concatenate([rng.uniform(lo, hi, 1 << 20).astype(np.float32),
                        rng.random(1 << 16, dtype=np.float32)])
    want = np.asarray(jax.jit(lambda v: jnp.power(v, e))(x))
    np.testing.assert_array_equal(P.powf(torch.from_numpy(x), e).numpy(), want)


@pytest.mark.parametrize("e", [1.0 / 3.0, 1.0 / 2.4, 2.4, -0.7, 7.5, 100.0])
def test_powf_equals_libm_over_the_f32_range(e):
    """Positive f32 of every exponent, subnormals, 0 and the overflow and
    underflow edges, against libm's powf called through ctypes."""
    rng = np.random.default_rng(23)
    x = np.concatenate([
        (np.float32(2.0) ** rng.integers(-149, 128, 4000).astype(np.float32)
         * rng.uniform(1, 2, 4000).astype(np.float32)),
        rng.integers(1, 1 << 23, 1000).astype(np.uint32).view(np.float32),   # subnormal
        np.array([0.0, 1.0, 1e-45, 2.0 ** -126, 3.4e38], np.float32)]).astype(np.float32)
    x = x[np.isfinite(x)]
    libm_powf = _libm_powf()
    want = np.array([libm_powf(float(v), float(np.float32(e))) for v in x], np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(P.powf(t, e).numpy(), want)
    # the exact pass alone, on every lane (powf sends it only a few)
    ylogx, _, y = P._chain(P._bits(t), float(np.float32(e)), True, P._tables("cpu"))
    exact = torch.where(t == 0, 0.0 if e > 0 else np.inf, P._round_f32(ylogx, y))
    np.testing.assert_array_equal(exact.numpy(), want)


@pytest.mark.parametrize("e,lo,hi,stride", [
    (1.0 / 3.0, 0.008856, 1.01, 7),         # the cube root's Lab range
    (1.0 / 2.4, 0.0031308, 1.0, 7),         # _linear_to_srgb_u8's range
    (2.4, 2.0 ** -52, 2.0 ** 52, 4099),     # |ylogx| up to 125
])
def test_fast_pass_stays_inside_its_window(e, lo, hi, stride):
    """powf's fast pass (glibc's chain with unfused contractions) gives a
    double within 2^8 units in the last place of the exact chain's on every
    `stride`-th f32 of the range, far inside the 2^16-unit window that
    sends a lane to the exact pass; under 1 in 1,000 lanes fall in that
    window, and on these ranges the exact pass changes no f32."""
    yd = float(np.float32(e))
    tabs = P._tables("cpu")
    bits = np.arange(int(np.float32(lo).view(np.uint32)), int(np.float32(hi).view(np.uint32)) + 1,
                     stride, dtype=np.uint32)
    ix = P._bits(torch.from_numpy(bits.view(np.float32)))
    ylogx, r, fast = P._chain(ix, yd, False, tabs)
    exact = P._chain(ix, yd, True, tabs)[2]
    regular = (ylogx.abs() < 125.0) & (r.abs() <= 2.0 ** -6 - 2.0 ** -40)
    ulps = (fast.view(torch.int64) - exact.view(torch.int64)).abs()[regular]
    assert int(regular.sum()) > 0.99 * len(bits) and int(ulps.max()) <= 1 << 8
    low = fast.view(torch.int64) & ((1 << 29) - 1)
    assert float(((low - (1 << 28)).abs() < P._MIDPOINT_ULPS).double().mean()) < 1e-3
    assert torch.equal(fast[regular].float(), exact[regular].float())


def _exact_fma(a: float, b: float, c: float) -> float:
    # float(Fraction) divides integers, which CPython rounds correctly
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _hard_fma_cases():
    rng = np.random.default_rng(29)
    u = 2.0 ** -52
    cases = [
        (1.0, 1.0, 2.0 ** -53), (1.0, 1.0 + u, 2.0 ** -53),      # exact ties
        (-1.0, 1.0, -(2.0 ** -53)), (1.0, 1.0 + 2 * u, -(2.0 ** -54)),
        (1.0 + u, 1.0 + u, 2.0 ** -53),                           # tie broken by u^2
        (1.0 + u, 1.0 - u, -1.0), (1.0 + u, 1.0 + u, -1.0),       # cancellation
        (3.0, 1.0 / 3.0, -1.0), (0.1, 10.0, -1.0),
        (1.0 + u, 1.0 + u, 2.0 ** 60), (1.0 + u, 1.0 + u, -(2.0 ** 60)),   # gaps
        (1.0 + u, 1.0 - u, 2.0 ** -60), (2.0 ** 40, 2.0 ** 30, 1.0),
        (0.0, 5.0, -3.0), (5.0, 0.0, 0.0),
    ]
    for _ in range(400):   # c cancels the rounded product: the result is its error
        a, b = rng.uniform(-2, 2, 2) * 2.0 ** rng.integers(-30, 30, 2)
        cases.append((a, b, -(a * b)))
        cases.append((a, b, -(a * b) + (a * b) * u * rng.uniform(-4, 4)))
    for _ in range(400):   # product and addend near a rounding midpoint of the sum
        a, b = rng.uniform(1, 2, 2)
        p = a * b
        half_ulp = math.ulp(p) / 2
        cases.append((a, b, half_ulp * rng.choice([-1.0, 1.0])))
        cases.append((a, b, (half_ulp + math.ulp(half_ulp) * rng.integers(-3, 4))
                      * rng.choice([-1.0, 1.0])))
    for _ in range(200):
        # c + fl(a*b) is a tie that the product's low part breaks, by less
        # than half a unit of the low sum: rounding that sum to nearest
        # (not to odd) lands back on the tie
        c = rng.uniform(1, 2) * 2.0 ** rng.integers(-8, 8)
        h = math.ulp(c) / 2
        s = rng.choice([-1.0, 1.0])
        cases.append((s * (1 - 2.0 ** -53), (1 + u) * h, s * c))
    for _ in range(400):   # wide exponent gaps either way
        a, b = rng.uniform(-2, 2, 2) * 2.0 ** rng.integers(-20, 20, 2)
        cases.append((a, b, rng.uniform(-2, 2) * 2.0 ** rng.integers(-120, 120)))
    return cases


def test_fma64_is_the_correctly_rounded_fma():
    a, b, c = (torch.tensor(v, dtype=torch.float64) for v in zip(*_hard_fma_cases()))
    want = [_exact_fma(x, y, z) for x, y, z in zip(a.tolist(), b.tolist(), c.tolist())]
    got = P.fma64(a, b, c).tolist()
    bad = [(x, y, z) for x, y, z, g, w in zip(a.tolist(), b.tolist(), c.tolist(), got, want)
           if struct.pack("<d", g) != struct.pack("<d", w)]
    assert not bad, bad[:5]


def test_fma64_with_one_constant_operand_and_presplit_halves():
    rng = np.random.default_rng(31)
    a = torch.from_numpy(rng.uniform(-0.05, 0.05, 5000))
    for k, coef in enumerate(P._A):
        c = float(rng.uniform(-1, 1))
        got = P.fma64(a, coef, c, P._split(a), P._A_SPLIT[k]).tolist()
        assert got == [_exact_fma(x, coef, c) for x in a.tolist()]


def test_tables_match_their_definitions():
    for i, t in enumerate(P._EXP2_TAB):   # asuint64(2^(i/32)) - (i << 47)
        assert t == struct.unpack("<Q", struct.pack("<d", 2.0 ** (i / 32)))[0] - (i << 47)
    assert struct.unpack("<Q", struct.pack("<d", P._SHIFT))[0] == P._SHIFT_BITS
    assert P._SHIFT == 1.5 * 2.0 ** 52 / 32
    for i, (invc, logc) in enumerate(P._LOG2_TAB):
        # c = 1/invc lies in subinterval i of [0x3f330000, 2*0x3f330000)
        lo, hi = (struct.unpack("<f", struct.pack("<I", P._OFF + (j << 19)))[0]
                  for j in (i, i + 1))
        assert lo <= 1.0 / invc <= hi
        assert abs(logc - math.log2(1.0 / invc)) < 2e-16


def test_lanes_outside_the_branch_raise_nothing():
    """torch.where evaluates both branches: 0, subnormal, negative, inf and
    NaN lanes must neither raise nor disturb the lanes beside them."""
    good = np.float32([0.5, 0.25, 0.9])
    junk = np.float32([0.0, -0.0, 1e-45, -2.0, np.inf, np.nan, 1e-39])
    x = torch.from_numpy(np.concatenate([good, junk]))
    for e in (1.0 / 3.0, 1.0 / 2.4, 2.4):
        out = P.powf(x.abs(), e)
        np.testing.assert_array_equal(out[:3].numpy(), P.powf(torch.from_numpy(good), e).numpy())
        assert out[3] == 0 and out[4] == 0
    cb = _cbrt(x).numpy()
    assert cb[3] == 0 and np.signbit(cb[4]) and cb[6] < 0
    with pytest.raises(TypeError):
        P.powf(x.double(), 2.4)


@pytest.mark.cuda
def test_powf_on_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py compares the Lab conversion on the card)")
    x = torch.from_numpy(np.arange(_LO, _HI + 1, 97, dtype=np.uint32).view(np.float32))
    for e in (1.0 / 3.0, 1.0 / 2.4, 2.4):
        assert torch.equal(P.powf(x.cuda(), e).cpu(), P.powf(x, e))
