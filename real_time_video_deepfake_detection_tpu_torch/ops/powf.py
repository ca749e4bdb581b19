"""glibc's powf, bit for bit, in float64 torch ops.

The JAX package's Lab conversion takes jnp.cbrt and jnp.power; XLA's CPU
backend lowers both to a call of the host's powf (the cube root as
powf(|t|, f32(1/3)) with t's sign), which on x86-64 glibc 2.36 is the FMA
build of sysdeps/ieee754/flt-32/e_powf.c (Arm's optimized-routines). powf
is not correctly rounded, so a correctly rounded power (torch.pow in float64,
rounded to f32) gives the other f32 on about 0.07% of inputs. `powf` here
runs glibc's algorithm step for step:

  log2_inline   x = 2^k z, z in [0x3f330000, 2*0x3f330000) as f32 bits;
                r = fma(z, invc, -1) with (invc, logc) from a 16-entry table;
                log2(x) = k + logc + a degree-5 polynomial in r
  ylogx         y * log2(x) in double
  exp2_inline   ylogx = k/32 + r, 2^(k/32) from a 32-entry table with k>>5
                added into the exponent bits; s * (C0 r^3 + C1 r^2 + C2 r + 1)
  result        the double rounded once to f32

Each `a*b + c` that GCC contracted into a vfmadd in that build (read from
the disassembly of libm.so.6's powf FMA variant) is an exact emulated FMA
(`fma64`), every other operation a plain float64 op, in the same order;
a fast pass with the contractions unfused settles all but the lanes near
an f32 rounding midpoint, which the exact chain redoes (`powf`). The
tables and coefficients are the values that build loads, copied from
sysdeps/ieee754/flt-32/powf_log2_data.c (__powf_log2_data) and
e_exp2f_data.c (__exp2f_data) as hex floats. The code has no branch by
device: the same tensor ops run on a CPU or a CUDA tensor.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

Num = Union[torch.Tensor, float]
_h = float.fromhex   # C99 hex-float literals, as the glibc sources write them

# ------------------------------------------------ exact float64 fused multiply-add
_SPLITTER = 134217729.0   # 2^27 + 1 (Veltkamp)


def _split(a: Num) -> Tuple[Num, Num]:
    """a = hi + lo exactly, each with at most 26 significant bits (Veltkamp;
    exact for |a| < 2^996)."""
    t = a * _SPLITTER
    hi = t - (t - a)
    return hi, a - hi


def _two_sum(a: Num, b: Num) -> Tuple[Num, Num]:
    """s + e == a + b exactly, s = fl(a + b) (Knuth; no condition on the
    magnitudes)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_to_odd(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The double nearest v + w with an odd last bit, for v = fl(v + w):
    when w != 0 and v's significand is even, step v one unit toward w.
    (w != 0 implies v != 0: a sum that rounds to zero is exact.)"""
    bits = v.view(torch.int64)
    toward = (torch.sign(v) * torch.sign(w)).to(torch.int64)   # +1 away from 0, -1 toward
    return (bits + toward * (1 - (bits & 1))).view(torch.float64)


def fma64(a: Num, b: Num, c: Num, a_split=None, b_split=None) -> torch.Tensor:
    """a*b + c rounded once to float64, from float64 tensor ops.

    a*b = uh + ul exactly (Dekker's product over Veltkamp halves), then
    c + uh = th + tl exactly (two-sum), v = tl + ul rounded to odd, and the
    result th + v rounded to nearest. Boldo and Melquiond proved this equal
    to the correctly rounded a*b + c in binary64 ("Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd", IEEE
    Trans. Computers 57(4), 2008), provided nothing overflows and the
    product's low part does not underflow: the operands' exponents must sum
    above -969 and the splits need |a|, |b| < 2^996. Every call in `powf`
    stays far inside that on the inputs it serves (|r| >= 2^-77 or 0,
    |ylogx| < 150). `a_split`/`b_split` pass halves computed once."""
    ah, al = a_split if a_split is not None else _split(a)
    bh, bl = b_split if b_split is not None else _split(b)
    uh = a * b
    ul = al * bl - (((uh - ah * bh) - al * bh) - ah * bl)
    th, tl = _two_sum(c, uh)
    v, w = _two_sum(tl, ul)
    return th + _round_to_odd(v, w)


# ---------------------------------------------------------------- the tables
# __powf_log2_data.tab: (invc, logc) for 16 subintervals of [0x3f330000,
# 2*0x3f330000) as f32 bits; invc ~ 1/c, logc ~ log2(c) for c near the centre
_LOG2_TAB = (
    (_h("0x1.661ec79f8f3bep+0"), -_h("0x1.efec65b963019p-2")),
    (_h("0x1.571ed4aaf883dp+0"), -_h("0x1.b0b6832d4fca4p-2")),
    (_h("0x1.49539f0f010b0p+0"), -_h("0x1.7418b0a1fb77bp-2")),
    (_h("0x1.3c995b0b80385p+0"), -_h("0x1.39de91a6dcf7bp-2")),
    (_h("0x1.30d190c8864a5p+0"), -_h("0x1.01d9bf3f2b631p-2")),
    (_h("0x1.25e227b0b8ea0p+0"), -_h("0x1.97c1d1b3b7af0p-3")),
    (_h("0x1.1bb4a4a1a343fp+0"), -_h("0x1.2f9e393af3c9fp-3")),
    (_h("0x1.12358f08ae5bap+0"), -_h("0x1.960cbbf788d5cp-4")),
    (_h("0x1.0953f419900a7p+0"), -_h("0x1.a6f9db6475fcep-5")),
    (_h("0x1.0000000000000p+0"), _h("0x0.0p+0")),
    (_h("0x1.e608cfd9a47acp-1"), _h("0x1.338ca9f24f53dp-4")),
    (_h("0x1.ca4b31f026aa0p-1"), _h("0x1.476a9543891bap-3")),
    (_h("0x1.b2036576afce6p-1"), _h("0x1.e840b4ac4e4d2p-3")),
    (_h("0x1.9c2d163a1aa2dp-1"), _h("0x1.40645f0c6651cp-2")),
    (_h("0x1.886e6037841edp-1"), _h("0x1.88e9c2c1b9ff8p-2")),
    (_h("0x1.767dcf5534862p-1"), _h("0x1.ce0a44eb17bccp-2")),
)
# __powf_log2_data.poly: log1p(r)/ln2 ~ A0 r^5 + A1 r^4 + A2 r^3 + A3 r^2 + A4 r
_A = (_h("0x1.27616c9496e0bp-2"), -_h("0x1.71969a075c67ap-2"), _h("0x1.ec70a6ca7baddp-2"),
      -_h("0x1.7154748bef6c8p-1"), _h("0x1.71547652ab82bp+0"))
# __exp2f_data.tab: T[i] = asuint64(2^(i/32)) - (i << 47)
_EXP2_TAB = (
    0x3ff0000000000000, 0x3fefd9b0d3158574, 0x3fefb5586cf9890f, 0x3fef9301d0125b51,
    0x3fef72b83c7d517b, 0x3fef54873168b9aa, 0x3fef387a6e756238, 0x3fef1e9df51fdee1,
    0x3fef06fe0a31b715, 0x3feef1a7373aa9cb, 0x3feedea64c123422, 0x3feece086061892d,
    0x3feebfdad5362a27, 0x3feeb42b569d4f82, 0x3feeab07dd485429, 0x3feea47eb03a5585,
    0x3feea09e667f3bcd, 0x3fee9f75e8ec5f74, 0x3feea11473eb0187, 0x3feea589994cce13,
    0x3feeace5422aa0db, 0x3feeb737b0cdc5e5, 0x3feec49182a3f090, 0x3feed503b23e255d,
    0x3feee89f995ad3ad, 0x3feeff76f2fb5e47, 0x3fef199bdd85529c, 0x3fef3720dcef9069,
    0x3fef5818dcfba487, 0x3fef7c97337b9b5f, 0x3fefa4afa2a490da, 0x3fefd0765b6e4540,
)
_SHIFT = _h("0x1.8p+47")          # __exp2f_data.shift_scaled = 0x1.8p52 / 32
_SHIFT_BITS = 0x42e8000000000000   # asuint64(_SHIFT)
# __exp2f_data.poly: 2^r ~ C0 r^3 + C1 r^2 + C2 r + 1
_C = (_h("0x1.c6af84b912394p-5"), _h("0x1.ebfce50fac4f3p-3"), _h("0x1.62e42ff0c52d6p-1"))
_OFF = 0x3f330000
_OFLOW = _h("0x1.fffffffd1d571p+6")   # ylogx above it: |x^y| > 0x1.ffffffp127
_A_SPLIT = tuple(_split(a) for a in _A)
_C_SPLIT = tuple(_split(c) for c in _C)

_device_tables: Dict[str, Tuple[torch.Tensor, ...]] = {}


def _tables(device) -> Tuple[torch.Tensor, ...]:
    key = str(device)
    if key not in _device_tables:
        invc = torch.tensor([t[0] for t in _LOG2_TAB], dtype=torch.float64)
        hi, lo = _split(invc)
        logc = torch.tensor([t[1] for t in _LOG2_TAB], dtype=torch.float64)
        exp2 = torch.tensor(_EXP2_TAB, dtype=torch.int64)
        _device_tables[key] = tuple(t.to(device) for t in (invc, hi, lo, logc, exp2))
    return _device_tables[key]


def _fma_unfused(a: Num, b: Num, c: Num, a_split=None, b_split=None) -> torch.Tensor:
    """a*b + c with two roundings (the fast pass's stand-in for an FMA)."""
    return a * b + c


def _chain(ix: torch.Tensor, yd: float, exact: bool, tabs) -> Tuple[torch.Tensor, ...]:
    """glibc's log2_inline and exp2_inline on f32 bit patterns `ix` (int64,
    normal or already normalized), each contraction an exact FMA or, when
    not `exact`, unfused. Returns ylogx, the exp2 reduction r (|r| <= 1/64)
    and the double that powf rounds to f32.

    glibc's uint32 steps are taken on signed int64: for ix of a positive
    normal f32 (or a normalized subnormal one), ix - OFF lies in int32's
    range, so its arithmetic shift and mask give C's (tmp >> 19) % 16,
    (int32_t)(tmp & 0xff800000) and ix - top."""
    invc_t, invc_hi, invc_lo, logc_t, exp2_t = tabs
    fma = fma64 if exact else _fma_unfused
    # log2_inline: x = 2^k z, (invc, logc) of z's subinterval
    tmp = ix - _OFF
    i = (tmp >> 19) & 15
    top = tmp & -(1 << 23)
    z = (ix - top).to(torch.int32).view(torch.float32).to(torch.float64)
    r = fma(z, invc_t.index_select(0, i), -1.0,
            b_split=(invc_hi.index_select(0, i), invc_lo.index_select(0, i)) if exact else None)
    y0 = logc_t.index_select(0, i) + (top >> 23).to(torch.float64)
    rs = _split(r) if exact else None
    r2 = r * r
    p1 = fma(r, _A[0], _A[1], rs, _A_SPLIT[0])
    p2 = fma(r, _A[2], _A[3], rs, _A_SPLIT[2])
    r4 = r2 * r2
    q = fma(r, _A[4], y0, rs, _A_SPLIT[4])
    q = fma(r2, p2, q)
    ylogx = yd * fma(p1, r4, q)

    # exp2_inline, on lanes inside the range glibc computes (others clamped:
    # their result is replaced by _round_f32's)
    xd = ylogx.clamp(-149.0, _OFLOW).nan_to_num()
    kd = xd + _SHIFT
    kbits = kd.view(torch.int64) - _SHIFT_BITS     # k, with ylogx = k/32 + r
    kd = kd - _SHIFT
    r = xd - kd
    s = (exp2_t.index_select(0, kbits & 31) + kbits * (1 << 47)).view(torch.float64)
    rs = _split(r) if exact else None
    p = fma(r, _C[0], _C[1], rs, _C_SPLIT[0])
    r2 = r * r
    q = fma(r, _C[2], 1.0, rs, _C_SPLIT[2])
    return ylogx, r, fma(p, r2, q) * s


def _round_f32(ylogx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """powf's result: the double rounded to f32, and glibc's special
    results in round-to-nearest: overflow to inf; below 2^-150 to 0;
    between 2^-150 and 2^-149 the least subnormal."""
    out = y.to(torch.float32)
    out = torch.where(ylogx > _OFLOW, float("inf"), out)
    out = torch.where(ylogx < -149.0, 2.0 ** -149, out)
    return torch.where(ylogx <= -150.0, 0.0, out)


def _bits(xf: torch.Tensor) -> torch.Tensor:
    """powf's ix of flat float32 `xf`, as int64; a subnormal x is scaled by
    2^23 to a normal one and 23 taken from its exponent field, which then
    goes negative."""
    ix = xf.view(torch.int32).to(torch.int64)
    sub = (xf * 8388608.0).view(torch.int32).to(torch.int64) & 0x7FFFFFFF
    return torch.where(ix < 0x00800000, sub - (23 << 23), ix)


# Lanes the fast pass hands to the exact one: a double within this many
# units in the last place of an f32 rounding midpoint (>= 2^-37 relative)
_MIDPOINT_ULPS = 1 << 16


def powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """glibc 2.36's powf(x, f32(y)) for float32 x >= 0, bit for bit, with y
    a nonzero finite exponent (rounded to f32 as powf's argument is).
    Subnormal x, 0, overflow and underflow follow glibc in round-to-nearest;
    negative or non-finite x give an unspecified value and raise nothing, so
    callers may pass the lanes of a torch.where branch they do not take.

    Two passes. The fast one runs glibc's chain with every contraction
    unfused (a*b + c, two roundings). Its lanes take the same table entries
    and, in exp2, the same k as glibc's, unless ylogx lies at a rounding
    boundary of the 1/32 grid (|r| within 2^-40 of 1/64). Otherwise each
    unfused contraction moves its result by one rounding, which moves
    ylogx by a few units in its last place (< 2^-44 for |ylogx| < 125)
    and the double result by less than 2^-43 relative, 2^9 units in its
    last place (tests/test_torch_powf.py holds it within 2^8 units on the
    Lab ranges and for |ylogx| up to 125). So its f32 rounding is glibc's
    unless the double lies within that of an f32 rounding midpoint. The
    lanes within 2^16 units of one (under 1 in 1,000 of the Lab range), the
    k-boundary lanes and the lanes with |ylogx| >= 125 or NaN (subnormal
    results, overflow, underflow) go through the exact pass: the same
    chain with `fma64`. The exact pass gathers its lanes with a boolean
    mask, which on a CUDA tensor waits for the device."""
    if x.dtype != torch.float32:
        raise TypeError(f"powf takes float32, got {x.dtype}")
    yd = float(np.float32(y))
    if not (np.isfinite(yd) and yd != 0.0):
        raise ValueError(f"powf exponent must be finite and nonzero, got {y}")
    tabs = _tables(x.device)
    xf = x.reshape(-1)
    ix = _bits(xf)
    ylogx, r, yv = _chain(ix, yd, False, tabs)
    out = yv.to(torch.float32)
    low = yv.view(torch.int64) & ((1 << 29) - 1)     # the bits f32 rounding drops
    redo = (((low - (1 << 28)).abs() < _MIDPOINT_ULPS)
            | (r.abs() > 2.0 ** -6 - 2.0 ** -40)
            | ~(ylogx.abs() < 125.0))
    idx = redo.nonzero().squeeze(1)
    if idx.numel():
        ylogx_e, _, y_e = _chain(ix[idx], yd, True, tabs)
        out = out.index_put((idx,), _round_f32(ylogx_e, y_e))
    return torch.where(xf == 0, 0.0 if yd > 0 else float("inf"), out).view(x.shape)
