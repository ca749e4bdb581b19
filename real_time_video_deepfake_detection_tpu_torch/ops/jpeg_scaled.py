"""libjpeg-turbo's DCT-scaled reconstruction (scale_num/8), in int32 torch.

What `jpeg_start_decompress` does at `scale_num = M, scale_denom = 8` in
libjpeg-turbo 2.1.5 (JPEG_LIB_VERSION 62), the decode the JAX package's
native ingest (native/ingest.cpp:74-80) selects from a size hint:

- the output is ceil(W*M/8) x ceil(H*M/8) (jdmaster.c
  jpeg_core_output_dimensions);
- each component's IDCT size starts at M and doubles while the sampling
  ratio allows and it is below 8 (jdmaster.c), so 4:2:0 chroma at M = 4
  takes the 8x8 IDCT and at M = 6 the 12x12 one, and the upsampler sees a
  1:1 ratio (`component_sizes`);
- sizes 1, 2 and 4 are jidctred.c's reduced IDCTs (libjpeg 6b), sizes 3,
  5, 6, 7, 10, 12 and 14 jidctint.c's, 8 is jpeg_idct_islow; every one is
  the integer code as libjpeg writes it, through the range-limit table
  (`idct_scaled`);
- jdsample.c filters (h2v1, h2v2 "fancy") only when the smallest IDCT size
  is above 1; otherwise it replicates (ops/jpeg_decode.bgr_from_components).

Every routine reads an (..., 8, 8) block of dequantised int32 coefficients
(rows are vertical frequencies) and returns (..., K, K) samples in [0, 255].
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .jpeg import idct_islow

_CB = 13          # CONST_BITS
_P1 = 2           # PASS1_BITS


def _fix(x: float) -> int:
    return int(x * (1 << _CB) + 0.5)


def range_limit(v: torch.Tensor) -> torch.Tensor:
    """libjpeg's post-IDCT range-limit table indexed by v & RANGE_MASK
    (jdmaster.c prepare_range_limit_table): v + 128 clamped to [0, 255] for
    v in [-512, 511], wrapping beyond."""
    return torch.clamp(((v + 512) & 1023) - 512 + 128, 0, 255)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


# ------------------------------------------------ jidctred.c (libjpeg 6b)

_R_0_211164243 = 1730
_R_0_509795579 = 4176
_R_0_541196100 = 4433
_R_0_601344887 = 4926
_R_0_720959822 = 5906
_R_0_765366865 = 6270
_R_0_850430095 = 6967
_R_0_899976223 = 7373
_R_1_061594337 = 8697
_R_1_272758580 = 10426
_R_1_451774981 = 11893
_R_1_847759065 = 15137
_R_2_172734803 = 17799
_R_2_562915447 = 20995
_R_3_624509785 = 29692


def _red4(d: Sequence[torch.Tensor], p1: bool) -> List[torch.Tensor]:
    tmp0 = d[0] << (_CB + 1)
    tmp2 = d[2] * _R_1_847759065 + d[6] * (-_R_0_765366865)
    tmp10, tmp12 = tmp0 + tmp2, tmp0 - tmp2
    z1, z2, z3, z4 = d[7], d[5], d[3], d[1]
    tmp0 = (z1 * (-_R_0_211164243) + z2 * _R_1_451774981
            + z3 * (-_R_2_172734803) + z4 * _R_1_061594337)
    tmp2 = (z1 * (-_R_0_509795579) + z2 * (-_R_0_601344887)
            + z3 * _R_0_899976223 + z4 * _R_2_562915447)
    n = (_CB - _P1 + 1) if p1 else (_CB + _P1 + 3 + 1)
    return [_descale(tmp10 + tmp2, n), _descale(tmp12 + tmp0, n),
            _descale(tmp12 - tmp0, n), _descale(tmp10 - tmp2, n)]


def _red2(d: Sequence[torch.Tensor], p1: bool) -> List[torch.Tensor]:
    tmp10 = d[0] << (_CB + 2)
    tmp0 = (d[7] * (-_R_0_720959822) + d[5] * _R_0_850430095
            + d[3] * (-_R_1_272758580) + d[1] * _R_3_624509785)
    n = (_CB - _P1 + 2) if p1 else (_CB + _P1 + 3 + 2)
    return [_descale(tmp10 + tmp0, n), _descale(tmp10 - tmp0, n)]


# ------------------------------------------ jidctint.c (libjpeg 7 and on)
#
# Pass 1 puts the rounding into the DC term (ONE << (CONST_BITS-PASS1_BITS-1))
# and shifts by CONST_BITS-PASS1_BITS; pass 2 adds ONE << (PASS1_BITS+2) to
# the DC sample and shifts by CONST_BITS+PASS1_BITS+3. `_dc` and `_sh` give
# the two; a few outputs are formed pre-shifted, as the C code forms them.

def _dc(x, p1: bool):
    return (x << _CB) + (1 << (_CB - _P1 - 1)) if p1 else (x + (1 << (_P1 + 2))) << _CB


def _sh(p1: bool) -> int:
    return _CB - _P1 if p1 else _CB + _P1 + 3


def _int3(d, p1):
    tmp0 = _dc(d[0], p1)
    tmp12 = d[2] * _fix(0.707106781)
    tmp10 = tmp0 + tmp12
    tmp2 = tmp0 - tmp12 - tmp12
    tmp0 = d[1] * _fix(1.224744871)
    s = _sh(p1)
    return [(tmp10 + tmp0) >> s, tmp2 >> s, (tmp10 - tmp0) >> s]


def _int5(d, p1):
    tmp12 = _dc(d[0], p1)
    tmp0, tmp1 = d[2], d[4]
    z1 = (tmp0 + tmp1) * _fix(0.790569415)
    z2 = (tmp0 - tmp1) * _fix(0.353553391)
    z3 = tmp12 + z2
    tmp10, tmp11 = z3 + z1, z3 - z1
    tmp12 = tmp12 - (z2 << 2)
    z2, z3 = d[1], d[3]
    z1 = (z2 + z3) * _fix(0.831253876)
    tmp0 = z1 + z2 * _fix(0.513743148)
    tmp1 = z1 - z3 * _fix(2.176250899)
    s = _sh(p1)
    return [(tmp10 + tmp0) >> s, (tmp11 + tmp1) >> s, tmp12 >> s,
            (tmp11 - tmp1) >> s, (tmp10 - tmp0) >> s]


def _int6(d, p1):
    s = _sh(p1)
    tmp0 = _dc(d[0], p1)
    tmp10 = d[4] * _fix(0.707106781)
    tmp1 = tmp0 + tmp10
    tmp11 = tmp0 - tmp10 - tmp10
    if p1:
        tmp11 = tmp11 >> s
    tmp0 = d[2] * _fix(1.224744871)
    tmp10, tmp12 = tmp1 + tmp0, tmp1 - tmp0
    z1, z2, z3 = d[1], d[3], d[5]
    tmp1 = (z1 + z3) * _fix(0.366025404)
    tmp0 = tmp1 + ((z1 + z2) << _CB)
    tmp2 = tmp1 + ((z3 - z2) << _CB)
    tmp1 = (z1 - z2 - z3) << (_P1 if p1 else _CB)
    if p1:
        mid = [tmp11 + tmp1, tmp11 - tmp1]
    else:
        mid = [(tmp11 + tmp1) >> s, (tmp11 - tmp1) >> s]
    return [(tmp10 + tmp0) >> s, mid[0], (tmp12 + tmp2) >> s,
            (tmp12 - tmp2) >> s, mid[1], (tmp10 - tmp0) >> s]


def _int7(d, p1):
    tmp13 = _dc(d[0], p1)
    z1, z2, z3 = d[2], d[4], d[6]
    tmp10 = (z2 - z3) * _fix(0.881747734)
    tmp12 = (z1 - z2) * _fix(0.314692123)
    tmp11 = tmp10 + tmp12 + tmp13 - z2 * _fix(1.841218003)
    tmp0 = z1 + z3
    z2 = z2 - tmp0
    tmp0 = tmp0 * _fix(1.274162392) + tmp13
    tmp10 = tmp10 + tmp0 - z3 * _fix(0.077722536)
    tmp12 = tmp12 + tmp0 - z1 * _fix(2.470602249)
    tmp13 = tmp13 + z2 * _fix(1.414213562)
    z1, z2, z3 = d[1], d[3], d[5]
    tmp1 = (z1 + z2) * _fix(0.935414347)
    tmp2 = (z1 - z2) * _fix(0.170262339)
    tmp0 = tmp1 - tmp2
    tmp1 = tmp1 + tmp2
    tmp2 = (z2 + z3) * (-_fix(1.378756276))
    tmp1 = tmp1 + tmp2
    z2 = (z1 + z3) * _fix(0.613604268)
    tmp0 = tmp0 + z2
    tmp2 = tmp2 + z2 + z3 * _fix(1.870828693)
    s = _sh(p1)
    return [(tmp10 + tmp0) >> s, (tmp11 + tmp1) >> s, (tmp12 + tmp2) >> s,
            tmp13 >> s, (tmp12 - tmp2) >> s, (tmp11 - tmp1) >> s,
            (tmp10 - tmp0) >> s]


def _int10(d, p1):
    s = _sh(p1)
    z3 = _dc(d[0], p1)
    z4 = d[4]
    z1 = z4 * _fix(1.144122806)
    z2 = z4 * _fix(0.437016024)
    tmp10, tmp11 = z3 + z1, z3 - z2
    tmp22 = z3 - ((z1 - z2) << 1)
    if p1:
        tmp22 = tmp22 >> s
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _fix(0.831253876)
    tmp12 = z1 + z2 * _fix(0.513743148)
    tmp13 = z1 - z3 * _fix(2.176250899)
    tmp20, tmp24 = tmp10 + tmp12, tmp10 - tmp12
    tmp21, tmp23 = tmp11 + tmp13, tmp11 - tmp13
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    if not p1:
        z3 = z3 << _CB
    tmp11, tmp13 = z2 + z4, z2 - z4
    tmp12 = tmp13 * _fix(0.309016994)
    z5 = (z3 << _CB) if p1 else z3
    z2 = tmp11 * _fix(0.951056516)
    z4 = z5 + tmp12
    tmp10 = z1 * _fix(1.396802247) + z2 + z4
    tmp14 = z1 * _fix(0.221231742) - z2 + z4
    z2 = tmp11 * _fix(0.587785252)
    z4 = z5 - tmp12 - (tmp13 << (_CB - 1))
    if p1:
        tmp12 = (z1 - tmp13 - z3) << _P1
    else:
        tmp12 = ((z1 - tmp13) << _CB) - z3
    tmp11 = z1 * _fix(1.260073511) - z2 - z4
    tmp13 = z1 * _fix(0.642039522) - z2 + z4
    if p1:
        mid = [tmp22 + tmp12, tmp22 - tmp12]
    else:
        mid = [(tmp22 + tmp12) >> s, (tmp22 - tmp12) >> s]
    return [(tmp20 + tmp10) >> s, (tmp21 + tmp11) >> s, mid[0],
            (tmp23 + tmp13) >> s, (tmp24 + tmp14) >> s, (tmp24 - tmp14) >> s,
            (tmp23 - tmp13) >> s, mid[1], (tmp21 - tmp11) >> s,
            (tmp20 - tmp10) >> s]


def _int12(d, p1):
    z3 = _dc(d[0], p1)
    z4 = d[4] * _fix(1.224744871)
    tmp10, tmp11 = z3 + z4, z3 - z4
    z1 = d[2]
    z4 = z1 * _fix(1.366025404)
    z1 = z1 << _CB
    z2 = d[6] << _CB
    tmp12 = z1 - z2
    tmp21, tmp24 = z3 + tmp12, z3 - tmp12
    tmp12 = z4 + z2
    tmp20, tmp25 = tmp10 + tmp12, tmp10 - tmp12
    tmp12 = z4 - z1 - z2
    tmp22, tmp23 = tmp11 + tmp12, tmp11 - tmp12
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    tmp11 = z2 * _fix(1.306562965)
    tmp14 = z2 * (-_R_0_541196100)
    tmp10 = z1 + z3
    tmp15 = (tmp10 + z4) * _fix(0.860918669)
    tmp12 = tmp15 + tmp10 * _fix(0.261052384)
    tmp10 = tmp12 + tmp11 + z1 * _fix(0.280143716)
    tmp13 = (z3 + z4) * (-_fix(1.045510580))
    tmp12 = tmp12 + tmp13 + tmp14 - z3 * _fix(1.478575242)
    tmp13 = tmp13 + tmp15 - tmp11 + z4 * _fix(1.586706681)
    tmp15 = tmp15 + tmp14 - z1 * _fix(0.676326758) - z4 * _fix(1.982889723)
    z1 = z1 - z4
    z2 = z2 - z3
    z3 = (z1 + z2) * _R_0_541196100
    tmp11 = z3 + z1 * _R_0_765366865
    tmp14 = z3 - z2 * _R_1_847759065
    s = _sh(p1)
    return [(tmp20 + tmp10) >> s, (tmp21 + tmp11) >> s, (tmp22 + tmp12) >> s,
            (tmp23 + tmp13) >> s, (tmp24 + tmp14) >> s, (tmp25 + tmp15) >> s,
            (tmp25 - tmp15) >> s, (tmp24 - tmp14) >> s, (tmp23 - tmp13) >> s,
            (tmp22 - tmp12) >> s, (tmp21 - tmp11) >> s, (tmp20 - tmp10) >> s]


def _int14(d, p1):
    s = _sh(p1)
    z1 = _dc(d[0], p1)
    z4 = d[4]
    z2 = z4 * _fix(1.274162392)
    z3 = z4 * _fix(0.314692123)
    z4 = z4 * _fix(0.881747734)
    tmp10, tmp11, tmp12 = z1 + z2, z1 + z3, z1 - z4
    tmp23 = z1 - ((z2 + z3 - z4) << 1)
    if p1:
        tmp23 = tmp23 >> s
    z1, z2 = d[2], d[6]
    z3 = (z1 + z2) * _fix(1.105676686)
    tmp13 = z3 + z1 * _fix(0.273079590)
    tmp14 = z3 - z2 * _fix(1.719280954)
    tmp15 = z1 * _fix(0.613604268) - z2 * _fix(1.378756276)
    tmp20, tmp26 = tmp10 + tmp13, tmp10 - tmp13
    tmp21, tmp25 = tmp11 + tmp14, tmp11 - tmp14
    tmp22, tmp24 = tmp12 + tmp15, tmp12 - tmp15
    z1, z2, z3, z4 = d[1], d[3], d[5], d[7]
    z4s = z4 << _CB          # tmp13 in pass 1, z4 in pass 2
    tmp14 = z1 + z3
    tmp11 = (z1 + z2) * _fix(1.334852607)
    tmp12 = tmp14 * _fix(1.197448846)
    tmp10 = tmp11 + tmp12 + z4s - z1 * _fix(1.126980169)
    tmp14 = tmp14 * _fix(0.752406978)
    tmp16 = tmp14 - z1 * _fix(1.061150426)
    z1 = z1 - z2
    tmp15 = z1 * _fix(0.467085129) - z4s
    tmp16 = tmp16 + tmp15
    if p1:
        z1 = z1 + z4
    t = (z2 + z3) * (-_fix(0.158341681)) - z4s
    tmp11 = tmp11 + t - z2 * _fix(0.424103948)
    tmp12 = tmp12 + t - z3 * _fix(2.373959773)
    t = (z3 - z2) * _fix(1.405321284)
    tmp14 = tmp14 + t + z4s - z3 * _fix(1.6906431334)
    tmp15 = tmp15 + t + z2 * _fix(0.674957567)
    if p1:
        tmp13 = (z1 - z3) << _P1
        mid = [tmp23 + tmp13, tmp23 - tmp13]
    else:
        tmp13 = ((z1 - z3) << _CB) + z4s
        mid = [(tmp23 + tmp13) >> s, (tmp23 - tmp13) >> s]
    return [(tmp20 + tmp10) >> s, (tmp21 + tmp11) >> s, (tmp22 + tmp12) >> s,
            mid[0], (tmp24 + tmp14) >> s, (tmp25 + tmp15) >> s,
            (tmp26 + tmp16) >> s, (tmp26 - tmp16) >> s, (tmp25 - tmp15) >> s,
            (tmp24 - tmp14) >> s, mid[1], (tmp22 - tmp12) >> s,
            (tmp21 - tmp11) >> s, (tmp20 - tmp10) >> s]


# size -> (1-D routine, columns pass 1 reads); jidctint's sizes below 8
# read the first K columns, the larger ones and jidctred's all 8
_ROUTINES = {2: (_red2, 8), 3: (_int3, 3), 4: (_red4, 8), 5: (_int5, 5),
             6: (_int6, 6), 7: (_int7, 7), 10: (_int10, 8), 12: (_int12, 8),
             14: (_int14, 8)}


def idct_scaled(deq: torch.Tensor, size: int) -> torch.Tensor:
    """jpeg_idct_{size}x{size} over (..., 8, 8) dequantised int32
    coefficients -> (..., size, size) samples in [0, 255]."""
    x = deq.to(torch.int32)
    if size == 8:
        return range_limit(idct_islow(x))
    if size == 1:
        return range_limit(_descale(x[..., :1, :1], 3))
    fn, cols = _ROUTINES[size]
    ws = torch.stack(fn([x[..., u, :cols] for u in range(8)], True), dim=-2)
    if cols < 8:   # pass 2 reads no column past the ones pass 1 wrote
        ws = torch.nn.functional.pad(ws, (0, 8 - cols))
    out = torch.stack(fn([ws[..., v] for v in range(8)], False), dim=-1)
    return range_limit(out)


def component_sizes(factors: Sequence[Tuple[int, int]], m: int) -> List[int]:
    """Each component's IDCT size at scale m/8 (jdmaster.c): m, doubled
    while it is below 8 and the component's sampling leaves room for it on
    both axes."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    out = []
    for h, v in factors:
        s = m
        while s < 8 and (hmax * m) % (h * s * 2) == 0 and (vmax * m) % (v * s * 2) == 0:
            s *= 2
        out.append(s)
    return out


def scaled_dims(height: int, width: int, m: int) -> Tuple[int, int]:
    """The output size at scale m/8: ceil(H*m/8) x ceil(W*m/8)."""
    return -(-height * m // 8), -(-width * m // 8)


def pick_scale(height: int, width: int, hint: int) -> int:
    """The largest m in 1..8 whose output still covers `hint` on the larger
    side (native/ingest.cpp's loop; 8 when hint <= 0)."""
    if hint <= 0:
        return 8
    full = max(height, width)
    m = 8
    while m > 1 and (full * (m - 1)) // 8 >= hint:
        m -= 1
    return m
