"""Hand-built H.264 Constrained Baseline streams for the decoder's tests: a
writer of the syntax (SPS, PPS, slice headers, CAVLC macroblocks that carry
no coefficients), not an encoder.

`random_stream` draws pictures from a seed. Each picture is split into one
to three slices. Each macroblock is I_PCM, Intra 16x16 with no
coefficients, P_Skip or a P partition (16x16, 16x8, 8x16, 8x8 with every
sub-partition, 8x8ref0) with its own ref_idx and motion vector. The slice
headers use what x264 never writes: reference list modification (idc 0, 1
and 2), adaptive marking with MMCO 1-6, long-term references (IDR
long_term_reference_flag and MMCO 3 / 6), non-reference P pictures and POC
types 0, 1 and 2. A model of the decoded picture buffer (H.264 8.2.4 and
8.2.5, frames only) keeps every stream valid: each list command names a
reference, each ref_idx falls in the list, the references never exceed
max_num_ref_frames, and frame_num has no gaps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


class BitWriter:
    """MSB-first bits of an RBSP."""

    def __init__(self):
        self.bits: List[int] = []

    def u(self, n: int, v: int) -> None:
        self.bits.extend((v >> (n - 1 - i)) & 1 for i in range(n))

    def ue(self, v: int) -> None:
        n = (v + 1).bit_length()
        self.u(n - 1, 0)
        self.u(n, v + 1)

    def se(self, v: int) -> None:
        self.ue(2 * v - 1 if v > 0 else -2 * v)

    def te(self, v: int, cmax: int) -> None:
        if cmax == 1:
            self.u(1, 1 - v)
        else:
            self.ue(v)

    def code(self, code: str) -> None:
        self.bits.extend(int(c) for c in code)

    def align(self) -> None:
        self.bits.extend([0] * (-len(self.bits) % 8))

    def raw(self, data: bytes) -> None:
        self.bits.extend(np.unpackbits(np.frombuffer(data, np.uint8)).tolist())

    def rbsp(self) -> bytes:
        """The bits with rbsp_trailing_bits."""
        bits = self.bits + [1]
        bits += [0] * (-len(bits) % 8)
        return np.packbits(np.array(bits, np.uint8)).tobytes()


class BitReader:
    """MSB-first bits of a NAL unit's payload, emulation prevention removed."""

    def __init__(self, data: bytes):
        rbsp, zeros = bytearray(), 0
        for b in data:
            if zeros >= 2 and b == 3:
                zeros = 0
                continue
            zeros = zeros + 1 if b == 0 else 0
            rbsp.append(b)
        self.bits = np.unpackbits(np.frombuffer(bytes(rbsp), np.uint8))
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while not self.u(1):
            zeros += 1
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


def escape(rbsp: bytes) -> bytes:
    """Emulation prevention: 00 00 0x (x <= 3) becomes 00 00 03 0x."""
    out, zeros = bytearray(), 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(ref_idc: int, nal_type: int, rbsp: bytes) -> bytes:
    return bytes([(ref_idc << 5) | nal_type]) + escape(rbsp)


# frame_num wraps at 16 within a stream
LOG2_MAX_FRAME_NUM, LOG2_MAX_POC_LSB = 4, 6
# POC type 1: a reference picture's POC steps 2, 4, 2, 4...; a non-reference
# one sits one past the reference before it (output order stays decode order)
POC_CYCLE, OFFSET_FOR_NON_REF_PIC = (2, 4), 1
PIC_INIT_QP = 30


@dataclasses.dataclass
class Params:
    """The SPS and PPS of a stream."""
    mbw: int = 8
    mbh: int = 5
    num_ref_frames: int = 4
    poc_type: int = 2
    num_ref_idx_default: int = 1
    chroma_qp_offset: int = 0


def sps_nal(p: Params) -> bytes:
    w = BitWriter()
    w.u(8, 66)
    w.u(8, 0xC0)   # constraint_set0 and 1: Constrained Baseline
    w.u(8, 30)
    w.ue(0)         # seq_parameter_set_id
    w.ue(LOG2_MAX_FRAME_NUM - 4)
    w.ue(p.poc_type)
    if p.poc_type == 0:
        w.ue(LOG2_MAX_POC_LSB - 4)
    elif p.poc_type == 1:
        w.u(1, 0)   # delta_pic_order_always_zero
        w.se(OFFSET_FOR_NON_REF_PIC)
        w.se(0)     # offset_for_top_to_bottom_field
        w.ue(len(POC_CYCLE))
        for v in POC_CYCLE:
            w.se(v)
    w.ue(p.num_ref_frames)
    w.u(1, 0)       # gaps_in_frame_num_value_allowed
    w.ue(p.mbw - 1)
    w.ue(p.mbh - 1)
    w.u(1, 1)       # frame_mbs_only
    w.u(1, 1)       # direct_8x8_inference
    w.u(1, 0)       # frame_cropping
    w.u(1, 0)       # vui_parameters_present
    return nal(3, 7, w.rbsp())


def pps_nal(p: Params) -> bytes:
    w = BitWriter()
    w.ue(0)         # pic_parameter_set_id
    w.ue(0)
    w.u(1, 0)       # CAVLC
    w.u(1, 0)       # bottom_field_pic_order_in_frame_present
    w.ue(0)         # one slice group
    w.ue(p.num_ref_idx_default - 1)
    w.ue(0)
    w.u(1, 0)       # weighted_pred
    w.u(2, 0)
    w.se(PIC_INIT_QP - 26)
    w.se(0)
    w.se(p.chroma_qp_offset)
    w.u(1, 1)       # deblocking_filter_control_present
    w.u(1, 0)       # constrained_intra_pred
    w.u(1, 0)       # redundant_pic_cnt_present
    return nal(3, 8, w.rbsp())


# ------------------------------------------------------- the picture buffer

@dataclasses.dataclass
class _Ref:
    fn: int
    long: bool = False
    lti: int = 0
    picnum: int = 0     # FrameNumWrap of a short-term reference
    poc: int = 0


@dataclasses.dataclass
class Stats:
    """What a stream exercised."""
    mmco: Dict[int, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(range(1, 7), 0))
    modification: Dict[int, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(range(3), 0))
    idr_long_term: int = 0
    long_term_predictions: int = 0   # partitions predicted from a long-term reference
    reordered_predictions: int = 0   # from an entry a modification moved
    pcm: int = 0
    i16: int = 0
    skip: int = 0
    partitions: Dict[str, int] = dataclasses.field(default_factory=dict)
    non_ref: int = 0
    pictures: int = 0


class _Dpb:
    def __init__(self, p: Params):
        self.p = p
        self.maxfn = 1 << LOG2_MAX_FRAME_NUM
        self.refs: List[_Ref] = []
        self.max_lti = -1
        self.prev_ref_fn = 0

    def lists(self, fn: int) -> List[_Ref]:
        """The initial P list at frame_num fn: short-term by PicNum down,
        then long-term by LongTermPicNum up."""
        for r in self.refs:
            if not r.long:
                r.picnum = r.fn - self.maxfn if r.fn > fn else r.fn
        shorts = sorted((r for r in self.refs if not r.long), key=lambda r: -r.picnum)
        longs = sorted((r for r in self.refs if r.long), key=lambda r: r.lti)
        return shorts + longs


def _modify(rng, dpb: _Dpb, init: List[_Ref], n_active: int, fn: int, stats: Stats):
    """Random modification commands for a list of n_active entries: the
    commands and the list they give."""
    lst: List[Optional[_Ref]] = init[:n_active] + [None]
    cmds = []
    pred = fn
    maxpic = dpb.maxfn
    for idx in range(int(rng.integers(1, n_active + 1))):
        target = dpb.refs[int(rng.integers(len(dpb.refs)))]
        if target.long:
            cmds.append((2, target.lti))
        else:
            nowrap = target.picnum % maxpic
            if rng.random() < 0.5:
                diff = (pred - nowrap) % maxpic or maxpic
                cmds.append((0, diff - 1))
            else:
                diff = (nowrap - pred) % maxpic or maxpic
                cmds.append((1, diff - 1))
            pred = nowrap
        stats.modification[cmds[-1][0]] += 1
        lst = lst[:idx] + [target] + lst[idx:]
        lst = lst[:idx + 1] + [r for r in lst[idx + 1:] if r is not target]
        lst = (lst + [None])[:n_active + 1]
    return cmds, lst[:n_active]


def _marking(rng, dpb: _Dpb, fn: int, stats: Stats, allow_reset: bool = True):
    """The adaptive marking ops of a non-IDR reference picture (None for
    the sliding window), applied to the model; MMCO 5 only with
    allow_reset."""
    p = dpb.p
    shorts = [r for r in dpb.refs if not r.long]
    longs = [r for r in dpb.refs if r.long]
    # a short-term frame whose frame_num the next picture takes must go
    stale = [r for r in shorts if r.fn == (fn + 1) % dpb.maxfn]
    full = len(dpb.refs) >= max(p.num_ref_frames, 1)
    if not stale and rng.random() < 0.5 and (not full or shorts):
        if full:
            oldest = min(shorts, key=lambda r: r.picnum)
            dpb.refs.remove(oldest)
        dpb.refs.append(_Ref(fn))
        return None
    if allow_reset and rng.random() < 0.1:
        dpb.refs = [_Ref(0)]
        dpb.max_lti = -1
        stats.mmco[5] += 1
        return [(5,)]
    ops = []

    def unmark(r):
        dpb.refs.remove(r)
        if r.long:
            ops.append((2, r.lti))
        else:
            ops.append((1, fn - r.picnum - 1))

    for r in stale:
        unmark(r)
    to_long = False
    for _ in range(int(rng.integers(0, 4))):
        shorts = [r for r in dpb.refs if not r.long]
        longs = [r for r in dpb.refs if r.long]
        kinds = [1] * bool(shorts) + [2] * bool(longs) + [3] * bool(shorts and dpb.max_lti >= 0)
        kinds += [4] * all(op[0] != 4 for op in ops) + [6] * (not to_long)
        if not kinds:
            break
        k = kinds[int(rng.integers(len(kinds)))]
        if k in (1, 2):
            unmark((shorts if k == 1 else longs)[int(rng.integers(len(shorts if k == 1 else longs)))])
        elif k == 3:
            r = shorts[int(rng.integers(len(shorts)))]
            idx = int(rng.integers(dpb.max_lti + 1))
            for o in [o for o in dpb.refs if o.long and o.lti == idx]:
                dpb.refs.remove(o)
            ops.append((3, fn - r.picnum - 1, idx))
            r.long, r.lti = True, idx
        elif k == 4:
            # mostly a bound that unmarks the highest long-term index
            top = max(r.lti for r in longs) if longs and rng.random() < 0.7 else p.num_ref_frames
            plus1 = int(rng.integers(0, top + 1))
            dpb.max_lti = plus1 - 1
            dpb.refs = [r for r in dpb.refs if not (r.long and r.lti > dpb.max_lti)]
            ops.append((4, plus1))
        else:
            to_long = True
    lti = None
    if to_long and dpb.max_lti < 0 and all(op[0] != 4 for op in ops):
        dpb.max_lti = p.num_ref_frames - 1   # MMCO 4 first, so that there is an index
        ops.append((4, p.num_ref_frames))
    if to_long and dpb.max_lti >= 0:
        lti = int(rng.integers(dpb.max_lti + 1))
        for o in [o for o in dpb.refs if o.long and o.lti == lti]:
            dpb.refs.remove(o)
    while len(dpb.refs) + 1 > max(p.num_ref_frames, 1):
        unmark(dpb.refs[int(rng.integers(len(dpb.refs)))])
    if lti is not None:
        ops.append((6, lti))
        dpb.refs.append(_Ref(fn, True, lti))
    else:
        dpb.refs.append(_Ref(fn))
    for op in ops:
        stats.mmco[op[0]] += 1
    return ops


# --------------------------------------------------------------- macroblocks

def _coeff_token_zero(n_c: int) -> str:
    """coeff_token of TotalCoeff 0, TrailingOnes 0 in the table of nC."""
    return "1" if n_c < 2 else "11" if n_c < 4 else "1111" if n_c < 8 else "000011"


class _Picture:
    def __init__(self, p: Params):
        self.p = p
        self.kind = [""] * (p.mbw * p.mbh)   # "pcm", "i16", "skip", "p"
        self.slice_of = [-1] * (p.mbw * p.mbh)


def _mb(rng, w: BitWriter, pic: _Picture, addr: int, slice_id: int, p_slice: bool,
        refs: List[_Ref], moved: set, qp: List[int], stats: Stats) -> str:
    """One coded (not skipped) macroblock; returns its kind."""
    p = pic.p
    x, y = addr % p.mbw, addr // p.mbw

    def avail(dx, dy):
        xx, yy = x + dx, y + dy
        return 0 <= xx < p.mbw and 0 <= yy < p.mbh and pic.slice_of[yy * p.mbw + xx] == slice_id

    r = rng.random()
    if not p_slice or r < 0.3:
        if rng.random() < 0.5:
            w.ue(25 + 5 * p_slice)
            w.align()
            w.raw(rng.integers(0, 256, 384, dtype=np.uint8).tobytes())
            stats.pcm += 1
            return "pcm"
        left, top, corner = avail(-1, 0), avail(0, -1), avail(-1, -1)
        modes = [2] + [0] * top + [1] * left + [3] * (left and top and corner)
        mode = modes[int(rng.integers(len(modes)))]
        cmodes = [0] + [1] * left + [2] * top + [3] * (left and top and corner)
        w.ue(1 + mode + 5 * p_slice)
        w.ue(cmodes[int(rng.integers(len(cmodes)))])
        d = int(rng.integers(-3, 4)) if rng.random() < 0.3 else 0
        d = max(min(d, 51 - qp[0]), -qp[0])
        qp[0] += d
        w.se(d)
        # the DC block's nC: I_PCM neighbours count 16, every other 0
        n = [16 if pic.kind[(y + dy) * p.mbw + x + dx] == "pcm" else 0
             for dx, dy in ((-1, 0), (0, -1)) if avail(dx, dy)]
        n_c = (n[0] + n[1] + 1) >> 1 if len(n) == 2 else (n[0] if n else 0)
        for c in _coeff_token_zero(n_c):
            w.u(1, int(c))
        stats.i16 += 1
        return "i16"
    n_active = len(refs)
    kinds = ["16x16", "16x8", "8x16", "8x8"] + ["8x8ref0"] * (n_active > 1)
    shape = kinds[int(rng.integers(len(kinds)))]
    stats.partitions[shape] = stats.partitions.get(shape, 0) + 1
    w.ue(kinds.index(shape))
    nparts = {"16x16": 1, "16x8": 2, "8x16": 2}.get(shape, 4)

    def mvd():
        if rng.random() < 0.3:
            return 0
        if rng.random() < 0.04:
            return int(rng.choice([-1, 1]) * rng.integers(200, 700))
        return int(rng.integers(-24, 25))

    subs = [int(rng.integers(4)) for _ in range(4)] if nparts == 4 else []
    for s in subs:
        w.ue(s)
    idxs = [0 if shape == "8x8ref0" else int(rng.integers(n_active)) for _ in range(nparts)]
    if shape != "8x8ref0" and n_active > 1:
        for i in idxs:
            w.te(i, n_active - 1)
    for i in idxs:
        stats.long_term_predictions += refs[i].long
        stats.reordered_predictions += i in moved
    for k in range(nparts):
        for _ in range({0: 1, 1: 2, 2: 2, 3: 4}[subs[k]] if subs else 1):
            w.se(mvd())
            w.se(mvd())
    w.ue(0)   # coded_block_pattern 0: no residual, no mb_qp_delta
    return "p"


# ------------------------------------------------------------------ streams

def random_stream(seed: int, p: Params, n_pictures: int = 48
                  ) -> Tuple[List[bytes], List[List[bytes]], Stats]:
    """(the SPS and PPS, each picture's NAL units, what was exercised)."""
    rng = np.random.default_rng(seed)
    dpb = _Dpb(p)
    stats = Stats()
    pictures = []
    prev_non_ref = False
    poc = 0
    n_mb = p.mbw * p.mbh
    for k in range(n_pictures):
        idr = k == 0 or rng.random() < 0.04
        ref_idc = 1 if idr or prev_non_ref or rng.random() >= 0.2 else 0
        prev_non_ref = not ref_idc
        stats.non_ref += not ref_idc
        fn = 0 if idr else (dpb.prev_ref_fn + 1) % dpb.maxfn
        poc = 0 if idr else poc + 2
        init = [] if idr else dpb.lists(fn)
        # marking first in the model, for the header; the lists use `init`
        refs_before = list(dpb.refs)
        marking, long_term_flag, mmco5 = None, False, False
        if idr:
            long_term_flag = bool(rng.random() < 0.4)
            stats.idr_long_term += long_term_flag
            dpb.refs = [_Ref(0, long_term_flag, 0)]
            dpb.max_lti = 0 if long_term_flag else -1
        elif ref_idc:
            dpb.refs = [dataclasses.replace(r) for r in refs_before]
            marking = _marking(rng, dpb, fn, stats)
            mmco5 = bool(marking) and marking[0][0] == 5
        bounds = sorted(set(int(v) for v in rng.integers(1, n_mb, int(rng.integers(0, 3)))))
        starts = [0] + bounds
        ends = bounds + [n_mb]
        pic = _Picture(p)
        nals = []
        kinds = [not idr and rng.random() >= 0.1 for _ in starts]
        fixed = len(set(kinds)) == 1 and rng.random() < 0.5   # slice_type 5-9
        for sid, (first, end, p_slice) in enumerate(zip(starts, ends, kinds)):
            w = BitWriter()
            w.ue(first)
            w.ue((0 if p_slice else 2) + 5 * fixed)
            w.ue(0)
            w.u(LOG2_MAX_FRAME_NUM, fn)
            if idr:
                w.ue(k % 7)
            if p.poc_type == 0:
                w.u(LOG2_MAX_POC_LSB, poc % (1 << LOG2_MAX_POC_LSB))
            elif p.poc_type == 1:
                w.se(0)   # delta_pic_order_cnt[0]
            slice_refs, moved = [], set()
            if p_slice:
                # the model's references before this picture's marking
                saved, dpb.refs = dpb.refs, refs_before
                n_active = int(rng.integers(1, min(len(init), 16) + 1))
                w.u(1, int(n_active != p.num_ref_idx_default))
                if n_active != p.num_ref_idx_default:
                    w.ue(n_active - 1)
                if rng.random() < 0.5:
                    cmds, slice_refs = _modify(rng, dpb, init, n_active, fn, stats)
                    moved = {i for i, r in enumerate(slice_refs) if r is not init[i]}
                    w.u(1, 1)
                    for op, v in cmds:
                        w.ue(op)
                        w.ue(v)
                    w.ue(3)
                else:
                    slice_refs = init[:n_active]
                    w.u(1, 0)
                dpb.refs = saved
            if ref_idc:
                if idr:
                    w.u(1, 0)
                    w.u(1, int(long_term_flag))
                elif marking is None:
                    w.u(1, 0)
                else:
                    w.u(1, 1)
                    for op in marking:
                        w.ue(op[0])
                        for v in op[1:]:
                            w.ue(v)
                    w.ue(0)
            qp = [int(rng.integers(16, 46))]
            w.se(qp[0] - PIC_INIT_QP)
            idc = int(rng.choice([0, 0, 0, 1, 2]))
            w.ue(idc)
            if idc != 1:
                w.se(int(rng.integers(-6, 7)))
                w.se(int(rng.integers(-6, 7)))
            run = 0
            for addr in range(first, end):
                pic.slice_of[addr] = sid
                if p_slice and rng.random() < 0.35:
                    run += 1
                    pic.kind[addr] = "skip"
                    stats.skip += 1
                    continue
                if p_slice:
                    w.ue(run)
                    run = 0
                pic.kind[addr] = _mb(rng, w, pic, addr, sid, p_slice, slice_refs, moved, qp, stats)
            if run:
                w.ue(run)
            nals.append(nal(ref_idc, 5 if idr else 1, w.rbsp()))
        if mmco5:
            dpb.prev_ref_fn = 0
            poc = 0
        elif ref_idc:
            dpb.prev_ref_fn = fn
        pictures.append(nals)
        stats.pictures += 1
    return [sps_nal(p), pps_nal(p)], pictures, stats


def annex_b(parameter_sets: List[bytes], pictures: List[List[bytes]]) -> bytes:
    """The stream as a raw .h264 file (start codes)."""
    out = bytearray()
    for n in parameter_sets:
        out += b"\x00\x00\x00\x01" + n
    for nals in pictures:
        for n in nals:
            out += b"\x00\x00\x00\x01" + n
    return bytes(out)


def length_prefixed(nals: List[bytes], size: int = 4) -> bytes:
    """One sample of an mp4 track: each NAL unit after its length."""
    return b"".join(len(n).to_bytes(size, "big") + n for n in nals)


# ------------------------------------------------------------ High streams
#
# What x264 never writes in a Main or High stream: explicit B weights,
# implicit weights with long-term references, B lists with modification
# commands and long-term entries, scaling lists that fall back by rules A
# and B (and the default lists), and B pictures out of output order in a
# stream without a VUI (FFmpeg then estimates its reorder depth from the
# POCs). CAVLC; residuals of one coefficient a 4x4 block (and a chroma DC
# coefficient), so that the scaling lists act.

# coeff_token of (TotalCoeff 1, TrailingOnes 1) in the table of nC, and
# total_zeros of TotalCoeff 1 (Tables 9-5, 9-7, 9-9)
_ONE_TOKEN = ("01", "10", "1110", "000001")
_TOTAL_ZEROS_1 = ("1", "011", "010", "0011", "0010", "00011", "00010", "000011", "000010",
                  "0000011", "0000010", "00000011", "00000010", "000000011", "000000010",
                  "000000001")
_CHROMA_DC_TOTAL_ZEROS_1 = ("1", "01", "001", "000")
# coded_block_pattern of inter macroblocks by codeNum (Table 9-4)
_INTER_CBP = (0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13, 14, 6, 9, 31, 35, 37, 42, 44,
              33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22,
              25, 38, 41)
# B sub_mb_type: partitions, lists (0: direct)
_B_SUB = ((4, 0), (1, 1), (1, 2), (1, 3), (2, 1), (2, 1), (2, 2), (2, 2), (2, 3), (2, 3), (4, 1),
          (4, 2), (4, 3))
# B mb_type 1-21: partitions, lists of each
_B_TYPES = {1: (1, 1, 0), 2: (1, 2, 0), 3: (1, 3, 0)}
for _t, (_a, _b) in enumerate(((1, 1), (2, 2), (1, 2), (2, 1), (1, 3), (2, 3), (3, 1), (3, 2),
                               (3, 3))):
    _B_TYPES[4 + 2 * _t] = _B_TYPES[5 + 2 * _t] = (2, _a, _b)
LOG2_MAX_POC_LSB_HIGH = 8


@dataclasses.dataclass
class HighParams:
    """The SPS and PPS of a High stream. Scaling lists: {index: values in
    scan order, or None for the default list}; a missing index falls back.
    reorder: the VUI's max_num_reorder_frames, None for no VUI."""
    mbw: int = 6
    mbh: int = 4
    num_ref_frames: int = 4
    num_ref_idx_default: Tuple[int, int] = (2, 1)
    weighted_pred: bool = False
    weighted_bipred_idc: int = 1
    transform_8x8: bool = True
    sps_lists: Optional[Dict[int, Optional[List[int]]]] = None
    pps_lists: Optional[Dict[int, Optional[List[int]]]] = None
    reorder: Optional[int] = 2
    gop: int = 3


@dataclasses.dataclass
class HighStats:
    """What a High stream exercised."""
    b_slices: int = 0
    explicit_bi: int = 0          # bi-predicted partitions under explicit weights
    implicit_long_term: int = 0   # bi-predicted partitions with a long-term reference (implicit)
    b_modified_lists: int = 0
    b_long_term_refs: int = 0     # B partitions predicted from a long-term reference
    direct: int = 0
    t8: int = 0
    coefficients: int = 0
    out_of_order: int = 0         # pictures decoded before one they follow in output
    pictures: int = 0


def _scaling_list(w: BitWriter, values: Optional[List[int]], rng) -> None:
    """scaling_list(): the default (useDefaultScalingMatrixFlag) for None,
    else the values' deltas, ending early (nextScale 0) when the tail
    repeats."""
    if values is None:
        w.se(-8)
        return
    n = len(values)
    end = n
    while end > 1 and values[end - 1] == values[end - 2]:
        end -= 1
    if end == n or rng.random() < 0.5:
        end = n
    last = 8
    for j in range(end):
        w.se((values[j] - last + 128) % 256 - 128)
        last = values[j]
    if end < n:
        w.se((0 - last + 128) % 256 - 128)


def high_sps_nal(p: HighParams, rng) -> bytes:
    w = BitWriter()
    w.u(8, 100)
    w.u(8, 0)
    w.u(8, 40)
    w.ue(0)
    w.ue(1)         # chroma_format_idc 4:2:0
    w.ue(0)
    w.ue(0)
    w.u(1, 0)       # transform bypass
    w.u(1, int(p.sps_lists is not None))
    if p.sps_lists is not None:
        for i in range(8):
            w.u(1, int(i in p.sps_lists))
            if i in p.sps_lists:
                _scaling_list(w, p.sps_lists[i], rng)
    w.ue(LOG2_MAX_FRAME_NUM - 4)
    w.ue(0)         # pic_order_cnt_type 0
    w.ue(LOG2_MAX_POC_LSB_HIGH - 4)
    w.ue(p.num_ref_frames)
    w.u(1, 0)
    w.ue(p.mbw - 1)
    w.ue(p.mbh - 1)
    w.u(1, 1)       # frame_mbs_only
    w.u(1, 1)       # direct_8x8_inference
    w.u(1, 0)
    w.u(1, int(p.reorder is not None))
    if p.reorder is not None:
        w.u(5, 0)   # aspect ratio, overscan, video signal, chroma loc, timing
        w.u(3, 0)   # nal / vcl hrd, pic_struct
        w.u(1, 1)   # bitstream_restriction
        w.u(1, 1)
        for v in (0, 0, 16, 16, p.reorder, p.num_ref_frames):
            w.ue(v)
    return nal(3, 7, w.rbsp())


def high_pps_nal(p: HighParams, rng) -> bytes:
    w = BitWriter()
    w.ue(0)
    w.ue(0)
    w.u(1, 0)       # CAVLC
    w.u(1, 0)
    w.ue(0)
    w.ue(p.num_ref_idx_default[0] - 1)
    w.ue(p.num_ref_idx_default[1] - 1)
    w.u(1, int(p.weighted_pred))
    w.u(2, p.weighted_bipred_idc)
    w.se(PIC_INIT_QP - 26)
    w.se(0)
    w.se(2)         # chroma_qp_index_offset
    w.u(1, 1)
    w.u(1, 0)
    w.u(1, 0)
    w.u(1, int(p.transform_8x8))
    w.u(1, int(p.pps_lists is not None))
    if p.pps_lists is not None:
        for i in range(6 + 2 * p.transform_8x8):
            w.u(1, int(i in p.pps_lists))
            if i in p.pps_lists:
                _scaling_list(w, p.pps_lists[i], rng)
    w.se(-1)        # second_chroma_qp_index_offset
    return nal(3, 8, w.rbsp())


class _HighPicture:
    def __init__(self, p: HighParams):
        self.p = p
        self.slice_of = [-1] * (p.mbw * p.mbh)
        self.kind = [""] * (p.mbw * p.mbh)
        self.nz = np.zeros((p.mbh * 4, p.mbw * 4), np.int32)   # total_coeff by 4x4 block

    def avail(self, mx: int, my: int, sid: int) -> bool:
        return 0 <= mx < self.p.mbw and 0 <= my < self.p.mbh and \
            self.slice_of[my * self.p.mbw + mx] == sid

    def n_c(self, bx: int, by: int, sid: int) -> int:
        n = [int(self.nz[y, x]) for x, y in ((bx - 1, by), (bx, by - 1))
             if self.avail(x >> 2, y >> 2, sid)]
        return (n[0] + n[1] + 1) >> 1 if len(n) == 2 else (n[0] if n else 0)


_BLK_X = (0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3)
_BLK_Y = (0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3)


def _one_coefficient(rng, w: BitWriter, n_c: int, max_coeff: int, stats: HighStats) -> int:
    """A 4x4 block with no coefficient or one of +-1 at a random scan
    position; its TotalCoeff."""
    if rng.random() < 0.4:
        w.code(_coeff_token_zero(n_c))
        return 0
    t = 0 if n_c < 2 else 1 if n_c < 4 else 2 if n_c < 8 else 3
    w.code(_ONE_TOKEN[t])
    w.u(1, int(rng.integers(2)))
    w.code(_TOTAL_ZEROS_1[int(rng.integers(max_coeff))])
    stats.coefficients += 1
    return 1


def _chroma_dc(rng, w: BitWriter, stats: HighStats) -> None:
    for _ in range(2):
        if rng.random() < 0.3:
            w.code("01")          # TotalCoeff 0
            continue
        w.code("1")               # TotalCoeff 1, TrailingOnes 1
        w.u(1, int(rng.integers(2)))
        w.code(_CHROMA_DC_TOTAL_ZEROS_1[int(rng.integers(4))])
        stats.coefficients += 1


def _high_mb(rng, w: BitWriter, pic: _HighPicture, addr: int, sid: int, slice_type: str,
             refs: List[List[_Ref]], qp: List[int], weights: int, stats: HighStats) -> str:
    """One coded macroblock of an I, P or B slice; returns its kind."""
    p = pic.p
    x, y = addr % p.mbw, addr // p.mbw
    base = {"I": 0, "P": 5, "B": 23}[slice_type]
    if slice_type == "I" or rng.random() < 0.12:
        if rng.random() < 0.3:
            w.ue(base + 25)
            w.align()
            w.raw(rng.integers(0, 256, 384, dtype=np.uint8).tobytes())
            pic.nz[y * 4:y * 4 + 4, x * 4:x * 4 + 4] = 16
            return "pcm"
        left, top, corner = (pic.avail(x - 1, y, sid), pic.avail(x, y - 1, sid),
                             pic.avail(x - 1, y - 1, sid))
        modes = [2] + [0] * top + [1] * left + [3] * (left and top and corner)
        cmodes = [0] + [1] * left + [2] * top + [3] * (left and top and corner)
        cdc = int(rng.integers(2))
        w.ue(base + 1 + modes[int(rng.integers(len(modes)))] + 4 * cdc)
        w.ue(cmodes[int(rng.integers(len(cmodes)))])
        w.se(0)
        _one_coefficient(rng, w, pic.n_c(x * 4, y * 4, sid), 16, stats)   # the DC block
        if cdc:
            _chroma_dc(rng, w, stats)
        return "i16"
    b = slice_type == "B"
    n_active = [len(refs[0]), len(refs[1])]

    def te(lst, i):
        if n_active[lst] > 1:
            w.te(i, n_active[lst] - 1)

    def mvd():
        for _ in range(2):
            w.se(int(rng.integers(-20, 21)) if rng.random() < 0.7 else 0)

    def pick_ref(lst):
        i = int(rng.integers(n_active[lst]))
        return i

    small = False   # a partition below 8x8 (no 8x8 transform)
    bi_refs = []
    if b:
        t = int(rng.choice([0, 0, 1, 2, 3, 3, 4, 5, 8, 11, 12, 17, 20, 21, 22, 22]))
        w.ue(t)
        if t == 0:
            stats.direct += 1
        elif t == 22:
            subs = [int(rng.integers(13)) for _ in range(4)]
            for s in subs:
                w.ue(s)
            # direct sub-macroblocks count as 8x8 (direct_8x8_inference_flag)
            small = any(_B_SUB[s][0] > 1 for s in subs if s)
            stats.direct += sum(s == 0 for s in subs)
            chosen = [[None] * 4, [None] * 4]
            for lst in range(2):
                for k, s in enumerate(subs):
                    if _B_SUB[s][1] & (1 << lst):
                        chosen[lst][k] = pick_ref(lst)
                        te(lst, chosen[lst][k])
            for lst in range(2):
                for s in subs:
                    if _B_SUB[s][1] & (1 << lst):
                        for _ in range(_B_SUB[s][0]):
                            mvd()
            for k, s in enumerate(subs):
                if _B_SUB[s][1] == 3:
                    bi_refs.append((chosen[0][k], chosen[1][k]))
            for lst in range(2):
                for i in chosen[lst]:
                    if i is not None:
                        stats.b_long_term_refs += refs[lst][i].long
        else:
            parts, a, c = _B_TYPES[t]
            flags = [a, c][:parts]
            chosen = [[pick_ref(lst) if f & (1 << lst) else None for f in flags] for lst in range(2)]
            for lst in range(2):
                for i in chosen[lst]:
                    if i is not None:
                        te(lst, i)
                        stats.b_long_term_refs += refs[lst][i].long
            for lst in range(2):
                for f in flags:
                    if f & (1 << lst):
                        mvd()
            for k, f in enumerate(flags):
                if f == 3:
                    bi_refs.append((chosen[0][k], chosen[1][k]))
        for i0, i1 in bi_refs:
            stats.explicit_bi += weights == 1
            stats.implicit_long_term += weights == 2 and (refs[0][i0].long or refs[1][i1].long)
    else:
        t = int(rng.integers(5 if n_active[0] > 1 else 4))
        w.ue(t)
        if t < 3:
            for _ in range(1 if t == 0 else 2):
                te(0, pick_ref(0))
            for _ in range(1 if t == 0 else 2):
                mvd()
        else:
            subs = [int(rng.integers(4)) for _ in range(4)]
            for s in subs:
                w.ue(s)
            small = any(s > 0 for s in subs)
            if t == 3:
                for _ in range(4):
                    te(0, pick_ref(0))
            for s in subs:
                for _ in range((1, 2, 2, 4)[s]):
                    mvd()
    luma = int(rng.integers(16)) if rng.random() < 0.8 else 0
    chroma = int(rng.integers(2))
    w.ue(_INTER_CBP.index(luma | chroma << 4))
    t8 = False
    if luma and p.transform_8x8 and not small:
        t8 = bool(rng.integers(2))
        w.u(1, int(t8))
        stats.t8 += t8
    if luma or chroma:
        d = int(rng.integers(-2, 3))
        d = max(min(d, 51 - qp[0]), -qp[0])
        qp[0] += d
        w.se(d)
    for blk in range(16):
        bx, by = x * 4 + _BLK_X[blk], y * 4 + _BLK_Y[blk]
        total = 0
        if luma & (1 << (blk // 4)):
            total = _one_coefficient(rng, w, pic.n_c(bx, by, sid), 16, stats)
        pic.nz[by, bx] = total
    if chroma:
        _chroma_dc(rng, w, stats)
    return "b" if b else "p"


def _weights(rng, w: BitWriter, n_active: List[int], lists: int) -> None:
    """pred_weight_table: the denominators, then a luma and a chroma weight
    and offset for most references (each weight within 1.5 x 2^denominator,
    so that w0 + w1 stays within the bi-prediction bound)."""
    log2 = (int(rng.integers(0, 6)), int(rng.integers(0, 6)))
    w.ue(log2[0])
    w.ue(log2[1])
    for lst in range(lists):
        for _ in range(n_active[lst]):
            for comp, reps in ((0, 1), (1, 2)):
                on = rng.random() < 0.7
                w.u(1, int(on))
                unit = 1 << log2[comp]
                for _ in range(reps if on else 0):
                    w.se(int(rng.integers(unit // 2, unit + unit // 2 + 1)))
                    w.se(int(rng.integers(-12, 13)))


def _b_lists(refs: List[_Ref], poc: int) -> Tuple[List[_Ref], List[_Ref]]:
    """The initial B lists (8.2.4.2.3) of the model's references."""
    shorts = [r for r in refs if not r.long]
    longs = sorted((r for r in refs if r.long), key=lambda r: r.lti)
    before = sorted((r for r in shorts if r.poc < poc), key=lambda r: -r.poc)
    after = sorted((r for r in shorts if r.poc > poc), key=lambda r: r.poc)
    l0, l1 = before + after + longs, after + before + longs
    if len(l1) > 1 and l0 == l1:
        l1[0], l1[1] = l1[1], l1[0]
    return l0, l1


def random_high_stream(seed: int, p: HighParams, n_pictures: int = 32
                       ) -> Tuple[List[bytes], List[List[bytes]], HighStats]:
    """(the SPS and PPS, each picture's NAL units in decode order, what was
    exercised): groups of up to p.gop pictures, the last of each (a
    reference) decoded first, POC type 0."""
    rng = np.random.default_rng(seed)
    stats = HighStats()
    dpb = _Dpb(p)
    pictures = []
    order = []   # (display index, is anchor) in decode order
    display = 0
    order.append((0, True))
    while len(order) < n_pictures:
        g = int(rng.integers(1, p.gop + 1))
        g = min(g, n_pictures - len(order))
        order.append((display + g, True))
        for k in range(1, g):
            order.append((display + k, False))
        display += g
    poc_base = 0
    shown = -1
    idr_done = False
    n_mb = p.mbw * p.mbh
    sink = Stats()
    for k, (disp, anchor) in enumerate(order):
        # an IDR only where no picture before it in output order is pending
        idr = k == 0 or (anchor and disp == max(d for d, _ in order[:k + 1]) and
                         all(d < disp for d, _ in order[:k]) and rng.random() < 0.08)
        if idr:
            poc_base = disp
        stats.out_of_order += disp < shown
        shown = max(shown, disp)
        ref_idc = 1 if anchor or idr else int(rng.random() < 0.5)
        fn = 0 if idr else (dpb.prev_ref_fn + 1) % dpb.maxfn
        poc = 2 * (disp - poc_base)
        init = [] if idr else dpb.lists(fn)
        refs_before = list(dpb.refs)
        marking, long_term_flag = None, False
        if idr:
            long_term_flag = bool(rng.random() < 0.3)
            dpb.refs = [_Ref(0, long_term_flag, 0)]
            dpb.max_lti = 0 if long_term_flag else -1
        elif ref_idc:
            dpb.refs = [dataclasses.replace(r) for r in refs_before]
            marking = _marking(rng, dpb, fn, sink, allow_reset=False)
            dpb.refs[-1].poc = poc   # the picture itself, appended last
        bounds = sorted(set(int(v) for v in rng.integers(1, n_mb, int(rng.integers(0, 2)))))
        starts, ends = [0] + bounds, bounds + [n_mb]
        pic = _HighPicture(p)
        nals = []
        for sid, (first, end) in enumerate(zip(starts, ends)):
            if idr or not init:
                stype = "I"
            else:
                stype = str(rng.choice(["B", "B", "B", "P", "I"] if not anchor else ["P", "B", "I"]))
            w = BitWriter()
            w.ue(first)
            w.ue({"P": 0, "B": 1, "I": 2}[stype])
            w.ue(0)
            w.u(LOG2_MAX_FRAME_NUM, fn)
            if idr:
                w.ue(k % 5)
            w.u(LOG2_MAX_POC_LSB_HIGH, poc % (1 << LOG2_MAX_POC_LSB_HIGH))
            refs = [[], []]
            if stype == "B":
                w.u(1, 1)   # direct_spatial_mv_pred_flag
                stats.b_slices += 1
            if stype in "PB":
                saved, dpb.refs = dpb.refs, refs_before
                n0 = int(rng.integers(1, min(len(init), 16) + 1))
                n1 = int(rng.integers(1, min(len(init), 16) + 1)) if stype == "B" else 0
                override = (n0, n1 if stype == "B" else p.num_ref_idx_default[1]) != \
                    tuple(p.num_ref_idx_default) or rng.random() < 0.2
                w.u(1, int(override))
                if override:
                    w.ue(n0 - 1)
                    if stype == "B":
                        w.ue(n1 - 1)
                elif stype == "B":
                    n0, n1 = p.num_ref_idx_default
                else:
                    n0 = p.num_ref_idx_default[0]
                inits = _b_lists(refs_before, poc) if stype == "B" else (init, init)
                for lst, n in enumerate((n0, n1)[:2 if stype == "B" else 1]):
                    if rng.random() < 0.5:
                        cmds, chosen = _modify(rng, dpb, inits[lst], n, fn, sink)
                        stats.b_modified_lists += stype == "B"
                        w.u(1, 1)
                        for op, v in cmds:
                            w.ue(op)
                            w.ue(v)
                        w.ue(3)
                        # entries past the commands keep the initial order of the
                        # other references: the writer only needs their kinds
                        refs[lst] = [r if r is not None else init[0] for r in chosen]
                    else:
                        w.u(1, 0)
                        refs[lst] = (inits[lst] * n)[:n]
                dpb.refs = saved
                if (p.weighted_pred and stype == "P") or (p.weighted_bipred_idc == 1 and stype == "B"):
                    _weights(rng, w, [n0, n1], 2 if stype == "B" else 1)
            if ref_idc:
                if idr:
                    w.u(1, 0)
                    w.u(1, int(long_term_flag))
                elif marking is None:
                    w.u(1, 0)
                else:
                    w.u(1, 1)
                    for op in marking:
                        w.ue(op[0])
                        for v in op[1:]:
                            w.ue(v)
                    w.ue(0)
            qp = [int(rng.integers(20, 40))]
            w.se(qp[0] - PIC_INIT_QP)
            w.ue(0)
            w.se(0)
            w.se(0)
            weights = p.weighted_bipred_idc if stype == "B" else int(p.weighted_pred)
            run = 0
            for addr in range(first, end):
                pic.slice_of[addr] = sid
                if stype != "I" and rng.random() < 0.25:
                    run += 1
                    pic.kind[addr] = "skip"
                    pic.nz[(addr // p.mbw) * 4:(addr // p.mbw) * 4 + 4,
                           (addr % p.mbw) * 4:(addr % p.mbw) * 4 + 4] = 0
                    continue
                if stype != "I":
                    w.ue(run)
                    run = 0
                pic.kind[addr] = _high_mb(rng, w, pic, addr, sid, stype, refs, qp, weights, stats)
            if run:
                w.ue(run)
            nals.append(nal(ref_idc, 5 if idr else 1, w.rbsp()))
        if ref_idc:
            dpb.prev_ref_fn = fn
        pictures.append(nals)
        stats.pictures += 1
    return [high_sps_nal(p, rng), high_pps_nal(p, rng)], pictures, stats
