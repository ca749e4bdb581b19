"""ISO-BMFF (mp4 / QuickTime mov) demuxer, in numpy and the standard
library: the container layer under the JAX package's cv2.VideoCapture
calls on mp4 files (data_tools/face_extract.py, train/clip_head.py,
cli/analyze.py), as cv2's FFmpeg backend (libavformat's mov demuxer) reads
the container.

`demux(data)` finds the first video track and gives its codec (the sample
entry's fourcc: 'avc1'/'avc3' H.264 with its avcC record: SPS, PPS and
the NAL length size; 'mp4v' MPEG-4 Part 2 with the decoder config of its
esds), its size, timescale and sample table: each sample's file offset,
size, decode and presentation time and keyframe flag, as libavformat's
packets give them (pos, size, dts, pts, AV_PKT_FLAG_KEY), and the frame
count and fps that cv2.CAP_PROP_FRAME_COUNT and CAP_PROP_FPS report.
Each sample also carries the flag libavformat's mov demuxer gives a packet
whose presentation time falls outside the edit list (AV_PKT_FLAG_DISCARD):
such a sample is decoded as a reference, and its picture dropped.

Boxes read: ftyp, moov, mvhd, trak, tkhd, edts/elst, mdia, mdhd, hdlr,
minf, stbl, stsd, stts, ctts, stss, stsc, stsz/stz2, stco/co64; 64-bit box
sizes and a moov after the mdat. The edit list is applied as libavformat
applies a plain one: leading empty edits delay every time, the first
media edit's start time is subtracted (the B-frame delay x264 writes);
as mov_fix_index walks that edit, a sample whose composition time lies
before its start or at or past its end is flagged discarded, and the walk
stops after the first keyframe whose time plus duration reaches the end
(after the second with a ctts table, for trailing B-frames): the samples
past it are not packets at all. Later media edits and the samples before
the keyframe that precedes the edit's start are not handled (libavformat
drops those). The bytes come from the user: every read is
bounds checked, and a table that points outside the file is refused.
Refused with their reason (`Mp4Error`): a fragmented file (moof, or mvex
in the moov), a file with no video track, one whose moov is cut or
missing.

No frame is decoded here: utils/h264.py decodes the H.264 samples
(Constrained Baseline, Main and High) for utils/video.VideoReader, which
names the codec or the profile and the frame count of a track it refuses.

`Mp4Muxer` writes: an mp4, mov or m4v file of one mp4v track as
libavformat 62.12's movenc writes it for cv2.VideoWriter, byte for byte
(utils/video.VideoWriter drives it).
"""

from __future__ import annotations

import dataclasses
import math
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# The sample entries a video track may carry, and how they are named
CODECS = {b"avc1": "H.264 (avc1)", b"avc3": "H.264 (avc3)", b"mp4v": "MPEG-4 Part 2 (mp4v)",
          b"hvc1": "H.265 (hvc1)", b"hev1": "H.265 (hev1)", b"av01": "AV1 (av01)",
          b"vp09": "VP9 (vp09)", b"mjpa": "Motion-JPEG (mjpa)", b"jpeg": "Motion-JPEG (jpeg)"}
_TOP_LEVEL = (b"ftyp", b"moov", b"mdat", b"free", b"skip", b"wide", b"uuid", b"pdin", b"meta",
              b"moof", b"mfra", b"styp", b"sidx")
_INT_MAX = 2 ** 31 - 1


class Mp4Error(ValueError):
    """A file the demuxer refuses, with the reason."""


@dataclasses.dataclass
class AvcConfig:
    """An avcC record (ISO/IEC 14496-15): the profile and level, the NAL
    length size in bytes and the parameter sets."""
    profile: int
    level: int
    nal_length_size: int
    sps: List[bytes]
    pps: List[bytes]


@dataclasses.dataclass
class VideoTrack:
    """The first video track of a file. The sample arrays are in decode
    order; times are in `timescale` units."""
    codec: str                  # the sample entry's fourcc, e.g. "avc1"
    width: int
    height: int
    timescale: int
    offsets: np.ndarray         # (N,) int64 file offsets
    sizes: np.ndarray           # (N,) int64
    dts: np.ndarray             # (N,) int64
    pts: np.ndarray             # (N,) int64
    keyframes: np.ndarray       # (N,) bool
    frame_count: int            # as cv2.CAP_PROP_FRAME_COUNT
    fps: float                  # as cv2.CAP_PROP_FPS
    discard: np.ndarray         # (N,) bool: AV_PKT_FLAG_DISCARD
    avc: Optional[AvcConfig] = None
    decoder_config: bytes = b""  # mp4v: the esds DecoderSpecificInfo (the VOL header)

    @property
    def codec_name(self) -> str:
        return CODECS.get(self.codec.encode(), f"'{self.codec}'")


def is_iso_bmff(head: bytes) -> bool:
    """Whether a file's first bytes open an ISO-BMFF box (mp4, mov, m4v)."""
    return len(head) >= 8 and head[4:8] in _TOP_LEVEL


class _Reader:
    """Bounds-checked big-endian reads from data[start:end]."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start, end

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > self.end:
            raise Mp4Error("a box ends before its fields")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack(">Q", self.take(8))[0]

    def array(self, n: int, dtype: str) -> np.ndarray:
        """n big-endian values of `dtype` (a numpy code like ">u4")."""
        size = np.dtype(dtype).itemsize
        if n < 0 or n * size > self.end - self.pos:
            raise Mp4Error("a table runs past its box")
        a = np.frombuffer(self.data, dtype, n, self.pos)
        self.pos += n * size
        return a


def _boxes(data: bytes, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """(type, payload start, payload end) of the boxes in data[start:end]."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        header = 8
        if size == 1:
            if pos + 16 > end:
                raise Mp4Error(f"the {kind.decode('latin-1')} box is cut")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos
        if size < header or pos + size > end:
            raise Mp4Error(f"the {kind.decode('latin-1')} box runs past its parent "
                           "(a cut file?)")
        yield kind, pos + header, pos + size
        pos += size


def _children(data: bytes, start: int, end: int) -> Dict[bytes, Tuple[int, int]]:
    out: Dict[bytes, Tuple[int, int]] = {}
    for kind, s, e in _boxes(data, start, end):
        out.setdefault(kind, (s, e))
    return out


def _full(data: bytes, span: Tuple[int, int]) -> Tuple[int, _Reader]:
    """(version, reader past the flags) of a full box."""
    r = _Reader(data, *span)
    version = r.u8()
    r.take(3)
    return version, r


def _avcc(data: bytes, start: int, end: int) -> AvcConfig:
    r = _Reader(data, start, end)
    if r.u8() != 1:
        raise Mp4Error("an avcC record of an unknown version")
    profile = r.u8()
    r.u8()
    level = r.u8()
    nal_length_size = (r.u8() & 3) + 1
    sps = [r.take(r.u16()) for _ in range(r.u8() & 31)]
    pps = [r.take(r.u16()) for _ in range(r.u8())]
    return AvcConfig(profile, level, nal_length_size, sps, pps)


def _descriptor(r: _Reader) -> Tuple[int, int]:
    """(tag, payload length) of an MPEG-4 descriptor (ISO/IEC 14496-1)."""
    tag = r.u8()
    n = 0
    for _ in range(4):
        b = r.u8()
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, n


def _esds_config(data: bytes, start: int, end: int) -> bytes:
    """The DecoderSpecificInfo of an esds box (its ES_Descriptor's
    DecoderConfigDescriptor), or b""."""
    _, r = _full(data, (start, end))
    tag, _ = _descriptor(r)
    if tag != 3:
        return b""
    r.u16()
    flags = r.u8()
    if flags & 0x80:
        r.u16()
    if flags & 0x40:
        r.take(r.u8())
    if flags & 0x20:
        r.u16()
    tag, _ = _descriptor(r)
    if tag != 4:
        return b""
    r.take(13)
    if r.pos >= r.end:
        return b""
    tag, n = _descriptor(r)
    return r.take(n) if tag == 5 else b""


def _sample_entry(data: bytes, stsd: Tuple[int, int]):
    """(fourcc, width, height, avcC, decoder config) of the first sample
    entry of an stsd box."""
    _, r = _full(data, stsd)
    if r.u32() < 1:
        raise Mp4Error("the video track has no sample description")
    entries = list(_boxes(data, r.pos, r.end))
    if not entries:
        raise Mp4Error("the video track has no sample description")
    kind, s, e = entries[0]
    # VisualSampleEntry: 6 reserved, data reference index, 16 predefined,
    # width, height, resolutions, reserved, frame count, compressor name,
    # depth, predefined: 78 bytes before its child boxes
    er = _Reader(data, s, e)
    er.take(24)
    width, height = er.u16(), er.u16()
    avc, config = None, b""
    if e - s >= 78:
        for ckind, cs, ce in _boxes(data, s + 78, e):
            if ckind == b"avcC" and avc is None:
                avc = _avcc(data, cs, ce)
            elif ckind == b"esds" and not config:
                config = _esds_config(data, cs, ce)
    return kind, width, height, avc, config


def _av_reduce(num: int, den: int, limit: int = _INT_MAX) -> Tuple[int, int]:
    """libavutil's av_reduce for non-negative num, den: num/den in lowest
    terms, or, past `limit`, the continued-fraction convergent it picks,
    with its 64-bit integer wraps."""
    m64 = (1 << 64) - 1

    def s64(v):   # an unsigned 64-bit value as int64_t
        v &= m64
        return v - (1 << 64) if v >> 63 else v

    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    if num <= limit and den <= limit:
        a1n, a1d, den = num, den, 0
    while den:
        x = num // den   # uint64_t
        next_den = num - den * x
        a2n, a2d = s64(x * a1n + a0n), s64(x * a1d + a0d)
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if (den * (2 * x * a1d + a0d)) & m64 > s64(num * a1d) & m64:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, next_den
    return a1n, a1d


def _table(data: bytes, stbl: Dict[bytes, Tuple[int, int]], track_timescale: int,
           edits: List[Tuple[int, int]], movie_timescale: int):
    """The sample table arrays and (frame count, fps) of an stbl."""
    if b"stsz" in stbl:
        _, r = _full(data, stbl[b"stsz"])
        uniform, count = r.u32(), r.u32()
        sizes = (np.full(count, uniform, np.int64) if uniform
                 else r.array(count, ">u4").astype(np.int64))
    elif b"stz2" in stbl:
        _, r = _full(data, stbl[b"stz2"])
        r.take(3)
        field, count = r.u8(), r.u32()
        if field == 4:
            packed = r.array((count + 1) // 2, "u1")
            sizes = np.stack([packed >> 4, packed & 15], 1).reshape(-1)[:count].astype(np.int64)
        elif field in (8, 16):
            sizes = r.array(count, {8: "u1", 16: ">u2"}[field]).astype(np.int64)
        else:
            raise Mp4Error(f"an stz2 field size of {field} bits")
    else:
        raise Mp4Error("the video track has no sample sizes (stsz)")
    n = len(sizes)
    if b"stco" in stbl:
        _, r = _full(data, stbl[b"stco"])
        chunks = r.array(r.u32(), ">u4").astype(np.int64)
    elif b"co64" in stbl:
        _, r = _full(data, stbl[b"co64"])
        chunks = r.array(r.u32(), ">u8").astype(np.int64)
    else:
        raise Mp4Error("the video track has no chunk offsets (stco / co64)")
    if b"stsc" not in stbl:
        raise Mp4Error("the video track has no sample-to-chunk table (stsc)")
    _, r = _full(data, stbl[b"stsc"])
    stsc = r.array(3 * r.u32(), ">u4").reshape(-1, 3).astype(np.int64)
    # samples per chunk, from each run's first chunk to the next run's
    per_chunk = np.zeros(len(chunks), np.int64)
    for j, (first, count, _) in enumerate(stsc):
        last = stsc[j + 1][0] - 1 if j + 1 < len(stsc) else len(chunks)
        if first < 1 or last > len(chunks) or first > last + 1:
            raise Mp4Error("the sample-to-chunk table points past the chunks")
        per_chunk[first - 1:last] = count
    if per_chunk.sum() < n:
        raise Mp4Error("the chunks hold fewer samples than the sample sizes list")
    chunk_of = np.repeat(np.arange(len(chunks)), per_chunk)[:n]
    first_in_chunk = np.concatenate([[0], np.cumsum(per_chunk)[:-1]])[chunk_of]
    csum = np.concatenate([[0], np.cumsum(sizes)])
    offsets = chunks[chunk_of] + csum[np.arange(n)] - csum[first_in_chunk]
    if n and (offsets.min() < 0 or (offsets + sizes).max() > len(data)):
        raise Mp4Error("a sample lies outside the file (a cut file?)")
    # decode times (stts) and the frame rate libavformat derives from them
    if b"stts" not in stbl:
        raise Mp4Error("the video track has no decode times (stts)")
    _, r = _full(data, stbl[b"stts"])
    stts = r.array(2 * r.u32(), ">u4").reshape(-1, 2).astype(np.int64)
    deltas = np.repeat(stts[:, 1], stts[:, 0])
    if len(deltas) < n:
        deltas = np.concatenate([deltas, np.zeros(n - len(deltas), np.int64)])
    dts = np.concatenate([[0], np.cumsum(deltas[:n])[:-1]]).astype(np.int64) if n else deltas[:0]
    stts_count = int(stts[:, 0].sum())
    stts_duration = int((stts[:, 0] * stts[:, 1]).sum())
    cts = np.zeros(n, np.int64)
    if b"ctts" in stbl:
        _, r = _full(data, stbl[b"ctts"])
        ctts = r.array(2 * r.u32(), ">u4").reshape(-1, 2)
        offs = np.repeat(ctts[:, 1].astype(np.uint32).view(np.int32), ctts[:, 0])
        m = min(n, len(offs))
        cts[:m] = offs[:m]
    keyframes = np.ones(n, bool)
    if b"stss" in stbl:
        _, r = _full(data, stbl[b"stss"])
        sync = r.array(r.u32(), ">u4").astype(np.int64) - 1
        keyframes[:] = False
        keyframes[sync[(sync >= 0) & (sync < n)]] = True
    # the edit list: empty edits delay, the first media edit starts the media
    delay, start, edit_end = 0, 0, None
    for duration, media_time in edits:
        if media_time == -1:
            delay += duration * track_timescale // max(movie_timescale, 1)
            continue
        start = media_time
        if duration and movie_timescale:   # av_rescale, rounding to nearest
            half = movie_timescale // 2
            edit_end = start + (duration * track_timescale + half) // movie_timescale
        break
    discard = np.zeros(n, bool)
    if edit_end is not None:
        media_cts = dts + cts
        found_key = False
        for i in range(n):
            c = int(media_cts[i])
            discard[i] = c < start or c >= edit_end
            step = int(dts[i + 1] - dts[i]) if i + 1 < n else edit_end - start
            if c + step >= edit_end and keyframes[i]:
                if b"ctts" in stbl and not found_key:
                    found_key = True
                    continue
                n = i + 1
                break
        offsets, sizes, dts, cts, keyframes, discard = (
            a[:n] for a in (offsets, sizes, dts, cts, keyframes, discard))
    dts = dts - start + delay
    pts = dts + cts
    fps = 0.0
    if stts_count and stts_duration:
        num, den = _av_reduce(track_timescale * stts_count, stts_duration)
        fps = num / den
    return offsets, sizes, dts, pts, keyframes, discard, stts_count, fps


def demux(data: bytes) -> VideoTrack:
    """The first video track of an mp4 / mov file's bytes; raises Mp4Error
    with the reason for a file it refuses."""
    top = list(_boxes(data, 0, len(data)))
    kinds = [k for k, _, _ in top]
    if b"moof" in kinds:
        raise Mp4Error("a fragmented mp4 (moof boxes) is not read")
    if b"moov" not in kinds:
        raise Mp4Error("no moov box (a cut file, or not an mp4)")
    _, ms, me = top[kinds.index(b"moov")]
    moov = list(_boxes(data, ms, me))
    if any(k == b"mvex" for k, _, _ in moov):
        raise Mp4Error("a fragmented mp4 (mvex in its moov) is not read")
    movie_timescale = 0
    for kind, s, e in moov:
        if kind == b"mvhd":
            version, r = _full(data, (s, e))
            r.take(16 if version == 1 else 8)
            movie_timescale = r.u32()
    for kind, s, e in moov:
        if kind != b"trak":
            continue
        trak = _children(data, s, e)
        if b"mdia" not in trak:
            continue
        mdia = _children(data, *trak[b"mdia"])
        if b"hdlr" not in mdia or b"mdhd" not in mdia or b"minf" not in mdia:
            continue
        _, r = _full(data, mdia[b"hdlr"])
        r.take(4)
        if r.take(4) != b"vide":
            continue
        version, r = _full(data, mdia[b"mdhd"])
        r.take(16 if version == 1 else 8)
        timescale = r.u32()
        if not timescale:
            raise Mp4Error("the video track has a timescale of 0")
        minf = _children(data, *mdia[b"minf"])
        if b"stbl" not in minf:
            raise Mp4Error("the video track has no sample table (stbl)")
        stbl = _children(data, *minf[b"stbl"])
        if b"stsd" not in stbl:
            raise Mp4Error("the video track has no sample description (stsd)")
        fourcc, width, height, avc, config = _sample_entry(data, stbl[b"stsd"])
        edits: List[Tuple[int, int]] = []
        if b"edts" in trak:
            edts = _children(data, *trak[b"edts"])
            if b"elst" in edts:
                version, r = _full(data, edts[b"elst"])
                for _ in range(r.u32()):
                    if version == 1:
                        duration, media_time = r.u64(), struct.unpack(">q", r.take(8))[0]
                    else:
                        duration, media_time = r.u32(), struct.unpack(">i", r.take(4))[0]
                    r.take(4)   # media rate
                    edits.append((duration, media_time))
        offsets, sizes, dts, pts, keyframes, discard, count, fps = _table(
            data, stbl, timescale, edits, movie_timescale)
        if not width or not height:   # a sample entry without a size: the track header's
            if b"tkhd" in trak:
                version, r = _full(data, trak[b"tkhd"])
                r.take(84 if version == 1 else 72)
                width, height = r.u32() >> 16, r.u32() >> 16
        return VideoTrack(fourcc.decode("latin-1"), width, height, timescale, offsets, sizes,
                          dts, pts, keyframes, count, fps, discard, avc, config)
    raise Mp4Error("no video track")


def read(path) -> VideoTrack:
    """demux() of a file."""
    with open(path, "rb") as fh:
        return demux(fh.read())


# ------------------------------------------------------------------- muxer
#
# The mp4 / mov / m4v files libavformat 62.12's movenc writes for one mp4v
# video track as cv2.VideoWriter drives it (no fragments, no faststart):
# ftyp, a free ('wide' in mov) placeholder, the mdat, then the moov with
# mvhd, one trak (tkhd, edts/elst, mdia: mdhd, hdlr, minf: vmhd, [mov: the
# data handler], dinf, stbl: stsd (the mp4v entry with its esds, and btrt in
# mp4), stts, stss (when not every sample is a keyframe), stsc, stsz (one
# size when all are equal), stco) and a udta naming the muxer (an iTunes
# ilst in mp4 and m4v, ©swr in mov). Past 4 GiB the chunk offsets go to a
# co64 box (once the last sample starts past 2^32 - 1, co64_required) and
# the mdat, once its size passes 2^32 - 1, takes the placeholder's 8 bytes
# for a 64-bit size (mov_write_trailer).

MUXER = "Lavf62.12.101"
_KINDS = {
    "mp4": (b"isom", (b"isom", b"iso2", b"mp41"), b"free"),
    "m4v": (b"M4V ", (b"M4V ", b"isom", b"iso2"), b"free"),
    "mov": (b"qt  ", (b"qt  ",), b"wide"),
}
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_MAX_CHUNK = 1 << 20


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I", 8 + len(body)) + kind + body


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _descr(tag: int, size: int) -> bytes:
    """An MPEG-4 descriptor header with movenc's 4-byte size."""
    return bytes([tag, 0x80 | (size >> 21) & 0x7F, 0x80 | (size >> 14) & 0x7F,
                  0x80 | (size >> 7) & 0x7F, size & 0x7F])


class Mp4Muxer:
    """Writes one mp4v track to an open binary file: `kind` 'mp4', 'mov' or
    'm4v'; `timescale` the track's (the stream time base's denominator
    doubled up to 10000 or more), `delta` one frame in it; `config` the
    esds decoder config (the encoder's global header); `bit_rate` the
    encoder's. add() appends a sample; finish() writes the moov."""

    def __init__(self, fh, kind: str, width: int, height: int, timescale: int, delta: int,
                 config: bytes, bit_rate: int):
        self.fh, self.kind = fh, kind
        self.width, self.height = width, height
        self.timescale, self.delta = timescale, delta
        self.config, self.bit_rate = config, bit_rate
        self.offsets: List[int] = []
        self.sizes: List[int] = []
        self.keys: List[bool] = []
        brand, compatible, placeholder = _KINDS[kind]
        fh.write(_box(b"ftyp", brand, struct.pack(">I", 0x200), *compatible))
        fh.write(_box(placeholder))
        self.mdat_at = fh.tell()
        fh.write(struct.pack(">I", 0) + b"mdat")

    def add(self, sample: bytes, key: bool) -> None:
        self.offsets.append(self.fh.tell())
        self.sizes.append(len(sample))
        self.keys.append(bool(key))
        self.fh.write(sample)

    def _esds(self, avg: int) -> bytes:
        cfg = self.config
        dsi = 5 + len(cfg) if cfg else 0
        body = (_descr(0x03, 3 + 5 + 13 + dsi + 5 + 1) + struct.pack(">HB", 1, 0)
                + _descr(0x04, 13 + dsi) + bytes([0x20, 0x11]) + (0).to_bytes(3, "big")
                + struct.pack(">II", max(self.bit_rate, avg), avg))
        if cfg:
            body += _descr(0x05, len(cfg)) + cfg
        body += _descr(0x06, 1) + b"\x02"
        return _full_box(b"esds", 0, 0, body)

    def _stbl(self, avg: int) -> bytes:
        mov = self.kind == "mov"
        n = len(self.sizes)
        entry = (b"\0" * 6 + struct.pack(">H", 1) + struct.pack(">HH", 0, 0)
                 + (b"FFMP" + struct.pack(">II", 0x200, 0x200) if mov else b"\0" * 12)
                 + struct.pack(">HHIIIH", self.width, self.height, 0x480000, 0x480000, 0, 1)
                 + b"\0" * 32 + struct.pack(">Hh", 0x18, -1) + self._esds(avg))
        if self.kind == "mp4":
            entry += _box(b"btrt", struct.pack(">III", 0, max(self.bit_rate, avg), avg))
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), _box(b"mp4v", entry))
        stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta) if n else
                         struct.pack(">I", 0))
        boxes = [stsd, stts]
        keys = [i + 1 for i, k in enumerate(self.keys) if k]
        if keys and len(keys) < n:
            boxes.append(_full_box(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys),
                                                                *keys)))
        # build_chunks: contiguous samples while the chunk stays under 1 MiB
        chunks: List[List[int]] = []   # [offset, samples, bytes]
        for off, size in zip(self.offsets, self.sizes):
            c = chunks[-1] if chunks else None
            if c and c[0] + c[2] == off and c[2] + size < _MAX_CHUNK:
                c[1] += 1
                c[2] += size
            else:
                chunks.append([off, 1, size])
        stsc, last = [], -1
        for i, (_, count, _) in enumerate(chunks):
            if count != last:
                stsc.append(struct.pack(">III", i + 1, count, 1))
                last = count
        boxes.append(_full_box(b"stsc", 0, 0, struct.pack(">I", len(stsc)), *stsc))
        if n and len(set(self.sizes)) == 1:
            stsz = struct.pack(">II", max(1, self.sizes[0]), n)
        else:
            stsz = struct.pack(f">II{n}I", 0, n, *self.sizes)
        boxes.append(_full_box(b"stsz", 0, 0, stsz))
        if self.offsets and self.offsets[-1] > 0xFFFFFFFF:
            boxes.append(_full_box(b"co64", 0, 0, struct.pack(f">I{len(chunks)}Q", len(chunks),
                                                              *[c[0] for c in chunks])))
        else:
            boxes.append(_full_box(b"stco", 0, 0, struct.pack(f">I{len(chunks)}I", len(chunks),
                                                              *[c[0] for c in chunks])))
        return _box(b"stbl", *boxes)

    def finish(self) -> None:
        fh, mov = self.fh, self.kind == "mov"
        end = fh.tell()
        size = end - self.mdat_at
        if size <= 0xFFFFFFFF:
            fh.seek(self.mdat_at)
            fh.write(struct.pack(">I", size))
        else:   # the placeholder box becomes the 64-bit size's header
            fh.seek(self.mdat_at - 8)
            fh.write(struct.pack(">I4sQ", 1, b"mdat", size + 8))
        fh.seek(end)
        n = len(self.sizes)
        duration = n * self.delta
        movie = -(-duration * 1000 // self.timescale)   # rounded up
        avg = sum(self.sizes) * 8 * self.timescale // duration if duration else 0
        w, h = self.width, self.height
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIIIIH", 0, 0, 1000, movie, 0x10000, 0x100),
                         b"\0" * 10, _MATRIX, b"\0" * 24, struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie), b"\0" * 8,
                         struct.pack(">HHHH", 0, 0, 0, 0), _MATRIX, struct.pack(">II", w << 16,
                                                                              h << 16))
        edts = _box(b"edts", _full_box(b"elst", 0, 0, struct.pack(">IIiI", 1, movie, 0,
                                                                  0x10000)))
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, self.timescale, duration,
                                                    0x7FFF if mov else 0x55C4, 0))
        if mov:
            hdlr = _full_box(b"hdlr", 0, 0, b"mhlr", b"vide", b"\0" * 12, b"\x0cVideoHandler")
            data_hdlr = _full_box(b"hdlr", 0, 0, b"dhlr", b"url ", b"\0" * 12,
                                  b"\x0bDataHandler")
        else:
            hdlr = _full_box(b"hdlr", 0, 0, b"\0" * 4, b"vide", b"\0" * 12, b"VideoHandler\0")
            data_hdlr = b""
        vmhd = _full_box(b"vmhd", 0, 1, b"\0" * 8)
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                       _full_box(b"url ", 0, 1)))
        minf = _box(b"minf", vmhd, data_hdlr, dinf, self._stbl(avg))
        trak = _box(b"trak", tkhd, edts, _box(b"mdia", mdhd, hdlr, minf))
        name = MUXER.encode()
        if mov:
            udta = _box(b"udta", _box(b"\xa9swr", struct.pack(">HH", len(name), 0x55C4), name))
        else:
            meta_hdlr = _full_box(b"hdlr", 0, 0, b"\0" * 4, b"mdirappl", b"\0" * 9)
            ilst = _box(b"ilst", _box(b"\xa9too", _box(b"data", struct.pack(">II", 1, 0), name)))
            udta = _box(b"udta", _full_box(b"meta", 0, 0, meta_hdlr, ilst))
        fh.write(_box(b"moov", mvhd, trak, udta))
