"""Video in and out without cv2: the port's counterpart of the JAX
package's cv2.VideoCapture / cv2.VideoWriter calls (cli/analyze.py,
train/clip_head.py, data_tools/face_extract.py). `VideoReader` goes by a
file's content, not its name; `VideoWriter` by its fourcc and extension.

H.264 mp4 / mov (an avc1 or avc3 track, Constrained Baseline, Main or
High: CAVLC or CABAC, I, P and B slices, progressive 8-bit 4:2:0) and
MPEG-4 Part 2 mp4 / mov (an mp4v track FFmpeg's mpeg4 encoder wrote:
cv2.VideoWriter's 'mp4v', the JAX analyzer's --output; Simple and Advanced
Simple, B-VOPs, quarter-pel, MPEG quantisation, video packets and data
partitioning): demuxed by utils/mp4.py and decoded by utils/h264.py or
utils/mpeg4.py, whose frames equal cv2.VideoCapture(path)'s (its FFmpeg
backend) byte for byte, in cv2's order and number (a not-coded VOP gives
no frame): a sample libavformat flags discarded (past the
edit list) is decoded as a reference and not returned, so `frame_count`
(CAP_PROP_FRAME_COUNT) can exceed the frames read. `seek(i)` lands where
cv2 5.0's set(CAP_PROP_POS_FRAMES, i) lands, which is not always frame i:
cv2 seeks back to the keyframe at or before time max(i - 16, 0) / fps
(widening the step while it lands past i - 1), numbers the first picture
it decodes from its pts x CAP_PROP_FPS, and counts on from there, so
where the average frame rate differs from the frame spacing (an edit list
that ends at the last sample's time), later seeks return frame i - 1; on
a B-frame file (whose dts start below zero) libavformat's seek subtracts
that shift from its target once more (mov_seek_stream's
min_corrected_pts), and so does this one; after a seek, B-VOPs whose
forward reference is missing are dropped as FFmpeg drops them. Refused
with a reason that names the profile and feature (field or MBAFF coding,
4:2:2, 4:4:4 or 4:0:0 chroma, more than 8 bits; an mp4v stream written by
Xvid or DivX, GMC, interlaced coding, the short video header...) or the
codec (H.265...) and the frame count; an avc3 track is judged by the
parameter sets of its first sample, an mp4v track by its esds and first
sample. A damaged slice or VOP stops the reader (read() gives (False,
None) and `reason` says where); FFmpeg conceals the damage and reads on.

MPEG-4 Part 2 AVI (a RIFF 'AVI ' file whose video stream's compression is
an MPEG-4 Part 2 fourcc: mp4v, FMP4, XVID, DIVX, DX50, MP4S, M4S2): each
chunk a packet, as libavformat's avidec gives them to cv2 (the times the
chunk numbers in units of the stream header's scale / rate, the keyframes
idx1's flags, the frame count the header's length), decoded and sought as
an mp4v track; FFmpeg's own and cv2's 'mp4v' files read as cv2 reads them,
Xvid- and DivX-written streams (DivX's packed B-frames among them) are
refused by the decoder.

Motion-JPEG AVI (a RIFF 'AVI ' file whose video stream is MJPG): each
chunk a frame, decoded as libavcodec's mjpeg decoder decodes it and
converted as libswscale converts it (utils/mjpeg.py), so its frames equal
cv2.VideoCapture(path)'s (the FFmpeg backend, not CAP_OPENCV_MJPEG, whose
libjpeg decode differs) byte for byte, in gray, 4:4:4, 4:2:2, 4:2:0, 4:1:1
and 4:4:0 at any size, with or without DHT segments (the Annex K tables,
then the stream's last); its chunks are packets as for an mp4v AVI, so
`frame_count`, `fps` and the landing of `seek` are cv2's too. Other
samplings and arithmetic, lossless, 12-bit and non-YCbCr frames are
refused by name when the reader reaches them, and a damaged frame stops it
(libavcodec conceals the damage and reads on).

Chunk offsets come, as avidec takes them, from the OpenDML index (the
super index and each part's ix00) when the file has one, else from idx1
and then a scan of the OpenDML 'AVIX' parts, else from a scan of the movi
lists. The file is mapped (mmap), not read into memory.

Nothing else opens: a camera index, a missing file, any other container
or codec (`VideoReader.reason` says why).

`VideoWriter(path, fourcc, fps, size)` writes 'mp4v' as cv2 5.0's
cv2.VideoWriter writes it, byte for byte, in mp4, mov, m4v or AVI by the
path's extension (utils/mpeg4.Encoder, utils/mp4.Mp4Muxer and avienc's
layout here), past 4 GiB too (movenc's co64 and 64-bit mdat, avienc's
OpenDML parts from 1 GiB on); and, under 'MJPG', the port's Motion-JPEG AVI
of cv2.imencode q95 frames, which cv2 opens with its FFmpeg and its
Motion-JPEG backends. Other fourccs and containers (.mkv, .webm, no
extension) raise ValueError naming them.
"""

from __future__ import annotations

import math
import mmap
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from . import h264, mjpeg, mp4, mpeg4
from .jpeg_encode import encode_jpeg

FORMATS = ("H.264 mp4 / mov (Constrained Baseline, Main and High: progressive 8-bit 4:2:0), "
           "MPEG-4 Part 2 mp4 / mov / AVI (mp4v as FFmpeg's mpeg4 encoder writes it: Simple "
           "and Advanced Simple, progressive), and "
           "Motion-JPEG AVI (RIFF 'AVI ' with an MJPG video stream: gray, 4:4:4, 4:2:2, 4:2:0, "
           "4:1:1 and 4:4:0 frames of 8 bits, Huffman-coded)")
QUALITY = 95   # of the frames the 'MJPG' writer encodes, as the JAX package's crops


def _chunks(data: bytes, off: int, end: int):
    """(fourcc, payload offset, size) of the RIFF chunks in data[off:end];
    a chunk that runs past `end` (a file cut short) is cut there."""
    while off + 8 <= end:
        fcc = data[off:off + 4]
        size = min(struct.unpack_from("<I", data, off + 4)[0], end - off - 8)
        yield fcc, off + 8, size
        off += 8 + size + (size & 1)


_INT_MAX = 2 ** 31 - 1
# AVI compression fourccs of MPEG-4 Part 2 (FFmpeg's, cv2's, Xvid's and DivX's)
_MPEG4_TAGS = (b"MP4V", b"FMP4", b"XVID", b"DIVX", b"DX50", b"MP4S", b"M4S2")
_INDEX_KEYFRAME, _INDEX_DISCARD = 1, 2


class _Mp4Track:
    """An mp4 track (or an AVI stream's chunks) read as cv2 5.0's FFmpeg
    backend reads it, whatever its codec: grab() decodes packets until a
    picture comes out (CvCapture_FFMPEG::grabFrame), seek() is
    CvCapture_FFMPEG::seek over libavformat's backward keyframe seek
    (ff_index_search_timestamp on the samples' dts). `decoder` is an
    h264.Decoder, an mpeg4.Decoder or an mjpeg.Decoder. An AVI stream
    (`avi`) has no nb_frames in libavformat, so its reads do not stop at
    the frame count (CAP_PROP_FRAME_COUNT, the header's length)."""

    def __init__(self, data: bytes, track: mp4.VideoTrack, decoder, avi: bool = False):
        self.data, self.track, self.decoder = data, track, decoder
        self.avi = avi
        self.time_base = 1 / track.timescale   # r2d(time_base)
        kept = track.pts[~track.discard] if track.discard.any() else track.pts
        self.start_time = int(kept.min()) if len(kept) else 0
        # libavformat's min_corrected_pts: the edit list's shift of the dts
        # (B-frame files start at a negative dts), which mov_seek_stream
        # subtracts from a seek's target once more
        self.min_corrected_pts = max(-int(track.dts[0]), 0) if len(track.dts) else 0
        self.flags = (track.keyframes * _INDEX_KEYFRAME) | (track.discard * _INDEX_DISCARD)
        self.next = 0              # the next packet (sample in decode order)
        self.eof = False           # the flush packet was sent
        self.held = False          # a grabbed picture waits at the decoder's front
        self.frame_number = 0
        self.first_frame_number = -1
        self.error = ""

    def _to_frame_number(self, pts: int) -> int:   # dts_to_frame_number
        sec = float(pts - self.start_time) * self.time_base
        return int(self.track.fps * sec + 0.5)

    def _decode_next(self) -> bool:
        """Send the next packet (or, at the end, the flush); False when
        nothing is left or a slice was damaged."""
        t = self.track
        try:
            if self.next < len(t.sizes):
                i = self.next
                self.next += 1
                off, size = int(t.offsets[i]), int(t.sizes[i])
                self.decoder.decode(self.data[off:off + size], int(t.pts[i]), bool(t.discard[i]))
                return True
            if self.eof:
                return False
            self.eof = True
            self.decoder.drain()
            return True
        except (h264.H264Error, mpeg4.Mpeg4Error, mjpeg.MjpegError) as e:
            self.error = str(e)
            return False

    def grab(self) -> bool:
        if self.error:
            return False
        if not self.avi and 0 < self.track.frame_count < self.frame_number:
            return False
        if self.held:
            self.decoder.take(bgr=False)
            self.held = False
        while self.decoder.peek() is None:
            if not self._decode_next():
                return False
        self.held = True
        self.frame_number += 1
        if self.first_frame_number < 0:
            self.first_frame_number = self._to_frame_number(self.decoder.peek().pts)
        return True

    def retrieve(self) -> Optional[np.ndarray]:
        if not self.held:
            return None
        self.held = False
        return self.decoder.take()[0]

    def _seek_sample(self, ts: int) -> int:
        """libavformat's backward seek on the samples' dts: the last
        non-discarded sample at or before `ts` less min_corrected_pts, then
        back to a keyframe."""
        ts -= self.min_corrected_pts
        dts, flags = self.track.dts, self.flags
        n = len(dts)
        a, b = -1, n
        if n and dts[n - 1] < ts:
            a = n - 1
        while b - a > 1:
            m = (a + b) >> 1
            while flags[m] & _INDEX_DISCARD and m < b and m < n - 1:
                m += 1
                if m == b and dts[m] >= ts:
                    m = b - 1
                    break
            if dts[m] >= ts:
                b = m
            if dts[m] <= ts:
                a = m
        m = a
        while 0 <= m < n and not flags[m] & _INDEX_KEYFRAME:
            m -= 1
        if m < 0 and n and ts < dts[0]:
            m = 0
        return max(m, 0)

    def seek(self, index: int) -> None:
        total = self.track.frame_count
        index = min(int(index), total)
        if self.first_frame_number < 0 and total > 1:
            self.grab()
        delta = 16
        while True:
            temp = max(index - delta, 0)
            sec = temp / self.track.fps
            ts = self.start_time + int(sec / self.time_base + 0.5)
            if total > 1:
                self.next = self._seek_sample(ts)
            self.decoder.flush()
            self.eof = self.held = False
            if index <= 0:
                self.frame_number = 0
                return
            self.grab()
            if index == 1:
                self.frame_number = 1
                return
            # no picture: cv2 numbers AV_NOPTS_VALUE, far below 0
            self.frame_number = (self._to_frame_number(self.decoder.peek().pts)
                                 - self.first_frame_number) if self.held else -1
            if self.frame_number < 0 or self.frame_number > index - 1:
                if temp == 0 or delta >= _INT_MAX // 4:
                    return
                delta = delta * 2 if delta < 16 else delta * 3 // 2
                continue
            while self.frame_number < index - 1:
                if not self.grab():
                    break
            self.frame_number += 1
            return


class VideoReader:
    """Frames of an H.264 mp4 / mov (Constrained Baseline, Main, High), an
    MPEG-4 Part 2 mp4 / mov / AVI (mp4v) or a Motion-JPEG AVI, as
    cv2.VideoCapture(path) reads them: `read()` -> (ok, (H, W, 3) u8 BGR or
    None), `seek(i)` (CAP_PROP_POS_FRAMES), `frame_count`, `fps`. The file is
    mapped, not read."""

    def __init__(self, path):
        self.reason = ""
        self.fps = 0.0
        self._data = b""
        self._map: Optional[mmap.mmap] = None
        self._mp4: Optional[_Mp4Track] = None
        if not isinstance(path, (str, os.PathLike)):
            self.reason = f"{path!r} is not a file path (camera capture is not supported)"
            return
        try:
            with open(path, "rb") as fh:
                if os.fstat(fh.fileno()).st_size:
                    self._map = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
                    self._data = self._map
        except OSError as e:
            self.reason = f"cannot read {os.fspath(path)}: {e.strerror}"
            return
        try:
            self.reason = self._parse()
        except (struct.error, ValueError, IndexError) as e:
            self.reason = f"malformed AVI: {e}"
        if self.reason:
            self.release()

    def _parse(self) -> str:
        data = self._data
        if mp4.is_iso_bmff(data[:8]):
            try:
                track = mp4.demux(data)
            except mp4.Mp4Error as e:
                return f"unreadable mp4/mov: {e}"
            frames = f"{track.frame_count} frames"
            if track.codec == "mp4v":
                return self._open_mp4v(track, frames)
            if track.codec not in ("avc1", "avc3") or track.avc is None:
                return (f"{track.codec_name} decode is not ported: {frames}; the port reads "
                        f"{FORMATS} only")
            reader = _Mp4Track(data, track, h264.Decoder(track.avc.nal_length_size,
                                                         track.avc.sps + track.avc.pps))
            probe = reader.decoder
            if not (track.avc.sps and track.avc.pps) and len(track.sizes):
                # avc3: the parameter sets travel in the first sample
                first = data[int(track.offsets[0]):int(track.offsets[0] + track.sizes[0])]
                try:
                    probe = h264.Decoder(track.avc.nal_length_size, track.avc.sps + track.avc.pps
                                         + h264.parameter_sets(first, track.avc.nal_length_size))
                except h264.H264Error as e:
                    return f"{track.codec_name}: unreadable parameter sets ({e}): {frames}"
            why = probe.unsupported()
            if why:
                return f"{track.codec_name}: {why}: {frames}; the port reads {FORMATS} only"
            self._mp4, self.fps = reader, track.fps
            return ""
        if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"AVI ":
            return f"not an AVI file; the port reads {FORMATS} only"
        riffs = [(off, size) for fcc, off, size in _chunks(data, 0, len(data)) if fcc == b"RIFF"]
        first_off, first_size = riffs[0]
        lists = {}
        idx1 = None
        for fcc, off, size in _chunks(data, first_off + 4, first_off + first_size):
            if fcc == b"LIST":
                lists.setdefault(data[off:off + 4], (off, size))
            elif fcc == b"idx1":
                idx1 = (off, size)
        if b"hdrl" not in lists or b"movi" not in lists:
            return "an AVI without hdrl or movi"
        stream = self._video_stream(*lists[b"hdrl"])
        if stream is None:
            return f"no MJPG video stream (nor an MPEG-4 Part 2 one); the port reads {FORMATS} only"
        index, codec, scale, rate, length, width, height, indx = stream
        self.fps = rate / scale if scale else 0.0
        tags = (b"%02ddc" % index, b"%02ddb" % index)
        movi_off, movi_size = lists[b"movi"]
        # avidec's order: the OpenDML index, else idx1 and then the chunks
        # of the OpenDML parts (read on past the index), else the chunks met
        frames = self._from_odml(indx, tags) if indx else None
        if frames is None:
            frames = self._from_idx1(idx1, movi_off, tags) if idx1 else None
            if frames is None:
                frames = self._scan_movi(movi_off + 4, movi_off + movi_size, tags)
            for off, size in riffs[1:]:                 # OpenDML RIFF 'AVIX' parts
                if data[off:off + 4] != b"AVIX":
                    continue
                for fcc, loff, lsize in _chunks(data, off + 4, off + size):
                    if fcc == b"LIST" and data[loff:loff + 4] == b"movi":
                        frames += self._scan_movi(loff + 4, loff + lsize, tags)
        # the AVI stream as libavformat's avidec gives it to cv2: a packet per
        # chunk of data, its time the chunk's number (empty chunks counted) in
        # units of the stream header's scale / rate, keyframes as the index
        # flags them (all, without one), the frame count the header's length
        numbered = [(i, f) for i, f in enumerate(frames) if f[1] > 0]
        frames = [f for _, f in numbered]
        n = len(frames)
        count = length or n
        dts = np.array([i for i, _ in numbered], np.int64) * scale
        track = mp4.VideoTrack(
            codec, width, height, max(rate, 1),
            np.array([f[0] for f in frames], np.int64), np.array([f[1] for f in frames], np.int64),
            dts, dts.copy(), np.array([f[2] for f in frames], bool), count, self.fps,
            np.zeros(n, bool))
        if codec == "mp4v":
            return self._open_mp4v(track, f"{count} frames", avi=True)
        self._mp4 = _Mp4Track(data, track, mjpeg.Decoder(), avi=True)
        return ""

    def _open_mp4v(self, track: mp4.VideoTrack, frames: str, avi: bool = False) -> str:
        """An mp4v track: its esds headers and first sample judged, then
        opened."""
        first = b""
        if len(track.sizes):
            first = self._data[int(track.offsets[0]):int(track.offsets[0] + track.sizes[0])]
        try:
            decoder = mpeg4.Decoder(track.decoder_config, first)
        except mpeg4.Mpeg4Error as e:
            return f"{track.codec_name}: unreadable headers ({e}): {frames}"
        why = decoder.unsupported()
        if why:
            return f"{track.codec_name}: {why}: {frames}; the port reads {FORMATS} only"
        self._mp4, self.fps = _Mp4Track(self._data, track, decoder, avi), track.fps
        return ""

    def _video_stream(self, off: int, size: int):
        """(index, codec 'mjpg' / 'mp4v', scale, rate, length, width, height,
        its OpenDML super index (offset, size) or None) of the first
        Motion-JPEG or MPEG-4 Part 2 video stream of hdrl, or None."""
        data = self._data
        index = 0
        for fcc, loff, lsize in _chunks(data, off + 4, off + size):
            if fcc != b"LIST" or data[loff:loff + 4] != b"strl":
                continue
            strh = strf = indx = None
            for sfcc, soff, ssize in _chunks(data, loff + 4, loff + lsize):
                if sfcc == b"strh" and ssize >= 48:
                    strh = (soff, ssize)
                elif sfcc == b"strf" and ssize >= 20:
                    strf = (soff, ssize)
                elif sfcc == b"indx" and ssize >= 24:
                    indx = (soff, ssize)
            if strh and data[strh[0]:strh[0] + 4] == b"vids":
                handler = data[strh[0] + 4:strh[0] + 8].upper()
                compression = data[strf[0] + 16:strf[0] + 20].upper() if strf else b""
                codec = ("mjpg" if b"MJPG" in (handler, compression) else
                         "mp4v" if compression in _MPEG4_TAGS else None)
                if codec:
                    scale, rate, _, length = struct.unpack_from("<IIII", data, strh[0] + 20)
                    width, height = (struct.unpack_from("<ii", data, strf[0] + 4) if strf
                                     else (0, 0))
                    return index, codec, scale, rate, length, width, abs(height), indx
            index += 1
        return None

    def _from_odml(self, indx, tags, depth: int = 0) -> Optional[List[Tuple[int, int, bool]]]:
        """Frames of an OpenDML index (avidec's read_odml_index): a super
        index of standard indexes ('ix00': offsets from their base, bit 31 of
        the size set on a non-keyframe), (offset, size, keyframe) with the
        empty entries kept; None when it is not one."""
        data = self._data
        off, size = indx
        longs, sub, kind, n, chunk, base = struct.unpack_from("<HBBI4sQ", data, off)
        if sub or kind > 1 or (kind and longs != 2) or chunk not in tags or depth > 4:
            return None
        frames: List[Tuple[int, int, bool]] = []
        for i in range(min(n, (size - 24) // (8 if kind else 16))):
            if kind:
                rel, length = struct.unpack_from("<II", data, off + 24 + 8 * i)
                at = base + rel
                length_ = length & 0x7FFFFFFF
                frames.append((at, length_ if at + length_ <= len(data) else 0,
                               not length & 0x80000000))
            else:
                ix_off = struct.unpack_from("<Q", data, off + 24 + 16 * i)[0]
                if ix_off + 32 > len(data):
                    return None
                ix_size = struct.unpack_from("<I", data, ix_off + 4)[0]
                part = self._from_odml((ix_off + 8, min(ix_size, len(data) - ix_off - 8)), tags,
                                       depth + 1)
                if part is None:
                    return None
                frames += part
        return frames

    def _from_idx1(self, idx1, movi_off: int, tags) -> Optional[List[Tuple[int, int, bool]]]:
        """Frames of the idx1 index, (offset, size, keyframe): the offsets
        are relative to the movi list's type field or absolute in the file;
        None when neither fits."""
        data = self._data
        off, size = idx1
        entries = [struct.unpack_from("<4sIII", data, off + 16 * i) for i in range(size // 16)]
        entries = [e for e in entries if e[0] in tags]
        if not entries:
            return []
        for base in (movi_off, 0):
            ck_off = base + entries[0][2]
            if data[ck_off:ck_off + 4] == entries[0][0]:
                return [(base + e[2] + 8, e[3] if base + e[2] + 8 + e[3] <= len(data) else 0,
                         bool(e[1] & 0x10)) for e in entries]
        return None

    def _scan_movi(self, off: int, end: int, tags) -> List[Tuple[int, int, bool]]:
        frames = []
        data = self._data
        for fcc, coff, size in _chunks(data, off, end):
            if fcc in tags:
                frames.append((coff, size, True))
            elif fcc == b"LIST" and data[coff:coff + 4] == b"rec ":
                frames += self._scan_movi(coff + 4, coff + size, tags)
        return frames

    def is_opened(self) -> bool:
        """Open, as cv2's isOpened(): an mp4 stopped at a damaged slice stays open."""
        return not self.reason or self._mp4 is not None

    @property
    def frame_count(self) -> int:
        return self._mp4.track.frame_count if self._mp4 is not None else 0

    def seek(self, index: int) -> None:
        """Position the reader where cv2's set(CAP_PROP_POS_FRAMES, index)
        lands."""
        if self._mp4 is not None:
            self._mp4.seek(index)
            self._stopped()

    _CODECS = {"mp4v": "MPEG-4 Part 2", "mjpg": "Motion-JPEG"}

    def _stopped(self) -> None:
        if self._mp4 is not None and self._mp4.error and not self.reason:
            # a parameter set or VOL inside a later sample may name what is not decoded
            kind = "unsupported" if self._mp4.decoder.unsupported() else "damaged"
            codec = self._CODECS.get(self._mp4.track.codec, "H.264")
            self.reason = f"{kind} {codec} stream: {self._mp4.error}"

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, frame) for the next frame; (False, None) past the end or
        where a frame is refused or damaged (`reason` says which)."""
        if self._mp4 is None:
            return False, None
        ok = self._mp4.grab()
        self._stopped()
        return (True, self._mp4.retrieve()) if ok else (False, None)

    def release(self) -> None:
        self._data, self._mp4 = b"", None
        if self._map is not None:
            try:
                self._map.close()
            except BufferError:   # a view of it is still alive: the collector closes it
                pass
            self._map = None


def _fourcc_name(fourcc) -> str:
    """A fourcc given as cv2.VideoWriter_fourcc's int or as its four
    characters, as four characters."""
    if isinstance(fourcc, (int, np.integer)):
        return bytes((int(fourcc) >> (8 * i)) & 0xFF for i in range(4)).decode("latin-1")
    return str(fourcc)


def _cv2_time_base(fps: float) -> Tuple[int, int]:
    """(num, den) of the time base cv2's FFmpeg writer gives its encoder for
    `fps`: the first power-of-ten denominator whose rounded rate is within
    0.001 of fps (29.97 -> 100/2997, 7.5 -> 10/75)."""
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    return base, rate


def _cv2_bit_rate(fps: float, width: int, height: int) -> int:
    """The bit rate cv2 5.0's FFmpeg writer gives the mpeg4 encoder (and so
    the containers' headers): 2 * fps * width * height truncated, one less
    where that truncation is 2 modulo 4 and the product not whole (read off
    the files of 161 sizes and rates), at most INT_MAX."""
    y = 2 * fps * width * height
    if y >= _INT_MAX:
        return _INT_MAX
    b = int(y)
    return b - 1 if b % 4 == 2 and b != y else b


# the containers an 'mp4v' stream is written in, by extension (libavformat's
# av_guess_format matches extensions without regard to case)
MP4V_CONTAINERS = {".mp4": "mp4", ".mov": "mov", ".m4v": "m4v", ".avi": "avi"}
_REFUSED = {".mkv": "Matroska is not written (libavformat's Matroska muxer writes random "
                    "UIDs, so no file can equal cv2's)",
            ".webm": "WebM takes no mp4v (cv2's FFmpeg writer fails to open it)"}


def mp4v_container(path) -> str:
    """The container an 'mp4v' stream is written in for `path`: 'mp4',
    'mov', 'm4v' or 'avi' by its extension; ValueError naming any other."""
    ext = os.path.splitext(os.fspath(path))[1].lower()
    if ext not in MP4V_CONTAINERS:
        why = _REFUSED.get(ext, "the port writes mp4v into " + ", ".join(MP4V_CONTAINERS))
        raise ValueError(f"container {ext or '(no extension)'!r} of {os.fspath(path)!r} "
                         f"is not written: {why}")
    return MP4V_CONTAINERS[ext]


class _MjpegAvi:
    """Motion-JPEG AVI: JPEG frames (utils/jpeg_encode, cv2.imencode's bytes
    at QUALITY 95) as '00dc' chunks with avih / strh / strf headers and an
    idx1 index."""

    def __init__(self, path, fps: float, size: Tuple[int, int]):
        self.width, self.height = int(size[0]), int(size[1])
        self.fps = float(fps)
        self._fh = open(path, "wb")
        self._index: List[Tuple[int, int]] = []   # (offset from the movi type, size)
        self._max_size = 0
        self._fh.write(self._header(0))
        self._movi_at = self._fh.tell()   # the 'movi' type field
        self._fh.write(b"movi")

    def _header(self, n_frames: int) -> bytes:
        """RIFF header, hdrl list and the movi list's chunk header (sizes
        patched by release())."""
        w, h = self.width, self.height
        if float(self.fps).is_integer():
            scale, rate = 1, int(self.fps)
        else:
            scale, rate = 1000, int(round(self.fps * 1000))
        usec = int(round(1e6 * scale / rate))
        buf = max(self._max_size, 1 << 20)
        avih = struct.pack("<10I16x", usec, 0, 0, 0x910, n_frames, 0, 1, buf, w, h)
        strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", b"MJPG", 0, 0, 0, 0, scale, rate, 0,
                           n_frames, buf, -1, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
        # the movi list's size is patched on release
        return b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl + b"LIST" + struct.pack("<I", 0)

    def write(self, frame: np.ndarray) -> None:
        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(f"frame {frame.shape[:2]} differs from the video's "
                             f"{(self.height, self.width)}")
        self.write_jpeg(encode_jpeg(frame, QUALITY))

    def write_jpeg(self, jpeg: bytes) -> None:
        at = self._fh.tell()
        self._fh.write(b"00dc" + struct.pack("<I", len(jpeg)) + jpeg)
        if len(jpeg) & 1:
            self._fh.write(b"\0")
        self._index.append((at - self._movi_at, len(jpeg)))
        self._max_size = max(self._max_size, len(jpeg))

    def release(self) -> None:
        if self._fh is None:
            return
        fh, self._fh = self._fh, None
        try:
            movi_end = fh.tell()
            fh.write(b"idx1" + struct.pack("<I", 16 * len(self._index)))
            for off, size in self._index:
                fh.write(struct.pack("<4sIII", b"00dc", 0x10, off, size))   # AVIIF_KEYFRAME
            end = fh.tell()
            fh.seek(0)
            fh.write(self._header(len(self._index)))
            fh.seek(4)
            fh.write(struct.pack("<I", end - 8))
            fh.seek(self._movi_at - 4)
            fh.write(struct.pack("<I", movi_end - self._movi_at))
        finally:
            fh.close()


def _chunk(fcc: bytes, payload: bytes) -> bytes:
    return fcc + struct.pack("<I", len(payload)) + payload


def _list(typ: bytes, payload: bytes) -> bytes:
    return b"LIST" + struct.pack("<I", len(payload) + 4) + typ + payload


AVI_MAX_RIFF_SIZE = 1 << 30   # avienc starts an OpenDML 'AVIX' part past this


class _Mp4vAvi:
    """An mp4v stream in AVI as libavformat 62.12's avienc writes it: hdrl
    (avih, strl with strh / strf and the OpenDML super index reserved as
    JUNK, the odml/dmlh reserve), the INFO list naming the muxer, 1016 bytes
    of padding, the movi list of '00dc' chunks and the idx1 index (keyframes
    flagged); finish() writes the counts. The super index reserves room for
    the RIFF parts of a 10-hour file at 110% of the bit rate (avienc's
    estimate when the duration is unknown), at least 256 entries.

    Past `riff_limit` bytes of a RIFF (avienc's 1 GiB) the next chunk opens
    an OpenDML part, as avienc's avi_write_packet_internal does: the part's
    'ix00' standard index (offsets from its movi list, bit 31 set on a
    non-keyframe) closes its movi list, the first RIFF also gets its idx1
    and the counts so far (avih's total frames stays that count), and a
    'RIFF AVIX' with its own movi list follows. The super index 'indx'
    (then no longer JUNK) lists each part's ix00, and finish() turns the
    odml JUNK into a LIST whose dmlh holds the total frame count. Each
    payload goes to the file in a write() of its own. `riff_limit` and
    `fourcc` (the stream's handler and compression) let the tests build
    small OpenDML files of other codecs."""

    def __init__(self, fh, width: int, height: int, num: int, den: int, bit_rate: int,
                 riff_limit: int = AVI_MAX_RIFF_SIZE, fourcc: bytes = b"mp4v"):
        self.fh = fh
        self.fourcc = fourcc
        self.width, self.height, self.num, self.den = width, height, num, den
        self.bit_rate = bit_rate
        self.riff_limit = riff_limit
        self.index: List[Tuple[int, int, bool]] = []   # this RIFF's (offset, size, key)
        self.max_size = 0
        self.packets = 0
        self.first_count = 0   # avih's total frames: the count when the first RIFF closed
        self.parts: List[Tuple[int, int, int]] = []   # super index: (ix offset, size, entries)
        filesize_est = 10 * 60 * 60.0 * (bit_rate // 8) * 1.10
        self.index_entries = max(math.ceil(filesize_est / (1 << 30)) + 1, 256)
        # the first movi list's type field, which the idx1 offsets count from
        self.first_movi_at = 5674 + 16 * (self.index_entries - 256)
        self.movi_at = self.first_movi_at   # the current part's
        self.riff_at = 8                    # the current RIFF's type field
        self.first_movi_end = self.first_end = 0   # once the first RIFF is closed
        fh.write(self._header(0, 0))

    def _header(self, first_end: int, movi_end: int) -> bytes:
        w, h = self.width, self.height
        count = self.first_count if self.parts else self.packets
        avih = struct.pack("<10I16x", 1000000 * self.num // self.den, self.bit_rate // 8, 0,
                           0x910, count, 0, 1, 1 << 20, w, h)
        strh = struct.pack("<4s4sIHHIIIIIIiI4h", b"vids", self.fourcc, 0, 0, 0, 0, self.num,
                           self.den, 0, self.packets, self.max_size, -1, 0, 0, 0, w, h)
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, self.fourcc, w * h * 3, 0, 0, 0,
                           0)
        indx = struct.pack("<HBBI4s", 4, 0, 0, len(self.parts), b"00dc") + b"\0" * 12
        indx += b"".join(struct.pack("<QII", *p) for p in self.parts)
        indx = indx.ljust(24 + 16 * self.index_entries, b"\0")
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)
                     + _chunk(b"indx" if self.parts else b"JUNK", indx))
        dmlh = b"dmlh" + struct.pack("<II", 248, self.packets if self.parts else 0) + b"\0" * 244
        odml = (b"LIST" + struct.pack("<I", 4 + len(dmlh)) + b"odml" + dmlh if self.parts else
                _chunk(b"JUNK", b"odml" + dmlh))
        hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl + odml)
        info = _list(b"INFO", _chunk(b"ISFT", mp4.MUXER.encode() + b"\0"))
        movi_size = movi_end - self.first_movi_at if movi_end else 0
        return (b"RIFF" + struct.pack("<I", max(first_end - 8, 0)) + b"AVI " + hdrl + info
                + _chunk(b"JUNK", b"\0" * 1016) + b"LIST" + struct.pack("<I", movi_size)
                + b"movi")

    def _write_ix(self) -> None:
        """The current part's ix00, listed in the super index."""
        fh = self.fh
        at = fh.tell()
        fh.write(b"ix00" + struct.pack("<IHBBI4sQI", 24 + 8 * len(self.index), 2, 0, 1,
                                       len(self.index), b"00dc", self.movi_at, 0))
        fh.write(b"".join(struct.pack("<II", off + 8, size | (0 if key else 0x80000000))
                          for off, size, key in self.index))
        self.parts.append((at, fh.tell() - at, len(self.index)))
        if len(self.parts) >= self.index_entries:
            raise ValueError(f"more than {self.index_entries - 1} OpenDML parts: the super "
                             "index's reserve is full")

    def _write_idx1(self) -> None:
        self.fh.write(b"idx1" + struct.pack("<I", 16 * len(self.index)))
        self.fh.write(b"".join(struct.pack("<4sIII", b"00dc", 0x10 if key else 0, off, size)
                               for off, size, key in self.index))

    def _close_list(self, type_at: int) -> int:
        """Patch the size of the list or RIFF whose type field is at
        `type_at`; the position after it."""
        fh = self.fh
        end = fh.tell()
        fh.seek(type_at - 4)
        fh.write(struct.pack("<I", end - type_at))
        fh.seek(end)
        return end

    def add(self, sample: bytes, key: bool) -> None:
        fh = self.fh
        self.packets += 1
        at = fh.tell()
        if at - self.riff_at > self.riff_limit:   # an OpenDML part
            self._write_ix()
            movi_end = self._close_list(self.movi_at)
            if not self.first_end:
                self._write_idx1()
                self.first_count = self.packets
                self.first_movi_end, self.first_end = movi_end, fh.tell()
            else:
                self._close_list(self.riff_at)
            self.riff_at = fh.tell() + 8
            fh.write(b"RIFF\0\0\0\0AVIXLIST\0\0\0\0movi")
            self.movi_at = fh.tell() - 4
            self.index = []
            at = fh.tell()
        fh.write(b"00dc" + struct.pack("<I", len(sample)))
        fh.write(sample)
        if len(sample) & 1:
            fh.write(b"\0")
        self.index.append((at - self.movi_at, len(sample), key))
        self.max_size = max(self.max_size, len(sample))

    def finish(self) -> None:
        fh = self.fh
        if not self.first_end:
            movi_end = fh.tell()
            self._write_idx1()
            end = fh.tell()
            fh.seek(0)
            fh.write(self._header(end, movi_end))
            fh.seek(end)
            return
        self._write_ix()
        self._close_list(self.movi_at)
        end = self._close_list(self.riff_at)
        fh.seek(0)
        fh.write(self._header(self.first_end, self.first_movi_end))
        fh.seek(end)


def mp4v_muxer(fh, kind: str, width: int, height: int, fps: float, header: bytes):
    """The muxer cv2's FFmpeg writer opens for an mp4v stream of (even)
    `width` x `height` at `fps` in container `kind` (MP4V_CONTAINERS'
    values) on the binary file `fh`: its add(packet, key) appends a packet,
    its finish() closes the file's structures. `header` is the encoder's
    global header (the esds decoder config; unused in AVI)."""
    num, den = _cv2_time_base(fps)
    bit_rate = _cv2_bit_rate(fps, width, height)
    if kind == "avi":
        g = math.gcd(num, den)
        return _Mp4vAvi(fh, width, height, num // g, den // g, bit_rate)
    timescale = den
    while timescale < 10000:
        timescale *= 2
    return mp4.Mp4Muxer(fh, kind, width, height, timescale, timescale * num // den, header,
                        bit_rate)


class VideoWriter:
    """cv2.VideoWriter(path, fourcc, fps, size) for the fourccs the port
    writes; `size` = (width, height), frames (H, W, 3) u8 BGR.

    'mp4v': MPEG-4 Part 2 as cv2 5.0's FFmpeg backend writes it, byte for
    byte: the frame cut to even sizes and converted to yuv420p as cv2
    converts it, encoded as libavcodec's mpeg4 encoder encodes it with cv2's
    settings (utils/mpeg4.Encoder), in the container libavformat picks by the
    path's extension, matched without regard to case: '.mp4', '.mov' and
    '.m4v' (movenc, the VOL headers in the esds) or '.avi' (avienc, the
    headers in every keyframe). A frame whose even-cut size differs from the
    video's raises (cv2 skips it with a warning), and so does an fps whose
    time base MPEG-4 cannot carry (a denominator over 65535, as 67.123's
    1000/67123; cv2 fails to open).

    'MJPG': the port's Motion-JPEG AVI (cv2.imencode's JPEG bytes at
    QUALITY 95 per frame; `write_jpeg` appends a JPEG as it is), whatever
    the extension, as the port's tests and chip_smoke.py build AVI
    fixtures; it is not cv2's MJPG writer.

    Any other fourcc, an mp4v path with another extension (.mkv, .webm) or
    none raises ValueError naming it. `release()` finishes the file."""

    def __init__(self, path, fourcc, fps: float, size: Tuple[int, int]):
        name = _fourcc_name(fourcc)
        if not fps > 0:
            raise ValueError(f"fps must be positive, got {fps}")
        if name == "MJPG":
            self._mjpeg: Optional[_MjpegAvi] = _MjpegAvi(path, fps, size)
            self.width, self.height = self._mjpeg.width, self._mjpeg.height
            return
        if name != "mp4v":
            raise ValueError(f"fourcc {name!r} is not written: the port writes 'mp4v' (mp4, "
                             "mov, m4v, avi) and its Motion-JPEG AVI ('MJPG')")
        self._mjpeg = None
        kind = mp4v_container(path)
        self.width, self.height = int(size[0]) & ~1, int(size[1]) & ~1
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"size {tuple(size)} is empty")
        num, den = _cv2_time_base(float(fps))
        bit_rate = _cv2_bit_rate(float(fps), self.width, self.height)
        self._encoder = mpeg4.Encoder(self.width, self.height, num, den, bit_rate,
                                      global_header=kind != "avi")
        self._fh = open(path, "wb")
        self._mux = mp4v_muxer(self._fh, kind, self.width, self.height, float(fps),
                               self._encoder.header)
        self._pts = 0

    def write(self, frame: np.ndarray) -> None:
        if self._mjpeg is not None:
            return self._mjpeg.write(frame)
        if self._fh is None:
            raise ValueError("the writer is released")
        frame = np.asarray(frame)
        if (frame.ndim != 3 or frame.shape[2] != 3
                or (frame.shape[0] & ~1, frame.shape[1] & ~1) != (self.height, self.width)):
            raise ValueError(f"frame {frame.shape} differs from the video's "
                             f"{(self.height, self.width)}")
        packet, key = self._encoder.encode(frame, self._pts)
        self._pts += 1
        self._mux.add(packet, key)

    def reconstruction(self) -> np.ndarray:
        """The last frame written as a decoder of the file gives it (mp4v):
        the encoder's reconstruction, converted to BGR as cv2 converts a
        decoded frame."""
        if self._mjpeg is not None:
            raise ValueError("reconstruction is for the mp4v writer")
        return self._encoder.reconstruction()

    def write_jpeg(self, jpeg: bytes) -> None:
        """Append one frame's JPEG bytes as they are (MJPG only)."""
        if self._mjpeg is None:
            raise ValueError("write_jpeg is for the Motion-JPEG writer (fourcc 'MJPG')")
        self._mjpeg.write_jpeg(jpeg)

    def release(self) -> None:
        if self._mjpeg is not None:
            return self._mjpeg.release()
        if self._fh is None:
            return
        fh, self._fh = self._fh, None
        try:
            self._mux.finish()
        finally:
            fh.close()
