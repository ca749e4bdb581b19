"""Video in and out without cv2: the port's counterpart of the JAX
package's cv2.VideoCapture / cv2.VideoWriter calls (cli/analyze.py,
train/clip_head.py, data_tools/face_extract.py). `VideoReader` goes by a
file's content, not its name.

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

Motion-JPEG AVI (a RIFF 'AVI ' file whose video stream is MJPG): each
frame decoded by the port's JPEG decoder (utils/jpeg_ingest.decode_jpeg),
which equals libjpeg's: its frames equal cv2.VideoCapture(path,
cv2.CAP_OPENCV_MJPEG)'s byte for byte, and its `seek` lands on the exact
frame. Frame offsets come from the idx1 index when the file has one, else
from a scan of the movi list; OpenDML 'AVIX' continuations are scanned
too. A frame without a DHT segment (camera Motion-JPEG) gets the standard
Huffman tables libjpeg supplies. cv2's default (FFmpeg) backend decodes
Motion-JPEG with its own IDCT and upsampling, which differ from libjpeg's.

Nothing else opens: a camera index, a missing file, any other container
or codec (`VideoReader.reason` says why).

`VideoWriter` writes JPEG frames (utils/jpeg_encode, cv2.imencode's bytes
at QUALITY 95) as '00dc' chunks with avih / strh / strf headers and an
idx1 index: a file cv2 opens with its FFmpeg and its Motion-JPEG backends.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from . import h264, mp4, mpeg4
from .jpeg_encode import encode_jpeg, standard_dht
from .jpeg_ingest import decode_jpeg

FORMATS = ("H.264 mp4 / mov (Constrained Baseline, Main and High: progressive 8-bit 4:2:0), "
           "MPEG-4 Part 2 mp4 / mov (mp4v as FFmpeg's mpeg4 encoder writes it: Simple and "
           "Advanced Simple, progressive), and "
           "Motion-JPEG AVI (RIFF 'AVI ' with an MJPG video stream)")
QUALITY = 95   # of the frames VideoWriter encodes, as the JAX package's crops


def _chunks(data: bytes, off: int, end: int):
    """(fourcc, payload offset, size) of the RIFF chunks in data[off:end];
    a chunk that runs past `end` (a file cut short) is cut there."""
    while off + 8 <= end:
        fcc = data[off:off + 4]
        size = min(struct.unpack_from("<I", data, off + 4)[0], end - off - 8)
        yield fcc, off + 8, size
        off += 8 + size + (size & 1)


def _has_dht(jpeg: bytes) -> bool:
    """Whether a DHT marker comes before the first SOS."""
    i = 2
    while i + 4 <= len(jpeg) and jpeg[i] == 0xFF:
        m = jpeg[i + 1]
        if m == 0xC4:
            return True
        if m == 0xDA:
            return False
        i += 2 + struct.unpack_from(">H", jpeg, i + 2)[0]
    return False


_INT_MAX = 2 ** 31 - 1
_INDEX_KEYFRAME, _INDEX_DISCARD = 1, 2


class _Mp4Track:
    """An mp4 track read as cv2 5.0's FFmpeg backend reads it, whatever its
    codec: grab() decodes packets until a picture comes out
    (CvCapture_FFMPEG::grabFrame), seek() is CvCapture_FFMPEG::seek over
    libavformat's backward keyframe seek (ff_index_search_timestamp on the
    samples' dts). `decoder` is an h264.Decoder or an mpeg4.Decoder."""

    def __init__(self, data: bytes, track: mp4.VideoTrack, decoder):
        self.data, self.track, self.decoder = data, track, decoder
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
        except (h264.H264Error, mpeg4.Mpeg4Error) as e:
            self.error = str(e)
            return False

    def grab(self) -> bool:
        if self.error:
            return False
        if self.track.frame_count > 0 and self.frame_number > self.track.frame_count:
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
    """Frames of an H.264 mp4 / mov (Constrained Baseline, Main, High) or an
    MPEG-4 Part 2 one (mp4v), as cv2.VideoCapture(path) reads them, or of a
    Motion-JPEG AVI, as cv2.VideoCapture(path, CAP_OPENCV_MJPEG) reads them:
    `read()` -> (ok, (H, W, 3) u8 BGR or None), `seek(i)`
    (CAP_PROP_POS_FRAMES), `frame_count`, `fps`."""

    def __init__(self, path):
        self.reason = ""
        self.fps = 0.0
        self._frames: List[Tuple[int, int]] = []   # (offset, size) per frame
        self._pos = 0
        self._data = b""
        self._mp4: Optional[_Mp4Track] = None
        if not isinstance(path, (str, os.PathLike)):
            self.reason = f"{path!r} is not a file path (camera capture is not supported)"
            return
        try:
            with open(path, "rb") as fh:
                self._data = fh.read()
        except OSError as e:
            self.reason = f"cannot read {os.fspath(path)}: {e.strerror}"
            return
        try:
            self.reason = self._parse()
        except (struct.error, ValueError, IndexError) as e:
            self.reason = f"malformed AVI: {e}"
        if self.reason:
            self._frames, self._data, self._mp4 = [], b"", None

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
        stream, rate = self._video_stream(*lists[b"hdrl"])
        if stream is None:
            return f"no MJPG video stream; the port reads {FORMATS} only"
        self.fps = rate
        tags = (b"%02ddc" % stream, b"%02ddb" % stream)
        movi_off, movi_size = lists[b"movi"]
        frames = self._from_idx1(idx1, movi_off, tags) if idx1 else None
        if frames is None:
            frames = self._scan_movi(movi_off + 4, movi_off + movi_size, tags)
        for off, size in riffs[1:]:                 # OpenDML RIFF 'AVIX' parts
            if data[off:off + 4] != b"AVIX":
                continue
            for fcc, loff, lsize in _chunks(data, off + 4, off + size):
                if fcc == b"LIST" and data[loff:loff + 4] == b"movi":
                    frames += self._scan_movi(loff + 4, loff + lsize, tags)
        self._frames = frames
        return ""

    def _open_mp4v(self, track: mp4.VideoTrack, frames: str) -> str:
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
        self._mp4, self.fps = _Mp4Track(self._data, track, decoder), track.fps
        return ""

    def _video_stream(self, off: int, size: int):
        """(index, fps) of the first MJPG video stream of hdrl, or (None, 0)."""
        data = self._data
        index = 0
        for fcc, loff, lsize in _chunks(data, off + 4, off + size):
            if fcc != b"LIST" or data[loff:loff + 4] != b"strl":
                continue
            strh = strf = None
            for sfcc, soff, ssize in _chunks(data, loff + 4, loff + lsize):
                if sfcc == b"strh" and ssize >= 48:
                    strh = (soff, ssize)
                elif sfcc == b"strf" and ssize >= 20:
                    strf = (soff, ssize)
            if strh and data[strh[0]:strh[0] + 4] == b"vids":
                handler = data[strh[0] + 4:strh[0] + 8].upper()
                compression = data[strf[0] + 16:strf[0] + 20].upper() if strf else b""
                if b"MJPG" in (handler, compression):
                    scale, rate = struct.unpack_from("<II", data, strh[0] + 20)
                    return index, (rate / scale if scale else 0.0)
            index += 1
        return None, 0.0

    def _from_idx1(self, idx1, movi_off: int, tags) -> Optional[List[Tuple[int, int]]]:
        """Frames of the idx1 index, whose offsets are relative to the movi
        list's type field or absolute in the file; None when neither fits."""
        data = self._data
        off, size = idx1
        entries = [struct.unpack_from("<4sIII", data, off + 16 * i) for i in range(size // 16)]
        entries = [e for e in entries if e[0] in tags]
        if not entries:
            return []
        for base in (movi_off, 0):
            ck_off = base + entries[0][2]
            if data[ck_off:ck_off + 4] == entries[0][0]:
                return [(base + e[2] + 8, e[3]) for e in entries
                        if e[3] > 0 and base + e[2] + 8 + e[3] <= len(data)]
        return None

    def _scan_movi(self, off: int, end: int, tags) -> List[Tuple[int, int]]:
        frames = []
        data = self._data
        for fcc, coff, size in _chunks(data, off, end):
            if fcc in tags and size > 0:
                frames.append((coff, size))
            elif fcc == b"LIST" and data[coff:coff + 4] == b"rec ":
                frames += self._scan_movi(coff + 4, coff + size, tags)
        return frames

    def is_opened(self) -> bool:
        """Open, as cv2's isOpened(): an mp4 stopped at a damaged slice stays open."""
        return not self.reason or self._mp4 is not None

    @property
    def frame_count(self) -> int:
        if self._mp4 is not None:
            return self._mp4.track.frame_count
        return len(self._frames)

    def seek(self, index: int) -> None:
        """Position the reader on frame `index`: exactly (clamped to the
        video) in an AVI, where cv2 lands in an mp4."""
        if self._mp4 is not None:
            self._mp4.seek(index)
            self._stopped()
            return
        self._pos = min(max(int(index), 0), len(self._frames))

    def _stopped(self) -> None:
        if self._mp4 is not None and self._mp4.error and not self.reason:
            # a parameter set or VOL inside a later sample may name what is not decoded
            kind = "unsupported" if self._mp4.decoder.unsupported() else "damaged"
            codec = "H.264" if self._mp4.track.codec != "mp4v" else "MPEG-4 Part 2"
            self.reason = f"{kind} {codec} stream: {self._mp4.error}"

    def _next_jpeg(self) -> Optional[bytes]:
        """The next frame's JPEG bytes (the standard Huffman tables inserted
        when it has none), or None past the end."""
        if self._pos >= len(self._frames):
            return None
        off, size = self._frames[self._pos]
        self._pos += 1
        jpeg = self._data[off:off + size]
        if jpeg[:2] == b"\xff\xd8" and not _has_dht(jpeg):
            jpeg = jpeg[:2] + standard_dht() + jpeg[2:]
        return jpeg

    def read(self) -> Tuple[bool, Optional[np.ndarray]]:
        """(True, frame) for the next frame; (False, None) past the end or
        for a frame the decoder refuses."""
        if self._mp4 is not None:
            ok = self._mp4.grab()
            self._stopped()
            return (True, self._mp4.retrieve()) if ok else (False, None)
        jpeg = self._next_jpeg()
        if jpeg is None:
            return False, None
        frame = decode_jpeg(jpeg)
        return frame is not None, frame

    def release(self) -> None:
        self._frames, self._data, self._pos, self._mp4 = [], b"", 0, None


class VideoWriter:
    """Writes (H, W, 3) u8 BGR frames of one size, `size` = (width, height),
    to a Motion-JPEG AVI at `fps`, each encoded at QUALITY (cv2.imencode's
    bytes); `release()` writes the index and the header's counts."""

    def __init__(self, path, fps: float, size: Tuple[int, int]):
        self.width, self.height = int(size[0]), int(size[1])
        if not fps > 0:
            raise ValueError(f"fps must be positive, got {fps}")
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

        def chunk(fcc, payload):
            return fcc + struct.pack("<I", len(payload)) + payload

        def lst(typ, payload):
            return b"LIST" + struct.pack("<I", len(payload) + 4) + typ + payload

        strl = lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf))
        hdrl = lst(b"hdrl", chunk(b"avih", avih) + strl)
        # the movi list's size is patched on release
        return b"RIFF" + struct.pack("<I", 0) + b"AVI " + hdrl + b"LIST" + struct.pack("<I", 0)

    def write(self, frame: np.ndarray) -> None:
        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(f"frame {frame.shape[:2]} differs from the video's "
                             f"{(self.height, self.width)}")
        self.write_jpeg(encode_jpeg(frame, QUALITY))

    def write_jpeg(self, jpeg: bytes) -> None:
        """Append one frame's JPEG bytes as they are."""
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
