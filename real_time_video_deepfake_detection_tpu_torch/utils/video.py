"""Motion-JPEG AVI in and out, without cv2: the port's counterpart of the
JAX package's cv2.VideoCapture / cv2.VideoWriter calls (cli/analyze.py,
train/clip_head.py, data_tools/face_extract.py).

`VideoReader` opens a RIFF 'AVI ' file whose video stream is MJPG (by its
content, not its name) and decodes each frame with the port's JPEG decoder
(utils/jpeg_ingest.decode_jpeg), which equals libjpeg's: its frames equal
cv2.VideoCapture(path, cv2.CAP_OPENCV_MJPEG)'s byte for byte, and its
`seek` lands on the exact frame. Frame offsets come from the idx1 index
when the file has one, else from a scan of the movi list; OpenDML 'AVIX'
continuations are scanned too. A frame without a DHT segment (camera
Motion-JPEG) gets the standard Huffman tables libjpeg supplies.

Nothing else opens: a camera index, a missing file, any other container
or codec (`VideoReader.reason` says why). An mp4 or mov file is demuxed
(utils/mp4.py) and stays unopened with a reason that names its codec and
its frame count, since no H.264 or MPEG-4 Part 2 decoder is ported yet.
cv2.VideoCapture's default backend (FFmpeg) reads those, and decodes
Motion-JPEG with its own IDCT and upsampling, which differ from libjpeg's.

`VideoWriter` writes JPEG frames (utils/jpeg_encode, cv2.imencode's bytes
at QUALITY 95) as '00dc' chunks with avih / strh / strf headers and an
idx1 index: a file cv2 opens with its FFmpeg and its Motion-JPEG backends.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from . import mp4
from .jpeg_encode import encode_jpeg, standard_dht
from .jpeg_ingest import decode_jpeg

FORMATS = "Motion-JPEG AVI (RIFF 'AVI ' with an MJPG video stream)"
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


class VideoReader:
    """Frames of a Motion-JPEG AVI, as cv2.VideoCapture(path,
    CAP_OPENCV_MJPEG) reads them: `read()` -> (ok, (H, W, 3) u8 BGR or
    None), `seek(i)` (CAP_PROP_POS_FRAMES), `frame_count`, `fps`."""

    def __init__(self, path):
        self.reason = ""
        self.fps = 0.0
        self._frames: List[Tuple[int, int]] = []   # (offset, size) per frame
        self._pos = 0
        self._data = b""
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
            self._frames, self._data = [], b""

    def _parse(self) -> str:
        data = self._data
        if mp4.is_iso_bmff(data[:8]):
            try:
                track = mp4.demux(data)
            except mp4.Mp4Error as e:
                return f"unreadable mp4/mov: {e}"
            return (f"{track.codec_name} decode is not ported yet: {len(track.sizes)} frames "
                    f"demuxed; the port reads {FORMATS} only")
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
        return not self.reason

    @property
    def frame_count(self) -> int:
        return len(self._frames)

    def seek(self, index: int) -> None:
        """Position the reader on frame `index` (clamped to the video)."""
        self._pos = min(max(int(index), 0), len(self._frames))

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
        jpeg = self._next_jpeg()
        if jpeg is None:
            return False, None
        frame = decode_jpeg(jpeg)
        return frame is not None, frame

    def release(self) -> None:
        self._frames, self._data, self._pos = [], b"", 0


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
