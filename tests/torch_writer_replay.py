"""Replay of an 'mp4v' writer run through the port's muxers without its
payloads: the packet sizes and key flags a run of cv2.VideoWriter gave
(tests/data/torch_writer_large/replay.json, written by
tools/torch_writer_large_proof.py) go through utils/video.mp4v_muxer as
dummy payloads, into a sink that keeps every byte but theirs. The digest
of those bytes in file order is compared with the same digest of cv2's
file: its headers, chunk and box headers and indexes, all the container
is. torch + numpy only (no cv2)."""

from __future__ import annotations

import base64
import bisect
import hashlib
import json
import os
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_writer_large",
                       "replay.json")


class Payload:
    """A packet's payload of `n` bytes that is never materialised."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n


class PayloadSink:
    """A seekable binary file stand-in: non-payload writes are kept (a
    patch overwrites what it covers), a Payload write only moves the
    position. `digest()` is the SHA-256 of the kept bytes in file order."""

    def __init__(self):
        self.pos = 0
        self.starts: List[int] = []
        self.regions: Dict[int, bytearray] = {}
        self.payloads: List[Tuple[int, int]] = []

    def tell(self) -> int:
        return self.pos

    def seek(self, pos: int, whence: int = 0) -> int:
        assert whence == 0
        self.pos = pos
        return pos

    def write(self, b) -> int:
        n = len(b)
        if isinstance(b, Payload):
            self.payloads.append((self.pos, n))
            self.pos += n
            return n
        b = bytes(b)
        i = bisect.bisect_right(self.starts, self.pos) - 1
        if i >= 0:
            start = self.starts[i]
            region = self.regions[start]
            if self.pos <= start + len(region):
                at = self.pos - start
                region[at:at + n] = b
                self.pos += n
                return n
        bisect.insort(self.starts, self.pos)
        self.regions[self.pos] = bytearray(b)
        self.pos += n
        return n

    def digest(self) -> str:
        h = hashlib.sha256()
        for start in self.starts:
            h.update(self.regions[start])
        return h.hexdigest()


def file_digest(path: str, payloads: Sequence[Tuple[int, int]]) -> str:
    """The same digest of a file on disk whose payloads sit at `payloads`
    ((offset, size) in file order)."""
    h = hashlib.sha256()
    at = 0
    with open(path, "rb") as fh:
        for off, n in list(payloads) + [(os.path.getsize(path), 0)]:
            fh.seek(at)
            left = off - at
            while left > 0:
                chunk = fh.read(min(left, 1 << 24))
                h.update(chunk)
                left -= len(chunk)
            at = off + n
    return h.hexdigest()


def pack_sizes(sizes: Sequence[int]) -> str:
    return base64.b64encode(zlib.compress(np.asarray(sizes, "<u4").tobytes(), 9)).decode()


def unpack_sizes(text: str) -> np.ndarray:
    return np.frombuffer(zlib.decompress(base64.b64decode(text)), "<u4").astype(np.int64)


def load() -> dict:
    with open(FIXTURE) as fh:
        return json.load(fh)


def replay(run: dict) -> PayloadSink:
    """One recorded run through the port's muxer: the sink it wrote."""
    from real_time_video_deepfake_detection_tpu_torch.utils import video

    sink = PayloadSink()
    mux = video.mp4v_muxer(sink, run["kind"], run["width"], run["height"], run["fps"],
                           bytes.fromhex(run["header"]))
    for size, key in zip(unpack_sizes(run["sizes"]), run["keys"]):
        mux.add(Payload(int(size)), key == "1")
    mux.finish()
    return sink
