"""The 'mp4v' writer's large-file forms (utils/video._Mp4vAvi: avienc's
OpenDML 'AVIX' parts from 1 GiB on, with their ix00 indexes, the super
index and dmlh; utils/mp4.Mp4Muxer: movenc's co64 and 64-bit mdat past
4 GiB), held to cv2.VideoWriter's files without writing them: the packet
sizes and key flags of tools/torch_writer_large_proof.py's runs (1080p
noise at 30 fps, where cv2's and the port's files were equal byte for byte:
an AVI past 1 GiB, an mp4 and a mov past 4 GiB) replayed through the
muxers with dummy payloads into tests/torch_writer_replay.PayloadSink,
whose non-payload bytes (headers, chunk and box headers, indexes) must
hash as cv2's file did. Also: an AVI past 4 GiB finishes with every RIFF
size in 32 bits. torch + numpy only.
"""

import struct

import pytest

from real_time_video_deepfake_detection_tpu_torch.utils import video

from tests import torch_writer_replay as replay

RUNS = replay.load()["runs"]


@pytest.mark.parametrize("kind", ["avi", "mp4", "mov"])
def test_replay_equals_cv2_outside_the_payloads(kind):
    run = RUNS[kind]
    assert run["port_equal"] and run["file_size"] == run["port_file_size"]
    sink = replay.replay(run)
    assert sink.tell() == run["file_size"]
    assert sink.digest() == run["nonpayload_sha256"]


def _kept(sink) -> bytes:
    return b"".join(bytes(sink.regions[s]) for s in sink.starts)


@pytest.mark.parametrize("kind", ["mp4", "mov"])
def test_mp4_and_mov_take_their_64_bit_forms(kind):
    run = RUNS[kind]
    assert run["file_size"] > 1 << 32
    sink = replay.replay(run)
    kept = _kept(sink)
    assert b"co64" in kept and b"stco" not in kept
    first = bytes(sink.regions[sink.starts[0]])
    at = first.index(b"mdat") - 4          # the placeholder box's place
    assert struct.unpack_from(">I", first, at)[0] == 1   # a 64-bit size follows
    moov = sink.starts[-1]
    assert bytes(sink.regions[moov])[4:8] == b"moov"
    assert struct.unpack_from(">Q", first, at + 8)[0] == moov - at


def test_avi_takes_its_opendml_form():
    run = RUNS["avi"]
    assert run["file_size"] > 1 << 30
    sink = replay.replay(run)
    kept = _kept(sink)
    assert kept.count(b"RIFF") == 2 and b"AVIX" in kept and kept.count(b"ix00") == 2
    assert b"indx" in kept and b"LIST\x04\x01\x00\x00odmldmlh" in kept
    n = len(run["keys"])
    assert struct.pack("<I", n) in kept[kept.index(b"dmlh"):kept.index(b"dmlh") + 12]


def test_avi_past_4_gib_finishes():
    """5 GiB of 1 MiB packets: a RIFF part each GiB, every size written in
    32 bits, the super index listing each part's ix00 and their entries
    adding up to every packet, as dmlh counts them."""
    sink = replay.PayloadSink()
    mux = video.mp4v_muxer(sink, "avi", 1920, 1080, 30.0, b"")
    n = 5 * 1024 + 7
    for i in range(n):
        mux.add(replay.Payload(1 << 20), i % 12 == 0)
    mux.finish()
    assert sink.tell() > 5 << 30
    kept = _kept(sink)
    riffs = [i for i in range(len(kept)) if kept.startswith(b"RIFF", i)]
    assert len(riffs) >= 5
    head = bytes(sink.regions[0])
    indx = head.index(b"indx") + 8
    entries = struct.unpack_from("<I", head, indx + 4)[0]
    assert entries == len(riffs)
    assert sum(struct.unpack_from("<QII", head, indx + 24 + 16 * k)[2]
               for k in range(entries)) == n
    dmlh = head.index(b"dmlh")
    assert struct.unpack_from("<I", head, dmlh + 8)[0] == n
