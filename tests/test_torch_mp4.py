"""The port's ISO-BMFF demuxer (utils/mp4.py) against libavformat and
cv2.VideoCapture, on the fixtures of tests/data/torch_mp4
(tools/make_torch_jpeg_mode_fixtures.py): x264 High (B-frames: ctts and
an edit list, the moov after the mdat), Constrained Baseline (+faststart),
QuickTime mov and cv2's mp4v. The sample table (offset, size, dts, pts,
keyframe, discard: AV_PKT_FLAG_DISCARD past the edit list) equals
libavformat's packets (packets.json); frame count, fps and size equal
cv2.VideoCapture's CAP_PROP_*. A fragmented file, an audio-only one and
cut ones are refused with their reason; utils/video.VideoReader opens
every video file (tests/test_torch_h264.py, tests/test_torch_h264_high.py
and tests/test_torch_mpeg4.py hold their frames).
"""

import ctypes
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu_torch.utils import mp4
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_mp4")
with open(os.path.join(DATA, "packets.json")) as _fh:
    RECORDS = json.load(_fh)["files"]
VIDEOS = sorted(k for k, r in RECORDS.items() if r["libavformat"] is not None
                and "fragmented" not in k)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread, beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _table(track):
    return np.stack([track.offsets, track.sizes, track.dts, track.pts,
                     track.keyframes.astype(np.int64), track.discard.astype(np.int64)],
                    1).tolist()


@pytest.mark.parametrize("name", VIDEOS)
def test_sample_table_equals_libavformat_packets(name):
    track, want = mp4.demux(_data(name)), RECORDS[name]["libavformat"]
    assert _table(track) == want["packets"]
    assert [1, track.timescale] == want["time_base"]
    assert track.frame_count == want["nb_frames"]
    assert track.fps == want["avg_frame_rate"][0] / want["avg_frame_rate"][1]
    assert {"h264": "avc1", "mpeg4": "mp4v"}[want["codec"]] == track.codec


@pytest.mark.parametrize("name", VIDEOS)
def test_frame_count_fps_and_size_equal_cv2(name):
    track = mp4.read(os.path.join(DATA, name))
    cap = cv2.VideoCapture(os.path.join(DATA, name))
    try:
        assert cap.isOpened()
        got = (track.frame_count, track.fps, track.width, track.height)
        assert got == (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS),
                       cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    finally:
        cap.release()
    rec = RECORDS[name]["cv2"]
    assert got == (rec["frame_count"], rec["fps"], rec["width"], rec["height"])


def test_codec_configuration():
    """The avcC parameter sets (whose first NAL bytes name an SPS and a PPS)
    and the NAL length size; mp4v's esds config, a VOL header."""
    for name in ("high_160x96.mp4", "baseline_160x96.mp4", "high_160x96.mov"):
        track = mp4.demux(_data(name))
        assert track.avc.nal_length_size == 4
        assert [s[0] & 31 for s in track.avc.sps] == [7]
        assert [p[0] & 31 for p in track.avc.pps] == [8]
        assert track.avc.profile == (100 if "high" in name else 66)
        off, size = int(track.offsets[0]), int(track.sizes[0])
        n = struct.unpack(">I", _data(name)[off:off + 4])[0]   # the first NAL's length
        assert 4 + n <= size
    track = mp4.demux(_data("mp4v_160x96.mp4"))
    assert track.avc is None and track.decoder_config[:3] == b"\x00\x00\x01"
    assert track.keyframes[0]
    assert mp4.demux(_data("baseline_160x96.mp4")).dts.tolist() == \
        mp4.demux(_data("baseline_160x96.mp4")).pts.tolist()   # no B-frames


def test_moov_after_mdat_and_with_a_64_bit_size():
    """The High file's moov follows its mdat; written with a 64-bit box
    size (size 1 and a largesize) it demuxes to the same table."""
    data = _data("high_160x96.mp4")
    kinds = [k for k, _, _ in mp4._boxes(data, 0, len(data))]
    assert kinds.index(b"moov") > kinds.index(b"mdat")
    at = data.rindex(b"moov") - 4
    size = struct.unpack(">I", data[at:at + 4])[0]
    assert at + size == len(data)
    wide = data[:at] + struct.pack(">I4sQ", 1, b"moov", size + 8) + data[at + 8:]
    assert _table(mp4.demux(wide)) == _table(mp4.demux(data))
    fast = _data("baseline_160x96.mp4")
    assert [k for k, _, _ in mp4._boxes(fast, 0, len(fast))
            if k in (b"moov", b"mdat")] == [b"moov", b"mdat"]


@pytest.mark.parametrize("case, why", [
    ("fragmented_160x96.mp4", "fragmented"), ("audio_only.mp4", "no video track"),
    ("cut_moov", "a cut file"), ("cut_mdat", "a cut file"), ("cut_samples", "outside the file"),
    ("not_mp4", "no moov")])
def test_refusals_carry_their_reason(case, why):
    if case.endswith(".mp4"):
        data = _data(case)
    elif case == "cut_moov":       # the moov at the end, cut in its middle
        data = _data("high_160x96.mp4")
        data = data[:data.rindex(b"moov") + 200]
    elif case == "cut_mdat":       # moov-at-end file cut before its moov
        data = _data("high_160x96.mp4")
        data = data[:data.rindex(b"moov") - 100]
    elif case == "cut_samples":    # +faststart: the moov whole, the samples cut
        data = _data("baseline_160x96.mp4")
        data = data[:len(data) // 2]
        # the mdat box now runs past the end: size it to the end
        at = data.index(b"mdat") - 4
        data = data[:at] + struct.pack(">I", len(data) - at) + data[at + 4:]
    else:
        data = b"\x00\x00\x00\x08free" + bytes(40)
    with pytest.raises(mp4.Mp4Error, match=why):
        mp4.demux(data)
    if case.endswith(".mp4"):
        assert cv2.VideoCapture(os.path.join(DATA, case)).isOpened() == (
            "fragmented" in case)   # FFmpeg plays fragments; the demuxer refuses them


@pytest.mark.parametrize("name", VIDEOS + ["fragmented_160x96.mp4", "audio_only.mp4"])
def test_video_reader_names_the_codec_and_frames(name):
    """Every video file opens (H.264 and mp4v: tests/test_torch_h264*.py and
    tests/test_torch_mpeg4.py hold their frames); the fragmented and
    audio-only files name why they do not."""
    r = VideoReader(os.path.join(DATA, name))
    if name in VIDEOS:   # H.264 and mp4v: decoded
        assert r.is_opened() and r.reason == ""
        assert r.frame_count == mp4.read(os.path.join(DATA, name)).frame_count
        assert r.frame_count == 48 or name != "baseline_160x96.mp4"
        ok, frame = r.read()
        assert ok and frame.shape == (96, 160, 3)
        return
    assert not r.is_opened() and r.frame_count == 0 and r.read() == (False, None)
    assert "unreadable mp4/mov" in r.reason


def test_discard_flag_marks_the_sample_past_the_edit_list():
    """x264's Baseline and High files end their edit list at the last
    sample's time: libavformat flags that sample discarded (cv2 reads 47 of
    48 frames); the mov and mp4v files have no such sample."""
    for name in VIDEOS:
        track = mp4.demux(_data(name))
        flags = [p[5] for p in RECORDS[name]["libavformat"]["packets"]]
        assert track.discard.tolist() == [bool(f) for f in flags]
        last = [int(np.argmax(track.pts))]   # the last picture (in decode order 45 of High)
        assert np.flatnonzero(track.discard).tolist() == (
            last if name in ("baseline_160x96.mp4", "high_160x96.mp4") else [])


def test_is_iso_bmff():
    assert all(mp4.is_iso_bmff(_data(n)[:8]) for n in RECORDS)
    with open(os.path.join(os.path.dirname(DATA), "torch_jpeg", "tiny_33x17_q85_420.jpg"),
              "rb") as fh:
        assert not mp4.is_iso_bmff(fh.read(8))
    assert not mp4.is_iso_bmff(b"RIFF\x00\x00\x00\x00AVI ")


def test_frame_rate_reduction_equals_libavutil():
    """The fps is libavformat's average frame rate, reduced by av_reduce
    to terms within INT_MAX: the port's reduction against libavutil's on
    seeded pairs, most past that limit."""
    lib = ctypes.CDLL("libavutil.so.57")
    lib.av_reduce.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int64] * 3
    rng = np.random.default_rng(16)
    pairs = [(90000 * 100003, 3600270000), (12800 * 48, 24064)] + [
        (int(a), int(b)) for bits in (31, 40, 62)
        for a, b in zip(rng.integers(1, 2 ** bits, 300), rng.integers(1, 2 ** bits, 300))]
    for num, den in pairs:
        n, d = ctypes.c_int(), ctypes.c_int()
        lib.av_reduce(ctypes.byref(n), ctypes.byref(d), num, den, 2 ** 31 - 1)
        assert mp4._av_reduce(num, den) == (n.value, d.value), (num, den)
