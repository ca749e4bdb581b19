"""The port's H.264 Main and High decode (csrc/h264.cpp through utils/h264.py
and utils/video.VideoReader) against what the JAX package reads through
cv2.VideoCapture: the x264 fixtures of tests/data/torch_h264_high
(tools/make_torch_h264_high_fixtures.py: CABAC and CAVLC, B-pyramid none,
normal and strict, sixteen B-frames, spatial and temporal direct, explicit
weighted P, implicit and default B weights, the 8x8 transform, cqm=jvt,
four slices, partitions=all, qp=4, an open GOP, Main profile, 1920x1080,
1080x1920 and 30000/1001 fps) and the High files of tests/data/torch_mp4.

- every picture's Y, U and V planes against the system libavcodec's
  (digests.json "yuv"), in its output order;
- every frame VideoReader reads, sequentially and after seek(i) for every i
  from 0 to the frame count (the small files), against cv2's digests, and
  against cv2.VideoCapture itself on some files;
- the refusals: MBAFF and 4:2:2 files, and 4:0:0, 4:4:4, bit depths above
  8 and transform bypass through a hand-built SPS in front of a real
  track, each naming the feature and the frame count;
- a damaged CABAC slice and a damaged B slice stop the reader with a
  reason that names the sample and the macroblock; an in-band SPS that
  reuses the active id at another size before a B picture is refused;
- hand-built High streams (tests/torch_h264_streams.random_high_stream)
  with what x264 never writes: explicit B weights, implicit weights with
  long-term references, B lists with modification commands and long-term
  entries, scaling lists that fall back by rules A and B, and B pictures
  out of output order in a stream without a VUI; each against
  cv2.VideoCapture on the raw .h264 file, frame for frame.
Torch stays on one thread (it is not used here; the pin keeps the module
in line with the other video tests).
"""

import dataclasses
import hashlib
import json
import os
import re

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu_torch.utils import h264, mp4
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader

from tests import torch_h264_streams as hs
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
HIGH = os.path.join(DATA, "torch_h264_high")
with open(os.path.join(HIGH, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["files"]
FIXTURES = sorted(k for k, r in DIGESTS.items() if not r.get("refused"))
# the 1080p files are read in sequence only: their seek sweeps would cost a minute
SEEKED = [k for k in FIXTURES if "1920" not in k]


def _path(key: str) -> str:
    return os.path.join(DATA, key) if "/" in key else os.path.join(HIGH, key)


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _digest(frame):
    return None if frame is None else {"sha256": _sha(frame), "shape": list(frame.shape)}


def _read_all(reader):
    out = []
    while True:
        ok, frame = reader.read()
        if not ok:
            assert frame is None
            return out
        out.append(frame)


def test_fixtures_cover_main_and_high():
    """The fixtures' parameter sets: CABAC and CAVLC, weighted P and both
    bi-prediction modes, the 8x8 transform and a scaling matrix, Main and
    High, B-frames out of decode order."""
    seen = set()
    for key in FIXTURES:
        track = mp4.read(_path(key))
        dec = h264.Decoder(track.avc.nal_length_size, track.avc.sps + track.avc.pps)
        assert dec.unsupported() == ""
        seen.add(("profile", track.avc.profile))
        seen.add(("b_frames", bool(np.any(np.diff(track.pts) < 0))))
        pps = hs.BitReader(track.avc.pps[0][1:])
        pps.ue(), pps.ue()
        seen.add(("cabac", pps.u(1)))
        pps.u(1), pps.ue(), pps.ue(), pps.ue()
        seen.add(("weighted_pred", pps.u(1)))
        seen.add(("weighted_bipred_idc", pps.u(2)))
        pps.se(), pps.se(), pps.se(), pps.u(3)
        if track.avc.profile == 100:
            seen.add(("transform_8x8", pps.u(1)))
            seen.add(("pic_scaling_matrix", pps.u(1)))
    for want in [("profile", 77), ("profile", 100), ("b_frames", True), ("b_frames", False),
                 ("cabac", 0), ("cabac", 1), ("weighted_pred", 1), ("weighted_bipred_idc", 0),
                 ("weighted_bipred_idc", 2), ("transform_8x8", 1), ("pic_scaling_matrix", 1)]:
        assert want in seen, want


# ------------------------------------------------------------- decoding

@pytest.mark.parametrize("key", FIXTURES)
def test_planes_equal_libavcodec(key):
    with open(_path(key), "rb") as fh:
        data = fh.read()
    track = mp4.demux(data)
    dec = h264.Decoder(track.avc.nal_length_size, track.avc.sps + track.avc.pps)
    got = []

    def take():
        while dec.peek() is not None:
            pts = dec.peek().pts
            got.append((pts, dec.take(bgr=False, planes=True)[1]))

    for i in range(len(track.sizes)):
        off = int(track.offsets[i])
        dec.decode(data[off:off + int(track.sizes[i])], int(track.pts[i]))
        take()
    dec.drain()
    take()
    want = DIGESTS[key]["yuv"]
    assert [p for p, _ in got] == [e["pts"] for e in want]
    for (pts, planes), e in zip(got, want):
        assert [_sha(p) for p in planes] == [e["y"], e["u"], e["v"]], pts
    assert [e["discarded"] for e in want] == [bool(track.discard[list(track.pts).index(e["pts"])])
                                              for e in want]


@pytest.mark.parametrize("key", FIXTURES)
def test_frames_equal_cv2_read_sequentially(key):
    rec = DIGESTS[key]
    r = VideoReader(_path(key))
    assert r.is_opened(), r.reason
    assert (r.frame_count, r.fps) == (rec["frame_count"], rec["fps"])
    assert [_digest(f) for f in _read_all(r)] == rec["read"]
    assert r.read() == (False, None) and r.reason == ""


@pytest.mark.parametrize("key", SEEKED)
def test_frames_equal_cv2_at_every_seek(key):
    """seek(i) then read(), i from 0 to the frame count, each on a fresh
    reader as the digests were taken; then seeks on one reader, back and
    forth."""
    rec = DIGESTS[key]
    for i, want in enumerate(rec["seek"]):
        r = VideoReader(_path(key))
        r.seek(i)
        ok, frame = r.read()
        assert _digest(frame) == want, i
        assert ok == (want is not None)
    r = VideoReader(_path(key))
    n = int(rec["frame_count"])
    for i in (n // 2, 1, n, 0, n - 1, 2):
        r.seek(i)
        assert _digest(r.read()[1]) == rec["seek"][i], i


@pytest.mark.parametrize("key", ["hi_640x360.mp4", "hi_temporal_320x180.mp4",
                                 "hi_cavlc_320x180.mp4", "main_256x144.mp4"])
def test_frames_equal_cv2_itself(key):
    """cv2.VideoCapture live, read in sequence and after the seeks where
    libavformat's min_corrected_pts moves its landing (B-frame files start
    at a negative dts: cv2 lands on frame i there, where the Baseline
    files' arithmetic lands one early)."""
    path = _path(key)
    cap = cv2.VideoCapture(path)
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame)
    cap.release()
    got = _read_all(VideoReader(path))
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    n = len(want)
    for i in sorted({n // 2, n - 9, n - 8, n - 7, n - 1}):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, frame = cap.read()
        cap.release()
        r = VideoReader(path)
        r.seek(i)
        got_ok, got = r.read()
        assert got_ok == ok and np.array_equal(got, frame), i


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("name, why", [
    ("hi_mbaff_160x96.mp4", r"High profile \(profile_idc 100\) with field or MBAFF coding"),
    ("hi422_160x96.mp4", r"High 4:2:2 profile \(profile_idc 122\) with 4:2:2 chroma")])
def test_refused_files_name_the_feature_and_frames(name, why):
    r = VideoReader(os.path.join(HIGH, name))
    assert not r.is_opened() and r.read() == (False, None)
    assert re.search(why, r.reason), r.reason
    assert f"{int(DIGESTS[name]['frame_count'])} frames" in r.reason


def _sps(profile: int, chroma: int, depth: int, bypass: int) -> bytes:
    """A High-family SPS of a 640x368 picture (the 640x360 track's size)."""
    w = hs.BitWriter()
    w.u(8, profile)
    w.u(8, 0)
    w.u(8, 40)
    w.ue(0)
    w.ue(chroma)
    if chroma == 3:
        w.u(1, 0)
    w.ue(depth)
    w.ue(depth)
    w.u(1, bypass)
    w.u(1, 0)
    w.ue(0)
    w.ue(0)
    w.ue(4)
    w.ue(4)
    w.u(1, 0)
    w.ue(39)
    w.ue(22)
    w.u(1, 1)
    w.u(1, 1)
    w.u(1, 0)
    w.u(1, 0)
    return hs.nal(3, 7, w.rbsp())


@pytest.mark.parametrize("profile, chroma, depth, bypass, why", [
    (100, 0, 0, 0, r"High profile \(profile_idc 100\) with 4:0:0 \(monochrome\) chroma"),
    (244, 3, 0, 0, r"High 4:4:4 Predictive profile \(profile_idc 244\) with 4:4:4 chroma"),
    (110, 1, 2, 0, r"High 10 profile \(profile_idc 110\) with a bit depth above 8"),
    (244, 1, 0, 1, r"High 4:4:4 Predictive profile \(profile_idc 244\) with lossless "
                   r"transform bypass")])
def test_hand_built_sps_refusals_name_the_feature_and_frames(monkeypatch, profile, chroma, depth,
                                                             bypass, why):
    """The 640x360 track with its SPS replaced: unopened, the profile,
    feature and frame count named."""
    from real_time_video_deepfake_detection_tpu_torch.utils import video
    path = os.path.join(HIGH, "hi_640x360.mp4")
    demux = mp4.demux
    with open(path, "rb") as fh:
        track = demux(fh.read())
    fake = dataclasses.replace(track, avc=dataclasses.replace(
        track.avc, sps=[_sps(profile, chroma, depth, bypass)]))
    monkeypatch.setattr(video.mp4, "demux", lambda data: fake)
    r = VideoReader(path)
    assert not r.is_opened() and r.read() == (False, None)
    assert re.search(why, r.reason), r.reason
    assert "48 frames" in r.reason


@pytest.mark.parametrize("key, sample", [("hi_640x360.mp4", 1), ("hi_cavlc_320x180.mp4", 2)])
def test_a_damaged_cabac_or_b_slice_stops_the_reader(tmp_path, key, sample):
    """Sixteen zero bytes in the middle of a sample: a CABAC P slice of
    the 640x360 file, a CAVLC B slice of the 320x180 one. The frames before
    read as cv2 reads them, then (False, None), and the reason names the
    sample and the macroblock. (FFmpeg conceals the damage.)"""
    with open(_path(key), "rb") as fh:
        data = bytearray(fh.read())
    track = mp4.demux(bytes(data))
    if "cavlc" in key:   # a B picture: decoded after a later one
        assert track.pts[sample] < track.pts[sample - 1]
    at = int(track.offsets[sample]) + int(track.sizes[sample]) // 2
    data[at:at + 16] = bytes(16)
    path = tmp_path / "damaged.mp4"
    path.write_bytes(bytes(data))
    r = VideoReader(str(path))
    assert r.is_opened()
    got = [_digest(f) for f in _read_all(r)]
    assert got == DIGESTS[key]["read"][:len(got)] and len(got) < len(DIGESTS[key]["read"])
    assert re.match(rf"damaged H\.264 stream: sample {sample}[,:] macroblock \d+", r.reason), \
        r.reason
    assert r.read() == (False, None)


def test_a_new_picture_size_before_a_b_picture_is_refused():
    """An in-band SPS that reuses the active id with another picture size
    in front of a B picture: refused, never decoded against references or a
    co-located picture of the old size."""
    small, large = hs.HighParams(mbw=4, mbh=3), hs.HighParams(mbw=9, mbh=6)
    ps_small, pics_small, _ = hs.random_high_stream(3, small, 8)
    ps_large, pics_large, _ = hs.random_high_stream(3, large, 8)
    k = next(i for i, nals in enumerate(pics_large)
             if any(n[0] & 31 == 1 and _slice_type(n) == 1 for n in nals))
    dec = h264.Decoder(4, ps_small)
    for i in range(k):
        dec.decode(hs.length_prefixed(pics_small[i]), i)
    with pytest.raises(h264.H264Error, match="a new SPS on a non-IDR picture"):
        dec.decode(hs.length_prefixed([ps_large[0]] + pics_large[k]), k)


def _slice_type(nal_unit: bytes) -> int:
    r = hs.BitReader(nal_unit[1:])
    r.ue()
    return r.ue() % 5


# ------------------------------------------------------- hand-built streams

_STREAMS = {
    # explicit weighted P and B, a VUI with the reorder depth
    "explicit": hs.HighParams(weighted_pred=True, weighted_bipred_idc=1, reorder=2),
    # implicit weights (long-term references fall back to 32/32), no VUI:
    # FFmpeg's reorder depth from the POCs
    "implicit_lt": hs.HighParams(weighted_bipred_idc=2, reorder=None, num_ref_frames=5),
    # PPS lists without SPS ones: absent lists fall back by rule A (the
    # defaults, or the list before), one the default by its flag
    "rule_a": hs.HighParams(pps_lists={0: [16 + 3 * k for k in range(16)], 2: None,
                                       3: [10 + k for k in range(16)],
                                       7: [8 + k // 2 for k in range(64)]}),
    # SPS and PPS lists: the PPS's absent lists fall back by rule B (the
    # SPS's), the SPS's own by rule A; no VUI
    "rule_b": hs.HighParams(sps_lists={0: [20 + k for k in range(16)], 1: None,
                                       3: [12 + 2 * k for k in range(16)],
                                       6: [9 + k // 3 for k in range(64)], 7: None},
                            pps_lists={1: [30 - k for k in range(16)], 4: [14] * 8 + [20] * 8},
                            reorder=None),
}
_SEEDS = (1, 2)


def _port_frames(parameter_sets, pictures):
    dec = h264.Decoder(4, parameter_sets)
    out = []
    for i, nals in enumerate(pictures):
        dec.decode(hs.length_prefixed(nals), i)
        while dec.peek() is not None:
            out.append(dec.take()[0])
    dec.drain()
    while dec.peek() is not None:
        out.append(dec.take()[0])
    return out


@pytest.mark.parametrize("seed", _SEEDS)
@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_hand_built_high_streams_equal_cv2(tmp_path, name, seed):
    """32 pictures in groups of up to three, the last of a group decoded
    first, with I, P and B slices (spatial direct, every B macroblock and
    sub-macroblock type, I_PCM, Intra 16x16, one-coefficient residuals in
    4x4 and 8x8 transforms and chroma DC): the port's frames equal
    cv2.VideoCapture's on the raw .h264 file, frame for frame, in number
    and order."""
    parameter_sets, pictures, stats = hs.random_high_stream(seed, _STREAMS[name], 32)
    path = tmp_path / f"{name}_{seed}.h264"
    path.write_bytes(hs.annex_b(parameter_sets, pictures))
    cap = cv2.VideoCapture(str(path))
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame)
    cap.release()
    got = _port_frames(parameter_sets, pictures)
    assert len(want) == len(got) == 32
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), i
    assert stats.out_of_order >= 8


def test_hand_built_high_streams_reach_every_feature():
    """Over the streams above: explicit bi-prediction, implicit weights with
    a long-term reference, modified B lists, long-term B references, direct
    prediction, 8x8 transforms, coefficients and pictures out of order."""
    total = hs.HighStats()
    for params in _STREAMS.values():
        for seed in _SEEDS:
            st = hs.random_high_stream(seed, params, 32)[2]
            for f in dataclasses.fields(total):
                setattr(total, f.name, getattr(total, f.name) + getattr(st, f.name))
    assert total.explicit_bi >= 300 and total.implicit_long_term >= 30
    assert total.b_modified_lists >= 60 and total.b_long_term_refs >= 100
    assert total.direct >= 100 and total.t8 >= 300 and total.coefficients >= 5000
    assert total.out_of_order >= 60 and total.b_slices >= 100


def test_scaling_lists_change_the_pictures():
    """The same stream under flat, rule A and rule B scaling lists: every
    picture differs (the residuals are scaled), and cv2 agrees with each
    (above)."""
    base = dataclasses.replace(_STREAMS["explicit"])
    flat = _port_frames(*hs.random_high_stream(1, base, 16)[:2])
    for name in ("rule_a", "rule_b"):
        params = dataclasses.replace(base, sps_lists=_STREAMS[name].sps_lists,
                                     pps_lists=_STREAMS[name].pps_lists)
        scaled = _port_frames(*hs.random_high_stream(1, params, 16)[:2])
        assert len(scaled) == len(flat) == 16
        assert all(not np.array_equal(a, b) for a, b in zip(scaled, flat)), name
