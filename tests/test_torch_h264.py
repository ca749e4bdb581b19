"""The port's H.264 Constrained Baseline decode (utils/h264.py,
csrc/h264.cpp, csrc/yuv2bgr.cpp) and VideoReader on mp4, against what the
JAX package reads through cv2.VideoCapture: the fixtures of
tests/data/torch_h264 (tools/make_torch_h264_fixtures.py, x264 through the
system FFmpeg) and the Baseline file of tests/data/torch_mp4.

- the conversion against the libswscale that cv2 5.0 bundles (FFmpeg 8.0,
  libswscale 9.5), called through ctypes as cv2 calls it (sws_getContext
  at the same size, SWS_BICUBIC, then the frame's colour space and range):
  every (Y, U, V) triple as a 2x2 luma block, under each matrix and range,
  and random planes at every fixture's coded width;
- every picture's Y, U and V planes against the system libavcodec's
  (digests.json "yuv"), discarded pictures included;
- every frame VideoReader reads, sequentially and after seek(i) for every i
  from 0 to the frame count, against cv2.VideoCapture's (digests.json, and
  cv2 itself on the 160x96 file), with cv2's landing one frame early past
  frame 40 of the 25.53 fps files and its count of 47 reads of 48 frames;
- the refusals: High mp4 and mov (CABAC), interlaced mp4v, a fragmented file, an
  audio-only one, and a damaged slice, which stops the reader; an avc3
  track judged by the parameter sets of its first sample;
- hand-built streams (tests/torch_h264_streams.py) that reach what x264
  never writes (I_PCM, reference list modification, MMCO 1-6, long-term
  references, non-reference pictures, POC types 0 and 1) against
  cv2.VideoCapture on the raw .h264 file, frame for frame; an SPS that
  changes the picture size before a P picture, and a P slice in an IDR
  picture, refused.
Torch stays on one thread (it is not used here; the pin keeps the module
in line with the other video tests).
"""

import ctypes
import dataclasses
import glob
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
with open(os.path.join(DATA, "torch_h264", "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["files"]
FIXTURES = sorted(DIGESTS)


def _path(key: str) -> str:
    return os.path.join(DATA, key if "/" in key else os.path.join("torch_h264", key))


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _digest(frame):
    return None if frame is None else {"sha256": _sha(frame), "shape": list(frame.shape)}


# ----------------------------------------------------------- conversion

_SWS_BICUBIC, _YUV420P, _BGR24 = 4, 0, 3


@pytest.fixture(scope="module")
def sws():
    """The libswscale cv2 bundles."""
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), os.pardir,
                                  "opencv_python.libs", "libswscale-*.so*"))
    assert libs, "cv2's bundled libswscale"
    lib = ctypes.CDLL(libs[0])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sws_getContext.restype = P
    lib.sws_getContext.argtypes = [I] * 6 + [I, P, P, P]
    lib.sws_getCoefficients.restype = P
    lib.sws_getCoefficients.argtypes = [I]
    lib.sws_setColorspaceDetails.argtypes = [P, P, I, P, I, I, I, I]
    lib.sws_scale.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(I), I, I,
                              ctypes.POINTER(P), ctypes.POINTER(I)]
    lib.sws_freeContext.argtypes = [P]
    assert lib.swscale_version() >> 16 == 9
    return lib


def _sws_convert(lib, y, u, v, matrix, full_range, stride):
    """sws_scale as cv2 5.0 calls it, into rows of `stride` bytes."""
    h, w = y.shape
    ctx = lib.sws_getContext(w, h, _YUV420P, w, h, _BGR24, _SWS_BICUBIC, None, None, None)
    lib.sws_setColorspaceDetails(ctx, lib.sws_getCoefficients(matrix), full_range,
                                 lib.sws_getCoefficients(5), 1, 0, 1 << 16, 1 << 16)
    out = np.zeros(h * stride + 64, np.uint8)
    P = ctypes.c_void_p
    src = (P * 4)(y.ctypes.data, u.ctypes.data, v.ctypes.data, None)
    sst = (ctypes.c_int * 4)(y.strides[0], u.strides[0], v.strides[0], 0)
    dst = (P * 4)(out.ctypes.data, None, None, None)
    dstst = (ctypes.c_int * 4)(stride, 0, 0, 0)
    lib.sws_scale(ctx, src, sst, 0, h, dst, dstst)
    lib.sws_freeContext(ctx)
    return out[:h * stride].reshape(h, stride)[:, :3 * w].reshape(h, w, 3)


@pytest.mark.parametrize("matrix, full_range", [(2, 0), (1, 0), (5, 1), (1, 1), (4, 0),
                                                (7, 0), (9, 1)])
def test_conversion_equals_libswscale_on_every_triple(sws, matrix, full_range):
    """All 2^24 (Y, U, V) triples, 16 Y values a pass: chroma (U, V) on a
    256 x 256 grid, each sample under a 2x2 luma block of one Y."""
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                         indexing="ij")
    u = np.ascontiguousarray(np.tile(uu, (1, 16)))
    v = np.ascontiguousarray(np.tile(vv, (1, 16)))
    for base in range(0, 256, 16):
        ycol = np.repeat(np.arange(base, base + 16, dtype=np.uint8), 512)  # 2 x 256 per value
        y = np.ascontiguousarray(np.broadcast_to(ycol, (512, ycol.size)))
        want = _sws_convert(sws, y, u, v, matrix, full_range, 3 * y.shape[1])
        got = h264.yuv420_to_bgr(y, u, v, matrix, full_range)
        assert np.array_equal(got, want), (matrix, full_range, base)


@pytest.mark.parametrize("key", FIXTURES)
def test_conversion_equals_libswscale_at_the_fixture_widths(sws, key):
    """Random planes at the fixture's coded size, converted into cv2's
    buffer (its rows 32-byte aligned), cropped to the picture."""
    rec = DIGESTS[key]
    w, h = int(rec["width"]), int(rec["height"])
    cw, ch = -(-w // 16) * 16, -(-h // 16) * 16
    rng = np.random.default_rng(w * 7 + h)
    y = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (ch // 2, cw // 2), dtype=np.uint8) for _ in range(2))
    want = _sws_convert(sws, y, u, v, 2, 0, -(-3 * cw // 32) * 32)[:h, :w]
    got = h264.yuv420_to_bgr(y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2])
    assert np.array_equal(got, want)


# ------------------------------------------------------------- decoding

def _decode_all(key):
    """Every picture of the file, discarded ones included: [(pts, [Y, U, V])]."""
    with open(_path(key), "rb") as fh:
        data = fh.read()
    track = mp4.demux(data)
    dec = h264.Decoder(track.avc.nal_length_size, track.avc.sps + track.avc.pps)
    out = []
    for i in range(len(track.sizes)):
        off = int(track.offsets[i])
        dec.decode(data[off:off + int(track.sizes[i])], int(track.pts[i]))
        while dec.peek() is not None:
            pts = dec.peek().pts
            out.append((pts, dec.take(bgr=False, planes=True)[1]))
    dec.drain()
    while dec.peek() is not None:
        pts = dec.peek().pts
        out.append((pts, dec.take(bgr=False, planes=True)[1]))
    return track, out


@pytest.mark.parametrize("key", FIXTURES)
def test_planes_equal_libavcodec(key):
    track, got = _decode_all(key)
    want = DIGESTS[key]["yuv"]
    assert [p for p, _ in got] == [e["pts"] for e in want]
    for (pts, planes), e in zip(got, want):
        assert [_sha(p) for p in planes] == [e["y"], e["u"], e["v"]], pts
    # the packets libavformat flags discarded are the demuxer's
    assert [e["discarded"] for e in want] == track.discard.tolist()


def test_in_band_parameter_sets_and_emulation_prevention():
    """avc3-style input: no parameter sets up front, the SPS and PPS
    inside the first sample (and again before the IDR of sample 12), an
    AUD, a filler and an SEI that are skipped; the planes are the same.
    The fixtures' slices hold emulation-prevention bytes."""
    key = "cb_640x360.mp4"
    with open(_path(key), "rb") as fh:
        data = fh.read()
    track = mp4.demux(data)

    def nal(b: bytes) -> bytes:
        return len(b).to_bytes(4, "big") + b

    params = b"".join(nal(p) for p in track.avc.sps + track.avc.pps)
    extra = nal(b"\x09\xf0") + nal(b"\x0c\xff\xff\x80") + nal(b"\x06\x05\x01\x00\x80")
    dec = h264.Decoder(track.avc.nal_length_size)
    got, escapes = [], 0
    for i in range(len(track.sizes)):
        off = int(track.offsets[i])
        sample = data[off:off + int(track.sizes[i])]
        escapes += sample.count(b"\x00\x00\x03")
        if i in (0, 12):
            sample = extra + params + sample
        dec.decode(sample, int(track.pts[i]))
        while dec.peek() is not None:
            got.append(dec.take(bgr=False, planes=True)[1])
    want = DIGESTS[key]["yuv"]
    assert len(got) == len(want) and escapes > 0
    for planes, e in zip(got, want):
        assert [_sha(p) for p in planes] == [e["y"], e["u"], e["v"]]


@pytest.mark.parametrize("key", FIXTURES)
def test_frames_equal_cv2_read_sequentially(key):
    rec = DIGESTS[key]
    r = VideoReader(_path(key))
    assert r.is_opened(), r.reason
    assert (r.frame_count, r.fps) == (rec["frame_count"], rec["fps"])
    got = []
    while True:
        ok, frame = r.read()
        if not ok:
            assert frame is None
            break
        got.append(_digest(frame))
    assert got == rec["read"]
    assert r.read() == (False, None) and r.reason == ""


@pytest.mark.parametrize("key", FIXTURES)
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


def test_cv2_lands_one_frame_early_past_frame_40():
    """The 160x96 Baseline file: CAP_PROP_FPS is 1200/47 (48 frames over
    the edit list's 1.88 s), the frames are 1/25 s apart; cv2 reads 47
    frames, and seek(i) lands on frame i - 1 for i = 41..47, on nothing at
    48. The port's reader against cv2 itself."""
    path = _path("torch_mp4/baseline_160x96.mp4")
    cap = cv2.VideoCapture(path)
    seq = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        seq.append(_sha(frame))
    cap.release()
    assert len(seq) == 47
    r = VideoReader(path)
    assert r.frame_count == 48 and r.fps == 1200 / 47
    assert [_sha(r.read()[1]) for _ in range(47)] == seq and r.read() == (False, None)
    for i in list(range(38, 49)):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, frame = cap.read()
        cap.release()
        r = VideoReader(path)
        r.seek(i)
        got = r.read()[1]
        if i == 48:
            assert not ok and got is None
            continue
        assert _sha(got) == _sha(frame) == seq[i - 1 if i >= 41 else i], i


@pytest.mark.parametrize("name, why", [
    ("../torch_h264_high/hi_mbaff_160x96.mp4",
     r"High profile \(profile_idc 100\) with field or MBAFF coding"),
    ("../torch_h264_high/hi422_160x96.mp4",
     r"High 4:2:2 profile \(profile_idc 122\) with 4:2:2 chroma"),
    ("../torch_mpeg4/interlaced_160x96.mp4", r"MPEG-4 Part 2 \(mp4v\): interlaced coding"),
    ("fragmented_160x96.mp4", "fragmented"),
    ("audio_only.mp4", "no video track")])
def test_refusals_name_the_profile_or_codec(name, why):
    path = os.path.join(DATA, "torch_mp4", name)
    r = VideoReader(path)
    assert not r.is_opened() and r.read() == (False, None)
    assert re.search(why, r.reason), r.reason
    if name.endswith(("mp4", "mov")) and "frag" not in name and "audio" not in name:
        assert f"{mp4.read(path).frame_count} frames" in r.reason


def test_b_frames_are_refused_by_their_order():
    """B-frames are no longer refused by their order: a track whose
    presentation times go back in decode order opens, with no reason, and
    reads the frames cv2 reads (tests/test_torch_h264_high.py holds every
    frame)."""
    path = os.path.join(DATA, "torch_h264_high", "hi_640x360.mp4")
    track = mp4.read(path)
    assert np.any(np.diff(track.pts) < 0)
    r = VideoReader(path)
    assert r.is_opened() and r.reason == ""
    with open(os.path.join(DATA, "torch_h264_high", "digests.json")) as fh:
        want = json.load(fh)["files"]["hi_640x360.mp4"]["read"]
    assert [_digest(r.read()[1]) for _ in range(3)] == want[:3]


def test_a_damaged_slice_stops_the_reader(tmp_path):
    """Sixteen zero bytes in the middle of the 640x360 file's sixth sample:
    five frames read as cv2 reads them, then (False, None), and the reason
    names the sample and the macroblock. (FFmpeg conceals the damage.)"""
    key = "cb_640x360.mp4"
    with open(_path(key), "rb") as fh:
        data = bytearray(fh.read())
    track = mp4.demux(bytes(data))
    at = int(track.offsets[5]) + int(track.sizes[5]) // 2
    data[at:at + 16] = bytes(16)
    path = tmp_path / "damaged.mp4"
    path.write_bytes(bytes(data))
    r = VideoReader(str(path))
    assert r.is_opened()
    got = [_digest(r.read()[1]) for _ in range(5)]
    assert got == DIGESTS[key]["read"][:5]
    assert r.read() == (False, None)
    assert r.reason.startswith("damaged H.264 stream: sample 5, macroblock"), r.reason
    assert r.read() == (False, None)
    r.seek(0)
    assert r.read() == (False, None)


def test_parameter_set_refusals_name_the_feature():
    """The SPS / PPS features the decoder refuses, each by name, from
    hand-built parameter sets (Exp-Golomb writer below)."""

    def bits_to_nal(header: int, bits: str) -> bytes:
        bits += "1"
        bits += "0" * (-len(bits) % 8)
        return bytes([header]) + bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))

    def ue(v: int) -> str:
        b = bin(v + 1)[2:]
        return "0" * (len(b) - 1) + b

    def se(v: int) -> str:
        return ue(2 * v - 1 if v > 0 else -2 * v)

    def sps(profile=66, frame_mbs_only=1, gaps=0, chroma=1, depth=0, bypass=0) -> bytes:
        s = f"{profile:08b}" + "11000000" + f"{30:08b}" + ue(0)
        if profile in (100, 244):
            s += ue(chroma) + ("0" if chroma == 3 else "") + ue(depth) + ue(depth)
            s += str(bypass) + "0"
        s += ue(0) + ue(2) + ue(1) + str(gaps) + ue(9) + ue(5) + str(frame_mbs_only)
        if not frame_mbs_only:
            s += "0"
        s += "1" + "0" + "0"
        return bits_to_nal(0x67, s)

    def pps(cabac=0, groups=0, weighted=0, redundant=0, t8=None) -> bytes:
        s = ue(0) + ue(0) + str(cabac) + "0" + ue(groups)
        if not groups:
            s += ue(0) + ue(0) + str(weighted) + "00" + se(0) + se(0) + se(0) + "1" + "0"
            s += str(redundant)
            if t8 is not None:
                s += str(t8) + "0" + se(0)
        return bits_to_nal(0x68, s)

    # CABAC, weighted prediction and the 8x8 transform decode (Main and High)
    cases = [(sps(), pps(), ""),
             (sps(), pps(cabac=1), ""),
             (sps(), pps(groups=1), "slice groups (FMO)"),
             (sps(), pps(weighted=1), ""),
             (sps(), pps(redundant=1), "redundant pictures"),
             (sps(profile=100), pps(t8=1), ""),
             (sps(frame_mbs_only=0), pps(), "field or MBAFF"),
             (sps(gaps=1), pps(), "gaps in frame_num"),
             (sps(profile=100, chroma=2), pps(t8=0), "4:2:2 chroma"),
             (sps(profile=100, chroma=0), pps(t8=0), "4:0:0 (monochrome) chroma"),
             (sps(profile=244, chroma=3), pps(t8=0), "4:4:4 chroma"),
             (sps(profile=100, bypass=1), pps(t8=0), "lossless transform bypass"),
             (sps(profile=100, depth=2), pps(t8=0), "bit depth above 8")]
    for s, p, why in cases:
        reason = h264.Decoder(4, [s, p]).unsupported()
        assert (why in reason) if why else reason == "", (why, reason)
        if why:
            assert "profile_idc" in reason


def test_avc3_first_sample_parameter_sets_decide(tmp_path, monkeypatch):
    """An avc3 track whose avcC holds no parameter sets is judged by those
    of its first sample: the MBAFF file stays unopened with its profile and
    feature named, the High and Baseline ones open and read cv2's frames. An
    MBAFF SPS inside a later sample stops the reader as unsupported, not
    damaged."""
    from real_time_video_deepfake_detection_tpu_torch.utils import video
    demux = mp4.demux
    with open(_path("torch_h264_high/hi_mbaff_160x96.mp4"), "rb") as fh:
        mbaff_params = demux(fh.read()).avc
    with open(os.path.join(DATA, "torch_h264_high", "digests.json")) as fh:
        high_read = json.load(fh)["files"]["torch_mp4/high_160x96.mp4"]["read"]

    def avc3_file(src, name, extra=None):
        """src's bytes with its first sample (the parameter sets in front)
        appended, and sample `extra[0]` replaced by extra[1] in front of it;
        the demuxer's track for that file as an avc3 one."""
        with open(_path(src), "rb") as fh:
            data = fh.read()
        track = demux(data)
        n = track.avc.nal_length_size
        samples = {0: hs.length_prefixed(track.avc.sps + track.avc.pps, n)}
        if extra:
            samples[extra[0]] = hs.length_prefixed(extra[1], n)
        offsets, sizes = track.offsets.copy(), track.sizes.copy()
        tail = b""
        for i, head in samples.items():
            off, size = int(track.offsets[i]), int(track.sizes[i])
            offsets[i], sizes[i] = len(data) + len(tail), len(head) + size
            tail += head + data[off:off + size]
        path = tmp_path / name
        path.write_bytes(data + tail)
        fake = dataclasses.replace(track, codec="avc3", offsets=offsets, sizes=sizes,
                                   avc=dataclasses.replace(track.avc, sps=[], pps=[]))
        return str(path), fake

    for src, name, extra in (("torch_h264_high/hi_mbaff_160x96.mp4", "mbaff.mp4", None),
                             ("torch_mp4/high_160x96.mp4", "high.mp4", None),
                             ("torch_mp4/baseline_160x96.mp4", "base.mp4", None),
                             ("torch_mp4/baseline_160x96.mp4", "mixed.mp4",
                              (3, mbaff_params.sps + mbaff_params.pps))):
        path, fake = avc3_file(src, name, extra)
        monkeypatch.setattr(video.mp4, "demux", lambda data, fake=fake: fake)
        r = VideoReader(path)
        if name == "mbaff.mp4":
            assert not r.is_opened() and r.read() == (False, None)
            assert re.search(r"High profile \(profile_idc 100\) with field or MBAFF", r.reason), \
                r.reason
            assert "6 frames" in r.reason
            continue
        assert r.is_opened(), r.reason
        got = []
        while True:
            ok, frame = r.read()
            if not ok:
                break
            got.append(_digest(frame))
        want = DIGESTS["torch_mp4/baseline_160x96.mp4"]["read"]
        if name == "high.mp4":
            assert got == high_read and r.reason == ""
        elif name == "base.mp4":
            assert got == want and r.reason == ""
        else:
            assert got == want[:3], len(got)
            assert r.reason.startswith("unsupported H.264 stream: High profile (profile_idc 100) "
                                       "with field or MBAFF"), r.reason


# ------------------------------------------------------- hand-built streams

_STREAMS = {"poc2": hs.Params(poc_type=2, num_ref_frames=4),
            "poc0": hs.Params(poc_type=0, num_ref_frames=3, num_ref_idx_default=2),
            "poc1": hs.Params(poc_type=1, num_ref_frames=5, chroma_qp_offset=-3)}
_SEEDS = (1, 2, 3)


def _port_frames(parameter_sets, pictures):
    """The port's BGR frames of a hand-built stream, fed one picture a sample."""
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
def test_hand_built_streams_equal_cv2(tmp_path, name, seed):
    """48 pictures of I_PCM, Intra 16x16, P_Skip and P partitions under
    random list modifications, MMCOs and long-term references: the port's
    frames equal cv2.VideoCapture's on the raw .h264 file, frame for frame
    (cv2 conceals what it cannot decode, so a stream it misread would not
    match either)."""
    parameter_sets, pictures, _ = hs.random_stream(seed, _STREAMS[name], 48)
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
    assert len(want) == len(got) == 48
    for i, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), i
    # the pictures move: no two in a row are equal
    assert all(not np.array_equal(a, b) for a, b in zip(got, got[1:]))


def test_hand_built_streams_reach_every_feature():
    """Over the streams above: every MMCO 1-6, every list modification idc,
    IDRs with long_term_reference_flag, predictions from long-term and from
    moved list entries, I_PCM and Intra 16x16 in I and P slices, every P
    partition, non-reference pictures."""
    total = hs.Stats()
    for name, params in _STREAMS.items():
        for seed in _SEEDS:
            st = hs.random_stream(seed, params, 48)[2]
            for k in total.mmco:
                total.mmco[k] += st.mmco[k]
            for k in total.modification:
                total.modification[k] += st.modification[k]
            for k, v in st.partitions.items():
                total.partitions[k] = total.partitions.get(k, 0) + v
            for f in ("idr_long_term", "long_term_predictions", "reordered_predictions", "pcm",
                      "i16", "skip", "non_ref", "pictures"):
                setattr(total, f, getattr(total, f) + getattr(st, f))
    assert min(total.mmco.values()) >= 10, total.mmco
    assert min(total.modification.values()) >= 50, total.modification
    assert total.idr_long_term >= 5 and total.non_ref >= 30
    assert total.long_term_predictions >= 1000 and total.reordered_predictions >= 1000
    assert total.pcm >= 1000 and total.i16 >= 1000 and total.skip >= 1000
    assert sorted(total.partitions) == ["16x16", "16x8", "8x16", "8x8", "8x8ref0"]


def test_a_new_picture_size_before_a_p_picture_is_refused():
    """An in-band SPS that reuses the active id with another picture size
    before a P picture: refused, never decoded against references of the
    old size; at an IDR the new size decodes as the stream alone does."""
    small, large = hs.Params(mbw=4, mbh=3), hs.Params(mbw=9, mbh=6)
    ps_small, pics_small, _ = hs.random_stream(1, small, 6)
    ps_large, pics_large, _ = hs.random_stream(1, large, 6)
    # the large P picture's header parses against the small IDR alone (its
    # list names frame 0 only), so its macroblocks would read that picture
    assert pics_large[1][0][0] & 31 == 1
    dec = h264.Decoder(4, ps_small)
    dec.decode(hs.length_prefixed(pics_small[0]), 0)
    with pytest.raises(h264.H264Error, match="a new SPS on a non-IDR picture"):
        dec.decode(hs.length_prefixed([ps_large[0]] + pics_large[1]), 1)
    # the same SPS in front of an IDR picture: the large stream's frames
    joined = [ps_large + pics_large[0]] + pics_large[1:]
    want = _port_frames(ps_large, pics_large)
    got = _port_frames(ps_small, pics_small + joined)
    assert len(got) == 12 and all(np.array_equal(a, b) for a, b in zip(got[6:], want))


def test_a_p_slice_in_an_idr_picture_is_refused():
    ps, pics, _ = hs.random_stream(9, hs.Params(mbw=4, mbh=3), 3)
    dec = h264.Decoder(4, ps)
    dec.decode(hs.length_prefixed(pics[0]), 0)
    p_as_idr = [bytes([0x65]) + n[1:] for n in pics[1]]
    with pytest.raises(h264.H264Error, match="a P slice in an IDR picture"):
        dec.decode(hs.length_prefixed(p_as_idr), 1)
