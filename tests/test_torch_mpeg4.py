"""The port's MPEG-4 Part 2 decode (csrc/mpeg4.cpp through utils/mpeg4.py
and utils/video.VideoReader) against what the JAX package reads through
cv2.VideoCapture: the fixtures of tests/data/torch_mpeg4
(tools/make_torch_mpeg4_fixtures.py: cv2.VideoWriter's mp4v files, as the
JAX analyzer writes its --output, at 640x360, 30000/1001 fps, 1920x1080,
1080x1920 and 202x114; the system libavcodec's mpeg4 encoder with 4MV, AC
prediction, resync markers, data partitioning, qscale 1 and 31, adaptive
quantisation, gop 1 and 300, one to three B-frames, MPEG quantisation with
default and custom matrices, quarter-pel, closed and open GOVs, a
video_signal_type and not-coded VOPs) and tests/data/torch_mp4's mp4v file.

- every picture's Y, U and V planes against the system libavcodec's
  (digests.json "yuv", FFmpeg 5.1, with its rounding of 16-pixel
  put_no_rnd rows: Decoder(approx16=True)), in its output order;
- every frame VideoReader reads, sequentially and after seek(i) for every
  i from 0 to the frame count, against cv2's digests (cv2's FFmpeg 8), and
  against cv2.VideoCapture itself on some files;
- the IDCT against cv2's bundled libavcodec's AVDCT (idct_algo auto, 8
  bits: its x86-64 simple_idct8) on 10^6 random blocks and the extreme ones;
- the refusals (Xvid, Xvid with GMC, interlaced files; DivX and old Lavc
  user data, the short video header, RVLC, shapes, sprites, not_8_bit,
  scalability, newpred, reduced resolution, complexity estimation through
  hand-built headers), each naming the feature and the frame count;
- damaged copies, which stop the reader with a reason;
- the entry points (face-crop extraction, the clip-head trainer's sampling,
  cli/analyze.py single and batched) on the cv2-written files against the
  JAX package on the CPU, within tests/test_torch_analyze.TOL.
Torch stays on one thread.
"""

import dataclasses
import glob
import hashlib
import json
import os
import random
import re
import shutil
import subprocess

import cv2
import numpy as np
import pytest

import real_time_video_deepfake_detection_tpu.cli.analyze as j_analyze
import real_time_video_deepfake_detection_tpu.data_tools.face_extract as j_fe
import real_time_video_deepfake_detection_tpu.train.clip_head as j_ch
from real_time_video_deepfake_detection_tpu.pipeline.faces import FaceDetector as JFaceDetector
import real_time_video_deepfake_detection_tpu_torch.cli.analyze as t_analyze
import real_time_video_deepfake_detection_tpu_torch.data_tools.face_extract as t_fe
import real_time_video_deepfake_detection_tpu_torch.train.clip_head as t_ch
from real_time_video_deepfake_detection_tpu_torch.pipeline.faces import FaceDetector
from real_time_video_deepfake_detection_tpu_torch.utils import h264, mp4, mpeg4, video
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader

from tests.test_torch_analyze import assert_close, hershey_jax, weights  # noqa: F401
from tests.test_torch_mp4_entry import cli_env, npz  # noqa: F401
from tests.test_torch_video_tools import _tree_bytes
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
M4 = os.path.join(DATA, "torch_mpeg4")
with open(os.path.join(M4, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["files"]
FIXTURES = sorted(k for k, r in DIGESTS.items() if not r.get("refused"))
FACE = os.path.join(M4, "cv2_face_272x320.mp4")
PLAIN = os.path.join(M4, "cv2_plain_272x320.mp4")
CLIP = os.path.join(M4, "cv2_640x360.mp4")
SMALL = os.path.join(M4, "cv2_202x114.mp4")


def _path(key: str) -> str:
    return os.path.join(DATA, key) if "/" in key else os.path.join(M4, key)


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


def _decode(key, approx16=False, planes=False, pixels=True):
    """Every picture of a fixture in the decoder's output order: [(pts,
    (bgr, planes))] (both None without `pixels`), and the decoder."""
    with open(_path(key), "rb") as fh:
        data = fh.read()
    track = mp4.demux(data)
    first = data[int(track.offsets[0]):int(track.offsets[0] + track.sizes[0])]
    dec = mpeg4.Decoder(track.decoder_config, first, approx16=approx16)
    out = []

    def take():
        while dec.peek() is not None:
            pts = dec.peek().pts
            out.append((pts, dec.take(bgr=pixels and not planes, planes=pixels and planes)))

    for i in range(len(track.sizes)):
        off = int(track.offsets[i])
        dec.decode(data[off:off + int(track.sizes[i])], int(track.pts[i]))
        take()
    dec.drain()
    take()
    return out, dec, track


# ------------------------------------------------------------ coverage

def test_fixtures_cover_the_encoders_and_their_options():
    """Over the fixtures: cv2's FFmpeg 8 writer (Lavc62) and the system's
    5.1 (Lavc59); I, P and B-VOPs, not-coded VOPs; intra, 1MV, 4MV and
    skipped macroblocks; direct (1MV and 4MV co-located), direct without
    vectors, forward, backward and interpolated B macroblocks and copies
    over skipped co-located ones; dquant and dbquant; all three escape
    modes; AC prediction, also rescaled across a quantiser change; video
    packets and data partitioning; both rounding types; quarter-pel; 8x8
    blocks clipped at the picture's edge."""
    total, builds = {}, set()
    for key in FIXTURES:
        _, dec, track = _decode(key, pixels=False)
        assert track.codec == "mp4v" and dec.unsupported() == ""
        builds.add(dec.user_data.split(".")[0])
        for k, v in dec.stats().items():
            total[k] = total.get(k, 0) + v
    assert builds == {"Lavc62", "Lavc59"}
    for k in mpeg4.STATS:
        if k != "b_vops_dropped":   # a seek drops them (test_frames_equal_cv2_itself)
            assert total[k] > 0, k
    assert total["escape3"] >= 1000 and total["ac_rescaled"] >= 100 and total["dbquant"] >= 50


# ------------------------------------------------------------- decoding

@pytest.mark.parametrize("key", FIXTURES)
def test_planes_equal_libavcodec(key):
    got, _, track = _decode(key, approx16=True, planes=True)
    want = DIGESTS[key]["yuv"]
    assert [p for p, _ in got] == [e["pts"] for e in want]
    for (pts, (_, planes)), e in zip(got, want):
        assert [_sha(p) for p in planes] == [e["y"], e["u"], e["v"]], pts
    assert [e["discarded"] for e in want] == [bool(track.discard[list(track.pts).index(e["pts"])])
                                              for e in want]


def test_the_libraries_round_16_pixel_rows_apart():
    """Where a sample is 0, FFmpeg 5.1's x86 put_no_rnd of 16-pixel rows
    rounds up and cv2's FFmpeg 8's does not: the two decodes of the 4MV
    file differ (each equals its own library above and below)."""
    a = [p for _, (_, p) in _decode("mv4_256x144.mp4", approx16=True, planes=True)[0]]
    b = [p for _, (_, p) in _decode("mv4_256x144.mp4", approx16=False, planes=True)[0]]
    assert len(a) == len(b) and np.array_equal(a[0][0], b[0][0])
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, b))


@pytest.mark.parametrize("key", FIXTURES)
def test_frames_equal_cv2_read_sequentially(key):
    rec = DIGESTS[key]
    r = VideoReader(_path(key))
    assert r.is_opened(), r.reason
    assert (r.frame_count, r.fps) == (rec["frame_count"], rec["fps"])
    assert [_digest(f) for f in _read_all(r)] == rec["read"]
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
        assert _digest(r.read()[1]) == rec["seek"][min(i, n)], i


@pytest.mark.parametrize("key", ["cv2_ntsc_640x360.mp4", "open_bf2_160x96.mp4",
                                 "bf3_256x144.mp4", "nvop_160x96.mp4"])
def test_frames_equal_cv2_itself(key):
    """cv2.VideoCapture live: the sequential read, and the seeks into the
    open GOVs (the B-VOPs after a seek's I-VOP lack their forward
    reference and are dropped, as FFmpeg drops them)."""
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
    dropped = 0
    for i in sorted({1, n // 3, n // 2, n - 3, n - 1}):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, frame = cap.read()
        cap.release()
        r = VideoReader(path)
        r.seek(i)
        got_ok, got = r.read()
        assert got_ok == ok and np.array_equal(got, frame), i
        dropped += r._mp4.decoder.stats()["b_vops_dropped"]
    if key == "open_bf2_160x96.mp4":
        assert dropped > 0


def test_vop_header_facts():
    """cv2.VideoWriter's stream (the JAX analyzer's --output) starts with a
    Visual Object Sequence of Simple Profile L1 and carries FFmpeg 8's
    user data; the video_signal_type file converts with BT.709 at full
    range, which differs from the BT.601 conversion of the same planes."""
    track = mp4.read(CLIP)
    assert track.decoder_config[:5] == b"\x00\x00\x01\xb0\x01"
    assert b"Lavc62" in track.decoder_config
    out, _, _ = _decode("bt709full_160x96.mp4", planes=True)
    y, u, v = out[0][1][1]
    frame = _read_all(VideoReader(_path("bt709full_160x96.mp4")))[0]
    assert np.array_equal(h264.yuv420_to_bgr(y, u, v, 1, 1), frame)
    assert not np.array_equal(h264.yuv420_to_bgr(y, u, v), frame)


# ------------------------------------------------------------------ IDCT

_AVDCT_C = r"""
#include <stdint.h>
/* Run an IDCT function pointer (AVDCT.idct) over n blocks given in natural
   order, permuting each as idct_permutation asks. */
void run(void (*idct)(int16_t*), const uint8_t* perm, const int16_t* in, int16_t* out, long n) {
  int16_t __attribute__((aligned(16))) b[64];
  for (long k = 0; k < n; ++k) {
    for (int i = 0; i < 64; ++i) b[perm[i]] = in[64 * k + i];
    idct(b);
    for (int i = 0; i < 64; ++i) out[64 * k + i] = b[i];
  }
}
"""


def _avdct(tmp_path):
    """cv2's bundled libavcodec's IDCT for an Lavc stream on this CPU
    (AVDCT, idct_algo 0 = auto, 8 bits), and a runner built with gcc."""
    import ctypes
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), "..", "opencv_python.libs",
                                  "libavcodec-*.so*"))
    assert libs, "cv2 bundles no libavcodec"
    lib = ctypes.CDLL(libs[0])
    lib.avcodec_dct_alloc.restype = ctypes.c_void_p
    lib.avcodec_dct_init.argtypes = [ctypes.c_void_p]
    ctx = lib.avcodec_dct_alloc()
    # AVDCT: av_class, idct, idct_permutation[64], fdct, dct_algo, idct_algo,
    # get_pixels, bits_per_sample
    ctypes.memmove(ctx + 92, (ctypes.c_int * 1)(0), 4)
    ctypes.memmove(ctx + 104, (ctypes.c_int * 1)(8), 4)
    assert lib.avcodec_dct_init(ctx) == 0
    raw = bytes((ctypes.c_char * 112).from_address(ctx))
    perm = np.frombuffer(raw[16:80], np.uint8).copy()
    fn = int.from_bytes(raw[8:16], "little")
    src = tmp_path / "run.c"
    src.write_text(_AVDCT_C)
    so = tmp_path / "run.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(src), "-o", str(so)], check=True)
    runner = ctypes.CDLL(str(so))
    runner.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_long]

    def idct(blocks):
        blocks = np.ascontiguousarray(blocks, np.int16)
        out = np.empty_like(blocks)
        runner.run(fn, perm.ctypes.data, blocks.ctypes.data, out.ctypes.data, len(blocks))
        return out

    return idct, perm


def _blocks(n, seed):
    """Random coefficient blocks of every kind the decoder can meet: sparse
    small, sparse 12-bit, full 16-bit, extremes only, DC-only rows (n / 5
    of each)."""
    rng = np.random.default_rng(seed)
    m = n // 5
    parts = []
    for lo, hi, keep in ((-256, 256, 0.35), (-2048, 2048, 0.2), (-32768, 32768, 1.0)):
        v = rng.integers(lo, hi, (m, 64), dtype=np.int16, endpoint=False)
        if keep < 1:
            v[rng.random((m, 64), dtype=np.float32) > keep] = 0
        parts.append(v)
    v = np.where(rng.random((m, 64), dtype=np.float32) < 0.5, np.int16(32767), np.int16(-32768))
    v[rng.random((m, 64), dtype=np.float32) > 0.3] = 0
    parts.append(v)
    v = rng.integers(-4096, 4096, (n - 4 * m, 64), dtype=np.int16)
    v[:, np.arange(64) % 8 != 0] = 0   # DC-only rows
    parts.append(v)
    return np.concatenate(parts)


def test_idct_equals_libavcodec_avdct(tmp_path):
    """10^6 random blocks and every single-coefficient block at the 16-bit
    extremes: the port's IDCT equals cv2's bundled libavcodec's (its
    transposed permutation: rows then columns)."""
    avdct, perm = _avdct(tmp_path)
    assert np.array_equal(perm.reshape(8, 8), np.arange(64).reshape(8, 8).T)
    blocks = _blocks(1_000_000, 19)
    singles = np.zeros((64 * 6, 64), np.int16)
    for i in range(64):
        for j, v in enumerate((32767, -32768, 2047, -2048, 1, -1)):
            singles[6 * i + j, i] = v
    for b in (blocks, singles):
        got, want = mpeg4.idct(b), avdct(b)
        bad = np.flatnonzero((got != want).any(1))
        assert bad.size == 0, (f"{bad.size} of {len(b)} blocks differ, the first "
                               f"{b[bad[0]].tolist()}")


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("key, why", [
    ("xvid_160x96.mp4", r"a stream written by Xvid \(build \d+"),
    ("xvid_gmc_160x96.mp4", r"GMC \(global motion compensation"),
    ("interlaced_160x96.mp4", r"interlaced coding")])
def test_refused_files_name_the_feature_and_frames(key, why):
    r = VideoReader(_path(key))
    assert not r.is_opened() and r.read() == (False, None)
    assert re.search(r"MPEG-4 Part 2 \(mp4v\): " + why, r.reason), r.reason
    assert f"{int(DIGESTS[key]['frame_count'])} frames" in r.reason
    assert r.frame_count == 0


class _Bits:
    def __init__(self):
        self.bits = []

    def u(self, n, v):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def stuffed(self) -> bytes:   # next_start_code: a 0, then 1s to the byte
        self.bits.append(0)
        while len(self.bits) % 8:
            self.bits.append(1)
        return bytes(int("".join(map(str, self.bits[i:i + 8])), 2)
                     for i in range(0, len(self.bits), 8))


def _config(user=b"Lavc59.37.100", profile=0x01, shape=0, sprite=0, interlaced=0, n_bit=0,
            cplx=0, dp=0, rvlc=0, newpred=0, reduced=0, scal=0, verid=1, vo_type=1):
    """VOS, VO and VOL headers of a 160x96 picture as FFmpeg writes them,
    with one field changed, and a user data string."""
    vol = _Bits()
    vol.u(1, 0)
    vol.u(8, vo_type)
    vol.u(1, 1)
    vol.u(4, verid)
    vol.u(3, 1)
    vol.u(4, 1)                      # square pixels
    vol.u(1, 1)
    vol.u(2, 1)
    vol.u(1, 1)
    vol.u(1, 0)                      # vol_control: 4:2:0, low_delay, no vbv
    vol.u(2, shape)
    vol.u(1, 1)
    vol.u(16, 25)
    vol.u(1, 1)
    vol.u(1, 0)                      # not fixed-rate
    if shape != 2:
        if shape == 0:
            vol.u(1, 1)
            vol.u(13, 160)
            vol.u(1, 1)
            vol.u(13, 96)
            vol.u(1, 1)
        vol.u(1, interlaced)
        vol.u(1, 1)                  # obmc_disable
        vol.u(1 if verid == 1 else 2, sprite)
        if not sprite:
            vol.u(1, n_bit)
            if n_bit:
                vol.u(4, 5)
                vol.u(4, 8)
            vol.u(1, 0)              # H.263 quantisation
            if verid != 1:
                vol.u(1, 0)          # quarter_sample
            vol.u(1, 0 if cplx else 1)
            if not cplx:
                vol.u(1, 1)          # resync markers disabled
                vol.u(1, dp)
                if dp:
                    vol.u(1, rvlc)
                if verid != 1:
                    vol.u(1, newpred)
                    if newpred:
                        vol.u(3, 0)
                    vol.u(1, reduced)
                vol.u(1, scal)
    vo = _Bits()
    vo.u(1, 1)
    vo.u(4, verid)
    vo.u(3, 1)
    vo.u(4, 1)
    vo.u(1, 0)
    return (b"\x00\x00\x01\xb0" + bytes([profile]) + b"\x00\x00\x01\xb5" + vo.stuffed()
            + b"\x00\x00\x01\x20" + vol.stuffed() + b"\x00\x00\x01\xb2" + user)


def test_a_hand_built_config_as_ffmpeg_writes_it_opens(monkeypatch):
    """The builder's unchanged headers describe the 160x96 file: it opens
    and reads cv2's frames with them in place of its own."""
    _use_config(monkeypatch, _config())
    r = VideoReader(_path("torch_mp4/mp4v_160x96.mp4"))
    assert r.is_opened(), r.reason
    want = DIGESTS["torch_mp4/mp4v_160x96.mp4"]["read"]
    assert [_digest(f) for f in _read_all(r)] == want


def _use_config(monkeypatch, config):
    demux = mp4.demux

    def patched(data):
        return dataclasses.replace(demux(data), decoder_config=config)

    monkeypatch.setattr(video.mp4, "demux", patched)


@pytest.mark.parametrize("fields, why", [
    (dict(user=b"DivX503Build1234p"), r"a stream written by DivX 503 \(build 1234"),
    (dict(user=b"XviD0050"), r"a stream written by Xvid \(build 50"),
    (dict(user=b"ffmpeg"), r"a stream written by an old libavcodec \(build 4600"),
    (dict(user=b"FFmpeg0.4.9-pre1b4650"), r"a stream written by an old libavcodec \(build 4650"),
    (dict(shape=1), r"a non-rectangular shape"),
    (dict(sprite=1), r"static sprites"),
    (dict(sprite=2, verid=2), r"GMC \(global motion compensation"),
    (dict(interlaced=1), r"interlaced coding"),
    (dict(n_bit=1), r"not_8_bit"),
    (dict(cplx=1), r"complexity estimation"),
    (dict(dp=1, rvlc=1), r"reversible VLCs \(RVLC\)"),
    (dict(newpred=1, verid=2), r"newpred"),
    (dict(reduced=1, verid=2), r"reduced-resolution VOPs"),
    (dict(scal=1), r"scalability"),
    (dict(vo_type=14), r"the studio profile")])
def test_hand_built_headers_are_refused(monkeypatch, fields, why):
    _use_config(monkeypatch, _config(**fields))
    r = VideoReader(_path("torch_mp4/mp4v_160x96.mp4"))
    assert not r.is_opened() and r.read() == (False, None)
    assert re.search(r"MPEG-4 Part 2 \(mp4v\): " + why, r.reason), r.reason
    n = int(DIGESTS["torch_mp4/mp4v_160x96.mp4"]["frame_count"])
    assert f"{n} frames" in r.reason


def test_the_short_video_header_is_refused(tmp_path):
    """A first sample that opens with the H.263 picture start code: FFmpeg's
    mpeg4 decoder finds no VOP in it; refused by name."""
    with open(_path("gop1_160x96.mp4"), "rb") as fh:
        data = bytearray(fh.read())
    track = mp4.demux(bytes(data))
    at = int(track.offsets[0])
    data[at:at + 4] = b"\x00\x00\x80\x02"
    path = tmp_path / "short.mp4"
    path.write_bytes(bytes(data))
    r = VideoReader(str(path))
    assert not r.is_opened()
    assert re.search(r"the short video header \(H\.263 baseline\): 8 frames", r.reason), r.reason


# --------------------------------------------------------------- damage

@pytest.mark.parametrize("key, sample, how, stops", [
    ("mv4_256x144.mp4", 3, "zeros", True), ("bf2_256x144.mp4", 2, "zeros", True),
    ("dp_256x144.mp4", 1, "cut", True), ("ps_256x144.mp4", 2, "ones", False)])
def test_a_damaged_vop_stops_the_reader(tmp_path, key, sample, how, stops):
    """Sixteen zero (or 0xFF) bytes in the middle of a sample, or the
    sample's second half zeroed: the frames read equal cv2's reading of the
    same damaged copy; where the damage breaks the syntax the reader stops
    with (False, None) and a reason naming the sample (FFmpeg conceals and
    reads on). Sixteen 0xFF bytes inside the third-escape levels of a
    packet's macroblock keep the syntax: both read a damaged picture."""
    with open(_path(key), "rb") as fh:
        data = bytearray(fh.read())
    track = mp4.demux(bytes(data))
    at, size = int(track.offsets[sample]), int(track.sizes[sample])
    if how == "cut":
        data[at + size // 2:at + size] = b"\x00" * (size - size // 2)
    else:
        data[at + size // 2:at + size // 2 + 16] = (b"\x00" if how == "zeros" else b"\xff") * 16
    path = tmp_path / "damaged.mp4"
    path.write_bytes(bytes(data))
    cap = cv2.VideoCapture(str(path))
    want = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        want.append(frame)
    cap.release()
    r = VideoReader(str(path))
    assert r.is_opened()
    got = _read_all(r)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    if stops:
        assert len(got) < len(want)
        assert re.match(rf"damaged MPEG-4 Part 2 stream: sample {sample}\b", r.reason), r.reason
    else:
        assert len(got) == len(want) and r.reason == ""
        assert [_digest(f) for f in got] != DIGESTS[key]["read"]
    assert r.read() == (False, None)


def test_reader_api_as_cv2():
    """frame_count and fps as CAP_PROP_FRAME_COUNT / CAP_PROP_FPS report
    them (the not-coded VOPs counted, not read), seeks past the end read
    nothing, release closes."""
    for key in ("nvop_160x96.mp4", "cv2_ntsc_640x360.mp4", "bf3_256x144.mp4"):
        cap = cv2.VideoCapture(_path(key))
        r = VideoReader(_path(key))
        assert r.frame_count == cap.get(cv2.CAP_PROP_FRAME_COUNT)
        assert r.fps == cap.get(cv2.CAP_PROP_FPS)
        cap.release()
    r = VideoReader(_path("nvop_160x96.mp4"))
    assert r.frame_count == 20 and len(_read_all(r)) == 17
    r.seek(10 ** 6)
    assert r.read() == (False, None)
    r.release()
    assert r.read() == (False, None)


# ---------------------------------------------------------- entry points

@pytest.fixture
def one_haar(monkeypatch):
    """The JAX side's haar_native boxes from the port's evaluator. The two
    rungs differ by 1 px on 2 of the 21 frames of the cv2-written 272x320
    clips (ROADMAP's stated differences, Faces: the port keeps cv2's float pyramid
    residual where JAX's native resize keeps a double; tests/test_torch_haar.py
    holds the evaluators); these tests hold the video path and what follows
    the boxes."""
    import real_time_video_deepfake_detection_tpu.models.haar_cascade as j_haar
    port = FaceDetector()
    monkeypatch.setattr(j_haar, "detect_haar_native", lambda frame: port(frame))


def test_fixture_faces_are_found():
    r, fd = VideoReader(FACE), FaceDetector()
    ok, frame = r.read()
    assert ok and len(fd(frame)) == 1


@pytest.mark.parametrize("path, n, size", [(FACE, 4, 200), (PLAIN, 3, 96), (SMALL, 5, 64)])
def test_extract_crops_equals_jax(one_haar, path, n, size):
    want = j_fe.extract_crops(path, JFaceDetector(), random.Random(5), max_frames=n, size=size)
    got = t_fe.extract_crops(path, FaceDetector(), random.Random(5), max_frames=n, size=size)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if path == FACE:
        assert len(got) >= 4


def test_preextract_equals_jax(one_haar, tmp_path):
    videos = tmp_path / "videos"
    for label, extra in (("real", [PLAIN]), ("fake", [])):
        (videos / label).mkdir(parents=True)
        shutil.copy(FACE, videos / label / "face.mp4")
        for p in extra:
            shutil.copy(p, videos / label / os.path.basename(p))
    want = j_fe.preextract(str(videos), str(tmp_path / "jax"), frames_per_video=3)
    got = t_fe.preextract(str(videos), str(tmp_path / "port"), frames_per_video=3,
                          device="cpu")
    assert got == want and got["real"] > 0 and got["fake"] > 0
    a, b = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k


@pytest.mark.parametrize("path, t, crop", [(FACE, 6, 48), (SMALL, 16, 96)])
def test_clip_from_video_equals_jax(one_haar, path, t, crop):
    want = j_ch._clip_from_video(path, t, JFaceDetector(), crop)
    got = t_ch._clip_from_video(path, t, FaceDetector(), crop)
    assert got.shape == want.shape == (t, crop, crop, 3)
    np.testing.assert_array_equal(got, want)


def test_analyze_single_matches_jax(one_haar, npz, cli_env, hershey_jax, tmp_path):  # noqa: F811
    """The JAX analyzer on its own kind of --output file (cv2.VideoWriter's
    mp4v): the same per-frame results and annotated frames."""
    jj, tj = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_analyze.main([FACE, "--weights", npz, "--json", jj, "--max-frames", "5",
                    "--output", str(tmp_path / "jax.mp4")])
    t_analyze.main([FACE, "--weights", npz, "--json", tj, "--max-frames", "5",
                    "--output", str(tmp_path / "port.avi"), "--device", "cpu"])
    with open(jj) as a, open(tj) as b:
        want, got = json.load(a), json.load(b)
    assert_close(got, want)
    assert got["summary"]["frames"] == 5 and got["frames"][0]["faces_detected"] == 1
    assert len(cli_env["jax"]) == len(cli_env["port"]) == 5
    assert hershey_jax["jax"] == hershey_jax["port"]
    for j_frame, t_frame in zip(cli_env["jax"], cli_env["port"]):
        np.testing.assert_array_equal(t_frame, j_frame)


def test_analyze_multi_matches_jax(one_haar, npz, cli_env, tmp_path):  # noqa: F811
    """Two cv2-written mp4v files batched through the engine, six frames of
    each: the face clip and the scene without a face."""
    paths = [FACE, PLAIN]
    jj, tj = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    j_analyze.main(paths + ["--weights", npz, "--json", jj, "--max-frames", "6"])
    t_analyze.main(paths + ["--weights", npz, "--json", tj, "--max-frames", "6", "--device", "cpu"])
    with open(jj) as a, open(tj) as b:
        want, got = json.load(a), json.load(b)
    n = sum(min(6, len(DIGESTS[os.path.basename(p)]["read"])) for p in paths)
    assert got["frames_total"] == want["frames_total"] == n
    for g, w in zip(got["videos"], want["videos"]):
        assert_close(g, w)
    assert 1 <= got["max_batch_seen"] <= 2 and got["engine_ticks"] >= 1
