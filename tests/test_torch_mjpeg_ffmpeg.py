"""Motion-JPEG AVI read as cv2.VideoCapture(path) reads it: cv2 5.0's
default FFmpeg backend, that is libavcodec 62.28's mjpeg decoder and
libswscale 9.5's conversion (utils/mjpeg.py, csrc/mjpeg.cpp,
csrc/simple_idct.cpp, csrc/yuv2bgr.cpp), through utils/video.VideoReader:

- every fixture of tests/data/torch_mjpeg (tools/make_torch_mjpeg_
  fixtures.py: cv2's FFmpeg and CAP_OPENCV_MJPEG writers at even and odd
  sizes; the port's 'MJPG' writer with 4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0
  and gray frames, progressive ones, odd sizes, no DHT, a DHT in the first
  frame only, no idx1, OpenDML parts): frame count, fps, every frame in
  order and after every seek, against the committed digests and cv2
  itself; the refused and damaged files read up to the frame they stop
  at, with the reason named;
- every frame's Y, U and V planes against the bundled libavcodec's mjpeg
  decoder, called through ctypes;
- the conversion of yuvj444p, yuvj422p, yuvj420p and gray at full range
  against the bundled libswscale (sws_scale at the same size, SWS_BICUBIC,
  BT.470BG full range, as cv2 calls it) on every (Y, U, V) triple, and of
  every format through libswscale's scaled path (4:2:0 and 4:2:2 at odd
  heights, 4:1:1, 4:4:0; odd widths in full chroma) on seeded planes;
- the port's 'MJPG' writer read back through the same path.
Torch stays on one thread.
"""

import ctypes
import glob
import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu_torch.utils import mjpeg
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader, VideoWriter

from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_mjpeg")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["files"]
FIXTURES = sorted(DIGESTS)
# files the port stops reading, and the word its reason starts with
STOPS = {"refused_arithmetic_83x41.avi": "unsupported", "damaged_frame4_96x64.avi": "damaged"}


def _path(name):
    return os.path.join(DATA, name)


def _digest(f):
    return {"sha256": hashlib.sha256(np.ascontiguousarray(f).tobytes()).hexdigest(),
            "shape": list(f.shape)}


def _port_reads(name, seek=None):
    r = VideoReader(_path(name))
    assert r.is_opened(), r.reason
    if seek is not None:
        r.seek(seek)
    out = []
    while True:
        ok, f = r.read()
        if not ok:
            break
        out.append(f)
    return out, r


def _cv2_reads(name, seek=None):
    cap = cv2.VideoCapture(_path(name))
    assert cap.getBackendName() == "FFMPEG"
    if seek is not None:
        cap.set(cv2.CAP_PROP_POS_FRAMES, seek)
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    return out, cap


def _held(got, want, name):
    """The port's frames against cv2's: all of them, or, for a file the
    port stops in, the frames before the one it stops at."""
    if name in STOPS:
        assert len(got) < max(len(want), 1) or len(want) == 0, name
        want = want[:len(got)]
    assert [_digest(f) for f in got] == [_digest(f) for f in want], name


@pytest.mark.parametrize("name", FIXTURES)
def test_reads_equal_cv2(name):
    entry = DIGESTS[name]
    got, r = _port_reads(name)
    want, cap = _cv2_reads(name)
    assert [_digest(f) for f in want] == entry["read"]
    assert r.frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == entry["frame_count"]
    assert r.fps == cap.get(cv2.CAP_PROP_FPS) == entry["fps"]
    _held(got, want, name)
    if name in STOPS:
        assert r.reason.startswith(STOPS[name]) and "Motion-JPEG" in r.reason, r.reason
    else:
        assert r.reason == ""


@pytest.mark.parametrize("name", [n for n in FIXTURES if n not in STOPS])
def test_seeks_equal_cv2(name):
    entry = DIGESTS[name]
    for i in range(entry["frame_count"] + 1):
        got, _ = _port_reads(name, i)
        assert [_digest(f) for f in got] == entry["seek"][str(i)], (name, i)
    want, _ = _cv2_reads(name, entry["frame_count"] // 2)
    got, _ = _port_reads(name, entry["frame_count"] // 2)
    _held(got, want, name)


def test_no_test_reads_with_cv2s_motion_jpeg_backend():
    """The port's reader is held to cv2's default backend: no test left
    opens a capture with CAP_OPENCV_MJPEG."""
    here = os.path.dirname(os.path.abspath(__file__))
    for path in glob.glob(os.path.join(here, "test_torch_*.py")):
        with open(path) as fh:
            text = fh.read()
        if path.endswith("test_torch_mjpeg_ffmpeg.py"):
            continue
        assert "VideoCapture(src, cv2.CAP_OPENCV_MJPEG)" not in text, path
        assert "real_capture(src, cv2.CAP_OPENCV_MJPEG)" not in text, path


# --------------------------------------------------- libavcodec and libswscale

def _bundled(stem):
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), os.pardir,
                                  "opencv_python.libs", stem + "-*.so*"))
    assert libs, stem
    return ctypes.CDLL(libs[0], mode=ctypes.RTLD_GLOBAL)


class _Frame(ctypes.Structure):   # AVFrame's leading fields
    _fields_ = [("data", ctypes.c_void_p * 8), ("linesize", ctypes.c_int * 8),
                ("extended_data", ctypes.c_void_p), ("width", ctypes.c_int),
                ("height", ctypes.c_int), ("nb_samples", ctypes.c_int), ("format", ctypes.c_int)]


class _Packet(ctypes.Structure):   # AVPacket's leading fields
    _fields_ = [("buf", ctypes.c_void_p), ("pts", ctypes.c_int64), ("dts", ctypes.c_int64),
                ("data", ctypes.c_void_p), ("size", ctypes.c_int)]


_AV_CODEC_ID_MJPEG = 7
_FMT = {8: "gray", 12: "yuvj420p", 13: "yuvj422p", 14: "yuvj444p", 32: "yuvj440p",
        138: "yuvj411p"}   # AVPixelFormat


@pytest.fixture(scope="module")
def avcodec():
    util, codec = _bundled("libavutil"), _bundled("libavcodec")
    assert codec.avcodec_version() >> 16 == 62
    P = ctypes.c_void_p
    codec.avcodec_find_decoder.restype = P
    codec.avcodec_alloc_context3.restype = P
    codec.avcodec_alloc_context3.argtypes = [P]
    codec.avcodec_open2.argtypes = [P, P, P]
    codec.av_packet_alloc.restype = P
    codec.av_new_packet.argtypes = [P, ctypes.c_int]
    codec.av_packet_unref.argtypes = [P]
    codec.avcodec_send_packet.argtypes = [P, P]
    codec.avcodec_receive_frame.argtypes = [P, P]
    codec.avcodec_free_context.argtypes = [ctypes.POINTER(P)]
    util.av_frame_alloc.restype = P
    util.av_frame_unref.argtypes = [P]
    util.av_opt_set.argtypes = [P, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    return util, codec


def _libavcodec_planes(avcodec, packets):
    """Each packet's (format, [planes]) from one mjpeg decoder context."""
    util, codec = avcodec
    dec = codec.avcodec_find_decoder(_AV_CODEC_ID_MJPEG)
    ctx = ctypes.c_void_p(codec.avcodec_alloc_context3(dec))
    util.av_opt_set(ctx, b"threads", b"1", 0)
    assert codec.avcodec_open2(ctx, dec, None) == 0
    pkt, frm = codec.av_packet_alloc(), util.av_frame_alloc()
    out = []
    for data in packets:
        assert codec.av_new_packet(pkt, len(data)) == 0
        ctypes.memmove(_Packet.from_address(pkt).data, data, len(data))
        assert codec.avcodec_send_packet(ctx, pkt) == 0
        codec.av_packet_unref(pkt)
        assert codec.avcodec_receive_frame(ctx, frm) == 0
        f = _Frame.from_address(frm)
        fmt = _FMT[f.format]
        sx, sy = mjpeg.SUBSAMPLING[fmt]
        planes = []
        for p in range(1 if fmt == "gray" else 3):
            w = f.width if p == 0 else -(-f.width >> sx)
            h = f.height if p == 0 else -(-f.height >> sy)
            buf = (ctypes.c_uint8 * (f.linesize[p] * h)).from_address(f.data[p])
            planes.append(np.frombuffer(buf, np.uint8).reshape(h, f.linesize[p])[:, :w].copy())
        out.append((fmt, planes))
        util.av_frame_unref(frm)
    codec.avcodec_free_context(ctypes.byref(ctx))
    return out


@pytest.mark.parametrize("name", [n for n in FIXTURES if n not in STOPS])
def test_planes_equal_libavcodec(avcodec, name):
    """The decoder's planes, frame by frame through one stream's decoder
    (its tables carried from frame to frame), against libavcodec's."""
    r = VideoReader(_path(name))
    t = r._mp4.track
    packets = [bytes(r._data[int(o):int(o + s)]) for o, s in zip(t.offsets, t.sizes)]
    dec = mjpeg.Decoder()
    for k, (packet, (fmt, want)) in enumerate(zip(packets, _libavcodec_planes(avcodec, packets))):
        dec.decode(packet, k)
        pic = dec.peek()
        assert pic.format == fmt, (name, k)
        _, got = dec.take(bgr=False, planes=True)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name} frame {k}")


@pytest.fixture(scope="module")
def sws():
    lib = _bundled("libswscale")
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


def _sws_convert(lib, planes, fmt):
    """sws_scale as cv2 5.0 calls it on a decoded frame, into rows long
    enough for the SIMD routine to run to the end of the picture's row (as
    cv2's frame buffers are)."""
    h, w = planes[0].shape
    stride = -(-3 * ((w + 15) & ~15) // 32) * 32
    fid = {v: k for k, v in _FMT.items()}[fmt]
    ctx = lib.sws_getContext(w, h, fid, w, h, 3, 4, None, None, None)   # BGR24, SWS_BICUBIC
    lib.sws_setColorspaceDetails(ctx, lib.sws_getCoefficients(5), 1, lib.sws_getCoefficients(5),
                                 1, 0, 1 << 16, 1 << 16)
    out = np.zeros(h * stride + 64, np.uint8)
    planes = [np.ascontiguousarray(p) for p in planes]
    P = ctypes.c_void_p
    src = (P * 4)(*([p.ctypes.data for p in planes] + [None] * (4 - len(planes))))
    sst = (ctypes.c_int * 4)(*([p.strides[0] for p in planes] + [0] * (4 - len(planes))))
    dst = (P * 4)(out.ctypes.data, None, None, None)
    dstst = (ctypes.c_int * 4)(stride, 0, 0, 0)
    lib.sws_scale(ctx, src, sst, 0, h, dst, dstst)
    lib.sws_freeContext(ctx)
    return out[:h * stride].reshape(h, stride)[:, :3 * w].reshape(h, w, 3)


@pytest.mark.parametrize("fmt", ["yuvj444p", "yuvj422p", "yuvj420p", "gray"])
def test_conversion_equals_libswscale_on_every_triple(sws, fmt):
    """Every (Y, U, V) triple (every Y for gray), 16 Y values a pass: each
    chroma sample under the luma samples it covers, all of one Y."""
    if fmt == "gray":
        y = np.tile(np.arange(256, dtype=np.uint8), (4, 1))
        np.testing.assert_array_equal(mjpeg.yuv_to_bgr([y], fmt), _sws_convert(sws, [y], fmt))
        return
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                         indexing="ij")
    sx, sy = {"yuvj444p": (1, 1), "yuvj422p": (2, 1), "yuvj420p": (2, 2)}[fmt]
    u = np.ascontiguousarray(np.tile(uu, (1, 16)))
    v = np.ascontiguousarray(np.tile(vv, (1, 16)))
    for base in range(0, 256, 16):
        ycol = np.repeat(np.arange(base, base + 16, dtype=np.uint8), 256 * sx)
        y = np.ascontiguousarray(np.broadcast_to(ycol, (256 * sy, ycol.size)))
        got = mjpeg.yuv_to_bgr([y, u, v], fmt)
        np.testing.assert_array_equal(got, _sws_convert(sws, [y, u, v], fmt), err_msg=str(base))


@pytest.mark.parametrize("fmt, h, w", [("yuvj444p", 7, 5), ("yuvj422p", 6, 9), ("yuvj420p", 10, 13),
                                       ("gray", 5, 3), ("yuvj420p", 2, 1), ("yuvj422p", 8, 17)])
def test_conversion_equals_libswscale_at_odd_sizes(sws, fmt, h, w):
    rng = np.random.default_rng(h * 31 + w)
    _held_to_sws(sws, fmt, h, w, rng)


def _held_to_sws(sws, fmt, h, w, rng):
    sx, sy = mjpeg.SUBSAMPLING[fmt]
    planes = [rng.integers(0, 256, (h, w), dtype=np.uint8)]
    if fmt != "gray":
        planes += [rng.integers(0, 256, (-(-h >> sy), -(-w >> sx)), dtype=np.uint8)
                   for _ in range(2)]
        if rng.random() < 0.3:   # chroma of extremes: the bicubic lobes overshoot
            planes[1] = np.where(planes[1] < 128, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(mjpeg.yuv_to_bgr(planes, fmt), _sws_convert(sws, planes, fmt),
                                  err_msg=f"{fmt} {h}x{w}")


@pytest.mark.parametrize("fmt", ["yuvj420p", "yuvj422p", "yuvj411p", "yuvj440p"])
def test_scaled_path_equals_libswscale(sws, fmt):
    """libswscale's scaled path (bicubic chroma; the mmxext routines on all
    rows but the last two, the C ones there; full chroma at an odd width):
    4:2:0 and 4:2:2 at odd heights, 4:1:1 and 4:4:0 at any, from 1x1 up."""
    rng = np.random.default_rng(["yuvj420p", "yuvj422p", "yuvj411p", "yuvj440p"].index(fmt))
    sizes = [(1, 1), (1, 2), (3, 2), (3, 3), (5, 8), (7, 9)]
    sizes += [(int(rng.integers(1, 120)), int(rng.integers(1, 170))) for _ in range(30)]
    for h, w in sizes:
        if fmt in ("yuvj420p", "yuvj422p"):
            h |= 1
        _held_to_sws(sws, fmt, h, w, rng)


def test_port_writer_reads_back_as_cv2(tmp_path):
    """The port's 'MJPG' writer (cv2.imencode q95 frames) read back through
    the libavcodec path equals cv2's default backend."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "w.avi")
    wr = VideoWriter(path, "MJPG", 12, (70, 38))
    for _ in range(5):
        wr.write(rng.integers(0, 256, (38, 70, 3), dtype=np.uint8))
    wr.release()
    cap = cv2.VideoCapture(path)
    r = VideoReader(path)
    for _ in range(5):
        ok1, a = cap.read()
        ok2, b = r.read()
        assert ok1 and ok2
        np.testing.assert_array_equal(b, a)
    assert r.read() == (False, None) and r.frame_count == 5


def test_decode_frame_names_what_it_refuses():
    with open(os.path.join(os.path.dirname(DATA), "torch_jpeg_modes",
                           "arith_seq_420_83x41.jpg"), "rb") as fh:
        arith = fh.read()
    with pytest.raises(mjpeg.MjpegError, match="arithmetic") as e:
        mjpeg.decode_frame(arith)
    assert e.value.unsupported
    with pytest.raises(mjpeg.MjpegError, match="not a JPEG") as e:
        mjpeg.decode_frame(b"\x00\x01")
    assert not e.value.unsupported
