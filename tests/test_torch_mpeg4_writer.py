"""The port's mp4v writer (utils/video.VideoWriter(path, "mp4v", fps, size):
csrc/bgr2yuv.cpp, csrc/mpeg4_enc.cpp through utils/mpeg4.Encoder,
utils/mp4.Mp4Muxer and the AVI muxer of utils/video.py) against what the
JAX package writes through cv2.VideoWriter(path, VideoWriter_fourcc(*"mp4v"),
fps, size) with cv2 5.0's bundled FFmpeg 8.0:

- the file's bytes, whole, for every case of tests/torch_mpeg4_scenes.CASES
  (mp4, mov, m4v, avi and '.MP4'; 1, 12, 13 and 25 frames; 25, 30000/1001,
  29.97, 59.94, 12, 7.5, 60 and 600 fps; 2x2 to 1920x1080 and odd sizes; a
  pan, noise, a cut to black, flat black and white, fast, jumping and
  half-pel motion, a new texture after a cut, the decoded frames of two
  cv2-written files), and the SHA-256 that
  tests/data/torch_mpeg4_writer/digests.json keeps of cv2's file (which
  chip_smoke.py holds the writer to on a machine without cv2);
- what the encoder decided where cv2's rate control and scene-change test
  show: the noise's first I-VOP at quantiser 7, the cut's I-VOP at frame 14
  inside the GOP;
- the BGR -> yuv420p conversion against the libswscale cv2 bundles, called
  as cv2's writer calls it, on random frames (odd sizes cut to even) and on
  every BGR triple;
- the forward DCT against cv2's bundled libavcodec's AVDCT (dct_algo auto:
  its x86 ff_fdct_sse2) on 10^6 blocks and the extremes;
- VideoReader on files the writer wrote (AVI and mp4): cv2.VideoCapture's
  frame count, fps, every frame and every seek's landing;
- the refusals, each naming the container or fourcc.
Torch stays on one thread.
"""

import glob
import hashlib
import json
import os
import subprocess

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu_torch.utils import mp4, mpeg4
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader, VideoWriter

from tests import torch_mpeg4_scenes as scenes
from tests.torch_train_util import one_torch_thread  # noqa: F401 (autouse fixture)

DIGESTS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                            "torch_mpeg4_writer", "digests.json")
with open(DIGESTS_PATH) as _fh:
    DIGESTS = json.load(_fh)["cases"]
_LIBS = os.path.join(os.path.dirname(cv2.__file__), os.pardir, "opencv_python.libs")


def _write(cls, fourcc, path, fps, frames) -> bytes:
    h, w = frames[0].shape[:2]
    wr = cls(str(path), fourcc, fps, (w, h))
    for f in frames:
        wr.write(f)
    wr.release()
    with open(path, "rb") as fh:
        return fh.read()


def _both(tmp_path, name):
    """(cv2's bytes, the port's bytes, their paths) of a case."""
    _, _, _, _, fps, ext = scenes.CASES[name]
    frames = scenes.case_frames(name)
    j_path, t_path = tmp_path / ("cv2" + ext), tmp_path / ("port" + ext)
    want = _write(cv2.VideoWriter, cv2.VideoWriter_fourcc(*"mp4v"), j_path, fps, frames)
    got = _write(VideoWriter, "mp4v", t_path, fps, frames)
    return want, got, str(j_path), str(t_path)


@pytest.mark.parametrize("name", sorted(scenes.CASES))
def test_writer_equals_cv2_byte_for_byte(tmp_path, name):
    want, got, _, _ = _both(tmp_path, name)
    if got != want:
        at = next((i for i in range(min(len(got), len(want))) if got[i] != want[i]),
                  min(len(got), len(want)))
        pytest.fail(f"{name}: {len(got)} bytes against cv2's {len(want)}, first differing "
                    f"at byte {at}")
    assert hashlib.sha256(want).hexdigest() == DIGESTS[name]["sha256"], \
        "cv2 writes other bytes than the committed digest (another cv2 / FFmpeg build?)"


def _vop(sample: bytes, time_bits: int):
    """(coding type 'I' or 'P', vop_quant) of a sample's VOP header."""
    i = sample.find(b"\x00\x00\x01\xb6") + 4
    bits = "".join(f"{b:08b}" for b in sample[i:i + 8])
    kind, p = int(bits[:2], 2), 2
    while bits[p] == "1":
        p += 1
    p += 1 + 1 + time_bits + 1 + 1 + (kind == 1) + 3
    return "IPBS"[kind], int(bits[p:p + 5], 2)


def test_rate_control_and_scene_change_decisions(tmp_path):
    """cv2's first I-VOP quantiser on noise is 7 (ratecontrol.c's first
    estimate, i_quant_factor -0.8); each later noise frame is a scene change
    against the last, so an I-VOP too, its quantiser falling to qmin 3 as the
    rate control's predictor learns; the cut to black at frame 14 is coded
    as an I-VOP inside the GOP."""
    want, got, _, t_path = _both(tmp_path, "avi_noise_640x360")
    assert got == want
    enc = mpeg4.Encoder(640, 360, 1, 25, 2 * 25 * 640 * 360, False)
    f = scenes.case_frames("avi_noise_640x360")
    vops = [_vop(enc.encode(x, i)[0], 5) for i, x in enumerate(f)]
    assert vops == [("I", 7), ("I", 4), ("I", 3), ("I", 3)]
    want, got, _, t_path = _both(tmp_path, "mp4_cut")
    assert got == want
    track = mp4.read(t_path)
    assert np.flatnonzero(track.keyframes).tolist() == [0, 12, scenes.CUT_AT]


# ----------------------------------------------------------- conversion

@pytest.fixture(scope="module")
def sws():
    import ctypes
    libs = glob.glob(os.path.join(_LIBS, "libswscale-*.so*"))
    assert libs, "cv2's bundled libswscale"
    lib = ctypes.CDLL(libs[0])
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.sws_getContext.restype = P
    lib.sws_getContext.argtypes = [I] * 6 + [I, P, P, P]
    lib.sws_scale.argtypes = [P, ctypes.POINTER(P), ctypes.POINTER(I), I, I,
                              ctypes.POINTER(P), ctypes.POINTER(I)]
    lib.sws_freeContext.argtypes = [P]
    assert lib.swscale_version() >> 16 == 9

    def convert(frame):
        """sws_scale BGR24 -> YUV420P (SWS_BICUBIC) at the even-cut size, as
        cv2's writer calls it on the frame's own rows."""
        h, w = frame.shape[0] & ~1, frame.shape[1] & ~1
        ctx = lib.sws_getContext(w, h, 3, w, h, 0, 4, None, None, None)
        ls, cs = (w + 63) // 64 * 64, (w // 2 + 63) // 64 * 64
        y = np.zeros((h + 1) * ls, np.uint8)
        u, v = np.zeros((h // 2 + 1) * cs, np.uint8), np.zeros((h // 2 + 1) * cs, np.uint8)
        src = (P * 4)(frame.ctypes.data, None, None, None)
        sst = (I * 4)(frame.strides[0], 0, 0, 0)
        dst = (P * 4)(y.ctypes.data, u.ctypes.data, v.ctypes.data, None)
        dstst = (I * 4)(ls, cs, cs, 0)
        lib.sws_scale(ctx, src, sst, 0, h, dst, dstst)
        lib.sws_freeContext(ctx)
        return (y[:h * ls].reshape(h, ls)[:, :w], u[:h // 2 * cs].reshape(h // 2, cs)[:, :w // 2],
                v[:h // 2 * cs].reshape(h // 2, cs)[:, :w // 2])

    return convert


@pytest.mark.parametrize("hw", [(64, 96), (113, 201), (114, 202), (360, 640), "every triple"])
def test_conversion_equals_libswscale(sws, hw):
    """Random frames (an odd size is cut to even), and every BGR triple once
    in a 4096 x 4096 frame whose 2x2 blocks mix four random ones."""
    rng = np.random.default_rng(20)
    if hw == "every triple":
        frame = rng.permutation(np.arange(1 << 24, dtype=np.uint32))
        frame = np.stack([(frame >> s) & 255 for s in (0, 8, 16)], -1).astype(np.uint8)
        frame = frame.reshape(4096, 4096, 3)
    else:
        frame = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    got, want = mpeg4.bgr_to_yuv420(frame), sws(frame)
    for plane, g, w in zip("YUV", got, want):
        assert np.array_equal(g, w), (plane, int((g != w).sum()))


# ------------------------------------------------------------------ FDCT

_AVDCT_C = r"""
#include <stdint.h>
/* Run a forward DCT function pointer (AVDCT.fdct) over n blocks in natural
   order. */
void run(void (*fdct)(int16_t*), const int16_t* in, int16_t* out, long n) {
  int16_t __attribute__((aligned(16))) b[64];
  for (long k = 0; k < n; ++k) {
    for (int i = 0; i < 64; ++i) b[i] = in[64 * k + i];
    fdct(b);
    for (int i = 0; i < 64; ++i) out[64 * k + i] = b[i];
  }
}
"""


def _avdct_fdct(tmp_path):
    """cv2's bundled libavcodec's forward DCT for the encoder (AVDCT,
    dct_algo 0 = auto, 8 bits), and a runner built with gcc."""
    import ctypes
    libs = glob.glob(os.path.join(_LIBS, "libavcodec-*.so*"))
    assert libs, "cv2 bundles no libavcodec"
    lib = ctypes.CDLL(libs[0])
    lib.avcodec_dct_alloc.restype = ctypes.c_void_p
    lib.avcodec_dct_init.argtypes = [ctypes.c_void_p]
    ctx = lib.avcodec_dct_alloc()
    # AVDCT: av_class, idct, idct_permutation[64], fdct, dct_algo, idct_algo,
    # get_pixels, bits_per_sample
    ctypes.memmove(ctx + 88, (ctypes.c_int * 2)(0, 0), 8)
    ctypes.memmove(ctx + 104, (ctypes.c_int * 1)(8), 4)
    assert lib.avcodec_dct_init(ctx) == 0
    fn = ctypes.c_void_p.from_address(ctx + 80).value
    src = tmp_path / "run.c"
    src.write_text(_AVDCT_C)
    so = tmp_path / "run.so"
    subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(src), "-o", str(so)], check=True)
    runner = ctypes.CDLL(str(so))
    runner.run.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long]

    def fdct(blocks):
        blocks = np.ascontiguousarray(blocks, np.int16)
        out = np.empty_like(blocks)
        runner.run(fn, blocks.ctypes.data, out.ctypes.data, len(blocks))
        return out

    return fdct


def test_fdct_equals_libavcodec_avdct(tmp_path):
    """10^6 blocks the encoder meets (pixels 0..255, residuals -255..255,
    sparse and flat ones) and every block of one coefficient at +-255: the
    port's ff_fdct_sse2 equals cv2's bundled libavcodec's."""
    fdct = _avdct_fdct(tmp_path)
    rng = np.random.default_rng(20)
    m = 250_000
    pixels = rng.integers(0, 256, (m, 64), dtype=np.int16)
    residuals = rng.integers(-255, 256, (m, 64), dtype=np.int16)
    sparse = np.where(rng.random((m, 64)) < 0.1, rng.integers(-255, 256, (m, 64)), 0)
    flat = np.repeat(rng.integers(-255, 256, (m, 1)), 64, 1)
    singles = np.zeros((128, 64), np.int16)
    singles[np.arange(64), np.arange(64)] = 255
    singles[64 + np.arange(64), np.arange(64)] = -255
    for b in (pixels, residuals, sparse, flat, singles,
              np.where(rng.random((1000, 64)) < 0.5, 255, -255)):
        got, want = mpeg4.fdct(b), fdct(b)
        bad = np.flatnonzero((got != want).any(1))
        assert bad.size == 0, f"{bad.size} of {len(b)} blocks differ, the first {b[bad[0]]}"


# ------------------------------------------------------------- read back

@pytest.mark.parametrize("name", ["avi_pan25", "mp4_pan25", "avi_2997", "mov_pan13"])
def test_reader_reads_what_the_writer_wrote(tmp_path, name):
    """Frame count, fps, every frame read on, and every seek's landing as
    cv2.VideoCapture gives them on the same file."""
    want, got, _, t_path = _both(tmp_path, name)
    assert got == want
    cap, reader = cv2.VideoCapture(t_path, cv2.CAP_FFMPEG), VideoReader(t_path)
    assert reader.is_opened() and not reader.reason
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert reader.frame_count == n == scenes.CASES[name][1]
    assert reader.fps == cap.get(cv2.CAP_PROP_FPS)
    for i in range(n + 1):
        (ok_w, w), (ok_g, g) = cap.read(), reader.read()
        assert ok_g == ok_w, i
        if ok_w:
            np.testing.assert_array_equal(g, w, err_msg=f"frame {i}")
    for i in list(range(n + 2)) + [3, 0, n - 1]:
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        reader.seek(i)
        (ok_w, w), (ok_g, g) = cap.read(), reader.read()
        assert ok_g == ok_w, f"seek {i}"
        if ok_w:
            np.testing.assert_array_equal(g, w, err_msg=f"seek {i}")


# -------------------------------------------------------------- refusals

@pytest.mark.parametrize("path, fourcc, why", [
    ("a.mkv", "mp4v", r"'\.mkv'.*Matroska"),
    ("a.webm", "mp4v", r"'\.webm'.*WebM"),
    ("noext", "mp4v", r"\(no extension\)"),
    ("a.flv", "mp4v", r"'\.flv'"),
    ("a.mp4", "XVID", r"fourcc 'XVID'"),
    ("a.mp4", cv2.VideoWriter_fourcc(*"avc1"), r"fourcc 'avc1'"),
])
def test_refusals_name_the_container_or_fourcc(tmp_path, path, fourcc, why):
    with pytest.raises(ValueError, match=why):
        VideoWriter(str(tmp_path / path), fourcc, 25, (64, 48))
    assert not os.path.exists(tmp_path / path)


def test_analyze_refuses_an_output_it_cannot_write(tmp_path):
    """--output is checked before the video is opened."""
    import real_time_video_deepfake_detection_tpu_torch.cli.analyze as t_analyze
    with pytest.raises(SystemExit, match=r"--output: .*'\.mkv'"):
        t_analyze.main([str(tmp_path / "missing.mp4"), "--output", str(tmp_path / "o.mkv"),
                        "--device", "cpu"])
