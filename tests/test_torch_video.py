"""The port's video I/O against cv2 on the CPU: the Motion-JPEG AVI reader
(utils/video.py) against cv2.VideoCapture(path), the default FFmpeg
backend the JAX package opens every video with (libavcodec's mjpeg
decoder and libswscale; tests/test_torch_mjpeg_ffmpeg.py holds the rest);
the writer against both of cv2's backends; the JPEG encoder
(utils/jpeg_encode.py) against cv2.imencode byte for byte; and INTER_AREA
(utils/host_resize.resize_area_u8) against cv2.resize."""

import struct

import cv2
import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu_torch.utils.host_resize import resize_area_u8
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_encode import encode_jpeg
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_coefs
from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader, VideoWriter

FOURCC = cv2.VideoWriter_fourcc(*"MJPG")


def moving_frames(n, h=240, w=320, seed=0):
    """A textured scene that moves a few pixels a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 2 * n, w + 2 * n, 3), np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 0)
    return [np.ascontiguousarray(base[i:i + h, 2 * i:2 * i + w]) for i in range(n)]


def write_cv2_mjpeg(path, frames, fps=25.0):
    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.CAP_OPENCV_MJPEG, FOURCC, fps, (w, h))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()


def read_all(cap):
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f)


@pytest.fixture(scope="module")
def cv2_avi(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "cv2_mjpeg.avi"
    write_cv2_mjpeg(path, moving_frames(12), fps=24.0)
    return str(path)


def test_reader_equals_cv2_mjpeg_backend(cv2_avi):
    """The file cv2's Motion-JPEG writer wrote, read as cv2.VideoCapture(path)
    (the FFmpeg backend) reads it."""
    cap = cv2.VideoCapture(cv2_avi)
    assert cap.getBackendName() == "FFMPEG"
    want = read_all(cap)
    reader = VideoReader(cv2_avi)
    assert reader.is_opened() and reader.reason == ""
    assert reader.frame_count == int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 12
    assert reader.fps == cap.get(cv2.CAP_PROP_FPS) == 24.0
    got = read_all(reader)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert reader.read() == (False, None)


def test_reader_seeks_every_index_like_cv2(cv2_avi):
    cap = cv2.VideoCapture(cv2_avi)
    reader = VideoReader(cv2_avi)
    for i in [11, 0, 5, 5, 3] + list(range(12)):
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        reader.seek(i)
        ok_w, want = cap.read()
        ok_g, got = reader.read()
        assert ok_w and ok_g
        np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")


@pytest.mark.parametrize("backend", ["ffmpeg", "mjpeg"])
def test_port_writer_opens_in_cv2(tmp_path, backend):
    frames = moving_frames(7, 120, 176, seed=1)
    path = str(tmp_path / "port.avi")
    wr = VideoWriter(path, "MJPG", 30, (176, 120))
    for f in frames:
        wr.write(f)
    wr.release()
    api = cv2.CAP_FFMPEG if backend == "ffmpeg" else cv2.CAP_OPENCV_MJPEG
    cap = cv2.VideoCapture(path, api)
    assert cap.isOpened()
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 7 and cap.get(cv2.CAP_PROP_FPS) == 30.0
    got = read_all(cap)
    assert len(got) == 7 and all(g.shape == (120, 176, 3) for g in got)
    want = [cv2.imdecode(np.frombuffer(encode_jpeg(f, 95), np.uint8), cv2.IMREAD_COLOR)
            for f in frames]
    port = read_all(VideoReader(path))
    assert len(port) == 7
    if backend == "mjpeg":   # libjpeg, as cv2.imdecode decodes each frame
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    else:   # the port reads its own file back as cv2's FFmpeg backend does
        for a, b in zip(port, got):
            np.testing.assert_array_equal(a, b)


def _strip_dht(jpeg: bytes) -> bytes:
    out, i = bytearray(jpeg[:2]), 2
    while jpeg[i + 1] != 0xDA:
        n = struct.unpack_from(">H", jpeg, i + 2)[0]
        if jpeg[i + 1] != 0xC4:
            out += jpeg[i:i + 2 + n]
        i += 2 + n
    return bytes(out + jpeg[i:])


def test_a_frame_without_huffman_tables_decodes_like_imdecode(tmp_path):
    """Camera Motion-JPEG leaves out DHT: the Annex K tables apply, as in
    cv2.imdecode, and the frames equal cv2.VideoCapture(path)'s."""
    frames = moving_frames(3, 64, 96, seed=2)
    jpegs = [_strip_dht(cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 80])[1].tobytes())
             for f in frames]
    assert all(b"\xff\xc4" not in j[:600] for j in jpegs)
    path = str(tmp_path / "nodht.avi")
    wr = VideoWriter(path, "MJPG", 15, (96, 64))
    for j in jpegs:
        wr.write_jpeg(j)
    wr.release()
    got = read_all(VideoReader(path))
    want = read_all(cv2.VideoCapture(path))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for j in jpegs:   # the tables are the ones cv2.imdecode supplies too
        assert cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR) is not None


def test_what_does_not_open(tmp_path):
    """A file that is no video, a missing file and a camera index stay
    unopened; cv2.VideoWriter's mp4v mp4 (which the port once refused) now
    opens and reads cv2's frames (tests/test_torch_mpeg4.py holds the rest)."""
    mp4 = str(tmp_path / "clip.mp4")
    wr = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 25, (64, 48))
    for f in moving_frames(3, 48, 64):
        wr.write(f)
    wr.release()
    cap = cv2.VideoCapture(mp4)
    want = [cap.read()[1] for _ in range(3)]
    got = read_all(VideoReader(mp4))
    assert len(got) == 3 and all(np.array_equal(g, w) for g, w in zip(got, want))
    junk = tmp_path / "junk.mp4"
    junk.write_bytes(b"not a video at all" * 10)
    for src, why in ((str(junk), "Motion-JPEG AVI"), (str(tmp_path / "missing.avi"), "cannot read"),
                     ("0", "cannot read"), (0, "camera capture")):
        r = VideoReader(src)
        assert not r.is_opened() and why in r.reason, (src, r.reason)
        assert r.frame_count == 0 and r.read() == (False, None)


def _sizes():
    rng = np.random.default_rng(4)
    fixed = [(1, 1), (17, 23), (224, 224), (405, 720), (480, 640), (8, 8), (9, 16), (16, 9)]
    return fixed + [(int(rng.integers(1, 300)), int(rng.integers(1, 300))) for _ in range(12)]


@pytest.mark.parametrize("quality", [95, 90])
@pytest.mark.parametrize("kind", ["noise", "smooth"])
def test_encode_jpeg_equals_imencode(quality, kind):
    """The same stream byte for byte: headers, quantisation tables and every
    coefficient; the partial MCUs of odd sizes included."""
    rng = np.random.default_rng(quality)
    for h, w in _sizes():
        if kind == "noise":
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
        else:
            yy, xx = np.mgrid[:h, :w]
            img = np.stack([(yy * 3 + xx) % 256, (xx * 2) % 256, (yy * 5) % 256], -1)
            img = img.astype(np.uint8)
        want = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()
        got = encode_jpeg(img, quality)
        assert got == want, (h, w)
    a, b = decode_coefs(got), decode_coefs(want)
    np.testing.assert_array_equal(a.qtabs, b.qtabs)
    for ca, cb in zip(a.coefs, b.coefs):
        np.testing.assert_array_equal(ca, cb)


def test_encode_jpeg_takes_views_and_refuses_other_input():
    img = np.random.default_rng(5).integers(0, 256, (50, 70, 3), np.uint8)
    view = img[5:45:2, 3:60]
    assert encode_jpeg(view, 95) == cv2.imencode(
        ".jpg", np.ascontiguousarray(view), [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    for bad in (img[..., 0], img.astype(np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            encode_jpeg(bad, 95)


@pytest.mark.parametrize("start", [80, 160, 240, 320])
def test_resize_area_equals_cv2(start):
    """Crop sides 80-400 to 224: cv2's linear path with the area weights
    below 224, its fractional decimation above, square and not."""
    rng = np.random.default_rng(start)
    for side in range(start, min(start + 80, 401), 3):
        for h, w in ((side, side), (side, int(rng.integers(80, 401)))):
            img = rng.integers(0, 256, (h, w, 3), np.uint8)
            np.testing.assert_array_equal(
                resize_area_u8(img, 224, 224),
                cv2.resize(img, (224, 224), interpolation=cv2.INTER_AREA), err_msg=str((h, w)))


@pytest.mark.parametrize("hw,dst", [((448, 448), (224, 224)), ((672, 672), (224, 224)),
                                    ((896, 448), (224, 224)), ((450, 449), (224, 224)),
                                    ((223, 225), (224, 224)), ((81, 300), (224, 224)),
                                    ((60, 90), (20, 30)), ((61, 33), (17, 5)),
                                    ((224, 224), (224, 224))])
def test_resize_area_integer_ratios_and_odd_shapes(hw, dst):
    img = np.random.default_rng(sum(hw)).integers(0, 256, hw + (3,), np.uint8)
    np.testing.assert_array_equal(
        resize_area_u8(img, *dst), cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(
        resize_area_u8(img[..., 0], *dst),
        cv2.resize(np.ascontiguousarray(img[..., 0]), dst[::-1], interpolation=cv2.INTER_AREA))


def _port_avi(path, frames):
    wr = VideoWriter(str(path), "MJPG", 20, (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        wr.write(f)
    wr.release()
    with open(path, "rb") as fh:
        return fh.read()


def test_reader_scans_movi_without_idx1_and_follows_avix(tmp_path):
    """An AVI without its idx1 index is scanned; an OpenDML 'AVIX' RIFF
    after the first adds its movi list's frames (in a 'rec ' list too),
    read past the frame count as cv2's default backend reads them."""
    frames = moving_frames(6, 48, 64, seed=3)
    data = _port_avi(tmp_path / "a.avi", frames[:4])
    cut = data.rindex(b"idx1")
    riff = bytearray(data[:cut])
    struct.pack_into("<I", riff, 4, len(riff) - 8)
    (tmp_path / "noidx.avi").write_bytes(bytes(riff))
    got = read_all(VideoReader(str(tmp_path / "noidx.avi")))
    want = read_all(cv2.VideoCapture(str(tmp_path / "noidx.avi")))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    jpegs = [encode_jpeg(f, 95) for f in frames]

    def chunk(fcc, payload):
        return fcc + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)

    rec = b"LIST" + struct.pack("<I", 4 + len(chunk(b"00dc", jpegs[5]))) + b"rec " + \
        chunk(b"00dc", jpegs[5])
    movi = b"movi" + chunk(b"00dc", jpegs[4]) + chunk(b"ix00", b"\0" * 24) + rec
    avix = b"RIFF" + struct.pack("<I", 4 + 8 + len(movi)) + b"AVIX" + \
        b"LIST" + struct.pack("<I", len(movi)) + movi
    (tmp_path / "avix.avi").write_bytes(data + avix)
    reader = VideoReader(str(tmp_path / "avix.avi"))
    cap = cv2.VideoCapture(str(tmp_path / "avix.avi"))
    assert reader.frame_count == cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4   # the header's
    got, want = read_all(reader), read_all(cap)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    reader.seek(5)
    cap.set(cv2.CAP_PROP_POS_FRAMES, 5)
    np.testing.assert_array_equal(reader.read()[1], cap.read()[1])


def test_reader_refuses_an_avi_without_a_motion_jpeg_stream(tmp_path):
    data = _port_avi(tmp_path / "a.avi", moving_frames(2, 32, 32))
    (tmp_path / "h264.avi").write_bytes(data.replace(b"MJPG", b"H264"))
    r = VideoReader(str(tmp_path / "h264.avi"))
    assert not r.is_opened() and "no MJPG video stream" in r.reason
    (tmp_path / "short.avi").write_bytes(b"RIFF\x04\x00\x00\x00AVI ")
    assert not VideoReader(str(tmp_path / "short.avi")).is_opened()


def test_a_file_cut_short_reads_its_whole_frames(tmp_path):
    frames = moving_frames(5, 48, 64, seed=6)
    data = _port_avi(tmp_path / "a.avi", frames)
    cut = data.index(b"00dc", data.index(b"00dc", data.index(b"movi")) + 8) + 8 + 300
    (tmp_path / "cut.avi").write_bytes(data[:cut])   # inside the second frame
    reader = VideoReader(str(tmp_path / "cut.avi"))
    cap = cv2.VideoCapture(str(tmp_path / "cut.avi"))
    assert reader.is_opened() and reader.frame_count == cap.get(cv2.CAP_PROP_FRAME_COUNT) == 5
    ok, first = reader.read()
    assert ok
    np.testing.assert_array_equal(first, read_all(VideoReader(str(tmp_path / "a.avi")))[0])
    np.testing.assert_array_equal(first, cap.read()[1])
    assert reader.read() == (False, None)   # the cut frame stops the reader
    assert reader.reason.startswith("damaged") and not cap.read()[0]
