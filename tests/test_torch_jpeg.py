"""The port's JPEG decode (csrc/jpeg_entropy.cpp + ops/jpeg_decode.py via
utils/jpeg_ingest.py) against libjpeg's default decode, as cv2.imdecode and
the JAX package's serving.server._decode_frame (native libjpeg) return it:
0 differing bytes on every committed fixture (tests/data/torch_jpeg, made by
tools/make_torch_jpeg_fixtures.py) and on generated images of every size
1-80 x 1-80, quality 50-95, in every accepted sampling; coefficients and
quant tables equal to the JAX native entropy decode; the torch
reconstruction equal to the JAX ops/jpeg_decode functions; refused and
corrupt streams give None without taking the process down (fuzzed in a
subprocess); the header scan _jpeg_dims equal to the JAX one."""

import hashlib
import json
import os
import subprocess
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from real_time_video_deepfake_detection_tpu.ops import jpeg_decode as JD
from real_time_video_deepfake_detection_tpu.serving.multi import _jpeg_dims as j_jpeg_dims
from real_time_video_deepfake_detection_tpu.serving.server import _decode_frame as j_decode_frame
from real_time_video_deepfake_detection_tpu.utils import native_ingest as NI
from real_time_video_deepfake_detection_tpu_torch.ops import jpeg_decode as TD
from real_time_video_deepfake_detection_tpu_torch.ops.resize import resize_bilinear_u8_cv2
from real_time_video_deepfake_detection_tpu_torch.serving.multi import _jpeg_dims
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
    JpegError, decode_coefs, decode_coefs_batch, decode_jpeg, reconstruct,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_jpeg")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["files"]

SAMPLING = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _cv2(data: bytes):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_decodes_like_cv2_and_the_jax_server(name):
    """Every fixture, progressive and truncated ones too, as the JAX
    server's libjpeg route decodes it; equal to cv2 where cv2 decodes it
    (cv2 refuses the truncated stream)."""
    entry, data = DIGESTS[name], _read(name)
    out = decode_jpeg(data)
    assert entry["port_decodes"]
    assert out is not None and list(out.shape) == entry["native"]["shape"]
    assert hashlib.sha256(out.tobytes()).hexdigest() == entry["native"]["sha256"]
    np.testing.assert_array_equal(out, j_decode_frame(data))
    if entry["sha256"] is None:
        assert _cv2(data) is None and decode_jpeg(data, "cv2") is None
    else:
        assert entry["sha256"] == entry["native"]["sha256"]
        np.testing.assert_array_equal(out, _cv2(data))


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(h=st.integers(1, 80), w=st.integers(1, 80), quality=st.integers(50, 95),
       sampling=st.sampled_from(["420", "422", "444", "440", "gray"]),
       seed=st.integers(0, 2 ** 16))
def test_generated_images_decode_like_cv2_and_the_jax_server(h, w, quality, sampling, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = 128 + 90 * np.sin(xx / 5.0 + seed) * np.cos(yy / 7.0)
    img = np.clip(img[..., None] + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling == "gray":
        img = img[..., 0]
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    data = enc.tobytes()
    out = decode_jpeg(data)
    assert out is not None
    np.testing.assert_array_equal(out, _cv2(data))
    np.testing.assert_array_equal(out, j_decode_frame(data))


def test_coefficients_and_quant_tables_equal_the_jax_native_entropy_decode():
    data = _read("frame_640x480_q85_420.jpg")
    coef_y, coef_c, qtab, ok = NI.decode_coefs_batch([data], 480, 640)
    assert ok[0]
    jc = decode_coefs(data)
    assert jc.factors == ((2, 2), (1, 1), (1, 1)) and (jc.height, jc.width) == (480, 640)
    np.testing.assert_array_equal(jc.coefs[0].reshape(-1, 64), coef_y[0])
    for c in (1, 2):
        np.testing.assert_array_equal(jc.coefs[c].reshape(-1, 64), coef_c[0, c - 1])
    np.testing.assert_array_equal(jc.qtabs, qtab[0][[0, 1, 1]])


def test_reconstruction_equals_the_jax_functions():
    datas = [_read("frame_640x480_q85_420.jpg"),
             cv2.imencode(".jpg", np.random.default_rng(3).integers(
                 0, 256, (480, 640, 3), dtype=np.uint8))[1].tobytes()]
    coef_y, coef_c, qtab, ok = NI.decode_coefs_batch(datas, 480, 640)
    y, c, ok2 = NI.decode_raw420_batch(datas, 480, 640)
    assert ok.all() and ok2.all()
    want = np.asarray(JD.bgr_from_coefs_420(jnp.asarray(coef_y), jnp.asarray(coef_c),
                                            jnp.asarray(qtab), 480, 640))
    got = TD.bgr_from_coefs_420(torch.from_numpy(coef_y), torch.from_numpy(coef_c),
                                torch.from_numpy(qtab.astype(np.int32)), 480, 640)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.stack([_cv2(d) for d in datas]))
    np.testing.assert_array_equal(
        TD.bgr_from_ycbcr420(torch.from_numpy(y), torch.from_numpy(c)).numpy(),
        np.asarray(JD.bgr_from_ycbcr420(jnp.asarray(y), jnp.asarray(c))))
    # dequantise + IDCT on coefficients of any sign and size an encoder makes
    rng = np.random.default_rng(4)
    coef = rng.integers(-300, 301, (2, 6, 64)).astype(np.int16)
    q = rng.integers(1, 30, (2, 64)).astype(np.uint16)
    np.testing.assert_array_equal(
        TD.samples_from_coefs(torch.from_numpy(coef), torch.from_numpy(q.astype(np.int32))).numpy(),
        np.asarray(JD.samples_from_coefs(jnp.asarray(coef), jnp.asarray(q))))


def test_pooled_decode_conformed_equals_the_jax_device_detect_ingest():
    """The device-detect tick's frames: the pooled decode, reconstructed as
    one batch and conformed to the capture size, equal what the JAX engine's
    pooled native decode + resize hands its tick."""
    names = ["frame_720x405_q85_420.jpg", "frame_405x720_q85_420.jpg",
             "frame_640x480_q85_420.jpg", "gray_319x241_q85.jpg"]
    datas = [_read(n) for n in names] + [_read("frame_720x405_q85_420.jpg")]
    want, ok = NI.decode_resize_batch(datas, 480, 640)
    assert ok.all()
    res = decode_coefs_batch(datas, n_threads=3)
    same = [res[0], res[4]]
    assert same[0].layout == same[1].layout
    batch = reconstruct(same, "cpu")
    np.testing.assert_array_equal(resize_bilinear_u8_cv2(batch, 480, 640).numpy(),
                                  want[[0, 4]])
    for i in (1, 2, 3):
        frame = resize_bilinear_u8_cv2(reconstruct([res[i]], "cpu"), 480, 640)[0]
        np.testing.assert_array_equal(frame.numpy(), want[i])


def test_refusals_carry_their_reason_by_route():
    """Not-JPEG bytes are refused on both routes; the progressive stream
    decodes on both; the truncated one decodes on the libjpeg route and is
    refused (-2) on cv2's, as cv2 refuses it."""
    cases = [(b"", -1, -1), (b"\x89PNG\r\n\x1a\n....", -1, -1),
             (_read("progressive_720x405_q85.jpg"), None, None),
             (_read("truncated_720x405_q85.jpg"), None, -2)]
    for k, route in enumerate(("native", "cv2")):
        out = decode_coefs_batch([c[0] for c in cases], route=route)
        for r, case in zip(out, cases):
            if case[1 + k] is None:
                assert not isinstance(r, JpegError), route
            else:
                assert isinstance(r, JpegError) and r.status == case[1 + k], route
    with pytest.raises(JpegError):
        decode_coefs(b"\xff\xd8\xff\xd9")


# Runs in a subprocess: a crash fails the test instead of killing the worker.
_FUZZ = r'''
import sys
import numpy as np
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg

base = open(sys.argv[1], "rb").read()
rng = np.random.default_rng(0)
seg = [i for i in range(len(base) - 1) if base[i] == 0xFF and base[i + 1] in
       (0xC0, 0xC4, 0xDA, 0xDB, 0xDD)]
sos = base.find(b"\xff\xda")
cases = [base[:k] for k in range(0, len(base), max(1, len(base) // 97))]
for _ in range(150):   # bit flips, half in the headers
    b = bytearray(base)
    i = int(rng.integers(0, sos + 12)) if rng.random() < 0.5 else int(rng.integers(0, len(b)))
    b[i] ^= 1 << int(rng.integers(0, 8))
    cases.append(bytes(b))
for s in seg:   # segment lengths 0, 1, 2, short, long, huge
    for v in (0, 1, 2, 5, 300, 0xFFFF):
        b = bytearray(base)
        b[s + 2:s + 4] = v.to_bytes(2, "big")
        cases.append(bytes(b))
dht = [s for s in seg if base[s + 1] == 0xC4]
for s in dht:   # Huffman tables: counts and symbols
    for k in range(5, 21):
        for v in (0, 0xFF, 0x10):
            b = bytearray(base)
            b[s + k] = v
            cases.append(bytes(b))
sof = base.find(b"\xff\xc0")
for patch in ((sof + 5, b"\xff\xff\xff\xff"), (sof + 9, b"\x04"), (sof + 4, b"\x0c"),
              (sof + 11, b"\x33"), (sof + 11, b"\x00")):
    b = bytearray(base)
    b[patch[0]:patch[0] + len(patch[1])] = patch[1]
    cases.append(bytes(b))
cases += [b"\xff\xd8" + bytes(rng.integers(0, 256, 200, dtype=np.uint8)) for _ in range(20)]
decoded = 0
for c in cases:
    out = decode_jpeg(c)
    if out is not None:
        assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3, out.shape
        decoded += 1
print(len(cases), decoded)
'''


def test_corrupt_streams_give_none_or_an_image_never_a_crash(tmp_path):
    img = np.random.default_rng(5).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for sampling in ("420", "444"):
        path = tmp_path / f"base_{sampling}.jpg"
        path.write_bytes(cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                                    SAMPLING[sampling],
                                                    cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes())
        r = subprocess.run([sys.executable, "-c", _FUZZ, str(path)], cwd=REPO,
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 0, r.stderr[-3000:]
        n_cases, n_decoded = map(int, r.stdout.split())
        assert n_cases > 400 and 0 < n_decoded < n_cases


def test_jpeg_dims_equals_the_jax_header_scan():
    for name in DIGESTS:
        data = _read(name)
        assert _jpeg_dims(data) == j_jpeg_dims(data)
    data = _read("frame_640x480_q85_420.jpg")
    assert _jpeg_dims(data) == (480, 640)
    sof = data.find(b"\xff\xc0")
    for case in (b"", b"\xff\xd8garbage-not-a-jpeg", b"PNG...definitely not",
                 data[:sof] + b"\xff\xff\xff" + data[sof:],
                 b"\xff\xd8\xff\xda\x00\x04\x01\x02\xff\xc0\x00\x11\x08\x00\x10\x00\x10",
                 data[:sof + 4]):
        assert _jpeg_dims(case) == j_jpeg_dims(case)
