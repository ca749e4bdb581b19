"""The port's decode of arithmetic-coded, lossless and 12-bit JPEGs against
the JAX package's routes, on the fixtures of tests/data/torch_jpeg_modes
(tools/make_torch_jpeg_mode_fixtures.py):

- every input on the libjpeg route (utils/image_decode.native_route)
  against the JAX package's native decode, and on the cv2 route against
  cv2.imdecode, byte for byte, refusals included: arithmetic SOF9/SOF10
  streams with restarts and DAC conditioning decode on both routes; lossless
  (SOF3) frames only on cv2's, where cv2 decodes them (RGB, CMYK, 2- to
  7-bit samples, subsampled components) and not where it refuses them
  (gray, JFIF-YCbCr, a restart inside a row); 12- and 16-bit frames on
  neither;
- the DCT-scaled decode of every arithmetic input at every M a hint
  selects against the native scaled decode (the committed digests);
- seeded cut points of the sequential, progressive and restart arithmetic
  streams against JAX's native decode (libjpeg reads zeros past the end
  and block-smooths the progressive ones; cv2 refuses them);
- the "coef" and "ycbcr420" wire planes, host prep's prep_frame, the
  batched device-detect app and the training loader against JAX's.
"""

import hashlib
import json
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.serving import multi as JM
from real_time_video_deepfake_detection_tpu.serving import server as JS
from real_time_video_deepfake_detection_tpu.train import data as JD
from real_time_video_deepfake_detection_tpu.utils import native_ingest as NI
from real_time_video_deepfake_detection_tpu.core.config import ServerConfig as JSC
from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig as TSC
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.train import data as TD
from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.native_prep import prep_frame

from tests.test_torch_http import (  # noqa: F401 (fixtures)
    _cfgs, _post, _same_response, jnp_lab, models, ssd,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg_modes")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["inputs"]
NATIVE = sorted(k for k, e in DIGESTS.items() if e["native"] is not None)
ARITH = sorted(k for k in DIGESTS if k.startswith("arith") and "@" not in k)
LOSSLESS = sorted(k for k in DIGESTS if k.startswith("lossless"))
DEEP = sorted(k for k in DIGESTS if k.startswith("bits"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread, beside the other test workers (its thread pool
    made single decode cases tens of times slower there)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(key: str) -> bytes:
    name, _, cut = key.partition("@")
    with open(os.path.join(DATA, name), "rb") as fh:
        data = fh.read()
    return data[:int(cut)] if cut else data


def _digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def _same(got, want):
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_the_fixtures_cover_each_mode():
    coding = {k: _data(k)[:800] for k in DIGESTS if "@" not in k}
    assert sum(b"\xff\xc9" in d for d in coding.values()) >= 8      # SOF9
    assert sum(b"\xff\xca" in d for d in coding.values()) >= 8      # SOF10
    assert sum(b"\xff\xc3" in d for d in coding.values()) >= 16     # SOF3
    assert all(b"\xff\xcc" in coding[k] for k in ARITH)             # DAC
    assert sum(DIGESTS[k]["smoothed"] for k in DIGESTS) > 0


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_routes_equal_jax_native_and_cv2(key):
    data, entry = _data(key), DIGESTS[key]
    native = NI.decode_jpeg(data)
    want_cv2 = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert (_digest(native), _digest(want_cv2)) == (entry["native"], entry["cv2"])
    _same(ID.native_route(data), native)
    _same(ID.cv2_route(data), want_cv2)
    _same(ID.decode_frame(data), JS._decode_frame(data))


@pytest.mark.parametrize("key", NATIVE)
def test_scaled_decode_equals_jax_native_scaled(key):
    jc = J.decode_coefs(_data(key))
    assert jc.smoothing == DIGESTS[key]["smoothed"]
    assert {"1", "3", "4", "8"} <= set(DIGESTS[key]["scaled"])
    for m, want in DIGESTS[key]["scaled"].items():
        frame = J.reconstruct([jc], "cpu", scale=int(m))[0].numpy()
        assert _digest(frame) == {"sha256": want["sha256"], "shape": want["shape"]}, m


@pytest.mark.parametrize("base", ["arith_seq_420_83x41.jpg", "arith_prog_420_83x41.jpg",
                                  "arith_prog_restart_420_83x41.jpg",
                                  "arith_seq_restart_319x241.jpg"])
def test_cut_points_decode_as_jax_native(base):
    data = _data(base)
    sos = data.index(b"\xff\xda")
    cuts = np.random.default_rng(len(base)).integers(sos, len(data), 40)
    smoothed = 0
    for cut in sorted(set(int(c) for c in cuts)):
        t = data[:cut]
        _same(ID.native_route(t), NI.decode_jpeg(t))
        assert ID.cv2_route(t) is None   # cv2 refuses a stream that ends early
        try:
            smoothed += J.decode_coefs(t).smoothing
        except J.JpegError:
            pass
    assert smoothed > 0 or "seq" in base


@pytest.mark.parametrize("key", LOSSLESS + DEEP)
def test_lossless_and_deep_refusals_carry_their_reason(key):
    """The native route refuses every lossless and 12/16-bit frame as
    JAX's libjpeg does; a lossless one names lossless coding."""
    data = _data(key)
    assert NI.decode_jpeg(data) is None
    with pytest.raises(J.JpegError) as e:
        J.decode_coefs(data)
    assert (e.value.status == J.LOSSLESS) == (b"\xff\xc3" in data[:200])


@pytest.mark.parametrize("key", LOSSLESS)
def test_lossless_samples_and_colour(key):
    """cv2's frame is the lossless samples as BGR (no YCbCr conversion), or
    cv2 refuses the frame."""
    data = _data(key)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    try:
        samples, color = J.decode_lossless(data)
    except J.JpegError:
        assert want is None
        return
    if color == "rgb":
        np.testing.assert_array_equal(samples[..., ::-1], want)
    else:
        assert (want is None) == (color != "cmyk")


@pytest.mark.parametrize("plane", ["coef", "ycbcr420"])
def test_wire_planes_carry_arithmetic_streams_as_jax(plane):
    datas = []
    for name in ("arith_seq_640x480_420.jpg", "arith_prog_640x480_420.jpg"):
        data = _data(name)
        sos = data.index(b"\xff\xda")
        datas += [data] + [data[:c] for c in (sos + 200, (sos + len(data)) // 2, len(data) - 2)]
    datas.append(_data("lossless_rgb_p1_83x41.jpg"))
    port = J.decode_coefs_wire_batch if plane == "coef" else J.decode_raw420_batch
    jax_fn = NI.decode_coefs_batch if plane == "coef" else NI.decode_raw420_batch
    got, want = port(datas, 480, 640), jax_fn(datas, 480, 640)
    assert list(got[-1]) == list(want[-1]) and sum(want[-1]) == len(datas) - 1
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a[:len(datas) - 1], b[:len(datas) - 1])


@pytest.mark.parametrize("key", ["arith_seq_720x405_420.jpg", "arith_prog_720x405_420.jpg",
                                 "arith_seq_s411_83x41.jpg", "arith_prog_gray_319x241.jpg",
                                 "arith_seq_420_83x41.jpg@990", "lossless_rgb_p4_83x41.jpg"])
def test_prep_frame_equals_jax(key):
    data = _data(key)
    got, want = prep_frame(data, (256, 256), 160), NI.prep_frame(data, (256, 256), 160)
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == (None if want[2] is None else tuple(int(v) for v in want[2]))
    assert (got[1] is None) == (want[1] is None)
    if want[1] is not None:
        np.testing.assert_array_equal(got[1], want[1])


APP_INPUTS = ["arith_seq_720x405_420.jpg", "arith_prog_s411_83x41.jpg",
              "arith_seq_cmyk_83x41.jpg", "arith_prog_dac_s444_319x241.jpg",
              "arith_prog_420_83x41.jpg@537", "lossless_rgb_p5_83x41.jpg",
              "lossless_sub_2x2_rgb_83x41.jpg", "lossless_gray_p1_83x41.jpg",
              "bits12_sof1_rgb_83x41.jpg"]


def test_batched_device_detect_app_equals_jax(models, ssd, jnp_lab):
    """The device-detect tick's pooled decode (native first, then the cv2
    route per entry, as JAX's tick falls back to cv2) answers every
    arithmetic, lossless and 12-bit upload as the JAX app does."""
    spec_j, pj, spec_t = models
    cj, ct = _cfgs(clahe_device=True)
    skw = dict(max_streams=4, max_batch=4, batch_timeout_ms=2.0, min_request_interval=0.0,
               device_detect=True, detect_capture_hw=(240, 320))
    je = JM.MultiStreamEngine(cj, JSC(**skw), params=pj, spec=spec_j, ssd_net=ssd[0].net)
    te = TM.MultiStreamEngine(ct, TSC(**skw), params=params_from_jax(pj), spec=spec_t,
                              device="cpu", ssd_net=ssd[1].net)
    ja, ta = JM.create_batched_app(je, je.server_cfg), TM.create_batched_app(te, te.server_cfg)
    try:
        errors = [_same_response(_post(ja, "/analyze", _data(k), stream_id="m"),
                                 _post(ta, "/analyze", _data(k), stream_id="m"), k).get("error")
                  for k in APP_INPUTS]
    finally:
        je.shutdown()
        te.shutdown()
    assert errors.count("Invalid image format") == 2   # the gray lossless and 12-bit frames


def test_loader_equals_jax_loader(tmp_path):
    """The training loader (cv2.imread's route) on arithmetic and lossless
    JPEGs, batch for batch against JAX's loader."""
    files = {"real": ["arith_seq_720x405_420.jpg", "arith_prog_s411_83x41.jpg",
                      "lossless_rgb_p2_83x41.jpg", "lossless_sub_2x1_rgb_83x41.jpg"],
             "fake": ["arith_prog_dac_s444_319x241.jpg", "arith_seq_cmyk_83x41.jpg",
                      "lossless_cmyk_83x41.jpg", "arith_prog_gray_319x241.jpg"]}
    for split in ("train", "val"):
        for label, names in files.items():
            d = tmp_path / split / label
            d.mkdir(parents=True)
            for name in names:
                shutil.copy(os.path.join(DATA, name), d / name)
    for split, kw in (("train", dict(shuffle=True, balanced=True)),
                      ("val", dict(shuffle=False, drop_last=False))):
        jl = JD.BatchLoader(JD.DeepfakeDataset(str(tmp_path), split, 32), 4, seed=5,
                            num_workers=2, **kw)
        tl = TD.BatchLoader(TD.DeepfakeDataset(str(tmp_path), split, 32), 4, seed=5,
                            num_workers=2, **kw)
        assert jl.ds.samples == tl.ds.samples and len(jl) == len(tl) > 0
        for (xj, yj), (xt, yt) in zip(jl, tl):
            np.testing.assert_array_equal(xt.numpy(), xj)
            np.testing.assert_array_equal(yt, yj)


def test_simd_idct_torch_equals_its_c_twin():
    """The SIMD-exact islow in torch (the card's path) and in C (the CPU's)
    agree on blocks whose dequantised coefficients wrap and saturate 16
    bits, as a cut arithmetic stream's do."""
    from real_time_video_deepfake_detection_tpu_torch.ops import jpeg_decode as D
    rng = np.random.default_rng(16)
    coef = np.zeros((3, 400, 64), np.int16)
    for b in range(3):
        for i in range(400):
            n = int(rng.integers(1, 64))
            idx = rng.choice(64, n, replace=False)
            coef[b, i, idx] = rng.integers(-32768, 32768, n) if i % 3 else \
                rng.integers(-60, 60, n)
            if i % 5 == 0:
                coef[b, i, 8:] = 0   # the column pass's DC shortcut
    qtab = rng.integers(1, 65536, (3, 64)).astype(np.int32)
    qtab[0] = rng.integers(1, 40, 64)
    c, q = torch.from_numpy(coef), torch.from_numpy(qtab)
    want = D.samples_islow_simd(c, q)
    got = D._samples_islow_simd_torch(c, q)
    assert torch.equal(got, want)
    assert not torch.equal(D.samples_from_coefs(c, q), want)   # the C routine differs
