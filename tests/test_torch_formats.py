"""The port's image decode against the JAX package's, route by route, on the
format fixtures (tests/data/torch_formats, made by tools/make_torch_format_
fixtures.py): progressive, 4:1:1, 4:4:0, RGB, CMYK and YCCK JPEGs, cuts of a
baseline and a progressive stream, EXIF orientations 1-8, PNG and BMP.
Every frame equal byte for byte, every refusal where JAX refuses:

- the libjpeg route (utils/image_decode.native_route) against the JAX
  package's native decode, and its DCT-scaled decode at every M a hint
  selects against the native scaled decode (the committed digests);
- the cv2 route against cv2.imdecode (and, from files, cv2.imread);
- single-stream /analyze and the batched app in host-prep and
  device-detect mode against the JAX apps (_same_response);
- the "coef" and "ycbcr420" wire planes against JAX's on the progressive
  capture-size stream and its cuts;
- the training loader against the JAX loader on a dataset with a PNG, a
  BMP, a progressive JPEG and EXIF-rotated JPEGs, bit for bit, the
  port's trainer over it, and its fused step's losses over the loader's
  batches against JAX's;
- cuts of the two streams at seeded points against JAX's native decode
  (libjpeg pads them, and block-smooths the progressive ones);
- a PNG whose image data inflates far past its rows, against cv2, with
  the memory its decode holds.
"""

import hashlib
import json
import os
import shutil
import struct
import tracemalloc
import zlib

from functools import partial

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_video_deepfake_detection_tpu.serving import multi as JM
from real_time_video_deepfake_detection_tpu.serving import server as JS
from real_time_video_deepfake_detection_tpu.train import data as JD
from real_time_video_deepfake_detection_tpu.train import steps as JST
from real_time_video_deepfake_detection_tpu.utils import native_ingest as NI
import real_time_video_deepfake_detection_tpu.pipeline.detector as j_detector
from real_time_video_deepfake_detection_tpu.core.config import ServerConfig as JSC
from real_time_video_deepfake_detection_tpu.core.config import TrainConfig as JTC
from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig as TSC
from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.serving import server as TS
from real_time_video_deepfake_detection_tpu_torch.train import data as TD
from real_time_video_deepfake_detection_tpu_torch.train import steps as TST
from real_time_video_deepfake_detection_tpu_torch.train import trainer as TT
from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
from real_time_video_deepfake_detection_tpu_torch.utils import png as png_mod
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax

from tests.test_torch_http import (  # noqa: F401 (fixtures)
    _cfgs, _post, _same_response, jnp_lab, models, ssd,
)
from tests.test_torch_train_step import _jax_fused_draws
from tests.torch_train_util import SIZE, small_effnet

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_formats")
with open(os.path.join(DATA, "digests.json")) as _fh:
    DIGESTS = json.load(_fh)["inputs"]
JPEGS = sorted(k for k, e in DIGESTS.items() if e["native"] is not None)
CAPTURE = (240, 320)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one thread for the whole file, beside the other test
    workers: with torch's thread pool there, single decode cases took tens
    of times longer than alone."""
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


@pytest.mark.parametrize("key", sorted(DIGESTS))
def test_routes_equal_jax_native_and_cv2(key):
    data, entry = _data(key), DIGESTS[key]
    native = NI.decode_jpeg(data) if data[:2] == b"\xff\xd8" else None
    want_cv2 = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert (_digest(native), _digest(want_cv2)) == (entry["native"], entry["cv2"])
    got = ID.native_route(data) if data[:2] == b"\xff\xd8" else None
    _same(got, native)
    _same(ID.cv2_route(data), want_cv2)
    _same(ID.decode_frame(data), JS._decode_frame(data))


@pytest.mark.parametrize("key", JPEGS)
def test_scaled_decode_equals_jax_native_scaled(key):
    jc = J.decode_coefs(_data(key))
    assert jc.smoothing == DIGESTS[key]["smoothed"]
    for m, want in DIGESTS[key]["scaled"].items():
        frame = J.reconstruct([jc], "cpu", scale=int(m))[0].numpy()
        assert _digest(frame) == {"sha256": want["sha256"], "shape": want["shape"]}, m


@pytest.mark.parametrize("base", ["base_420_83x41.jpg", "prog_420_83x41.jpg",
                                  "prog_restart_83x41.jpg", "s411_prog_83x41.jpg"])
def test_cut_points_decode_as_jax_native(base):
    data = _data(base)
    cuts = np.random.default_rng(len(base)).integers(2, len(data), 40)
    smoothed = 0
    for cut in sorted(set(int(c) for c in cuts)):
        t = data[:cut]
        _same(ID.native_route(t), NI.decode_jpeg(t))
        assert ID.cv2_route(t) is None   # cv2 refuses a stream that ends early
        try:
            smoothed += J.decode_coefs(t).smoothing
        except J.JpegError:
            pass
    assert smoothed > 0 or base.startswith("base")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_as_cv2_imread(orientation, tmp_path):
    for name in (f"exif{orientation}_83x41.jpg", "png_exif6_83x41.png"):
        path = str(tmp_path / name)
        shutil.copy(os.path.join(DATA, name), path)
        _same(ID.cv2_route(_data(name)), cv2.imread(path, cv2.IMREAD_COLOR))
    # the libjpeg route ignores it, as JAX's does
    data = _data(f"exif{orientation}_83x41.jpg")
    _same(ID.native_route(data), NI.decode_jpeg(data))


# a sample of each kind for the apps: one per route and layout
APP_INPUTS = ["prog_420_83x41.jpg", "s411_83x41.jpg", "rgb_adobe_83x41.jpg",
              "cmyk_83x41.jpg", "ycck_83x41.jpg", "exif6_83x41.jpg", "png_rgb16_83x41.png",
              "png_palette_short_83x41.png", "bmp_rle8_83x41.bmp", "base_420_83x41.jpg@649",
              "prog_420_83x41.jpg@272", "base_420_83x41.jpg@304", "png_rgb8_83x41.png@300"]


def test_single_stream_analyze_equals_jax(models, jnp_lab):
    spec_j, pj, spec_t = models
    cj, ct = _cfgs()
    ja = JS.create_app(j_detector.DeepfakeDetector(cj, params=pj, spec=spec_j),
                       JSC(min_request_interval=0.0))
    ta = TS.create_app(DeepfakeDetector(ct, params=params_from_jax(pj), spec=spec_t,
                                        device="cpu"), TSC(min_request_interval=0.0))
    codes = [_same_response(_post(ja, "/analyze", _data(k)), _post(ta, "/analyze", _data(k)),
                            k).get("error") for k in APP_INPUTS]
    assert codes.count("Invalid image format") == 2   # the cut header, the cut PNG


@pytest.mark.parametrize("mode", ["host_prep", "device_detect", "scaled_decode", "wire_coef"])
def test_batched_app_equals_jax(models, ssd, jnp_lab, mode):
    """Host prep, the device-detect tick (its pooled decode falls back to
    the cv2 route per entry), with --scaled-decode, and with the coef wire
    plane at the progressive stream's capture size."""
    spec_j, pj, spec_t = models
    skw = dict(max_streams=4, max_batch=4, batch_timeout_ms=2.0, min_request_interval=0.0)
    if mode != "host_prep":
        cj, ct = _cfgs(clahe_device=True)
        skw.update(device_detect=True, detect_capture_hw=CAPTURE,
                   ingest_scaled_decode=mode == "scaled_decode")
        if mode == "wire_coef":
            skw.update(detect_capture_hw=(480, 640), ingest_plane="coef")
        ekw_j, ekw_t = dict(ssd_net=ssd[0].net), dict(ssd_net=ssd[1].net)
    else:
        cj, ct = _cfgs(face_backend="heuristic")
        ekw_j, ekw_t = {}, {}
    je = JM.MultiStreamEngine(cj, JSC(**skw), params=pj, spec=spec_j, **ekw_j)
    te = TM.MultiStreamEngine(ct, TSC(**skw), params=params_from_jax(pj), spec=spec_t,
                              device="cpu", **ekw_t)
    ja, ta = JM.create_batched_app(je, je.server_cfg), TM.create_batched_app(te, te.server_cfg)
    try:
        for k in APP_INPUTS + ["prog_420_640x480.jpg"]:
            _same_response(_post(ja, "/analyze", _data(k), stream_id="f"),
                           _post(ta, "/analyze", _data(k), stream_id="f"), (mode, k))
    finally:
        je.shutdown()
        te.shutdown()


@pytest.mark.parametrize("plane", ["coef", "ycbcr420"])
def test_wire_planes_carry_progressive_streams_as_jax(plane):
    data = _data("prog_420_640x480.jpg")
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    datas = [data] + [data[:c] for c in (sos[1] - 3, (sos[2] + sos[3]) // 2, len(data) - 2)]
    port = J.decode_coefs_wire_batch if plane == "coef" else J.decode_raw420_batch
    jax_fn = NI.decode_coefs_batch if plane == "coef" else NI.decode_raw420_batch
    got, want = port(datas, 480, 640), jax_fn(datas, 480, 640)
    assert list(got[-1]) == list(want[-1]) and want[-1].all()
    for a, b in zip(got[:-1], want[:-1]):
        np.testing.assert_array_equal(a, b)


def _mixed_dataset(root) -> str:
    """train/val of real and fake: progressive and EXIF-rotated JPEGs, PNGs
    (a .png holding a BMP too, which cv2.imread reads by its content)."""
    files = {"real": ["prog_420_83x41.jpg", "exif6_83x41.jpg", "png_rgb8_83x41.png",
                      "s411_83x41.jpg"],
             "fake": ["exif3_83x41.jpg", "png_adam7_rgb16_83x41.png", "cmyk_83x41.jpg",
                      "prog_444_83x41.jpg", "png_exif6_83x41.png"]}
    for split in ("train", "val"):
        for label, names in files.items():
            d = os.path.join(root, split, label)
            os.makedirs(d)
            for name in names:
                shutil.copy(os.path.join(DATA, name), os.path.join(d, name))
    shutil.copy(os.path.join(DATA, "bmp24_83x41.bmp"),
                os.path.join(root, "train", "real", "bmp_as.png"))
    return str(root)


def test_loader_equals_jax_loader_and_trains(tmp_path):
    ds = _mixed_dataset(tmp_path / "ds")
    for split, kw in (("train", dict(shuffle=True, balanced=True)),
                      ("val", dict(shuffle=False, drop_last=False))):
        jl = JD.BatchLoader(JD.DeepfakeDataset(ds, split, 32), 4, seed=3, num_workers=2, **kw)
        tl = TD.BatchLoader(TD.DeepfakeDataset(ds, split, 32), 4, seed=3, num_workers=2, **kw)
        assert jl.ds.samples == tl.ds.samples and len(jl) == len(tl) > 0
        for (xj, yj), (xt, yt) in zip(jl, tl):
            np.testing.assert_array_equal(xt.numpy(), xj)
            np.testing.assert_array_equal(yt, yj)
    r = TT.main(["--dataset", ds, "--output-dir", str(tmp_path / "out"), "--device", "cpu",
                 "--image-size", "32", "--batch-size", "4", "--num-workers", "2",
                 "--epochs", "1"])
    assert np.isfinite(r["log"][0]["train_loss"])


def test_mixed_dataset_trains_with_jax_losses(tmp_path):
    """The fused step over a pass of the mixed dataset, the port's loader
    feeding the port's step and JAX's loader JAX's jitted step, from the
    same parameters and draws: the losses agree within the tolerance of
    test_torch_train_step's three-step test."""
    ds, n = _mixed_dataset(tmp_path / "ds"), 4
    spec_j, spec_t, pj, model = small_effnet(3)
    kw = dict(image_size=SIZE, batch_size=n, lr=1e-3, head_dropout=0.3)
    cfg_j, cfg_t = JTC(**kw), TrainConfig(**kw)
    tx = JST.make_optimizer(cfg_j, 6, spec=spec_j)
    js = JST.init_train_state(jax.tree.map(jnp.asarray, pj), cfg_j, 6, seed=0, tx=tx)
    step_j = jax.jit(partial(JST.fused_train_step, spec=spec_j, cfg=cfg_j, tx=tx))
    ts = TST.init_train_state(model, spec_t, cfg_t, 6, seed=0)
    lkw = dict(shuffle=True, balanced=True, seed=3, num_workers=2)
    jl = JD.BatchLoader(JD.DeepfakeDataset(ds, "train", SIZE), n, **lkw)
    tl = TD.BatchLoader(TD.DeepfakeDataset(ds, "train", SIZE), n, **lkw)
    steps = 0
    for (xj, yj), (xt, yt) in zip(jl, tl):
        draws, _ = _jax_fused_draws(js.rng, spec_j, cfg_j, n)
        js, mj = step_j(js, jnp.asarray(xj), jnp.asarray(yj, jnp.float32))
        mt = TST.fused_train_step(ts, xt, torch.as_tensor(yt, dtype=torch.float32), draws)
        tol = 1e-5 if steps == 0 else 1e-4
        assert abs(float(mt["loss"]) - float(mj["loss"])) <= tol * abs(float(mj["loss"])), steps
        steps += 1
    assert steps == len(tl) >= 2


def _with_idat(data: bytes, raw: bytes) -> bytes:
    """The PNG `data` with its IDAT chunks replaced by one holding `raw`
    deflated."""
    out, at, done = bytearray(data[:8]), 8, False
    while at < len(data):
        length, kind = struct.unpack_from(">I4s", data, at)
        if kind != b"IDAT":
            out += data[at:at + 12 + length]
        elif not done:
            z = zlib.compress(raw, 9)
            out += struct.pack(">I4s", len(z), b"IDAT") + z + struct.pack(
                ">I", zlib.crc32(b"IDAT" + z))
            done = True
        at += 12 + length
    return bytes(out)


@pytest.mark.parametrize("name", ["png_rgb8_83x41.png", "png_adam7_rgb8_83x41.png"])
def test_png_inflates_no_further_than_its_rows(name):
    """An IDAT stream that inflates far past the header's rows decodes as
    cv2 decodes it (libpng stops at the rows), and the decode holds no more
    than the image needs; a stream that stops short of them is refused by
    both."""
    data = _data(name)
    idat = b"".join(p for k, p, _ in png_mod._chunks(data) if k == b"IDAT")
    rows = zlib.decompress(idat)
    bomb = _with_idat(data, rows + bytes(64 << 20))
    assert len(bomb) < len(data) + (1 << 20)
    want = cv2.imdecode(np.frombuffer(bomb, np.uint8), cv2.IMREAD_COLOR)
    _same(ID.cv2_route(data), want)
    ID.cv2_route(bomb)   # the helper library built before the count
    tracemalloc.start()
    try:
        got = ID.cv2_route(bomb)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    _same(got, want)
    assert peak < len(bomb) + 16 * len(rows), peak
    short = _with_idat(data, rows[:-1])
    assert cv2.imdecode(np.frombuffer(short, np.uint8), cv2.IMREAD_COLOR) is None
    assert ID.cv2_route(short) is None


def _without_dht(data: bytes) -> bytes:
    """`data` with the DHT segments before its first scan taken out."""
    out, i = bytearray(data[:2]), 2
    while i + 4 <= len(data):
        length = 2 + ((data[i + 2] << 8) | data[i + 3])
        if data[i + 1] == 0xDA:
            return bytes(out + data[i:])
        if data[i + 1] != 0xC4:
            out += data[i:i + length]
        i += length
    return bytes(out)


@pytest.mark.parametrize("name", ["base_420_83x41.jpg", "exif1_83x41.jpg",
                                  "prog_420_83x41.jpg"])
def test_stream_without_huffman_tables_as_jax(name):
    """A sequential stream without DHT (as Motion-JPEG frames come) takes
    libjpeg's standard tables; a progressive one is refused, as libjpeg
    refuses it."""
    data = _without_dht(_data(name))
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    want = NI.decode_jpeg(data)
    assert (want is None) == name.startswith("prog")
    _same(ID.native_route(data), want)
