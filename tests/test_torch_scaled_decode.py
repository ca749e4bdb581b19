"""Port parity: libjpeg-turbo's DCT-scaled decode (ops/jpeg_scaled.py,
ops/jpeg_decode.bgr_from_components(scale=M), utils/jpeg_ingest.frames_at)
against the JAX package's native decoder (native/ingest.cpp, libjpeg-turbo
2.1.5), byte for byte: every accepted fixture at every M = 1..8 that a
size hint selects; the pooled fast decode at detect_capture_hw (120, 160),
where the 720x405 fixtures decode at M = 4, with the true source dims; the
committed scaled_digests.json (tools/make_torch_scaled_jpeg_digests.py)
against a fresh native decode. Then the device-detect engine with
ingest_scaled_decode against JAX's engine on the fixtures, within the
detect-tick tests' tolerance, and --scaled-decode reaching the engine's
ServerConfig through the server's parser."""

import ctypes
import hashlib
import json
import os

import numpy as np
import pytest

from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC, ServerConfig as JSC,
)
from real_time_video_deepfake_detection_tpu.models.ssd_res10 import SSDRes10 as JSSD
from real_time_video_deepfake_detection_tpu.serving.multi import MultiStreamEngine as JEngine
from real_time_video_deepfake_detection_tpu.utils import native_ingest as NI
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.ops.jpeg_scaled import (
    component_sizes, pick_scale,
)
from real_time_video_deepfake_detection_tpu_torch.serving import multi as TM
from real_time_video_deepfake_detection_tpu_torch.serving import server as TS
from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
    MultiStreamEngine as TEngine,
)
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
    decode_coefs, frames_at, reconstruct,
)
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import small_models, small_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data", "torch_jpeg")
with open(os.path.join(DATA, "scaled_digests.json")) as _fh:
    SCALED = json.load(_fh)["files"]
TOL = 1e-5
CAPTURE = (120, 160)


def _read(name: str) -> bytes:
    with open(os.path.join(DATA, name), "rb") as fh:
        return fh.read()


def _native(data: bytes, hint: int) -> np.ndarray:
    lib = NI.get_lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    buf = lib.ingest_decode(data, len(data), hint, ctypes.byref(h), ctypes.byref(w))
    assert buf
    try:
        return np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.ingest_free(buf)


def test_component_sizes_follow_jdmaster():
    """4:2:0 chroma is scaled up by the IDCT wherever the ratio allows."""
    f420, f422 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1))
    assert [component_sizes(f420, m)[1] for m in range(1, 9)] == [2, 4, 6, 8, 10, 12, 14, 8]
    assert [component_sizes(f422, m)[1] for m in range(1, 9)] == list(range(1, 9))
    assert component_sizes(((1, 1),), 3) == [3]


@pytest.mark.parametrize("name", sorted(SCALED))
def test_scaled_decode_equals_the_native_decoder(name):
    data = _read(name)
    jc = decode_coefs(data)
    for m, entry in SCALED[name].items():
        m = int(m)
        assert pick_scale(jc.height, jc.width, entry["hint"]) == m
        want = _native(data, entry["hint"])
        got = reconstruct([jc], "cpu", scale=m)[0].numpy()
        assert got.shape == want.shape, (name, m)
        assert np.array_equal(got, want), (name, m, int((got != want).sum()))
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"], (name, m)


def test_committed_digests_match_the_native_decoder():
    for name, scales in SCALED.items():
        data = _read(name)
        for m, entry in scales.items():
            img = _native(data, entry["hint"])
            assert list(img.shape) == entry["shape"], (name, m)
            assert hashlib.sha256(img.tobytes()).hexdigest() == entry["sha256"], (name, m)
    assert sum(len(v) for v in SCALED.values()) >= 8 * (len(SCALED) - 1) + 1


def test_pooled_fast_decode_equals_jax_at_the_capture_size():
    names = [n for n in sorted(SCALED) if n != "one_1x1_q85_420.jpg"]
    datas = [_read(n) for n in names]
    want, ok, dims = NI.decode_resize_batch(datas, *CAPTURE, n_threads=1, fast=True,
                                            with_dims=True)
    assert ok.all()
    coefs = [decode_coefs(d) for d in datas]
    assert pick_scale(405, 720, 2 * max(CAPTURE)) == 4
    got = frames_at(coefs, "cpu", CAPTURE, scaled=True).numpy()
    for i, n in enumerate(names):
        assert np.array_equal(got[i], want[i]), (n, int((got[i] != want[i]).sum()))
    assert [[jc.height, jc.width] for jc in coefs] == dims.tolist()


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return (JSSD.from_caffemodel(cm, proto),
            TSSD.from_caffemodel(cm, proto, device="cpu"))


def test_engine_with_the_scaled_decode_matches_jax(ssd):
    jssd, tssd = ssd
    spec_j, pj, _ = small_models(seed=7)
    _, spec_t = small_specs()
    kw = dict(model_input_size=64, clahe_device=True, detection_threshold=0.5)
    skw = dict(max_streams=4, max_batch=8, batch_timeout_ms=2.0, min_request_interval=0.0,
               device_detect=True, detect_capture_hw=CAPTURE, ingest_scaled_decode=True)
    je = JEngine(JDC(**kw, forensic=JFC(analysis_size=(64, 64))), JSC(**skw), params=pj,
                 spec=spec_j, ssd_net=jssd.net)
    te = TEngine(TDC(**kw, forensic=TFC(analysis_size=(64, 64))), TSC(**skw),
                 params=params_from_jax(pj), spec=spec_t, device="cpu", ssd_net=tssd.net)
    seq = [("a", "frame_720x405_q85_420.jpg"), ("b", "frame_405x720_q85_420.jpg"),
           ("a", "q50_720x405_420.jpg"), ("c", "frame_640x480_q85_420.jpg"),
           ("b", "s422_319x241_q85.jpg"), ("a", "q95_720x405_420.jpg")]
    try:
        rj = [je.analyze_jpeg(_read(n), s) for s, n in seq]
        rt = [te.analyze_jpeg(_read(n), s) for s, n in seq]
    finally:
        je.shutdown()
        te.shutdown()
    for i, (a, b) in enumerate(zip(rj, rt)):
        assert a.get("success") and set(a) == set(b), (i, a, b)
        for k in set(a) - {"processing_time_ms"}:
            if isinstance(a[k], float):
                assert b[k] == pytest.approx(a[k], abs=TOL), (i, k)
            else:
                assert b[k] == a[k], (i, k)
    assert sum("face_bbox" in r for r in rt) >= 1


def test_server_parser_passes_scaled_decode_to_the_engine(monkeypatch, tmp_path):
    seen = {}

    class Stop(Exception):
        pass

    def engine(cfg, scfg, **kw):
        seen["scfg"] = scfg
        raise Stop

    monkeypatch.setattr(TM, "MultiStreamEngine", engine)
    proto, cm = res10_class_ssd(str(tmp_path), seed=0, channels=(8, 8, 16, 16))
    with pytest.raises(Stop):
        TS.main(["--batched", "--device-detect", "--ssd-weights", cm, "--scaled-decode",
                 "--device", "cpu"])
    assert seen["scfg"].ingest_scaled_decode and seen["scfg"].device_detect
