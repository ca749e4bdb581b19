"""Port parity of wire ingest (ServerConfig.ingest_plane "coef" and
"ycbcr420") on the CPU: the port's pooled wire decode (csrc/jpeg_entropy.cpp
through utils/jpeg_ingest.py) against the JAX package's libjpeg one
(utils/native_ingest.decode_coefs_batch, decode_raw420_batch) byte for byte,
padded rows and zeroed quant tables included; the eligibility flags against
JAX's on JAX's mixed batch, its progressive entry included; the port's wire
step against JAX
make_device_step_detect_wire on the same arrays, for both planes, at the
small size and tolerance of tests/test_torch_detect_tick.py; and a
wire-plane engine against a bgr-plane engine on the same requests: the same
responses, a fallback entry's client-space face_bbox and a corrupt entry's
400 included (probabilities within 1e-6; measured: equal)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC,
)
from real_time_video_deepfake_detection_tpu.models.ssd_res10 import SSDRes10 as JSSD
from real_time_video_deepfake_detection_tpu.serving import batcher as JB
from real_time_video_deepfake_detection_tpu.utils import native_ingest as NI
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC, ServerConfig as TSC,
)
from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import SSDRes10 as TSSD
from real_time_video_deepfake_detection_tpu_torch.ops.jpeg_decode import (
    bgr_from_coefs_420, bgr_from_ycbcr420,
)
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
    MultiStreamEngine as TEngine,
)
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
from real_time_video_deepfake_detection_tpu_torch.utils.convert import params_from_jax
from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import res10_class_ssd

from tests.torch_port_util import assert_same, jax_state_leaves, small_models, small_specs

cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.skipif(NI.get_lib() is None,
                                reason="the JAX package's native library does not load here")

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
TOL = 1e-5
CAPTURE = (240, 320)
EXACT = ("face_bbox", "has_face", "faces_detected", "verdict", "frame_count",
         "full_forensic")


def _frame(h, w, seed):
    """A textured frame on which the synthetic SSD finds faces."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 110 + 60 * np.sin(xx / 13.0) * np.cos(yy / 17.0)
    return np.clip(base[..., None] + r.integers(-40, 41, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(img, quality=85, **flags):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    for k, v in flags.items():
        params += [getattr(cv2, f"IMWRITE_JPEG_{k.upper()}"), v]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def _mixed_batch():
    """JAX's mixed batch (tests/test_jpeg_wire.py) at 480x640 plus a
    progressive stream and more eligible ones."""
    good = _jpeg(_frame(480, 640, 0))
    return [good, _jpeg(_frame(240, 320, 1)),
            _jpeg(_frame(480, 640, 2), sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
            _jpeg(_frame(480, 640, 3)[..., 0]), b"\xff\xd8definitely-not-a-jpeg", good,
            _jpeg(_frame(480, 640, 4), progressive=1), _jpeg(_frame(480, 640, 5), 95),
            _jpeg(_frame(480, 640, 6), 50)]


def test_wire_eligibility_equals_jax_progressive_included():
    datas = _mixed_batch()
    for port, jax_fn in ((J.decode_coefs_wire_batch, NI.decode_coefs_batch),
                         (J.decode_raw420_batch, NI.decode_raw420_batch)):
        want, got = jax_fn(datas, 480, 640), port(datas, 480, 640)
        assert list(want[-1]) == [True, False, False, False, False, True, True, True, True]
        assert list(got[-1]) == list(want[-1])
        for a, b in zip(got[:-1], want[:-1]):   # the progressive row too
            np.testing.assert_array_equal(a[6], b[6])


@pytest.mark.parametrize("pad_to", [0, 16])
def test_wire_arrays_equal_jax_byte_for_byte(pad_to):
    datas = [_jpeg(_frame(480, 640, s), q) for s, q in ((7, 75), (8, 85), (9, 95))]
    with open(os.path.join(DATA, "frame_640x480_q85_420.jpg"), "rb") as fh:
        datas.append(fh.read())
    n, rows = len(datas), max(len(datas), pad_to)
    jy, jc, jq, jok = NI.decode_coefs_batch(datas, 480, 640, pad_to=pad_to)
    ty, tc, tq, tok = J.decode_coefs_wire_batch(datas, 480, 640, pad_to=pad_to)
    assert jok.all() and tok.all()
    assert (ty.shape, tc.shape, tq.shape, tq.dtype) == (
        (rows, 4800, 64), (rows, 2, 1200, 64), (rows, 2, 64), np.uint16)
    for a, b in ((jy, ty), (jc, tc), (jq, tq)):
        np.testing.assert_array_equal(b[:n], a[:n])
    assert (tq[n:] == 0).all() and (jq[n:] == 0).all()
    ry, rc, rok = NI.decode_raw420_batch(datas, 480, 640, pad_to=pad_to)
    sy, sc, sok = J.decode_raw420_batch(datas, 480, 640, pad_to=pad_to)
    assert rok.all() and sok.all() and sy.shape == (rows, 480, 640) and sc.shape == (
        rows, 2, 240, 320)
    np.testing.assert_array_equal(sy[:n], ry[:n])
    np.testing.assert_array_equal(sc[:n], rc[:n])
    # the wire planes reconstruct to the full decode
    full = np.stack([J.decode_jpeg(d) for d in datas])
    coefs = [torch.from_numpy(a[:n]) for a in (ty, tc, tq.astype(np.int32))]
    np.testing.assert_array_equal(bgr_from_coefs_420(*coefs, 480, 640).numpy(), full)
    np.testing.assert_array_equal(bgr_from_ycbcr420(
        torch.from_numpy(sy[:n]), torch.from_numpy(sc[:n])).numpy(), full)


@pytest.fixture(scope="module")
def ssd(tmp_path_factory):
    proto, cm = res10_class_ssd(str(tmp_path_factory.mktemp("ssd")), seed=0,
                                channels=(8, 8, 16, 16), decisive=True)
    return (JSSD.from_caffemodel(cm, proto),
            TSSD.from_caffemodel(cm, proto, device="cpu"))


def _cfgs():
    kw = dict(model_input_size=64, clahe_device=True, detection_threshold=0.5)
    return (JDC(**kw, forensic=JFC(analysis_size=(64, 64))),
            TDC(**kw, forensic=TFC(analysis_size=(64, 64))))


@pytest.mark.parametrize("plane", ["coef", "ycbcr420"])
def test_wire_step_matches_jax(ssd, plane):
    jssd, tssd = ssd
    spec_j, pj, model = small_models(seed=6)
    cj, ct = _cfgs()
    jstep = JB.make_device_step_detect_wire(jssd.net, spec_j, cj, plane, CAPTURE)
    tstep = TB.make_device_step_detect_wire(tssd.net, model, ct, plane, CAPTURE)
    n_slots, b = 6, 8
    sj = JB.init_stream_states(n_slots + 1, cj)
    st = TB.init_stream_states(n_slots + 1, ct)
    rng = np.random.default_rng(11)
    faces = 0
    for t in range(2):
        datas = [_jpeg(_frame(*CAPTURE, 20 + 8 * t + i)) for i in range(6)]
        fn = NI.decode_coefs_batch if plane == "coef" else NI.decode_raw420_batch
        wire = list(fn(datas, *CAPTURE, pad_to=b)[:-1])
        # the padded rows hold garbage, as the engine's do
        for a in wire:
            if a.dtype == np.uint16:
                a[6:] = rng.integers(1, 256, a[6:].shape)
            else:
                info = np.iinfo(a.dtype)
                a[6:] = rng.integers(max(info.min, -1024), min(info.max, 1024) + 1, a[6:].shape)
        active = np.arange(b) < 6
        slot_idx = np.full(b, n_slots, np.int32)
        slot_idx[:6] = rng.permutation(n_slots)
        oj, sj = jstep(pj, *map(jnp.asarray, wire), jnp.asarray(active), jnp.asarray(slot_idx),
                       sj)
        ot, st = tstep(*map(torch.from_numpy, wire + [active, slot_idx]), st)
        assert set(ot) == set(oj)
        for k in oj:
            assert_same(oj[k], ot[k], 0 if k in EXACT else TOL, f"{plane} tick {t} {k}")
        for i, (a, b_) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st))):
            assert_same(a, b_, TOL, f"{plane} tick {t} state leaf {i}")
        faces += int(ot["has_face"].sum())
    assert faces >= 4, "the synthetic SSD found too few faces for the test to bite"


@pytest.mark.parametrize("plane", ["coef", "ycbcr420"])
def test_wire_engine_answers_like_the_bgr_engine(ssd, plane):
    _, tssd = ssd
    _, spec_t = small_specs()
    _, pj, _ = small_models(seed=7)
    skw = dict(max_streams=4, max_batch=4, batch_timeout_ms=2.0, min_request_interval=0.0,
               device_detect=True, detect_capture_hw=CAPTURE)
    engines = {p: TEngine(_cfgs()[1], TSC(**skw, ingest_plane=p), params=params_from_jax(pj),
                          spec=spec_t, device="cpu", ssd_net=tssd.net)
               for p in ("bgr", plane)}
    wire_rows = []
    dispatch = engines[plane]._dispatch_wire
    engines[plane]._dispatch_wire = lambda cfg, arrays, states: (
        wire_rows.append(int(arrays[-2].sum())) or dispatch(cfg, arrays, states))
    small = _frame(*CAPTURE, 40)
    # a 2x upsample is off-size, so not eligible: it takes the full decode
    # and the conform, and its face_bbox comes back in the client's
    # coordinates
    seq = [_jpeg(_frame(*CAPTURE, 41)), _jpeg(small),
           _jpeg(np.repeat(np.repeat(small, 2, axis=0), 2, axis=1), 95),
           _jpeg(_frame(*CAPTURE, 42), sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
           _jpeg(_frame(*CAPTURE, 43), progressive=1), b"\xff\xd8 corrupt",
           _jpeg(_frame(*CAPTURE, 44), 60)]
    try:
        got = {p: [e.analyze_jpeg(d, "s0") for d in seq] for p, e in engines.items()}
    finally:
        for e in engines.values():
            e.shutdown()
    for i, (a, b) in enumerate(zip(got["bgr"], got[plane])):
        assert set(a) == set(b), i
        for k in set(a) - {"processing_time_ms"}:
            if isinstance(a[k], float):
                assert b[k] == pytest.approx(a[k], abs=1e-6), (i, k)
            else:
                assert b[k] == a[k], (i, k)
    r = got[plane]
    assert [x.get("status") for x in r[4:6]] == [None, 400]
    box = r[2].get("face_bbox")
    assert box is not None and box["x"] + box["width"] <= 640 and box["y"] + box["height"] <= 480
    assert [x.get("frame_count") for x in r] == [1, 2, 3, 4, 5, None, 6]
    assert wire_rows == [1, 1, 1, 1], "four eligible requests (one progressive) took the wire"


def test_wire_engine_rejects_what_jax_rejects():
    _, spec_t = small_specs()
    for scfg, match in ((TSC(device_detect=True, ingest_plane="rgb"), "unknown ingest_plane"),
                        (TSC(device_detect=True, ingest_plane="coef",
                             detect_capture_hw=(405, 720)), "divisible by 16")):
        with pytest.raises(ValueError, match=match):
            TEngine(_cfgs()[1], scfg, spec=spec_t, device="cpu")
