"""The port's serving benchmark (cli/bench.py) and the ticks it drives, on
the CPU: serving/batcher.device_step_from_capture against the JAX tick
(small EfficientNet spec with carried parameters, 64x64 analysis frames,
three chained ticks; integers exactly, floats within 1e-5 as in
tests/test_torch_tick.py); every bench function at 2 streams and one window
with device="cpu", returning its keys beside the device's name; each
raising without CUDA when given no device; main's one JSON line."""

import functools
import io
import json
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import real_time_video_deepfake_detection_tpu.kernels.preproc as j_preproc
from real_time_video_deepfake_detection_tpu.core.config import (
    DetectorConfig as JDC, ForensicConfig as JFC,
)
from real_time_video_deepfake_detection_tpu.serving import batcher as JB
from real_time_video_deepfake_detection_tpu_torch.cli import bench as B
from real_time_video_deepfake_detection_tpu_torch.core.config import (
    DetectorConfig as TDC, ForensicConfig as TFC,
)
from real_time_video_deepfake_detection_tpu_torch.ops.resize import resize_bilinear_u8_cv2
from real_time_video_deepfake_detection_tpu_torch.serving import batcher as TB
from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves

from tests.torch_port_util import assert_same, jax_state_leaves, small_models


@pytest.mark.parametrize("schedule,pallas", [("frame", False), ("tick_full", True),
                                             ("tick_fast", True)])
def test_device_step_from_capture_matches_jax(monkeypatch, schedule, pallas):
    monkeypatch.setattr(j_preproc, "preprocess_faces_pallas", functools.partial(
        j_preproc.preprocess_faces_pallas, interpret=True))
    spec_j, pj, model = small_models(seed=6)
    kw = dict(use_pallas_preproc=pallas, use_pallas_color=pallas, model_input_size=64,
              mtcnn_image_size=40, detection_threshold=0.55, forensic_schedule=schedule)
    cj = JDC(**kw, forensic=JFC(analysis_size=(64, 64)))
    ct = TDC(**kw, forensic=TFC(analysis_size=(64, 64)))
    n = 2
    sj, st = JB.init_stream_states(n, cj), TB.init_stream_states(n, ct)
    rng = np.random.default_rng(21)
    for t in range(3):
        frames = rng.integers(0, 256, (n, 96, 128, 3), dtype=np.uint8)
        faces = (rng.random((n, 40, 40, 3), dtype=np.float32) * 255).astype(np.float32)
        has_face = np.array([True, t % 2 == 0])
        face_hw = np.array([[120, 120], [60, 90]], np.int32)
        active = np.array([True, t != 1])
        args = (frames, faces, has_face, face_hw, active)
        oj, sj = JB.device_step_from_capture(spec_j, cj, pj, *map(jnp.asarray, args), sj)
        ot, st = TB.device_step_from_capture(model, ct, *map(torch.from_numpy, args), st)
        assert set(ot) == set(oj)
        for k in oj:
            assert_same(oj[k], ot[k], 1e-5, f"tick {t} {k}")
        for i, (a, b) in enumerate(zip(jax_state_leaves(sj), tree_leaves(st))):
            assert_same(a, b, 1e-5, f"tick {t} state leaf {i}")
        small = resize_bilinear_u8_cv2(torch.from_numpy(frames), 64, 64)
        assert np.array_equal(small.numpy(), np.asarray(
            JB.resize_frames_on_device(jnp.asarray(frames), 64, 64)))


_CPU_RUNS = {
    "bench_core": (dict(n_streams=2, window=1, n_windows=1, warm_windows=0),
                   {"fps", "tick_ms_p50", "tick_ms_p95", "ticks", "streams"}),
    "bf16_parity_guard": (dict(n_streams=2, n_ticks=1),
                          {"max_prob_diff", "verdicts_equal", "ok"}),
    "tick_schedule_guard": (dict(n_streams=2, n_ticks=3), {"ok", "ticks"}),
    "bench_core_detect": (dict(n_streams=2, window=1, n_windows=1, warm_windows=0,
                               latency_iters=1),
                          {"fps", "tick_ms_p50", "tick_ms_p95", "req_ms_p50", "req_ms_p95",
                           "gflop_per_tick_conv_matmul", "achieved_tflops",
                           "bf16_peak_tflops", "mfu_pct_bf16peak", "power_limit", "ssd",
                           "mtcnn"}),
    "detect_ssd_bf16_guard": (dict(n_streams=2, n_ticks=1),
                              {"ok", "max_prob_diff", "boxes_equal", "n_faces_seen"}),
    "bench_prep_scaling": (dict(n=4, threads=(1, 2), repeats=1),
                           {"frames", "exact", "coef1", "raw4201"}),
    "bench_e2e": (dict(n_streams=2, frames_per_stream=1),
                  {"mode", "fps", "req_ms_p50", "req_ms_p95", "requests", "ticks"}),
}


@pytest.mark.parametrize("name", sorted(_CPU_RUNS))
def test_bench_function_runs_on_the_cpu(name):
    kw, keys = _CPU_RUNS[name]
    r = getattr(B, name)(device="cpu", **kw)
    assert r["device"] == "cpu"
    assert keys <= set(r), keys - set(r)
    if name == "detect_ssd_bf16_guard":
        # a verdict, not a requirement: on the CPU the synthetic SSD's bf16
        # boxes move by a pixel on some random frames, and the bench then
        # keeps the f32 SSD
        assert r["ok"] is (r["boxes_equal"] and r["max_prob_diff"] < 1e-3)
        assert r["n_faces_seen"] >= 0
    elif "ok" in r:
        assert r["ok"] is True
    if "fps" in r:
        assert r["fps"] > 0 and r["tick_ms_p50" if "tick_ms_p50" in r else "req_ms_p50"] > 0
    if name == "bench_core_detect":
        assert r["gflop_per_tick_conv_matmul"] > 1.0    # SSD + B0 on 2 streams
        assert r["mfu_pct_bf16peak"] == r["bf16_peak_tflops"] == -1.0
        assert r["power_limit"] is None
    if name == "bench_prep_scaling":
        assert set(r["exact"]) == {1, 2}
    if name == "bench_e2e":
        assert r["requests"] == 2 and r["mode"] == "device-detect"


@pytest.mark.parametrize("kw", [dict(mtcnn=True), dict(ssd_bf16=True)],
                         ids=["mtcnn", "ssd_bf16"])
def test_bench_core_detect_modes_on_the_cpu(kw, monkeypatch):
    """The MTCNN core (the cascade in every tick, _decisive_mtcnn's weights)
    and the bf16 SSD, at 2 streams; the MTCNN core's cascade accepts every
    SSD face."""
    ticks = []
    make = B.make_device_step_detect

    def recording(*args):
        step = make(*args)

        def run(*a):
            out = step(*a)
            ticks.append(out)
            return out
        return run

    monkeypatch.setattr(B, "make_device_step_detect", recording)
    r = B.bench_core_detect(n_streams=2, window=1, n_windows=1, warm_windows=0,
                            latency_iters=0, device="cpu", **kw)
    assert r["device"] == "cpu" and r["fps"] > 0 and r["tick_ms_p50"] > 0
    assert r["ssd"] == ("bf16" if kw.get("ssd_bf16") else "f32")
    assert r["mtcnn"] is bool(kw.get("mtcnn"))
    assert ticks
    if kw.get("mtcnn"):
        sds = B._decisive_mtcnn()
        assert sds["onet"]["dense6_1.bias"].tolist() == [-5.0, 5.0]
        assert ticks[0][0]["face_probability"].dtype == torch.float32


@pytest.mark.parametrize("kw", [dict(device_detect=False), dict(ingest_plane="coef"),
                                dict(ingest_plane="ycbcr420")])
def test_bench_e2e_modes_on_the_cpu(kw):
    r = B.bench_e2e(n_streams=2, frames_per_stream=2, device="cpu", **kw)
    assert r["device"] == "cpu" and r["requests"] == 4
    assert r["mode"] == ("heuristic-host-prep" if "device_detect" in kw
                         else f"device-detect wire:{kw['ingest_plane']}")


@pytest.mark.parametrize("name", sorted(_CPU_RUNS) + ["main"])
def test_bench_raises_without_cuda_when_given_no_device(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        B.main([]) if name == "main" else getattr(B, name)()


def test_bf16_peak_by_device_name():
    assert B._bf16_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert B._bf16_peak_tflops("NVIDIA A100-SXM4-40GB") == -1.0
    assert B._bf16_peak_tflops("cpu") == -1.0


def _fake_phases(monkeypatch, calls, fail=None):
    """Stand-ins for the phases (they are tested above): record the order,
    return their keys, raise in `fail`."""
    def fake(name, result):
        def run(*args, **kw):
            calls.append((name, kw))
            if name == fail:
                raise RuntimeError(f"{name} failed")
            extra = {}
            if name == "bench_core_detect":
                extra = dict(ssd="bf16" if kw.get("ssd_bf16") else "f32",
                             mtcnn=kw.get("mtcnn", False))
            return dict(result, device="cpu", **extra)
        monkeypatch.setattr(B, name, run)

    core = dict(fps=100.0, tick_ms_p50=10.0, tick_ms_p95=12.0)
    fake("bench_core", core)
    fake("bf16_parity_guard", dict(ok=True, max_prob_diff=1e-4, verdicts_equal=True))
    fake("tick_schedule_guard", dict(ok=True))
    fake("detect_ssd_bf16_guard", dict(ok=True, max_prob_diff=2e-4, boxes_equal=True,
                                       n_faces_seen=3))
    fake("bench_core_detect", dict(core, req_ms_p50=20.0, req_ms_p95=25.0,
                                   gflop_per_tick_conv_matmul=50.0, achieved_tflops=5.0,
                                   bf16_peak_tflops=-1.0, mfu_pct_bf16peak=-1.0))
    fake("bench_e2e", dict(mode="device-detect", fps=90.0, req_ms_p50=30.0, req_ms_p95=40.0))
    fake("bench_prep_scaling", dict(exact={1: 100.0, 2: 60.0, 4: 40.0}, coef1=20.0,
                                    raw4201=35.0))


def test_main_prints_one_json_line(monkeypatch):
    calls = []
    _fake_phases(monkeypatch, calls)
    out = io.StringIO()
    with redirect_stdout(out):
        assert B.main(["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert set(r) == {"metric", "value", "unit", "vs_baseline", "ssd", "ssd_bf16_guard",
                      "mtcnn_core"}
    assert r["metric"] == "serving_frames_per_sec_per_chip"
    assert r["value"] == 100.0 and r["vs_baseline"] == 10.0
    assert "one cpu (power limit None)" in r["unit"]
    assert "not run (not ported yet): the DCT-scaled decode" in r["unit"]
    # the guard passed, the bf16 SSD was no faster (equal fps), so the f32
    # SSD is reported, and the line says why
    assert r["ssd"] == "f32" and "passed its guard" in r["unit"]
    assert r["ssd_bf16_guard"] == dict(ok=True, max_prob_diff=2e-4, boxes_equal=True,
                                       n_faces_seen=3)
    assert r["mtcnn_core"] == {"fps": 100.0, "tick_ms_p50": 10.0}
    assert "MTCNN P/R/O cascade also in the tick" in r["unit"]
    order = [name for name, _ in calls]
    # the fast classify modes were no faster (equal fps): bf16 alone is tried
    assert order[:6] == ["bench_core", "bf16_parity_guard", "tick_schedule_guard",
                         "bench_core", "bench_core", "detect_ssd_bf16_guard"]
    assert order[-5:] == ["bench_e2e"] * 4 + ["bench_prep_scaling"]
    detect_calls = [kw for name, kw in calls if name == "bench_core_detect"]
    assert [kw.get("n_streams") for kw in detect_calls] == [None, None, None, 128, 32, None]
    assert [bool(kw.get("ssd_bf16")) for kw in detect_calls] == [True] + [False] * 5
    assert [bool(kw.get("mtcnn")) for kw in detect_calls] == [False] * 5 + [True]


def test_main_reports_the_f32_ssd_when_its_guard_fails(monkeypatch):
    calls = []
    _fake_phases(monkeypatch, calls)
    monkeypatch.setattr(B, "detect_ssd_bf16_guard", lambda **kw: dict(
        device="cpu", ok=False, max_prob_diff=3e-3, boxes_equal=False, n_faces_seen=2))
    out = io.StringIO()
    with redirect_stdout(out):
        assert B.main(["--device", "cpu"]) == 0
    r = json.loads(out.getvalue())
    assert r["ssd"] == "f32" and r["ssd_bf16_guard"]["ok"] is False
    assert "the bf16 SSD failed its guard" in r["unit"]
    assert not any(kw.get("ssd_bf16") for name, kw in calls if name == "bench_core_detect")


def test_main_fails_with_the_failing_phase(monkeypatch):
    _fake_phases(monkeypatch, [], fail="bench_e2e")
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(RuntimeError, match="bench_e2e failed"):
        B.main(["--device", "cpu"])
    assert out.getvalue() == ""


def test_detect_core_flops_count_what_they_name():
    """The FLOP count sees the SSD's and B0's convolutions and matrix
    products: fewer streams, fewer FLOPs, in proportion."""
    r1 = B.bench_core_detect(n_streams=1, window=1, n_windows=1, warm_windows=0,
                             latency_iters=0, device="cpu")
    r2 = B.bench_core_detect(n_streams=2, window=1, n_windows=1, warm_windows=0,
                             latency_iters=0, device="cpu")
    assert r2["gflop_per_tick_conv_matmul"] == pytest.approx(
        2 * r1["gflop_per_tick_conv_matmul"], rel=1e-9)
    assert r1["req_ms_p50"] == -1.0
