"""The port's serving benchmark (cli/bench.py) in its other modes, on the
CPU at 1-2 streams: the detect core with the MTCNN cascade in every tick
and with the bf16 SSD, the engine end to end in host-prep mode and on each
wire plane, and the detect core's FLOP count. Kept apart from
tests/test_torch_bench.py so that the two files share the test run's
workers evenly."""

import pytest
import torch

from real_time_video_deepfake_detection_tpu_torch.cli import bench as B


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
