"""Serving benchmark of the port on one card: ONE JSON line on stdout.

Port of real_time_video_deepfake_detection_tpu/cli/bench.py:

1. Classify core: 64 streams, each tick one call of
   serving/batcher.device_step_from_capture (480x640 -> 256 resize, the six
   forensic signals, EfficientNet-B0 on pre-staged 160x160 faces, the
   tracker and the verdict), the stream state chained tick to tick; timed
   in windows of 8 ticks with one synchronize at each window's end. Two
   guarded modes may take over: bf16 (bf16_parity_guard) and the
   tick-scheduled forensics (tick_schedule_guard).
2. Detect core, the headline: the same with SSD-Res10-class detection, the
   300/256 resizes, per-stream crop and align and device CLAHE in the tick
   (serving/batcher.make_device_step_detect), and the depth-1 request
   latency (host frames -> copy -> tick -> verdict read back). The SSD
   carries synthetic weights (utils/ssd_synth.py, seed 0): the real
   caffemodel is not in the repository. The SSD in bf16 runs there only
   behind its guard (detect_ssd_bf16_guard: identical faces, boxes, counts
   and verdicts, probability drift below 1e-3) and only when it is faster
   than the f32 SSD. Then 128 streams and 32 streams, and the MTCNN core:
   the same tick with the P/R/O cascade aligning every crop
   (DetectorConfig.mtcnn_device; seeded facenet-shaped weights whose class
   heads accept, _decisive_mtcnn).
3. End to end: MultiStreamEngine.analyze_jpeg from 64 client threads, in
   device-detect mode with the bgr, coef and ycbcr420 wire planes and in
   host-prep mode pinned to the heuristic face rung; and the pooled host
   decode at 1, 2 and 4 threads. The JPEGs are the committed 480x640
   fixtures of tests/data/torch_jpeg/, so the bench runs from a checkout
   of the repository, not from an installed package.

Every tick runs the preprocess and hue kernels (DetectorConfig.
use_pallas_preproc, use_pallas_color) and, in device-detect mode, the two
CLAHE kernels. Left out: the DCT-scaled decode; the unit string says so.
The weights are random, from seed 0. Every number is measured in this run
on the device it names; a phase that fails ends the run with its error and
a non-zero exit.

    python -m real_time_video_deepfake_detection_tpu_torch.cli.bench [--device cpu]

Baseline: the reference serves one stream at most 10 frames/s (its 100 ms
global rate limit, backend_server.py:63), so vs_baseline = frames/s / 10.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import DetectorConfig, ServerConfig
from ..core.device import resolve_device
from ..models import backbones
from ..models.mtcnn import build_nets, init_random_mtcnn
from ..serving.batcher import (
    device_step_from_capture, init_stream_states, make_device_step_detect,
)

Device = Optional[Union[str, torch.device]]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JPEG_DIR = os.path.join(_REPO, "tests", "data", "torch_jpeg")
# 4:2:0 JPEGs at the capture size, so every wire plane carries them
CAPTURE_JPEGS = ("frame_640x480_q85_420.jpg", "q50_640x480_420.jpg", "q95_640x480_420.jpg")
CAPTURE_HW = (480, 640)

# dense bf16 peak TFLOP/s by device name (NVIDIA's data sheet, the SXM
# part at its 700 W limit); any other name gives -1 and no MFU
_BF16_PEAK_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 SXM", 989.0))


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit(dev: torch.device) -> Optional[str]:
    """The card's power limit as nvidia-smi reports it (None on the CPU)."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    r = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return r.stdout.strip() if r.returncode == 0 else "unavailable"


def _bf16_peak_tflops(name: str) -> float:
    for key, tflops in _BF16_PEAK_TFLOPS:
        if key in name:
            return tflops
    return -1.0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _model(dev: torch.device):
    """Full-size EfficientNet-B0 with random weights from seed 0."""
    model = backbones.build_model(backbones.make("b0"),
                                  generator=torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def _cfg(bf16: bool = False, **kw) -> DetectorConfig:
    cfg = dataclasses.replace(DetectorConfig().with_threshold(0.55), use_pallas_preproc=True,
                              use_pallas_color=True, **kw)
    return dataclasses.replace(cfg, bf16_inference=True) if bf16 else cfg


def _tick_cfgs(cfg: DetectorConfig, tick_schedule: bool):
    """The engine's ServerConfig.forensic_tick_schedule alternation: the
    full program every full_forensic_interval-th tick, the fast trio
    otherwise; without it, the per-stream frame schedule in every tick."""
    if tick_schedule:
        return (dataclasses.replace(cfg, forensic_schedule="tick_full"),
                dataclasses.replace(cfg, forensic_schedule="tick_fast"))
    return cfg, cfg


def _windows(tick, states, dev, window, n_windows, warm_windows):
    """Run (n_windows + warm_windows) windows of `window` ticks, chaining
    the state, with one synchronize at each window's end. Returns (ms per
    tick of each measured window, ticks run, seconds, states)."""
    per_tick_ms, i = [], 0
    t_all = time.perf_counter()
    for w in range(n_windows + warm_windows):
        t0 = time.perf_counter()
        for _ in range(window):
            _, states = tick(i, states)
            i += 1
        _sync(dev)
        if w >= warm_windows:
            per_tick_ms.append((time.perf_counter() - t0) / window * 1e3)
    return per_tick_ms, i, time.perf_counter() - t_all, states


def _pct(xs, q) -> float:
    return float(np.percentile(xs, q)) if xs else -1.0


def _core_inputs(n_streams: int, seed: int, dev: torch.device, n_variants: int):
    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.integers(0, 256, (n_streams, *CAPTURE_HW, 3),
                                            dtype=np.uint8)).to(dev)
              for _ in range(n_variants)]
    faces = [torch.from_numpy(rng.random((n_streams, 160, 160, 3), dtype=np.float32)
                              * 255.0).to(dev) for _ in range(n_variants)]
    return frames, faces


def _core_masks(n_streams: int, dev: torch.device):
    """has_face, face_hw (120 px crops) and active, for every stream."""
    ones = torch.ones((n_streams,), dtype=torch.bool, device=dev)
    return ones, torch.full((n_streams, 2), 120, dtype=torch.int32, device=dev), ones


# ------------------------------------------------------------ classify core

@torch.no_grad()
def bench_core(n_streams: int = 64, window: int = 8, n_windows: int = 12,
               warm_windows: int = 2, bf16: bool = False, tick_schedule: bool = False,
               device: Device = None) -> dict:
    """Classify-only serving core: frames/s and the tick's p50/p95 ms."""
    dev = resolve_device(device)
    cfg = _cfg(bf16)
    tick_cfgs = _tick_cfgs(cfg, tick_schedule)
    model = _model(dev)
    states = init_stream_states(n_streams, cfg, dev)
    frames, faces = _core_inputs(n_streams, 0, dev, 4)
    has_face, face_hw, active = _core_masks(n_streams, dev)

    def tick(i, states):
        c = tick_cfgs[0 if i % cfg.full_forensic_interval == 0 else 1]
        return device_step_from_capture(model, c, frames[i % 4], faces[i % 4], has_face,
                                        face_hw, active, states)

    for i in range(2):   # both schedule variants once, before the clock
        _, states = tick(i, states)
    _sync(dev)
    per_tick_ms, n_ticks, elapsed, _ = _windows(tick, states, dev, window, n_windows,
                                                warm_windows)
    return {"device": device_name(dev), "streams": n_streams, "ticks": n_ticks,
            "fps": n_streams * n_ticks / elapsed,
            "tick_ms_p50": _pct(per_tick_ms, 50), "tick_ms_p95": _pct(per_tick_ms, 95)}


@torch.no_grad()
def bf16_parity_guard(n_streams: int = 64, n_ticks: int = 4, device: Device = None) -> dict:
    """fp32 against bf16 on the same frames, faces and state: bf16 may carry
    the headline only when every face probability stays within 1e-3 and
    every verdict is equal."""
    dev = resolve_device(device)
    cfg32, cfg16 = _cfg(), _cfg(bf16=True)
    model = _model(dev)
    frames, faces = _core_inputs(n_streams, 7, dev, 1)
    has_face, face_hw, active = _core_masks(n_streams, dev)
    s32 = init_stream_states(n_streams, cfg32, dev)
    s16 = init_stream_states(n_streams, cfg16, dev)
    max_dp, verdicts_equal = 0.0, True
    for _ in range(n_ticks):
        o32, s32 = device_step_from_capture(model, cfg32, frames[0], faces[0], has_face,
                                            face_hw, active, s32)
        o16, s16 = device_step_from_capture(model, cfg16, frames[0], faces[0], has_face,
                                            face_hw, active, s16)
        max_dp = max(max_dp, float((o32["face_probability"]
                                    - o16["face_probability"]).abs().max()))
        verdicts_equal &= bool(torch.equal(o32["verdict"], o16["verdict"]))
    return {"device": device_name(dev), "max_prob_diff": max_dp,
            "verdicts_equal": verdicts_equal, "ok": verdicts_equal and max_dp < 1e-3}


@torch.no_grad()
def tick_schedule_guard(bf16: bool = False, n_streams: int = 64, n_ticks: int = 6,
                        device: Device = None) -> dict:
    """The tick-level full/fast alternation against the per-stream frame
    schedule, for streams that tick together from frame 0 (the bench's):
    ok when the outputs are bit-identical."""
    dev = resolve_device(device)
    cfg = _cfg(bf16)
    variants = _tick_cfgs(cfg, True)
    model = _model(dev)
    frames, faces = _core_inputs(n_streams, 13, dev, 1)
    has_face, face_hw, active = _core_masks(n_streams, dev)
    s_a = init_stream_states(n_streams, cfg, dev)
    s_b = init_stream_states(n_streams, cfg, dev)
    ok = True
    for i in range(n_ticks):
        oa, s_a = device_step_from_capture(model, cfg, frames[0], faces[0], has_face,
                                           face_hw, active, s_a)
        c = variants[0 if i % cfg.full_forensic_interval == 0 else 1]
        ob, s_b = device_step_from_capture(model, c, frames[0], faces[0], has_face,
                                           face_hw, active, s_b)
        for k in ("fake_probability", "frame_forensic_probability", "verdict"):
            ok &= bool(torch.equal(oa[k], ob[k]))
    return {"device": device_name(dev), "ticks": n_ticks, "ok": ok}


# -------------------------------------------------------------- detect core

def _synthetic_ssd(dev: torch.device):
    """The res10-class SSD with synthetic weights (seed 0, decisive: its
    confidences saturate as a trained detector's do), loaded on `dev`; the
    files live in a temporary directory only while they are read."""
    from ..models.caffe_net import CaffeNet
    from ..utils.ssd_synth import res10_class_ssd
    d = tempfile.mkdtemp(prefix="bench_ssd_")
    try:
        proto, caffemodel = res10_class_ssd(d, seed=0, decisive=True)
        return CaffeNet(proto, caffemodel).to(dev).eval()
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _flops_per_tick(steps, tick_cfgs, full_interval: int, args) -> float:
    """FLOPs of one tick, averaged over the forensic schedule, as
    torch.utils.flop_counter counts them: convolutions and matrix products
    only. The hand-written kernels (ctypes) and elementwise work are not
    counted."""
    from torch.utils.flop_counter import FlopCounterMode
    fl = {}
    for c in dict.fromkeys(tick_cfgs):
        with FlopCounterMode(display=False) as counter:
            steps[c](*args)
        fl[c] = float(counter.get_total_flops())
    return (fl[tick_cfgs[0]] + (full_interval - 1) * fl[tick_cfgs[1]]) / full_interval


def _decisive_mtcnn(seed: int = 5, bias: float = 5.0):
    """The JAX package's init_random_mtcnn(seed) weights with the class
    heads biased by -bias / +bias so the cascade accepts: the bench's stand-in
    for facenet's weights, at the cascade's real shapes and FLOPs."""
    sds = init_random_mtcnn(seed)
    for net, head in (("pnet", "conv4_1"), ("rnet", "dense5_1"), ("onet", "dense6_1")):
        sds[net][f"{head}.bias"] = torch.tensor([-bias, bias])
    return sds


@torch.no_grad()
def bench_core_detect(n_streams: int = 64, window: int = 8, n_windows: int = 10,
                      warm_windows: int = 2, bf16: bool = False, tick_schedule: bool = False,
                      latency_iters: int = 12, ssd_bf16: bool = False, mtcnn: bool = False,
                      device: Device = None) -> dict:
    """Capture-to-verdict serving core: frames/s, the tick's p50/p95 ms,
    the depth-1 request latency, FLOPs per tick and the share of the bf16
    peak they reach. ssd_bf16: the SSD in bfloat16; mtcnn: the P/R/O
    cascade in the tick (_decisive_mtcnn's weights)."""
    dev = resolve_device(device)
    cfg = _cfg(bf16, clahe_device=True, ssd_bf16=ssd_bf16, mtcnn_device=mtcnn)
    tick_cfgs = _tick_cfgs(cfg, tick_schedule)
    net = _synthetic_ssd(dev)
    model = _model(dev)
    mtcnn_nets = build_nets(_decisive_mtcnn(), dev) if mtcnn else None
    steps = {c: make_device_step_detect(net, model, c, mtcnn_nets)
             for c in dict.fromkeys(tick_cfgs)}
    states = init_stream_states(n_streams + 1, cfg, dev)   # + the dummy row
    rng = np.random.default_rng(0)
    frames_host = [rng.integers(0, 256, (n_streams, *CAPTURE_HW, 3), dtype=np.uint8)
                   for _ in range(4)]
    frames_dev = [torch.from_numpy(f).to(dev) for f in frames_host]
    active = torch.ones((n_streams,), dtype=torch.bool, device=dev)
    slot_idx = torch.arange(n_streams, dtype=torch.int32, device=dev)

    def tick(i, states, on_device=True):
        c = tick_cfgs[0 if i % cfg.full_forensic_interval == 0 else 1]
        f = (frames_dev[i % 4] if on_device
             else torch.from_numpy(frames_host[i % 4]).to(dev))
        return steps[c](f, active, slot_idx, states)

    for i in range(2):
        _, states = tick(i, states)
    _sync(dev)
    flops = _flops_per_tick(steps, tick_cfgs, cfg.full_forensic_interval,
                            (frames_dev[0], active, slot_idx, states))
    per_tick_ms, n_ticks, elapsed, states = _windows(tick, states, dev, window, n_windows,
                                                     warm_windows)
    # request latency: host frames -> copy -> one tick -> verdict on the host
    req_ms = []
    for k in range(latency_iters):
        t0 = time.perf_counter()
        out, states = tick(k, states, on_device=False)
        out["verdict"].cpu()
        req_ms.append((time.perf_counter() - t0) * 1e3)
    name = device_name(dev)
    peak = _bf16_peak_tflops(name)
    tflops = flops / (_pct(per_tick_ms, 50) / 1e3) / 1e12
    return {"device": name, "power_limit": power_limit(dev), "streams": n_streams,
            "ssd": "bf16" if ssd_bf16 else "f32", "mtcnn": mtcnn,
            "ticks": n_ticks, "fps": n_streams * n_ticks / elapsed,
            "tick_ms_p50": _pct(per_tick_ms, 50), "tick_ms_p95": _pct(per_tick_ms, 95),
            "req_ms_p50": _pct(req_ms, 50), "req_ms_p95": _pct(req_ms, 95),
            "gflop_per_tick_conv_matmul": flops / 1e9, "achieved_tflops": tflops,
            "bf16_peak_tflops": peak,
            "mfu_pct_bf16peak": 100.0 * tflops / peak if peak > 0 else -1.0}


@torch.no_grad()
def detect_ssd_bf16_guard(n_streams: int = 64, n_ticks: int = 3, device: Device = None) -> dict:
    """The SSD in bf16 against the SSD in f32 on the same frames and state:
    the bf16 SSD may carry the headline only when has_face, the boxes of
    face rows, faces_detected and verdicts are identical and every fake
    probability stays within 1e-3."""
    dev = resolve_device(device)
    cfg32 = _cfg(clahe_device=True)
    cfg16 = dataclasses.replace(cfg32, ssd_bf16=True)
    net = _synthetic_ssd(dev)
    model = _model(dev)
    s32 = make_device_step_detect(net, model, cfg32)
    s16 = make_device_step_detect(net, model, cfg16)
    rng = np.random.default_rng(11)
    active = torch.ones((n_streams,), dtype=torch.bool, device=dev)
    slot_idx = torch.arange(n_streams, dtype=torch.int32, device=dev)
    st32 = init_stream_states(n_streams + 1, cfg32, dev)
    st16 = init_stream_states(n_streams + 1, cfg16, dev)
    equal, max_dp, n_faces_seen = True, 0.0, 0
    for _ in range(n_ticks):
        frames = torch.from_numpy(rng.integers(0, 256, (n_streams, *CAPTURE_HW, 3),
                                               dtype=np.uint8)).to(dev)
        o32, st32 = s32(frames, active, slot_idx, st32)
        o16, st16 = s16(frames, active, slot_idx, st16)
        hf = o32["has_face"]
        # box rows mean something only where a face was selected
        equal &= bool(torch.equal(hf, o16["has_face"])
                      and torch.equal(o32["face_bbox"][hf], o16["face_bbox"][hf])
                      and torch.equal(o32["faces_detected"], o16["faces_detected"])
                      and torch.equal(o32["verdict"], o16["verdict"]))
        n_faces_seen += int(hf.sum())
        max_dp = max(max_dp, float((o32["fake_probability"]
                                    - o16["fake_probability"]).abs().max()))
    return {"device": device_name(dev), "ok": equal and max_dp < 1e-3,
            "max_prob_diff": max_dp, "boxes_equal": equal, "n_faces_seen": n_faces_seen}


# ------------------------------------------------------------- end to end

def capture_jpegs():
    """The committed 480x640 4:2:0 JPEG fixtures, as a client sends them."""
    out = []
    for name in CAPTURE_JPEGS:
        with open(os.path.join(JPEG_DIR, name), "rb") as fh:
            out.append(fh.read())
    return out


def bench_prep_scaling(n: int = 64, threads: Tuple[int, ...] = (1, 2, 4), repeats: int = 3,
                       device: Device = None) -> dict:
    """Best-of-`repeats` ms to decode one tick's `n` JPEGs: "exact", the
    full decode (pooled entropy decode on the host at each thread count,
    then the reconstruction on `device`); "coef1" and "raw4201", the host
    halves of the coef and ycbcr420 wire planes at one thread. The
    DCT-scaled decode is not ported."""
    from ..utils import jpeg_ingest as J
    dev = resolve_device(device)
    jpegs = capture_jpegs()
    datas = [jpegs[i % len(jpegs)] for i in range(n)]

    def best(fn):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)

    def exact(t):
        coefs = J.decode_coefs_batch(datas, t)
        refused = [c for c in coefs if isinstance(c, J.JpegError)]
        if refused:
            raise RuntimeError(f"the decoder refused a fixture: {refused[0]}")
        J.reconstruct(coefs, dev).cpu()

    def wire(fn):
        ok = fn(datas, *CAPTURE_HW, n_threads=1)[-1]
        if not ok.all():
            raise RuntimeError("a fixture is not eligible for the wire planes")

    return {"device": device_name(dev), "frames": n,
            "exact": {t: best(lambda: exact(t)) for t in threads},
            "coef1": best(lambda: wire(J.decode_coefs_wire_batch)),
            "raw4201": best(lambda: wire(J.decode_raw420_batch))}


def bench_e2e(n_streams: int = 64, frames_per_stream: int = 5, device_detect: bool = True,
              ingest_plane: str = "bgr", device: Device = None) -> dict:
    """MultiStreamEngine.analyze_jpeg from n_streams client threads, each
    sending frames_per_stream of the capture JPEGs: frames/s and the
    request latency's p50/p95. device_detect: SSD, crop/align and CLAHE in
    the tick, fed by `ingest_plane`; otherwise host prep with the heuristic
    face rung (the data plane without the cascade's cost). Any failed
    request fails the phase."""
    from ..serving.multi import MultiStreamEngine
    dev = resolve_device(device)
    scfg = dict(max_streams=n_streams, max_batch=n_streams, batch_timeout_ms=30.0,
                min_request_interval=0.0)
    if device_detect:
        engine = MultiStreamEngine(
            _cfg(clahe_device=True),
            ServerConfig(**scfg, device_detect=True, ingest_plane=ingest_plane),
            ssd_net=_synthetic_ssd(dev), device=dev)
        mode = "device-detect" if ingest_plane == "bgr" else f"device-detect wire:{ingest_plane}"
    else:
        engine = MultiStreamEngine(_cfg(face_backend="heuristic"), ServerConfig(**scfg),
                                   device=dev)
        mode = "heuristic-host-prep"
    jpegs = capture_jpegs()
    lat, errors = [], []
    lock = threading.Lock()

    def client(sid):
        try:
            for i in range(frames_per_stream):
                t0 = time.perf_counter()
                r = engine.analyze_jpeg(jpegs[i % len(jpegs)], f"s{sid}")
                if not r.get("success"):
                    raise RuntimeError(f"stream {sid} frame {i}: {r}")
                with lock:
                    lat.append(time.perf_counter() - t0)
        except Exception as e:   # reported after the join; the phase fails on it
            with lock:
                errors.append(f"{type(e).__name__}: {e}")

    try:
        client("warm")   # not timed: the stream table and the first ticks
        lat.clear()
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,)) for k in range(n_streams)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=600)
        elapsed = time.perf_counter() - t0
        if any(th.is_alive() for th in clients):
            raise RuntimeError("a client did not finish within 600 s")
        metrics = dict(engine.metrics)
    finally:
        engine.shutdown()
    if errors:
        raise RuntimeError(f"{len(errors)} clients failed: {errors[0]}")
    return {"device": device_name(dev), "mode": mode, "streams": n_streams,
            "requests": len(lat), "fps": len(lat) / elapsed,
            "req_ms_p50": _pct(lat, 50) * 1e3, "req_ms_p95": _pct(lat, 95) * 1e3,
            "ticks": metrics["ticks"], "ewma_batch_size": metrics["ewma_batch_size"],
            "ewma_host_prep_ms": metrics["ewma_host_prep_ms"]}


# --------------------------------------------------------------------- main

class _Progress:
    """Phase markers on stderr (stdout carries only the result line), and a
    watchdog that ends the process with exit code 3 when no phase has
    started for `stall_minutes`: a hung device call must not hang the run.
    close() stops the watchdog."""

    def __init__(self, stall_minutes: float = 30.0):
        self.stall_s = stall_minutes * 60.0
        self.t = time.time()
        self.name = "start"
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()

    def phase(self, name: str) -> None:
        self.t, self.name = time.time(), name
        print(f"[bench {time.strftime('%H:%M:%S')}] {name}", file=sys.stderr, flush=True)

    def close(self) -> None:
        self._done.set()

    def _watch(self) -> None:
        while not self._done.wait(10.0):
            if time.time() - self.t > self.stall_s:
                print(f"bench: no progress for {self.stall_s / 60:.0f} min in phase "
                      f"{self.name!r}", file=sys.stderr, flush=True)
                os._exit(3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # float32 as the CPU computes it: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    progress = _Progress()
    try:
        line = _run(dev, progress)
    finally:
        progress.close()
    print(json.dumps(line), flush=True)
    return 0


def _run(dev: torch.device, progress: _Progress) -> dict:
    """The phases in the JAX bench's order; the result line."""
    name, limit = device_name(dev), power_limit(dev)
    progress.phase("classify core fp32")
    core32 = bench_core(device=dev)
    progress.phase("bf16 parity guard")
    guard = bf16_parity_guard(device=dev)
    use_bf16 = guard["ok"]
    progress.phase("tick-schedule guard")
    use_tick = tick_schedule_guard(bf16=use_bf16, device=dev)["ok"]
    bf16_txt = (f"bf16 classifier, parity-guarded (max prob drift vs fp32 "
                f"{guard['max_prob_diff']:.1e} < 1e-3, verdicts equal)")
    core, mode_txt = core32, "fp32 parity mode"
    if use_bf16 or use_tick:
        progress.phase("classify core fast modes")
        cand = bench_core(bf16=use_bf16, tick_schedule=use_tick, device=dev)
        if cand["fps"] <= core32["fps"] and use_bf16 and use_tick:
            cand = bench_core(bf16=True, device=dev)
            use_tick = False
        if cand["fps"] > core32["fps"]:
            core = cand
            parts = ([bf16_txt] if use_bf16 else []) + (
                ["tick-scheduled forensics (bit-identical to the frame schedule for "
                 "synchronised streams; engine flag forensic_tick_schedule)"]
                if use_tick else [])
            mode_txt = (" + ".join(parts) + f"; fp32 frame-schedule mode: "
                        f"{core32['fps']:.0f} fps, p95 {core32['tick_ms_p95']:.1f} ms")

    progress.phase("ssd bf16 guard")
    ssd_guard = detect_ssd_bf16_guard(device=dev)
    use_ssd16 = ssd_guard["ok"]
    progress.phase("detect-inclusive core")
    detect = bench_core_detect(bf16=use_bf16, tick_schedule=use_tick, ssd_bf16=use_ssd16,
                               device=dev)
    if use_ssd16:
        d = bench_core_detect(bf16=use_bf16, tick_schedule=use_tick, device=dev)
        if d["fps"] >= detect["fps"]:
            detect = d
    if use_bf16 or use_tick:
        d32 = bench_core_detect(device=dev)
        if d32["fps"] > detect["fps"]:
            detect = d32
            mode_txt = "fp32 parity mode (the guarded fast modes were slower)"
    if not use_ssd16:
        ssd_txt = (f"f32 SSD (the bf16 SSD failed its guard: boxes/flags/counts/verdicts "
                   f"equal {ssd_guard['boxes_equal']}, prob drift "
                   f"{ssd_guard['max_prob_diff']:.1e})")
    elif detect["ssd"] == "bf16":
        ssd_txt = (f"bf16 SSD trunk (guarded: boxes/flags/counts/verdicts identical to "
                   f"f32, prob drift {ssd_guard['max_prob_diff']:.1e}; decode in f32)")
    else:
        ssd_txt = (f"f32 SSD (the bf16 SSD passed its guard, drift "
                   f"{ssd_guard['max_prob_diff']:.1e}, and was no faster)")
    scale_txt = ""
    for n, label in ((128, "128-stream throughput mode"), (32, "32-slot latency mode")):
        progress.phase(label)
        d = bench_core_detect(n_streams=n, bf16=use_bf16, tick_schedule=use_tick,
                              n_windows=6, latency_iters=0, device=dev)
        scale_txt += (f"; {n} slots: {d['fps']:.0f} fps, tick p50 {d['tick_ms_p50']:.1f} / "
                      f"p95 {d['tick_ms_p95']:.1f} ms")
    progress.phase("mtcnn-fused detect core")
    mtd = bench_core_detect(bf16=use_bf16, tick_schedule=use_tick, mtcnn=True, n_windows=6,
                            latency_iters=0, device=dev)

    e2e = []
    for label, kw in (("device-detect", dict()),
                      ("host-prep heuristic", dict(device_detect=False)),
                      ("wire ycbcr420", dict(ingest_plane="ycbcr420")),
                      ("wire coef", dict(ingest_plane="coef"))):
        progress.phase(f"e2e engine ({label})")
        e2e.append(bench_e2e(device=dev, **kw))
    progress.phase("prep scaling")
    prep = bench_prep_scaling(device=dev)
    progress.phase("done")

    e2e_txt = "; ".join(f"{r['mode']} {r['fps']:.0f} fps, req p50 {r['req_ms_p50']:.0f} / "
                        f"p95 {r['req_ms_p95']:.0f} ms" for r in e2e)
    prep_txt = (", ".join(f"{v:.1f} ms@{t}thr" for t, v in prep["exact"].items())
                + f"; wire host halves at 1 thread: entropy only {prep['coef1']:.1f} ms, "
                  f"raw 4:2:0 {prep['raw4201']:.1f} ms")
    mfu_txt = ""
    if detect["mfu_pct_bf16peak"] > 0:
        mfu_txt = (f"; {detect['gflop_per_tick_conv_matmul']:.0f} GFLOP per tick in "
                   f"convolutions and matrix products (torch.utils.flop_counter), "
                   f"{detect['achieved_tflops']:.2f} TFLOP/s = "
                   f"{detect['mfu_pct_bf16peak']:.2f}% of the "
                   f"{detect['bf16_peak_tflops']:.0f} TFLOP/s dense bf16 peak")
    unit = (f"frames/s aggregate over 64 streams on one {name} (power limit {limit}), "
            f"capture to verdict per tick: 640x480 -> SSD-res10-class detection (synthetic "
            f"weights) + six forensic signals + per-stream crop/align/CLAHE + "
            f"EfficientNet-B0 (random weights) + tracker verdict, PyTorch in float32 without "
            f"TF32 and the port's CUDA kernels; {mode_txt}; {ssd_txt}; tick p50 "
            f"{detect['tick_ms_p50']:.1f} / p95 {detect['tick_ms_p95']:.1f} ms; depth-1 "
            f"request (host frames -> copy -> tick -> verdict read back) p50 "
            f"{detect['req_ms_p50']:.0f} / p95 {detect['req_ms_p95']:.0f} ms{mfu_txt}"
            f"{scale_txt}; with the MTCNN P/R/O cascade also in the tick (mtcnn_device, "
            f"seeded facenet-shaped weights whose heads accept): {mtd['fps']:.0f} fps, tick "
            f"p50 {mtd['tick_ms_p50']:.1f} ms; classify-only core (pre-staged faces): "
            f"{core['fps']:.0f} fps, "
            f"tick p95 {core['tick_ms_p95']:.1f} ms; e2e from 64 client threads with the "
            f"480x640 JPEG fixtures: {e2e_txt}; pooled decode of 64 JPEGs: {prep_txt}; not "
            f"run (not ported yet): the DCT-scaled decode")
    return {"metric": "serving_frames_per_sec_per_chip", "value": round(detect["fps"], 1),
            "unit": unit, "vs_baseline": round(detect["fps"] / 10.0, 2),
            "ssd": detect["ssd"], "ssd_bf16_guard": {k: ssd_guard[k] for k in (
                "ok", "max_prob_diff", "boxes_equal", "n_faces_seen")},
            "mtcnn_core": {"fps": round(mtd["fps"], 1), "tick_ms_p50": mtd["tick_ms_p50"]}}

if __name__ == "__main__":
    sys.exit(main())
