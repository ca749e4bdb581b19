#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (real_time_video_deepfake_detection_tpu_torch) on the card,
in phases, each printing one JSON line:

  1. device   the card's name and power limit; TF32 off for convolutions
              and matmuls
  2. build    nvcc builds the package's CUDA kernels (csrc/*.cu, sm_90a)
  3. kernels  each kernel against its plain torch version at main-path
              shapes and at the edge inputs its layout is sensitive to
              (odd widths and tile sizes, constant planes, bases at odd
              byte offsets, B = 1 and 200, random CLAHE LUTs), each call
              one launch, timed with CUDA events (and its
              device time from torch.profiler, and the host time of its
              wrapper) beside its bound, the plain version and (where one
              exists) a PyTorch library call; the CLAHE kernels also
              against the numpy oracle clahe_u8_numpy
  4. serve    MultiStreamEngine on cuda in host-prep mode with full-size
              EfficientNet-B0 (random weights from a seed, batch-norm
              statistics set from one batch), 16 streams x 12 synthetic
              480x640 frames from 16 threads, with the preproc and hue
              kernels on; checks the responses and that the kernels were
              launched; times host prep on one thread, the face crop's Lab
              + CLAHE with each rung of the Lab ladder; then the same run
              with the jnp Lab rung pinned in place of the default cv2 one
  5. parity   device_step_compact at bucket 64 on cuda against the same
              tick on the CPU (where the plain versions run); the tick's
              time, a profiler window over it (device busy and idle share,
              largest device entries) and its forensics/classifier split
  6. detect-serve  MultiStreamEngine on cuda in device-detect mode with
              clahe_device: the synthetic res10-class SSD at its default
              channels (seeded, written to a temporary directory), the same
              B0, 16 streams x 12 capture frames; checks the responses,
              that all four kernels were launched and that faces were found
  7. detect-parity  one bucket-64 detect tick on cuda against the same tick
              on the CPU; the count of Lab and CLAHE'd face pixels that
              differ between the two; the Lab pair's time; the tick's time
              and a profiler window
  8. decode   every JPEG fixture of tests/data/torch_jpeg through the
              port's decoder (entropy decode on the host, reconstruction on
              the host CPU) against the sha256 of cv2.imdecode's output, the
              reconstruction on the card byte for byte against the CPU's,
              progressive and truncated streams refused; the entropy and
              reconstruction times of the extension's 720x405 frame and the
              pooled decode of 16
  9. http     two servers on 127.0.0.1, driven with multipart POSTs of the
              720x405 fixtures: (a) the single-stream app over
              DeepfakeDetector (full-size B0): /health, 12 /analyze 150 ms
              apart, a 429 probe, /stats, /reset, 400s for refused images,
              then its steps' times on one thread, in a new thread each,
              and the app's /analyze without the socket;
              (b) the batched app over the device-detect engine (as in
              detect-serve): 16 client threads with X-Stream-Id, 12 frames
              each; every kernel launched in every tick, and stream 0's
              responses equal to a second engine's fed the decoded frames
              through analyze (floats within 1e-6)
 10. wire     the wire planes of JPEG ingest (ServerConfig.ingest_plane):
              (a) device-detect engines (as detect-serve) with the bgr,
              coef and ycbcr420 planes answer the same requests alike (an
              eligible 480x640 fixture, the 720x405 frame, which takes the
              full decode, and a corrupt stream: 400; floats within 1e-6);
              (b) the planes' reconstruction on the card equals the CPU's
              and the full decode byte for byte, with its device ms and
              activities inside a bucket-16 tick and the copy of the wire
              buffer, pinned and pageable; (c) batched HTTP as in http(b)
              with the 480x640 fixtures, each plane in turn, every kernel
              launched in every tick

then a `{"kernels": [...]}` line (launches: the wire phase's coef run) and, last, `{"ok": true, "device": ...}`.
Any failed phase makes it exit non-zero without the last line. It needs a
CUDA device and the repository checkout around it.

    python3 chip_smoke.py --phases device,build,kernels   # a short run

runs only the named phases and prints no contract lines.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "real_time_video_deepfake_detection_tpu_torch"
SEED = 0

# Device memory rate (bytes/s) and float32 rate outside the tensor cores
# (FLOP/s) by card, from NVIDIA's data sheets; the bound of a kernel is the
# larger of its bytes over the first and its operations over the second.
_PEAKS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
          ("H200", 4.8e12, 67e12), ("H100", 3.35e12, 67e12))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_peaks(name: str):
    for key, bw, flops in _PEAKS:
        if key in name:
            return key, bw, flops
    return "H100", 3.35e12, 67e12


def bound_ms(bytes_moved: float, ops: float, peaks):
    t_bytes = bytes_moved / peaks[1] * 1e3
    t_ops = ops / peaks[2] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_cuda(fn, n: int = 60, warmup: int = 5) -> float:
    """Median milliseconds of `fn` over `n` runs, each timed with CUDA
    events on the current stream (so a call's host-side launch path counts
    when the device waits on it)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n: int = 200, reps: int = 5) -> float:
    """Median over `reps` runs of the host microseconds one call of `fn`
    takes to return (n calls back to back, the device drained before each
    run): a wrapper's host path, its checks and its launch."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / n)
        torch.cuda.synchronize()
    return statistics.median(times)


@contextlib.contextmanager
def exact_powf_only():
    """ops/color with ops/powf.py's exact chain on every lane in place of
    the two-pass powf (no fast pass, no gather, no device sync): the other
    design of the emulation, timed here against the committed one."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops import color, powf as P

    def exact(x, y):
        yd, xf = float(np.float32(y)), x.reshape(-1)
        ylogx, _, v = P._chain(P._bits(xf), yd, True, P._tables(x.device))
        out = torch.where(xf == 0, 0.0 if yd > 0 else float("inf"), P._round_f32(ylogx, v))
        return out.view(x.shape)

    saved, color.powf = color.powf, exact
    try:
        yield
    finally:
        color.powf = saved


def profile_device(fn, n: int):
    """Run `fn` n times under torch.profiler and return (wall ms per call,
    device-busy ms per call, device activities per call, the 8 largest
    device activities by total ms). Busy time sums the CUDA activities
    (kernels, copies, sets) of the trace; everything runs on one stream, so
    they do not overlap. Busy ms is None when the trace holds no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    busy = sum(sum(v) for v in by_name.values()) / n
    top = sorted(((k, sum(v) / n, len(v) / n) for k, v in by_name.items()),
                 key=lambda kv: -kv[1])[:8]
    return (wall, busy if busy > 0 else None,
            sum(len(v) for v in by_name.values()) / n,
            [{"name": k[:80], "ms_per_call": ms, "per_call": c} for k, ms, c in top])


def b0_state(ctx):
    """Full-size EfficientNet-B0 parameters from a seeded generator (the
    engine's init laws), with every batch norm's statistics set to those of
    its input on one batch of random inputs. With the init laws alone the
    activations shrink by ~1e-14 over the 16 blocks and every face gets the
    same probability; set this way, each layer sees unit-scale inputs and
    the classifier's output depends on the face."""
    if "b0_state" in ctx:
        return ctx["b0_state"]
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.efficientnet import BatchNorm
    model = backbones.build_model(backbones.make("b0"),
                                  torch.Generator().manual_seed(SEED)).cuda().eval()

    def set_stats(bn, args):
        x = args[0]
        dims = [d for d in range(x.ndim) if d != 1]
        bn.mean.copy_(x.mean(dims))
        bn.var.copy_(x.var(dims, correction=0))

    hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    x = torch.randn((32, 224, 224, 3), generator=torch.Generator().manual_seed(SEED + 2))
    with torch.no_grad():
        model(x.cuda())
    for h in hooks:
        h.remove()
    ctx["b0_state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return ctx["b0_state"]


# ----------------------------------------------------------------- phases

def phase_device(ctx):
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unavailable"
    print(line, flush=True)
    ctx["name"], ctx["smi"], ctx["peaks"] = name, line, card_peaks(name)
    return {"name": name, "nvidia_smi": line, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "peaks_assumed": {"card": ctx["peaks"][0], "bytes_per_s": ctx["peaks"][1],
                              "f32_flop_per_s": ctx["peaks"][2]}}


def phase_build(ctx):
    from real_time_video_deepfake_detection_tpu_torch.kernels import build
    t0 = time.time()
    lib = build.library()
    return {"seconds": round(time.time() - t0, 3), "nvcc_seconds": build.build_seconds,
            "library": os.path.relpath(lib._name, REPO)}


def odd_offset(x):
    """A copy of `x` whose data starts one element into its buffer: for u8,
    a base at an odd byte offset."""
    import torch
    buf = torch.empty(1 + x.numel(), dtype=x.dtype, device=x.device)
    return buf[1:].view(x.shape).copy_(x)


def phase_kernels(ctx):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from real_time_video_deepfake_detection_tpu_torch.kernels import color_stats, preproc
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    peaks = ctx["peaks"]
    res = {}

    # preprocess_faces: (64,160,160,3) u8 is the main path's input at a full
    # bucket; f32 and the edge shapes are the others the wrapper takes:
    # source rows staged with 16-byte copies (96x128) or element by element
    # (50x70, 40x56), and an output row of 675 floats, not a float4 multiple
    faces_u8 = torch.randint(0, 256, (64, 160, 160, 3), generator=g, device=dev,
                             dtype=torch.uint8)
    faces_f32 = torch.rand((64, 160, 160, 3), generator=g, device=dev) * 255
    cases = [(faces_u8, 224), (faces_f32, 224)]
    for shape, out_size in (((2, 96, 128, 3), 224), ((3, 50, 70, 3), 224),
                            ((2, 40, 56, 3), 225)):
        x = torch.rand(shape, generator=g, device=dev) * 256
        cases += [(x, out_size), (x.to(torch.uint8), out_size)]
    err = 0.0
    for x, out_size in cases:
        got = preproc.preprocess_faces(x, out_size)
        want = preproc.preprocess_faces_plain(x, out_size)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
    if not err <= 1e-4:
        raise AssertionError(f"preprocess_faces max abs error {err} > 1e-4")
    mean = torch.tensor(preproc.IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
    std = torch.tensor(preproc.IMAGENET_STD, device=dev).view(1, 3, 1, 1)
    nchw = faces_u8.permute(0, 3, 1, 2)

    def library():
        y = F.interpolate(nchw.float(), size=(224, 224), mode="bilinear",
                          align_corners=False)
        return (y * (1.0 / 255.0) - mean) / std

    lib_err = float((library().permute(0, 2, 3, 1)
                     - preproc.preprocess_faces_plain(faces_u8, 224)).abs().max())
    n_out = 64 * 224 * 224 * 3
    b_ms, b_by = bound_ms(faces_u8.numel() + 4 * n_out, 12 * n_out, peaks)
    kernel = functools.partial(preproc.preprocess_faces, faces_u8, 224)
    plain = functools.partial(preproc.preprocess_faces_plain, faces_u8, 224)
    res["preprocess_faces"] = {
        "name": "preprocess_faces", "route": "cuda",
        "source": f"{PKG}/csrc/preproc.cu",
        "replaces": "real_time_video_deepfake_detection_tpu/kernels/preproc.py:60",
        "shape": [64, 160, 160, 3], "dtype": "uint8", "max_abs_err": err,
        "inputs_checked": [list(x.shape) + [str(x.dtype)[6:], o] for x, o in cases],
        "ms": time_cuda(kernel), "host_us": host_us(kernel),
        "ms_f32_input": time_cuda(lambda: preproc.preprocess_faces(faces_f32, 224)),
        "plain_ms": time_cuda(plain),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_cuda(library), "library_call_max_abs_diff": lib_err,
        "device_ms": profile_device(kernel, 20)[1],
        "plain_device_ms": profile_device(plain, 20)[1],
        "library_device_ms": profile_device(library, 20)[1],
    }

    # unique_hue_count: random hues at a full tick, then the inputs the
    # cluster layout is sensitive to: B = 1; hw not a multiple of 16; hw
    # below one block's share; a base at an odd byte offset (head, body and
    # tail of each frame at other offsets); values 180..255 (count 1); and
    # more clusters than SMs
    hues = torch.randint(0, 180, (64, 256, 256), generator=g, device=dev,
                         dtype=torch.uint8)
    every = torch.arange(256 * 256, device=dev).remainder(180).to(torch.uint8)
    edge = torch.stack([torch.full((256, 256), 77, dtype=torch.uint8, device=dev),
                        every.view(256, 256),
                        torch.zeros((256, 256), dtype=torch.uint8, device=dev)])
    high = (torch.arange(2 * 128 * 152, device=dev).remainder(76) + 180).to(torch.uint8)

    def rand_hues(shape, hi=256):
        return torch.randint(0, hi, shape, generator=g, device=dev, dtype=torch.uint8)

    hue_cases = [("main", hues, None), ("edge", edge, [1.0, 180.0, 1.0]),
                 ("b1", hues[:1].clone(), None), ("hw3500", rand_hues((3, 50, 70)), None),
                 ("hw20", rand_hues((2, 4, 5)), None),
                 ("odd_offset", odd_offset(rand_hues((3, 50, 70))), None),
                 ("odd_offset", odd_offset(rand_hues((2, 256, 256), 180)), None),
                 ("180_255", high.view(2, 128, 152), [1.0, 1.0]),
                 ("b200", rand_hues((200, 256, 256), 200), None)]
    for label, x, expect in hue_cases:
        n0 = color_stats.launches
        got = color_stats.unique_hue_count(x)
        if color_stats.launches != n0 + 1:
            raise AssertionError(f"unique_hue_count counted {color_stats.launches - n0} launches")
        want = color_stats.unique_hue_count_plain(x)
        host = [float((np.unique(f) < 181).sum()) for f in x[:4].cpu().numpy()]
        if not torch.equal(got, want) or got[:4].cpu().tolist() != host:
            raise AssertionError(f"unique_hue_count mismatch on {label} {tuple(x.shape)}: "
                                 f"{got[:4]} {want[:4]} {host}")
        if expect is not None and got.cpu().tolist() != expect:
            raise AssertionError(f"{label} frames counted {got.tolist()}, want {expect}")
    b_ms, b_by = bound_ms(hues.numel() + 4 * 64, 10 * hues.numel(), peaks)
    kernel = functools.partial(color_stats.unique_hue_count, hues)
    plain = functools.partial(color_stats.unique_hue_count_plain, hues)
    res["unique_hue_count"] = {
        "name": "unique_hue_count", "route": "cuda",
        "source": f"{PKG}/csrc/color_stats.cu",
        "replaces": "real_time_video_deepfake_detection_tpu/kernels/color_stats.py:45",
        "shape": [64, 256, 256], "dtype": "uint8", "max_abs_err": 0.0,
        "inputs_checked": [[label] + list(x.shape) for label, x, _ in hue_cases],
        "ms": time_cuda(kernel), "host_us": host_us(kernel), "plain_ms": time_cuda(plain),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": profile_device(kernel, 20)[1],
        "plain_device_ms": profile_device(plain, 20)[1],
    }
    res.update(_clahe_kernels(peaks))
    ctx["kernels"] = res
    return {k: {kk: v.get(kk) for kk in ("max_abs_err", "ms", "host_us", "plain_ms",
                                         "bound_ms", "library_ms", "device_ms",
                                         "plain_device_ms", "library_device_ms",
                                         "max_diff_from_numpy_oracle", "inputs_checked",
                                         "edge_planes_checked", "random_luts_checked")}
            for k, v in res.items()}


def _face_planes(n: int, seed: int):
    """(n, 160, 160) u8 L planes: half random, half smooth face-like (a lit
    oval over a vertical gradient, with noise), as numpy."""
    import numpy as np
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[:160, :160]
    oval = ((xx - 80) / 56.0) ** 2 + ((yy - 80) / 72.0) ** 2 <= 1
    out = [r.integers(0, 256, (160, 160), dtype=np.uint8) for _ in range(n // 2)]
    for _ in range(n - n // 2):
        f = 60 + 0.4 * yy + 90 * oval + r.normal(0, 6, (160, 160)) + r.uniform(-30, 30)
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return np.stack(out)


def _edge_planes():
    """The planes the two kernels are sensitive to, as numpy: constant
    160x160 planes (one bin holds the whole tile: every atomic on one bin,
    the largest clip excess and residual); (40, 56) planes, whose 7-pixel
    tile rows are read byte by byte and whose tiles are 5 rows high; (24,
    200) planes, tiles 3 rows high and 25 wide; one 160x160 face (B = 1);
    and (16, 2056) planes, rows of more 4-pixel columns than a block of
    clahe_apply has threads."""
    import numpy as np
    r = np.random.default_rng(SEED + 4)
    const = np.stack([np.full((160, 160), v, np.uint8) for v in (0, 77, 128, 255)])
    yy, xx = np.mgrid[:40, :56]
    smooth = np.clip(60 + 2 * yy + 40 * (((xx - 28) / 20.0) ** 2 + ((yy - 20) / 16.0) ** 2 <= 1)
                     + r.normal(0, 4, (40, 56)), 0, 255).astype(np.uint8)
    narrow = np.stack([r.integers(0, 256, (40, 56), dtype=np.uint8), smooth,
                       np.full((40, 56), 200, np.uint8)])
    yy, xx = np.mgrid[:24, :200]
    wide = np.stack([r.integers(0, 256, (24, 200), dtype=np.uint8),
                     np.clip(50 + 4 * yy + xx // 2 + r.normal(0, 5, (24, 200)), 0,
                             255).astype(np.uint8)])
    long_rows = r.integers(0, 256, (2, 16, 2056), dtype=np.uint8)
    return const, narrow, wide, _face_planes(2, SEED + 6)[1:], long_rows


def _clahe_kernels(peaks):
    """clahe_luts and clahe_apply at a full tick's faces, (64, 160, 160) u8,
    and on the edge planes, each set also at a base at an odd byte offset:
    LUTs and outputs exactly equal to the plain versions, LUTs equal to the
    oracle's per-tile _lut_for_tile on the edge planes, and every output
    equal to the numpy oracle on the CPU. clahe_apply also takes random f32
    LUTs that do not come from clahe_luts (integer-valued and fractional,
    some outside 0..255; beside odd-offset planes, LUTs whose base is not
    16-byte aligned), exactly equal to its plain version."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.kernels import clahe
    from real_time_video_deepfake_detection_tpu_torch.ops.clahe import (
        _lut_for_tile, clahe_apply_batch, clahe_luts_batch, clahe_u8_numpy, clip_count)
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    oracle_diff = 0
    checked, random_luts = [], []
    for k, planes in enumerate((_face_planes(64, SEED + 3),) + _edge_planes()):
        oracle = np.stack([clahe_u8_numpy(p) for p in planes])
        for base in ("aligned", "odd_offset"):
            x = torch.from_numpy(planes).cuda()
            if base == "odd_offset":
                x = odd_offset(x)
            n0 = dict(clahe.launches)
            luts = clahe.clahe_luts(x)
            out = clahe.clahe_apply(x, luts)
            if clahe.launches != {kk: v + 1 for kk, v in n0.items()}:
                raise AssertionError(f"CLAHE launches {n0} -> {clahe.launches}")
            torch.cuda.synchronize()
            if not torch.equal(luts, clahe_luts_batch(x)):
                raise AssertionError(f"clahe_luts differs from its plain version on set {k} {base}")
            if not torch.equal(out, clahe_apply_batch(x, luts)):
                raise AssertionError(f"clahe_apply differs from its plain version on set {k} {base}")
            oracle_diff = max(oracle_diff, int(np.abs(out.cpu().numpy().astype(int)
                                                      - oracle.astype(int)).max()))
            checked.append(list(planes.shape) + [base])
            if k in (0, 3):   # LUTs that do not come from clahe_luts
                for frac in (False, True):
                    r = torch.rand(luts.shape, generator=g, device="cuda") * 288 - 16
                    r = r if frac else r.round()
                    if base == "odd_offset":
                        r = odd_offset(r)
                    if not torch.equal(clahe.clahe_apply(x, r), clahe_apply_batch(x, r)):
                        raise AssertionError(f"clahe_apply differs from its plain version on "
                                             f"random LUTs, set {k} {base} fractional={frac}")
                    random_luts.append(list(planes.shape) + [base, "fractional" if frac
                                                             else "integer"])
        if k > 0:
            th, tw = planes.shape[1] // 8, planes.shape[2] // 8
            got = luts.cpu().numpy()
            for i, p in enumerate(planes):
                for t in range(64):
                    tile = p[(t // 8) * th:(t // 8 + 1) * th, (t % 8) * tw:(t % 8 + 1) * tw]
                    want = _lut_for_tile(np.bincount(tile.ravel(), minlength=256),
                                         clip_count(2.0, th * tw), th * tw)
                    if not np.array_equal(got[i, t], want):
                        raise AssertionError(f"clahe_luts differs from _lut_for_tile: set {k}")
    if oracle_diff != 0:
        raise AssertionError(f"CLAHE differs from clahe_u8_numpy by {oracle_diff}")
    x = torch.from_numpy(_face_planes(64, SEED + 3)).cuda()
    luts = clahe.clahe_luts(x)
    n_px, n_lut = x.numel(), luts.numel()
    res = {}
    for name, kernel, plain, bytes_moved, ops in (
            # histogram increments, the 8-step scan and LUT per bin
            ("clahe_luts", lambda: clahe.clahe_luts(x), lambda: clahe_luts_batch(x),
             n_px + 4 * n_lut, n_px + 10 * n_lut),
            # per pixel: fractions, four lookups, the two-step lerp, rint
            ("clahe_apply", lambda: clahe.clahe_apply(x, luts),
             lambda: clahe_apply_batch(x, luts), 2 * n_px + 4 * n_lut, 16 * n_px)):
        b_ms, b_by = bound_ms(bytes_moved, ops, peaks)
        res[name] = {
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/clahe.cu",
            "replaces": ("real_time_video_deepfake_detection_tpu/kernels/clahe.py:68"
                         if name == "clahe_luts" else
                         "real_time_video_deepfake_detection_tpu/kernels/clahe.py:165"),
            "shape": [64, 160, 160], "dtype": "uint8", "max_abs_err": 0.0,
            "max_diff_from_numpy_oracle": oracle_diff,
            "edge_planes_checked": checked,
            "random_luts_checked": random_luts if name == "clahe_apply" else None,
            "ms": time_cuda(kernel), "host_us": host_us(kernel), "plain_ms": time_cuda(plain),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "device_ms": profile_device(kernel, 20)[1],
            "plain_device_ms": profile_device(plain, 20)[1],
        }
    return res


def _synthetic_frame(rng, face: bool, t: int):
    """480x640 BGR: a smooth textured background and, on face streams, a
    skin-toned ellipse (which the heuristic detector finds) moving a little
    each frame."""
    import numpy as np
    yy, xx = np.mgrid[:480, :640]
    f = 100 + 40 * np.sin(xx / 37.0 + t / 5.0) * np.cos(yy / 53.0)
    # gray noise: equal channels keep the background out of the skin range
    f = np.repeat((f + rng.integers(-12, 13, (480, 640)))[..., None], 3, axis=2)
    if face:
        m = ((xx - 320 - 3 * t) / 90.0) ** 2 + ((yy - 240) / 120.0) ** 2 <= 1.0
        skin = np.array([140, 160, 210]) + rng.integers(-6, 7, (int(m.sum()), 3))
        f[m] = skin
    return np.clip(f, 0, 255).astype(np.uint8)


_SCHEMA = {"success", "analysis_mode", "faces_detected", "fake_probability",
           "frame_forensic_probability", "real_probability", "confidence_level",
           "temporal_average", "stability_score", "frame_count",
           "processing_time_ms"}


def _host_prep_ms(engine, frames):
    """Median ms of each host-prep step of MultiStreamEngine.analyze on one
    thread with nothing else running, over a face stream's frames: the Lab
    + CLAHE of the face crop with each rung of the Lab ladder (clahe_lab:
    the default, cv2's 8-bit tables in numpy), and the jnp rung with the
    exact powf chain alone."""
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import (
        preprocess_face_quality)
    from real_time_video_deepfake_detection_tpu_torch.utils.host_resize import (
        resize_analysis)
    steps = {"resize_analysis": [], "detect": [], "clahe_lab": [], "align": [],
             "clahe_lab_native": [], "clahe_lab_jnp": [], "clahe_lab_jnp_exact_powf_only": []}
    for f in frames:
        t = [time.perf_counter()]
        resize_analysis(f, 256, 256)
        t.append(time.perf_counter())
        x, y, fw, fh = engine.face_detector(f)[0]
        face = f[y:y + fh, x:x + fw]
        t.append(time.perf_counter())
        crop = preprocess_face_quality(face)
        t.append(time.perf_counter())
        engine.aligner(crop)
        t.append(time.perf_counter())
        preprocess_face_quality(face, lab_backend="native")
        t.append(time.perf_counter())
        jnp_crop = preprocess_face_quality(face, lab_backend="jnp")
        t.append(time.perf_counter())
        with exact_powf_only():
            same = preprocess_face_quality(face, lab_backend="jnp")
        t.append(time.perf_counter())
        if not (same == jnp_crop).all():
            raise AssertionError("the exact powf chain alone changed a CLAHE'd crop")
        for k, a, b in zip(steps, t, t[1:]):
            steps[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in steps.items()}


def phase_serve(ctx):
    """The host-prep engine with the default Lab rung (cv2's 8-bit tables),
    then with the jnp rung pinned, in turns in one call."""
    from real_time_video_deepfake_detection_tpu_torch.pipeline import detector
    runs = {}
    for lab in ("cv2", "jnp"):
        saved, detector._LAB_BACKEND = detector._LAB_BACKEND, lab
        try:
            runs[lab] = _serve_run(ctx, host_prep=lab == "cv2")
        finally:
            detector._LAB_BACKEND = saved
    return {"lab_rung_cv2": runs["cv2"], "lab_rung_jnp": runs["jnp"]}


def _serve_run(ctx, host_prep):
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine

    cfg = DetectorConfig(use_pallas_preproc=True, use_pallas_color=True,
                         face_backend="heuristic")
    engine = MultiStreamEngine(cfg, ServerConfig(max_streams=64, max_batch=64),
                               params=b0_state(ctx), device="cuda")
    tick_ms, batch_sizes = [], []
    dispatch = engine._dispatch

    def timed_dispatch(tick_cfg, arrays, states):
        t0 = time.perf_counter()
        out = dispatch(tick_cfg, arrays, states)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        batch_sizes.append(int(arrays[4].sum()))
        return out

    engine._dispatch = timed_dispatch
    n_streams, n_frames = 16, 12
    rng = np.random.default_rng(SEED)
    frames = {s: [_synthetic_frame(rng, s % 2 == 0, t) for t in range(n_frames)]
              for s in range(n_streams)}
    results = {s: [] for s in range(n_streams)}
    errors = []

    def client(s):
        try:
            for t in range(n_frames):
                results[s].append(engine.analyze(frames[s][t], f"stream-{s}"))
        except Exception as e:   # reported below; the phase fails on it
            errors.append(f"stream {s}: {type(e).__name__}: {e}")

    _reset_launches()
    t0 = time.time()
    threads = [threading.Thread(target=client, args=(s,)) for s in range(n_streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.time() - t0
    launches = {k: v for k, v in _read_launches().items()
                if k in ("preprocess_faces", "unique_hue_count")}
    engine.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")

    problems = []
    for s, rs in results.items():
        if len(rs) != n_frames:
            problems.append(f"stream {s}: {len(rs)} responses")
            continue
        for t, r in enumerate(rs):
            missing = _SCHEMA - set(r)
            if missing or not r.get("success"):
                problems.append(f"stream {s} frame {t}: missing {missing} {r.get('error')}")
                continue
            if s % 2 == 0 and (r["analysis_mode"] != "face+frame"
                               or not {"face_probability", "face_bbox"} <= set(r)):
                problems.append(f"stream {s} frame {t}: {r['analysis_mode']}")
            if r["frame_count"] != t + 1:
                problems.append(f"stream {s} frame {t}: frame_count {r['frame_count']}")
            if r["frame_count"] >= 10 and r["confidence_level"] == "UNCERTAIN":
                problems.append(f"stream {s} frame {t}: UNCERTAIN")
            if not all(np.isfinite(r[k]) for k in ("fake_probability",
                                                     "frame_forensic_probability")):
                problems.append(f"stream {s} frame {t}: non-finite probability")
    for k, n in launches.items():
        if n <= 0:
            problems.append(f"kernel {k} was not launched on the main path")
    face_probs = [r["face_probability"] for rs in results.values() for r in rs
                  if "face_probability" in r]
    host_prep = _host_prep_ms(engine, frames[0]) if host_prep else None
    if not max(face_probs) - min(face_probs) > 1e-3:
        problems.append(f"the classifier gave every face the same probability {face_probs[0]}")
    if problems:
        raise AssertionError("; ".join(problems[:8]))
    return {"streams": n_streams, "frames_per_stream": n_frames,
            "ticks": len(tick_ms), "mean_batch": statistics.mean(batch_sizes),
            "median_tick_ms": statistics.median(tick_ms), "wall_s": wall,
            "frames_per_s": n_streams * n_frames / wall,
            "launches": launches, "engine_metrics": engine.metrics,
            "host_prep_ms_one_thread": host_prep,
            "face_probability_range": [min(face_probs), max(face_probs)],
            "verdicts_last": {f"stream-{s}": results[s][-1]["confidence_level"]
                              for s in (0, 1)}}


def phase_parity(ctx):
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig
    from real_time_video_deepfake_detection_tpu_torch.kernels import preproc
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.ops import forensics
    from real_time_video_deepfake_detection_tpu_torch.ops.color import bgr_to_gray_u8
    from real_time_video_deepfake_detection_tpu_torch.ops.filters import canny_with_iterations
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        device_step_compact, init_stream_states)
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves, tree_map
    from real_time_video_deepfake_detection_tpu_torch.utils.host_resize import resize_analysis

    cfg = DetectorConfig(use_pallas_preproc=True, use_pallas_color=True)
    b = 64
    rng = np.random.default_rng(SEED + 1)
    model_cpu = backbones.build_model(backbones.make("b0")).eval()
    model_cpu.load_state_dict(b0_state(ctx))
    model_gpu = backbones.build_model(backbones.make("b0")).eval()
    model_gpu.load_state_dict(b0_state(ctx))
    model_gpu.cuda()

    def inputs(t):
        frames = np.stack([resize_analysis(_synthetic_frame(rng, i % 2 == 0, t), 256, 256)
                           for i in range(b)])
        faces = rng.integers(0, 256, (b, 160, 160, 3), dtype=np.uint8)
        has_face = rng.random(b) < 0.6
        face_hw = rng.integers(40, 200, (b, 2)).astype(np.int32)
        active = rng.random(b) < 0.9
        slot_idx = np.where(active, np.arange(b), b).astype(np.int32)
        return [torch.from_numpy(a) for a in (frames, faces, has_face, face_hw,
                                              active, slot_idx)]

    st_cpu = init_stream_states(b + 1, cfg, "cpu")
    st_gpu = init_stream_states(b + 1, cfg, "cuda")
    max_float_diff = 0.0
    for t in range(2):   # a full-forensic tick, then a fast one
        xs = inputs(t)
        out_c, st_cpu = device_step_compact(model_cpu, cfg, *xs, st_cpu)
        out_g, st_gpu = device_step_compact(model_gpu, cfg, *[x.cuda() for x in xs], st_gpu)
        pairs = [(k, out_c[k], out_g[k].cpu()) for k in out_c]
        pairs += [(f"state{i}", a, g.cpu()) for i, (a, g) in
                  enumerate(zip(tree_leaves(st_cpu), tree_leaves(st_gpu)))]
        faces = out_c["face_probability"][xs[2]]
        if not float(faces.max() - faces.min()) > 1e-3:
            raise AssertionError(f"tick {t}: every face has probability {float(faces[0])}")
        for k, a, g in pairs:
            if a.dtype.is_floating_point:
                d = float((a - g).abs().max()) if a.numel() else 0.0
                max_float_diff = max(max_float_diff, d)
                if not d <= 1e-4:
                    raise AssertionError(f"tick {t} {k}: max abs diff {d} > 1e-4")
            elif not torch.equal(a, g):
                raise AssertionError(f"tick {t} {k}: {int((a != g).sum())} integers differ")

    xs = [x.cuda() for x in inputs(2)]
    _, rounds = canny_with_iterations(bgr_to_gray_u8(xs[0]))
    st = init_stream_states(b + 1, cfg, "cuda")

    def tick():
        device_step_compact(model_gpu, cfg, *xs, st)

    for _ in range(3):
        tick()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall, busy, activities, top = profile_device(tick, 5)
    frames, faces, has_face, face_hw, active, slot_idx = xs
    idx = slot_idx.long()
    sub_forensic = tree_map(lambda v: v[idx], st.forensic)
    full = torch.ones(b, dtype=torch.bool, device="cuda")
    split = {
        "forensics": functools.partial(
            forensics.analyze_frame_batch, frames, sub_forensic, full, cfg.forensic,
            use_pallas_color=True),
        "classifier": lambda: model_gpu(preproc.preprocess_faces(faces, 224)),
    }
    with torch.no_grad():
        split_ms = {k: profile_device(fn, 5)[:2] for k, fn in split.items()}
    return {"bucket": b, "ticks_compared": 2, "max_float_diff": max_float_diff,
            "tolerance": 1e-4, "canny_rounds_bucket64": rounds,
            "median_tick_ms_bucket64_full_forensic": statistics.median(times),
            "profiled_tick": {"wall_ms": wall, "device_busy_ms": busy,
                              "device_idle_share": None if busy is None else 1 - busy / wall,
                              "device_activities": activities, "top": top},
            "split_wall_and_device_ms": split_ms}


def _ssd_files(ctx):
    """The synthetic res10-class SSD at its default channels, decisive
    (a trained detector's saturated confidences), from SEED, written once
    into a temporary directory that main() removes."""
    if "ssd_dir" not in ctx:
        from real_time_video_deepfake_detection_tpu_torch.utils.ssd_synth import (
            res10_class_ssd)
        ctx["ssd_dir"] = tempfile.mkdtemp(prefix="chip_smoke_ssd_")
        ctx["ssd_files"] = res10_class_ssd(ctx["ssd_dir"], seed=SEED, decisive=True)
    return ctx["ssd_files"]


def _detect_cfg():
    from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig
    return DetectorConfig(use_pallas_preproc=True, use_pallas_color=True,
                          clahe_device=True)


def _capture_frames(n_streams, n_frames, net):
    """Synthetic capture frames for n_streams x n_frames, from the first
    seed from SEED on whose frames the SSD finds at least one face."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models.ssd_res10 import (
        make_detect_batch)
    detect = make_detect_batch(net)
    for seed in range(SEED, SEED + 24):
        rng = np.random.default_rng(seed)
        frames = {s: [_synthetic_frame(rng, s % 2 == 0, t) for t in range(n_frames)]
                  for s in range(n_streams)}
        probe = np.stack([frames[s][0] for s in range(n_streams)])
        if bool(detect(torch.from_numpy(probe).cuda())["has_face"].any()):
            return seed, frames
    raise AssertionError("the synthetic SSD found no face in 24 seeds of frames")


def _reset_launches():
    from real_time_video_deepfake_detection_tpu_torch.kernels import (
        clahe, color_stats, preproc)
    preproc.launches = 0
    color_stats.launches = 0
    for k in clahe.launches:
        clahe.launches[k] = 0


def _read_launches():
    from real_time_video_deepfake_detection_tpu_torch.kernels import (
        clahe, color_stats, preproc)
    return {"preprocess_faces": preproc.launches,
            "unique_hue_count": color_stats.launches, **clahe.launches}


def phase_detect_serve(ctx):
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine

    proto, cm = _ssd_files(ctx)
    net = CaffeNet(proto, cm)   # the engine moves it to the card
    engine = MultiStreamEngine(
        _detect_cfg(), ServerConfig(max_streams=64, max_batch=64, device_detect=True),
        params=b0_state(ctx), device="cuda", ssd_net=net)
    tick_ms, batch_sizes = [], []
    dispatch = engine._dispatch

    def timed_dispatch(tick_cfg, arrays, states):
        t0 = time.perf_counter()
        out = dispatch(tick_cfg, arrays, states)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        batch_sizes.append(int(arrays[1].sum()))   # (frames, active, slot_idx)
        return out

    engine._dispatch = timed_dispatch
    n_streams, n_frames = 16, 12
    seed, frames = _capture_frames(n_streams, n_frames, net)
    results = {s: [] for s in range(n_streams)}
    errors = []

    def client(s):
        try:
            for t in range(n_frames):
                results[s].append(engine.analyze(frames[s][t], f"stream-{s}"))
        except Exception as e:   # reported below; the phase fails on it
            errors.append(f"stream {s}: {type(e).__name__}: {e}")

    _reset_launches()
    t0 = time.time()
    threads = [threading.Thread(target=client, args=(s,)) for s in range(n_streams)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.time() - t0
    launches = _read_launches()
    engine.shutdown()
    ctx["launches"] = launches
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")

    problems = []
    for s, rs in results.items():
        if len(rs) != n_frames:
            problems.append(f"stream {s}: {len(rs)} responses")
            continue
        for t, r in enumerate(rs):
            missing = _SCHEMA - set(r)
            if missing or not r.get("success"):
                problems.append(f"stream {s} frame {t}: missing {missing} {r.get('error')}")
                continue
            if r["frame_count"] != t + 1:
                problems.append(f"stream {s} frame {t}: frame_count {r['frame_count']}")
            if r["frame_count"] >= 10 and r["confidence_level"] == "UNCERTAIN":
                problems.append(f"stream {s} frame {t}: UNCERTAIN")
            if not all(np.isfinite(r[k]) for k in ("fake_probability",
                                                     "frame_forensic_probability")):
                problems.append(f"stream {s} frame {t}: non-finite probability")
            box = r.get("face_bbox")
            if (r["analysis_mode"] == "face+frame") != (box is not None) or (
                    box and not (0 <= box["x"] and box["x"] + box["width"] <= 640
                                 and 0 <= box["y"] and box["y"] + box["height"] <= 480)):
                problems.append(f"stream {s} frame {t}: face_bbox {box}")
    for k, n in launches.items():
        if n <= 0:
            problems.append(f"kernel {k} was not launched on the main path")
    faces = [r for rs in results.values() for r in rs if r.get("analysis_mode") == "face+frame"]
    if not faces:
        problems.append("no frame had a detected face")
    face_probs = [r["face_probability"] for r in faces]
    if faces and not max(face_probs) - min(face_probs) > 1e-3:
        problems.append(f"the classifier gave every face the same probability {face_probs[0]}")
    if problems:
        raise AssertionError("; ".join(problems[:8]))
    return {"streams": n_streams, "frames_per_stream": n_frames, "frame_seed": seed,
            "ticks": len(tick_ms), "mean_batch": statistics.mean(batch_sizes),
            "median_tick_ms": statistics.median(tick_ms), "wall_s": wall,
            "frames_per_s": n_streams * n_frames / wall,
            "frames_with_face": len(faces), "launches": launches,
            "engine_metrics": engine.metrics,
            "face_probability_range": [min(face_probs), max(face_probs)]}


def phase_detect_parity(ctx):
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.kernels.clahe import clahe_u8
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.ops.color import (
        lab_to_rgb_u8, rgb_to_lab_u8)
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        _make_detect_prep, init_stream_states, make_device_step_detect)
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves

    cfg = _detect_cfg()
    b = 64
    proto, cm = _ssd_files(ctx)
    nets, steps, preps = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = backbones.build_model(backbones.make("b0")).eval()
        model.load_state_dict(b0_state(ctx))
        nets[dev] = CaffeNet(proto, cm).to(dev).eval()
        steps[dev] = make_device_step_detect(nets[dev], model.to(dev), cfg)
        preps[dev] = _make_detect_prep(nets[dev], cfg)
    rng = np.random.default_rng(SEED + 5)
    frames = np.stack([_synthetic_frame(rng, i % 2 == 0, i % 12) for i in range(b)])
    active = rng.random(b) < 0.9
    slot_idx = np.where(active, np.arange(b), b).astype(np.int32)
    xs = [torch.from_numpy(a) for a in (frames, active, slot_idx)]
    xg = [x.cuda() for x in xs]

    out_c, st_c = steps["cpu"](*xs, init_stream_states(b + 1, cfg, "cpu"))
    out_g, st_g = steps["cuda"](*xg, init_stream_states(b + 1, cfg, "cuda"))
    max_float_diff = 0.0
    pairs = [(k, out_c[k], out_g[k].cpu()) for k in out_c]
    pairs += [(f"state{i}", a, g.cpu()) for i, (a, g) in
              enumerate(zip(tree_leaves(st_c), tree_leaves(st_g)))]
    for k, a, g in pairs:
        if a.dtype.is_floating_point:
            d = float((a - g).abs().max()) if a.numel() else 0.0
            max_float_diff = max(max_float_diff, d)
            if not d <= 1e-4:
                raise AssertionError(f"{k}: max abs diff {d} > 1e-4")
        elif not torch.equal(a, g):
            raise AssertionError(f"{k}: {int((a != g).sum())} integers differ")
    n_face = int(out_c["has_face"].sum())
    if n_face == 0:
        raise AssertionError("no face detected in the bucket-64 tick")

    # the CLAHE'd face crops of the tick on both devices (the GPU's float64
    # pow in the Lab conversion is not the CPU's)
    def clahe_faces(dev, xx):
        faces = preps[dev](xx[0], xx[1])[1]
        lab = rgb_to_lab_u8(faces)
        L = clahe_u8(lab[..., 0].contiguous())
        return lab, lab_to_rgb_u8(torch.stack([L, lab[..., 1], lab[..., 2]], dim=-1))

    with torch.no_grad():
        lab_c, fc = clahe_faces("cpu", xs)
        lab_g, fg = clahe_faces("cuda", xg)
    face_rows = out_c["has_face"]
    lab_diff = int((lab_c[face_rows] != lab_g[face_rows].cpu()).any(-1).sum())
    px_diff = int((fc[face_rows] != fg[face_rows].cpu()).any(-1).sum())
    # the Lab conversion pair at the tick's faces (glibc's powf, emulated in
    # float64 torch: a fast pass, then an exact one on the few lanes near an
    # f32 rounding midpoint, after a device sync for their count), and the
    # same with the exact chain alone on every lane, in turns
    faces_g = preps["cuda"](xg[0], xg[1])[1]
    lab_pair = {"rgb_to_lab_u8": lambda: rgb_to_lab_u8(faces_g),
                "lab_to_rgb_u8": lambda: lab_to_rgb_u8(lab_g)}
    want = [fn() for fn in lab_pair.values()]
    lab_ms = {}
    for design in ("two_pass", "exact_only", "exact_only", "two_pass"):
        with exact_powf_only() if design == "exact_only" else contextlib.nullcontext():
            if not all(torch.equal(fn(), w) for fn, w in zip(lab_pair.values(), want)):
                raise AssertionError(f"the Lab pair changed with the {design} powf")
            for k, fn in lab_pair.items():
                _, busy, acts, _ = profile_device(fn, 5)
                lab_ms.setdefault(design, {}).setdefault(k, []).append(
                    {"event_ms": time_cuda(fn, n=20), "device_ms": busy, "device_activities": acts})

    step, st = steps["cuda"], init_stream_states(b + 1, cfg, "cuda")

    def tick():
        step(*xg, st)

    for _ in range(3):
        tick()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall, busy, activities, top = profile_device(tick, 5)
    return {"bucket": b, "faces_detected_frames": n_face, "max_float_diff": max_float_diff,
            "tolerance": 1e-4,
            "clahe_face_pixels_differing_gpu_vs_cpu": px_diff,
            "lab_face_pixels_differing_gpu_vs_cpu": lab_diff,
            "lab_ms_bucket64": lab_ms,
            "face_pixels_compared": int(face_rows.sum()) * 160 * 160,
            "median_tick_ms_bucket64": statistics.median(times),
            "profiled_tick": {"wall_ms": wall, "device_busy_ms": busy,
                              "device_idle_share": None if busy is None else 1 - busy / wall,
                              "device_activities": activities, "top": top}}


# ------------------------------------------------------------ decode, http

JPEG_DIR = os.path.join(REPO, "tests", "data", "torch_jpeg")
FRAME_JPEG = "frame_720x405_q85_420.jpg"   # the extension's 16:9 capture
# the fixtures that hold the extension's 720x405 frame, the HTTP phase's traffic
HTTP_JPEGS = (FRAME_JPEG, "q50_720x405_420.jpg", "q95_720x405_420.jpg")


def _jpegs():
    """{name: bytes} of the committed fixtures and their digests.json entries."""
    with open(os.path.join(JPEG_DIR, "digests.json")) as fh:
        digests = json.load(fh)["files"]
    data = {}
    for name in digests:
        with open(os.path.join(JPEG_DIR, name), "rb") as fh:
            data[name] = fh.read()
    return data, digests


def phase_decode(ctx):
    """Every fixture through the entropy decoder and the reconstruction on
    the host CPU, against the committed sha256 of cv2.imdecode's output;
    the same reconstruction on the card, byte for byte; and the decode's
    times for the 720x405 frame."""
    import hashlib
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops.resize import resize_bilinear_u8_cv2
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    data, digests = _jpegs()
    t0 = time.perf_counter()
    J.library()
    build_s = time.perf_counter() - t0
    problems, checked = [], 0
    for name, entry in sorted(digests.items()):
        cpu = J.decode_jpeg(data[name])
        if not entry["port_decodes"]:
            if cpu is not None:
                problems.append(f"{name}: decoded, must be refused")
            continue
        if cpu is None or hashlib.sha256(cpu.tobytes()).hexdigest() != entry["sha256"]:
            problems.append(f"{name}: differs from cv2.imdecode's digest")
            continue
        gpu = J.reconstruct([J.decode_coefs(data[name])], "cuda")[0].cpu().numpy()
        if not (gpu == cpu).all():
            problems.append(f"{name}: {int((gpu != cpu).sum())} bytes differ on the card")
        checked += 1
    if problems:
        raise AssertionError("; ".join(problems))

    frame = data[FRAME_JPEG]
    jc = J.decode_coefs(frame)

    def host_ms(fn, n=30):
        fn()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    batch16 = [frame] * 16
    group16 = J.decode_coefs_batch(batch16)
    rec1 = functools.partial(J.reconstruct, [jc], "cuda")
    rec16 = functools.partial(J.reconstruct, group16, "cuda")

    def rec16_conform():
        resize_bilinear_u8_cv2(J.reconstruct(group16, "cuda"), 480, 640)

    dev = {}
    for k, fn in (("reconstruct_1", rec1), ("reconstruct_16", rec16),
                  ("reconstruct_16_conform_480x640", rec16_conform)):
        _, busy, acts, top = profile_device(fn, 10)
        dev[k] = {"event_ms": time_cuda(fn, n=20), "device_ms": busy,
                  "device_activities": acts, "top": top[:4]}
    return {"fixtures_checked_cpu_and_card": checked,
            "refused_as_required": sorted(n for n, e in digests.items() if not e["port_decodes"]),
            "g++_build_and_load_s": build_s, "cpu_threads": torch.get_num_threads(),
            "frame": FRAME_JPEG,
            "entropy_ms_one_frame": host_ms(lambda: J.decode_coefs(frame)),
            "reconstruct_cpu_ms_one_frame": host_ms(lambda: J.reconstruct([jc], "cpu"), n=10),
            "decode_jpeg_cpu_ms_one_frame": host_ms(lambda: J.decode_jpeg(frame), n=10),
            "pooled_entropy_ms_16_frames": host_ms(lambda: J.decode_coefs_batch(batch16)),
            "pooled_entropy_ms_16_frames_one_thread":
                host_ms(lambda: J.decode_coefs_batch(batch16, n_threads=1), n=10),
            "on_card": dev}


def _client():
    """urllib with proxies off: every request of this script goes to
    127.0.0.1."""
    import urllib.request
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http(opener, url, jpeg=None, sid=None, post=False):
    """(status, JSON body, seconds) of one request; a JPEG goes as the
    multipart field `frame`, `sid` as the X-Stream-Id header."""
    import urllib.error
    import urllib.request
    headers, body = {}, None
    if jpeg is not None or post:
        b = "chipsmoke0417"
        body = b""
        if jpeg is not None:
            body += (f'--{b}\r\nContent-Disposition: form-data; name="frame"; '
                     f'filename="frame.jpg"\r\nContent-Type: image/jpeg\r\n\r\n').encode()
            body += jpeg + b"\r\n"
        body += f"--{b}--\r\n".encode()
        headers["Content-Type"] = f"multipart/form-data; boundary={b}"
    if sid is not None:
        headers["X-Stream-Id"] = sid
    req = urllib.request.Request(url, data=body, headers=headers,
                                 method="POST" if body is not None else "GET")
    t0 = time.perf_counter()
    try:
        with opener.open(req, timeout=120) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    return status, json.loads(raw), time.perf_counter() - t0


@contextlib.contextmanager
def _serving(app):
    """`app` in the port's ThreadingWSGIServer on 127.0.0.1, a free port;
    yields the base URL and stops the server after."""
    from wsgiref.simple_server import WSGIRequestHandler
    from real_time_video_deepfake_detection_tpu_torch.serving.server import make_server

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    httpd = make_server("127.0.0.1", 0, app, handler_class=Quiet)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)


def _single_stream_http(ctx, data):
    """(a) create_app over DeepfakeDetector on the card, full-size B0."""
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
    from real_time_video_deepfake_detection_tpu_torch.serving.server import create_app
    det = DeepfakeDetector(DetectorConfig().with_threshold(0.55), params=b0_state(ctx),
                           device="cuda")
    app = create_app(det, ServerConfig(min_request_interval=0.1))
    op, problems, lat, responses = _client(), [], [], []
    interval = 0.15   # over the 100 ms limit with room for the server's accept
    with _serving(app) as url:
        st, health, _ = _http(op, url + "/health")
        if st != 200 or health.get("gpu_name") != ctx["name"] or health["device"] != "cuda:0":
            problems.append(f"/health {st} {health}")
        last = 0.0
        for t in range(12):
            time.sleep(max(0.0, last + interval - time.time()))
            last = time.time()
            st, r, sec = _http(op, url + "/analyze", data[HTTP_JPEGS[t % 3]])
            lat.append(sec * 1e3)
            responses.append(r)
            if st != 200 or _SCHEMA - set(r) or r.get("frame_count") != t + 1:
                problems.append(f"/analyze {t}: {st} {r}")
        if responses and responses[-1].get("confidence_level") == "UNCERTAIN":
            problems.append("UNCERTAIN after 12 frames")
        # two requests at once: one is analyzed, the other rate limited
        time.sleep(interval)
        pair, barrier = [], threading.Barrier(2)

        def shoot():
            barrier.wait(timeout=60)
            pair.append(_http(op, url + "/analyze", data[FRAME_JPEG])[:2])

        shots = [threading.Thread(target=shoot) for _ in range(2)]
        for th in shots:
            th.start()
        for th in shots:
            th.join(timeout=120)
        probe = max(pair, key=lambda sr: sr[0])[1] if len(pair) == 2 else {}
        if sorted(st for st, _ in pair) != [200, 429] or probe.get("error") != "Rate limited" or (
                not 0 <= probe.get("retry_after_ms", -1) <= 100):
            problems.append(f"429 probe: {pair}")
        st, stats, _ = _http(op, url + "/stats")
        if st != 200 or stats.get("frame_count") != 13 or stats["voting"]["total_frames"] != 10:
            problems.append(f"/stats {st} {stats}")
        st, reset, _ = _http(op, url + "/reset", post=True)
        after = _http(op, url + "/stats")[1]
        if reset != {"success": True, "message": "Detector reset successfully"} or (
                after.get("frame_count") != 0 or after.get("history_length") != 0):
            problems.append(f"/reset {reset} then /stats {after}")
        refused = {}
        for name, body in (("progressive", data["progressive_720x405_q85.jpg"]),
                           ("truncated", data["truncated_720x405_q85.jpg"]),
                           ("garbage", b"not an image")):
            time.sleep(interval)
            st, r, _ = _http(op, url + "/analyze", body)
            refused[name] = st
            if st != 400 or r != {"error": "Invalid image format"}:
                problems.append(f"{name}: {st} {r}")
    if problems:
        raise AssertionError("single-stream: " + "; ".join(problems[:6]))
    return {"requests_200": len(lat), "latency_ms_p50": statistics.median(lat),
            "latency_ms_max": max(lat), "modes": sorted({r["analysis_mode"] for r in responses}),
            "verdict_last": responses[-1]["confidence_level"], "rate_limit_probe": 429,
            "refused_400": refused, "stats_before_reset": stats,
            # where the latency goes: the steps on this thread, the same in
            # a new thread each time (as the server runs a request), and the
            # app's whole /analyze without the socket, in new threads too
            "steps_ms_one_thread": _single_stream_steps(det, data[FRAME_JPEG]),
            "steps_ms_new_thread_each": _single_stream_steps(det, data[FRAME_JPEG],
                                                             fresh_threads=True),
            "app_dispatch_ms_new_thread_each": _dispatch_ms(app, data[FRAME_JPEG])}


def _in_new_thread(fn):
    th = threading.Thread(target=fn)
    th.start()
    th.join(timeout=120)


def _dispatch_ms(app, jpeg, n=8):
    """Median ms of the app's /analyze (test client, no socket), each call
    in a new thread, 150 ms apart for the rate limit."""
    client, times = app.test_client(), []

    def one():
        t0 = time.perf_counter()
        r = client.post("/analyze", data={"frame": (jpeg, "frame.jpg")})
        times.append((time.perf_counter() - t0) * 1e3 if r.status_code == 200 else None)

    for _ in range(n):
        time.sleep(0.15)
        _in_new_thread(one)
    if None in times:
        raise AssertionError(f"in-process /analyze failed: {times}")
    return statistics.median(times)


def _single_stream_steps(det, jpeg, n=8, fresh_threads=False):
    """Median ms of each step of a single-stream /analyze, each ending in a
    device sync, on this thread or in a new thread per frame."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import (
        preprocess_face_quality)
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    names = ("decode_jpeg", "forensics", "face_detect", "lab_clahe_host",
             "align_classify", "tracker")
    steps = {k: [] for k in names}

    def one():
        t = [time.perf_counter()]
        frame = decode_jpeg(jpeg)
        t.append(time.perf_counter())
        det.analyze_frame_forensics(frame)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        x, y, w, h = det.face_detector(frame)[0]
        t.append(time.perf_counter())
        pre = preprocess_face_quality(frame[y:y + h, x:x + w])
        t.append(time.perf_counter())
        det._single_prediction(pre)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        det.temporal_tracker.update(0.5)
        det.temporal_tracker.get_confidence_level()
        det.temporal_tracker.get_temporal_average()
        det.temporal_tracker.get_stability_score()
        t.append(time.perf_counter())
        for k, a, b in zip(names, t, t[1:]):
            steps[k].append((b - a) * 1e3)

    for _ in range(n):
        if fresh_threads:
            _in_new_thread(one)
        else:
            one()
    if any(len(v) != n for v in steps.values()):
        raise AssertionError("a step timing run failed")
    out = {k: statistics.median(v) for k, v in steps.items()}
    return {**out, "sum": sum(out.values())}


def _batched_http(ctx, data, n_streams, n_frames):
    """(b) create_batched_app over MultiStreamEngine(device_detect) on the
    card, 16 client threads; then one stream's responses against a second
    engine fed the decoded frames through analyze."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
        MultiStreamEngine, create_batched_app)
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    proto, cm = _ssd_files(ctx)
    scfg = ServerConfig(max_streams=64, max_batch=64, device_detect=True)

    def make_engine():
        return MultiStreamEngine(_detect_cfg(), scfg, params=b0_state(ctx), device="cuda",
                                 ssd_net=CaffeNet(proto, cm))

    engine = make_engine()
    tick_launches = []
    dispatch = engine._dispatch

    def counted_dispatch(tick_cfg, arrays, states):
        before = _read_launches()
        out = dispatch(tick_cfg, arrays, states)
        torch.cuda.synchronize()
        after = _read_launches()
        tick_launches.append({k: after[k] - before[k] for k in after})
        return out

    engine._dispatch = counted_dispatch
    app = create_batched_app(engine, scfg)
    frames = [HTTP_JPEGS[t % 3] for t in range(n_frames)]
    results = {s: [] for s in range(n_streams)}
    lat, errors = [], []
    op = _client()

    with _serving(app) as url:
        def client(s):
            try:
                last = 0.0
                for name in frames:
                    time.sleep(max(0.0, last + 0.15 - time.time()))
                    last = time.time()
                    st, r, sec = _http(op, url + "/analyze", data[name], sid=f"stream-{s}")
                    results[s].append((st, r))
                    lat.append(sec * 1e3)
            except Exception as e:   # reported below; the phase fails on it
                errors.append(f"stream {s}: {type(e).__name__}: {e}")

        _reset_launches()
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(s,)) for s in range(n_streams)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.time() - t0
        launches = _read_launches()
        metrics = _http(op, url + "/metrics")[1]
    engine.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")
    statuses = {}
    problems = []
    for s, rs in results.items():
        for t, (st, r) in enumerate(rs):
            statuses[st] = statuses.get(st, 0) + 1
            if st != 200 or _SCHEMA - set(r) or r.get("frame_count") != t + 1:
                problems.append(f"stream {s} frame {t}: {st} {r}")
    for i, tl in enumerate(tick_launches):
        if min(tl.values()) <= 0:
            problems.append(f"tick {i}: a kernel was not launched: {tl}")
    if problems:
        raise AssertionError("batched: " + "; ".join(problems[:6]))

    # stream-0's responses against an engine fed the same frames, decoded,
    # through analyze (host conform instead of the tick's device conform)
    ref_engine = make_engine()
    try:
        ref = [ref_engine.analyze(decode_jpeg(data[name]), "stream-0") for name in frames]
    finally:
        ref_engine.shutdown()
    max_diff = 0.0
    for t, ((_, got), want) in enumerate(zip(results[0], ref)):
        if set(got) != set(want):
            problems.append(f"frame {t}: keys {set(got) ^ set(want)}")
            continue
        for k in set(want) - {"processing_time_ms"}:
            if isinstance(want[k], float):
                max_diff = max(max_diff, abs(got[k] - want[k]))
                if not abs(got[k] - want[k]) <= 1e-6:
                    problems.append(f"frame {t} {k}: {got[k]} vs {want[k]}")
            elif got[k] != want[k]:
                problems.append(f"frame {t} {k}: {got[k]} vs {want[k]}")
    if problems:
        raise AssertionError("HTTP stream-0 against analyze: " + "; ".join(problems[:6]))
    faces = sum("face_bbox" in r for rs in results.values() for _, r in rs)
    return {"streams": n_streams, "frames_per_stream": n_frames, "statuses": statuses,
            "frames_per_s": n_streams * n_frames / wall, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "ticks": len(tick_launches), "launches": launches,
            "launches_per_tick_min": {k: min(t[k] for t in tick_launches) for k in launches},
            "frames_with_face": faces, "engine_metrics": metrics,
            "stream0_vs_analyze_max_float_diff": max_diff, "tolerance": 1e-6}


def phase_http(ctx):
    """Two servers on 127.0.0.1 driven with urllib multipart POSTs of the
    fixture JPEGs: (a) single-stream, (b) batched device-detect."""
    data, _ = _jpegs()
    single = _single_stream_http(ctx, data)
    batched = _batched_http(ctx, data, n_streams=16, n_frames=12)
    ctx["launches"] = batched["launches"]
    return {"single_stream": single, "batched_device_detect": batched}


# ------------------------------------------------------------------- wire

# the fixtures at detect_capture_hw (480x640), which the wire planes carry
WIRE_JPEGS = ("frame_640x480_q85_420.jpg", "q50_640x480_420.jpg", "q95_640x480_420.jpg")


def _wire_reconstruction(data):
    """(b) The wire planes of a bucket-16 batch of the 480x640 fixtures:
    the reconstruction on the card against the CPU's and against the full
    decode, byte for byte; then, inside one such tick, the reconstruction's
    device ms and activities and the copy of the wire buffer to the card,
    from pinned and from pageable memory."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops.jpeg_decode import (
        bgr_from_coefs_420, bgr_from_ycbcr420)
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    datas = [data[WIRE_JPEGS[i % 3]] for i in range(16)]
    full = torch.from_numpy(np.stack([J.decode_jpeg(d) for d in datas]))
    out = {}
    for plane, rec in (("coef", lambda y, c, q: bgr_from_coefs_420(
            y, c, q.to(torch.int32) & 0xFFFF, 480, 640)), ("ycbcr420", bgr_from_ycbcr420)):
        pinned = J.wire_buffer(plane, 16, 480, 640, pin_memory=True)
        t0 = time.perf_counter()
        ok = J.decode_wire_into(plane, datas, 480, 640, pinned.numpy())
        decode_ms = (time.perf_counter() - t0) * 1e3
        if not ok.all():
            raise AssertionError(f"{plane}: fixtures refused by the wire decode: {ok}")
        dev = pinned.cuda()
        on_card = rec(*J.wire_views(plane, dev, 480, 640))
        on_cpu = rec(*J.wire_views(plane, pinned, 480, 640))
        if not torch.equal(on_card.cpu(), on_cpu) or not torch.equal(on_cpu, full):
            raise AssertionError(f"{plane}: {int((on_card.cpu() != on_cpu).sum())} bytes differ "
                                 f"card vs CPU, {int((on_cpu != full).sum())} CPU vs full decode")
        fn = functools.partial(rec, *J.wire_views(plane, dev, 480, 640))
        wall, busy, acts, top = profile_device(fn, 10)
        pageable = torch.from_numpy(pinned.numpy().copy())
        out[plane] = {
            "bytes_per_frame": pinned[0].numel() * pinned.element_size(),
            "host_decode_ms_16_frames": decode_ms,
            "reconstruct_bucket16": {"event_ms": time_cuda(fn, n=20), "device_ms": busy,
                                     "device_activities": acts, "top": top[:4]},
            "copy_bucket16_event_ms": {
                "pinned": time_cuda(lambda: pinned.to("cuda", non_blocking=True), n=20),
                "pageable": time_cuda(lambda: pageable.to("cuda"), n=20)}}
    return out


def _wire_http(ctx, engine, data, n_streams, n_frames):
    """(c) create_batched_app over `engine`, n_streams client threads with
    X-Stream-Id sending n_frames of the 480x640 fixtures each, 150 ms
    apart; every kernel launched in every tick, wire ticks counted apart."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import create_batched_app
    ticks = []

    def counted(dispatch, kind, active_at):
        def run(tick_cfg, arrays, states):
            before = _read_launches()
            out = dispatch(tick_cfg, arrays, states)
            torch.cuda.synchronize()
            after = _read_launches()
            ticks.append((kind, int(np.sum(arrays[active_at])),
                          {k: after[k] - before[k] for k in after}))
            return out
        return run

    engine._dispatch = counted(engine._dispatch, "bgr", 1)   # (frames, active, slot_idx)
    engine._dispatch_wire = counted(engine._dispatch_wire, "wire", -2)
    app = create_batched_app(engine, engine.server_cfg)
    results = {s: [] for s in range(n_streams)}
    lat, errors = [], []
    op = _client()
    with _serving(app) as url:
        def client(s):
            try:
                last = 0.0
                for t in range(n_frames):
                    time.sleep(max(0.0, last + 0.15 - time.time()))
                    last = time.time()
                    st, r, sec = _http(op, url + "/analyze", data[WIRE_JPEGS[t % 3]],
                                       sid=f"stream-{s}")
                    results[s].append((st, r))
                    lat.append(sec * 1e3)
            except Exception as e:   # reported below; the phase fails on it
                errors.append(f"stream {s}: {type(e).__name__}: {e}")

        _reset_launches()
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(s,)) for s in range(n_streams)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.time() - t0
        launches = _read_launches()
        metrics = _http(op, url + "/metrics")[1]
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")
    problems = []
    for s, rs in results.items():
        for t, (st, r) in enumerate(rs):
            if st != 200 or _SCHEMA - set(r) or r.get("frame_count") != t + 1:
                problems.append(f"stream {s} frame {t}: {st} {r}")
    for i, (kind, _, tl) in enumerate(ticks):
        if min(tl.values()) <= 0:
            problems.append(f"{kind} tick {i}: a kernel was not launched: {tl}")
    wire_ticks = [n for kind, n, _ in ticks if kind == "wire"]
    plane = engine.server_cfg.ingest_plane
    if (plane != "bgr") != bool(wire_ticks) or (plane != "bgr" and len(wire_ticks) != len(ticks)):
        problems.append(f"{plane}: {len(wire_ticks)} wire ticks of {len(ticks)}")
    if problems:
        raise AssertionError(f"wire http {plane}: " + "; ".join(problems[:6]))
    return {"frames_per_s": n_streams * n_frames / wall, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
            "ewma_host_prep_ms": metrics["ewma_host_prep_ms"], "ticks": len(ticks),
            "wire_ticks": len(wire_ticks), "mean_batch": statistics.mean(n for _, n, _ in ticks),
            "launches": launches,
            "launches_per_tick_min": {k: min(t[k] for _, _, t in ticks) for k in launches},
            "engine_metrics": metrics}


def phase_wire(ctx):
    """The wire planes of device-detect serving: (a) the bgr, coef and
    ycbcr420 engines (as detect-serve) answer the same requests alike, an
    eligible 480x640 frame, the 720x405 frame (not eligible: full decode)
    and a corrupt stream (400); (b) the reconstruction on the card equals
    the CPU's; (c) batched HTTP with each plane in turn."""
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine
    data, _ = _jpegs()
    proto, cm = _ssd_files(ctx)
    probe = [data[WIRE_JPEGS[0]], data[FRAME_JPEG], b"\xff\xd8 corrupt stream"]
    answers, served = {}, {}
    for plane in ("bgr", "coef", "ycbcr420"):
        engine = MultiStreamEngine(
            _detect_cfg(), ServerConfig(max_streams=64, max_batch=64, device_detect=True,
                                        ingest_plane=plane),
            params=b0_state(ctx), device="cuda", ssd_net=CaffeNet(proto, cm))
        try:
            answers[plane] = [engine.analyze_jpeg(d, "probe") for d in probe * 2]
            served[plane] = _wire_http(ctx, engine, data, n_streams=16, n_frames=12)
        finally:
            engine.shutdown()
    problems, max_diff = [], 0.0
    for plane in ("coef", "ycbcr420"):
        for i, (want, got) in enumerate(zip(answers["bgr"], answers[plane])):
            if set(got) != set(want):
                problems.append(f"{plane} request {i}: keys {set(got) ^ set(want)}")
                continue
            for k in set(want) - {"processing_time_ms"}:
                if isinstance(want[k], float):
                    max_diff = max(max_diff, abs(got[k] - want[k]))
                    if not abs(got[k] - want[k]) <= 1e-6:
                        problems.append(f"{plane} request {i} {k}: {got[k]} vs {want[k]}")
                elif got[k] != want[k]:
                    problems.append(f"{plane} request {i} {k}: {got[k]} vs {want[k]}")
    if [r.get("status") for r in answers["bgr"]] != [None, None, 400] * 2:
        problems.append(f"bgr answers {answers['bgr']}")
    if problems:
        raise AssertionError("; ".join(problems[:6]))
    ctx["launches"] = served["coef"]["launches"]
    return {"requests": ["eligible 480x640", "720x405 (full decode)", "corrupt"] * 2,
            "answers_bgr": answers["bgr"], "max_float_diff_vs_bgr": max_diff,
            "tolerance": 1e-6, "reconstruction": _wire_reconstruction(data),
            "http_16_streams": served}


PHASES = (("device", phase_device), ("build", phase_build),
          ("kernels", phase_kernels), ("serve", phase_serve),
          ("parity", phase_parity), ("detect-serve", phase_detect_serve),
          ("detect-parity", phase_detect_parity), ("decode", phase_decode),
          ("http", phase_http), ("wire", phase_wire))


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(name for name, _ in PHASES),
                    help="comma-separated subset of the phases, for a short run "
                         "(the contract's last lines need all of them)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, PKG, "csrc")):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    wanted = set(args.phases.split(","))
    ctx = {}
    try:
        for name, fn in PHASES:
            if name not in wanted:
                continue
            t0 = time.time()
            try:
                info = fn(ctx)
            except Exception as e:   # report, then fail the run
                emit({"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc(limit=6)})
                return 1
            emit({"phase": name, "ok": True, "seconds": round(time.time() - t0, 3), **info})
    finally:
        if "ssd_dir" in ctx:
            shutil.rmtree(ctx["ssd_dir"], ignore_errors=True)
    if wanted != {name for name, _ in PHASES}:
        return 0   # a partial run prints no contract lines

    kernels = []
    for k, v in ctx["kernels"].items():
        kernels.append({key: v[key] for key in (
            "name", "route", "source", "replaces")} | {"launches": ctx["launches"][k]}
            | {key: v[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})
    emit({"kernels": kernels, "card": ctx["smi"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
