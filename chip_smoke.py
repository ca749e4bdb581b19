#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (real_time_video_deepfake_detection_tpu_torch) on the card,
in phases, each printing one JSON line:

  1. device   the card's name and power limit; TF32 off for convolutions
              and matmuls; whether NVDEC (libnvcuvid.so.1, with
              cuvidGetDecoderCaps for H.264 High and MPEG-4 Part 2, 8-bit
              4:2:0) and FFmpeg's libavcodec load, on a line of its own
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
              on 8 streams with the jnp Lab rung pinned in place of the
              default cv2 one
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
              and a profiler window; then the same with the MTCNN cascade in
              the tick (mtcnn_device, clahe_device; seeded weights whose
              scores do not saturate), GPU against CPU, every kernel
              launched (the f32 entry of preprocess_faces included) and
              profiled beside the tick without it; then the SSD-bf16
              guard's result and the detect tick's device ms with the bf16
              SSD against the f32 SSD
  8. decode   every JPEG fixture of tests/data/torch_jpeg through the
              port's decoder (entropy decode on the host, reconstruction on
              the host CPU) against the sha256 of the JAX package's libjpeg
              decode (progressive and truncated streams included), the
              reconstruction on the card byte for byte against the CPU's; the entropy and
              reconstruction times of the extension's 720x405 frame and the
              pooled decode of 16, and the entropy time of the same frame
              arithmetic-coded (sequential and progressive)
  9. http     two servers on 127.0.0.1, driven with multipart POSTs of the
              720x405 fixtures: (a) the single-stream app over
              DeepfakeDetector (full-size B0): /health, 12 /analyze 150 ms
              apart, a 429 probe, /stats, /reset, a progressive and a
              truncated JPEG (200) and garbage (400),
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
 11. haar     the haar_native face rung (HAARCASCADE_DIR set to the
              committed cascade XML): g++ builds csrc/haar.cpp; on the
              photograph, the 720x405 and 640x480 fixtures and a seeded
              noise frame, the C++ evaluator's raw windows equal the numpy
              evaluator's and its boxes the JAX rung's
              (tests/data/torch_haar/expected.json), ms per frame of each;
              FaceDetector() resolves to it and its native call count
              rises; the single-stream server at default settings answers
              the photograph with one face; host-prep serving, 16 streams x
              12 of the three decoded fixtures, with the rung on auto (one
              native call per frame, each frame answered with the JAX
              rung's box) and then pinned to the heuristic
 12. mtcnn    the MTCNN cascade (models/mtcnn.py) on the card against the
              CPU: mtcnn_align_batch on 64 random 160x160 crops and
              MTCNNAligner.detect on the photograph's face and crops of the
              640x480 fixture (scores 1e-5, boxes 1e-3 px, faces 1e-3 where
              a face passed, the same rows passing); ms per detect call and
              the device activities of one cascade; from_weights from a
              directory and from one file; serving: the device-detect
              engine with the cascade in the tick beside the same engine
              without it (the detect-serve workload), and host-prep serving
              with the MTCNN aligner beside the resize aligner (the haar
              phase's frames)
 13. clip     BASELINE config 5: (a) ViT-B/16 and Xception at full width
              (seeded; Xception's batch-norm statistics from one batch) on
              the card against the CPU at (16,224,224,3), features and
              logits within 1e-4 of their largest magnitude, and each
              backbone's bucket-64 forward: event and device ms, activities,
              GFLOP from the shapes; (b) the config-5 detect tick
              (clahe_device, the synthetic SSD, clip_window 64, the temporal
              head seeded as the engine seeds it, its output layer rescaled
              from one run of the same ticks on the card so that the
              threshold splits the decided streams) at bucket 16 on the
              card against the CPU over 12 ticks of history and one more,
              with vit_b16 and then xception: every output and state leaf
              (the rings included), floats within 1e-4 of their largest
              magnitude, verdicts and clip_frames exactly, both REAL and
              FAKE among the decided streams; the bucket-64
              vit_b16 clip tick on the card in turns with the B0 detect
              tick: wall, device-busy ms, activities and idle share;
              (c) serving: detect-serve's workload with vit_b16 and
              clip_window 64 and that head: every response carries
              clip_probability and clip_frames, UNCERTAIN exactly below 10
              clip frames and both REAL and FAKE above, all four
              kernels launched, a /reset empties a stream's ring; frames/s
              and request p50/p99
 14. train    the trainer (train/): (a) three fused steps of a small
              EfficientNet (B0's first 4 blocks at 64 px, batch 8, head
              dropout 0) on the card and the CPU from the same parameters
              and draws: losses within 1e-4, weight deltas within 1e-3
              (relative norm; a bias whose gradient is rounding noise, just
              before a train-mode batch norm, within its Adam step bound),
              statistics within 1e-5, frozen leaves unchanged; (b) full-size
              B0 at 224, batch 32, fp32 and bf16: step wall ms (median of 20
              after 5), device-busy ms, activities and idle share
              (torch.profiler), the augment / forward+backward / update
              split (CUDA events), images/s, peak memory, FLOPs
              (torch.utils.flop_counter) and the bound at the fp32 and bf16
              rates; one step each of vit_b16 and xception; (c) the
              BatchLoader, 8 decode threads, over copies of the 480x640
              and 720x405 fixtures, reconstructing on the card and on the
              host (byte-equal): images/s beside the step's; (d) trainer.main
              on a dataset of the baseline fixtures (2 epochs, a third that
              resumes, --fit-calibrator), then the batched app serving its
              best_model.pt (each face_probability against a direct forward
              of the EMA weights, 1e-5) and with a clip head trained and
              saved by train/clip_head.py
 15. detector the one-call host prep of host-prep serving
              (utils/native_prep.prep_frame) byte for byte against the
              Python route (decode, resize, heuristic detection, the native
              Lab rung's CLAHE, the resize aligner) on every fixture, and
              the host ms of each; at B0's full width (seeded), card
              against CPU: GradCAM of 8 aligned faces (1e-3) and its ms,
              DeepfakeDetector with 4 TTA augmentations from one seed (the
              probability within 1e-4) and its ms per face with and
              without TTA, the frequency maps (1e-4) and their ms; then
              cli/bench.bench_e2e in host-prep mode at 64 clients through
              the one-call prep and through decode -> analyze, in turns
              (the preprocess and hue kernels launched in each)
 16. sharded  data parallelism on the one card: (a) the serving tick
              sharded over the mesh [cuda:0, cuda:0]
              (make_sharded_device_step) at 64 streams, full-size B0,
              every kernel's flag on, against the unsharded dense tick:
              outputs and states over 2 ticks (floats within 1e-4 of
              their largest magnitude, the rest exactly), each kernel
              launched once per shard and tick, both ticks timed in turns
              and profiled; (b) make_sharded_device_step_detect on that
              mesh with clahe_device, the coef plane of the 480x640
              fixtures, the MTCNN cascade (seeded weights that do not
              saturate) at 64 streams, and vit_b16 in clip mode at 16,
              each against the unsharded compact tick with identity
              slots, launches per shard and tick checked, the bgr pair
              timed in turns; (c) make_sharded_train_step on 2 gloo ranks
              spawned on cuda:0 (parallel/mesh.spawn, a timeout; nccl
              refuses two ranks on one card), B0 at 224, global batch 32,
              against the one-process fused_train_step from the same seed
              and draws: losses within 1e-5, parameters, statistics and
              EMA within atol 2e-5 and rtol 2e-4, the ranks alike bit for
              bit; each version's step wall ms
 17. bench    the port's serving benchmark (cli/bench.py): its main, the
              timed windows cut to 4, prints its one JSON line (the MTCNN
              core and the SSD-bf16 guard in it); each function's dict on a
              line of its own, every kernel launched, all four in every
              detect tick (the hue kernel in every full-forensic one) and
              the f32 preprocess entry in every MTCNN tick
 18. video    video in (HAARCASCADE_DIR set to the committed XML), no
              kernel on its path: (a) a 48-frame 480x640 Motion-JPEG AVI
              (utils/video.VideoWriter) of the committed 640x480 fixture's
              bytes and encode_jpeg(q95) frames with the photograph's face
              moving through it, read back frame for frame equal to
              utils/mjpeg's decode of what was written (cv2's default
              backend's), seeks landing on frame i; encode ms of a
              224x224 crop and of a frame, read ms per frame; (a3) every
              Motion-JPEG AVI of tests/data/torch_mjpeg read in order and
              after every seek against the digests of cv2.VideoCapture's
              (libavcodec's mjpeg decoder, libswscale), the refused and
              damaged ones stopped with their reason; (a4) the mp4v
              writer's OpenDML AVI past 1 GiB and mp4 / mov past 4 GiB
              (tests/data/torch_writer_large) replayed through the muxers,
              every byte outside the payloads against cv2's; (a2) the
              mp4v writer (utils/video.VideoWriter(path, "mp4v", ...)):
              every case of tests/torch_mpeg4_scenes.CASES (numpy scenes
              from a seed, frames decoded from committed mp4v files; the
              "xy2" scene pins libavcodec's sad16_approx_xy2)
              written in mp4 / mov / m4v / avi and held to the SHA-256 of
              cv2.VideoWriter's file (tests/data/torch_mpeg4_writer); the
              writer's ms per frame at 640x360 and 1920x1080; (b)
              cli/analyze.main on its first 16 frames (.avi) and 8 (.mp4)
              with full-size B0 (backbone_state, saved as a port
              checkpoint), --gradcam --output --json, on the card and on
              the CPU: verdicts, faces and GradCAM boxes equal, temporal
              averages within 1e-4, the annotated frames equal outside the
              boxes wherever the labels are equal; each --output file read
              back by VideoReader: its frame count, fps and every frame
              equal to the encoder's own reconstruction; frames/s on the
              card; (c) cli/analyze.main over 4 such
              videos through the batched engine on the card: no error,
              max_batch_seen >= 2, frames/s; (d) train/clip_head.main on
              the card over train/{real,fake} x 4 and val/{real,fake} x 1
              (Motion-JPEG AVIs named .mp4, which the readers open by
              content; window 16, 160 px crops, B0, 30 epochs), its head
              served by the batched engine with clip_probability;
              feature-extraction ms per frame at batch_frames 256; (e)
              data_tools/face_extract.preextract of the train videos with
              the synthetic SSD on the card and on the CPU: the same JPEG
              files byte for byte; crops/s; (f) utils/mp4.demux of the
              mp4/mov fixtures (tests/data/torch_mp4): sample tables equal
              to libavformat's packets (the discard flag included), frame
              counts and fps to cv2.VideoCapture's, the fragmented and
              audio-only files refused, VideoReader's reason naming the
              profile or the codec; ms a demux; (g) H.264 mp4 in,
              Constrained Baseline, Main and High (utils/h264.py,
              csrc/h264.cpp on the host): every fixture of
              tests/data/torch_h264, tests/data/torch_h264_high and the
              torch_mp4 files read sequentially, and after seek(i) at every
              i (the Baseline files and three High ones; the other High
              files at 0, the middle and the end), each frame's sha256
              against the committed digests of cv2.VideoCapture's frames,
              the MBAFF and 4:2:2 files refused by name; host ms a frame of
              the Baseline and High 640x360 and 1920x1080 clips (read,
              decode alone, BGR conversion alone); the High 640x360 clip
              read by VideoReader into MultiStreamEngine in device-detect
              mode (_detect_cfg, the synthetic SSD, B0):
              the launches of every kernel counted from 0, and one
              bucket-8 detect tick of its frames on the card against the
              CPU (1e-4); cli/analyze.main on the mp4, single (24 frames)
              and batched over three mp4s; MPEG-4 Part 2 (mp4v) in
              (utils/mpeg4.py, csrc/mpeg4.cpp on the host): every fixture
              of tests/data/torch_mpeg4 and the torch_mp4 mp4v file read
              and seeked at every i against cv2's digests, the Xvid, GMC
              and interlaced files refused by name, host ms a frame of the
              cv2-written 640x360 and 1920x1080 files, and the 640x360 one
              through the same engine (each kernel launched once a tick)
              with its bucket-8 tick against the CPU (1e-4)
 19. final    the last modules: (a) TemporalHead.forward_blockwise at the
              config-5 head's width (768 features, dim 256, depth 2, 4
              heads, window 64) over 4 streams x 4,096 frames, block 63,
              card against CPU within 1e-5, and its ms; (b) the
              tensor-parallel forward (parallel/tensor_parallel.py) of
              ViT-B/16 at bucket 64 on a 2x2 mesh and ViT-L/16 at bucket
              16 on 1x2, every entry cuda:0, against the unsharded forward
              within 2e-4, both timed in turns; (c) the DCT-scaled decode:
              every accepted fixture at every M a hint selects on the card
              against tests/data/torch_jpeg/scaled_digests.json (JAX's
              libjpeg output); 1920x1080 and 2560x1440 JPEGs of the
              capture frames (utils/jpeg_encode, q85; M = 6 and 4 at
              480x640): the scaled pooled decode and the bucket-16 detect
              tick card against CPU, device-detect serving over HTTP with
              and then without ingest_scaled_decode (16 streams x 4
              frames, every answer 200, all four kernels launched), and
              bench_prep_scaling's fast1 against exact at one thread for
              each size; (d) the JAX dry run's section 1b: 2 gloo ranks on
              cuda:0, one data-parallel step of B0 at 224 (global batch
              32), save_checkpoint_dcp, a state of other weights restored
              onto a template, one more step of both: equal bit for bit;
              (e) cli/fetch_weights --list and --dry-run, nothing fetched

 20. formats  every image the JAX package decodes on its serving and
              training paths (tests/data/torch_formats): (a) each input on
              the libjpeg route, reconstructed on the card at full size and
              at every DCT scale a hint selects, against the JAX package's
              libjpeg digests, and on the cv2 route (JPEG on the card with
              its EXIF orientation, PNG and BMP on the host) against
              cv2.imdecode's: progressive, 4:1:1, 4:4:0, RGB, CMYK, YCCK,
              cut and block-smoothed streams, EXIF 1-8, PNG and BMP; (b)
              one input of each kind through the batched device-detect app
              (full-size B0) on the card and on the CPU, responses alike
              (floats within 1e-3, boxes within 1 px), every kernel launched
              in every tick, the launches counted from 0; the same for the
              arithmetic-coded, lossless and 12-bit fixtures of
              tests/data/torch_jpeg_modes, (a) and (b) both; (c) the
              progressive 640x480 stream and a cut of it, and an
              arithmetic-coded 640x480 stream, through the coef
              plane, its reconstruction on the card equal to the digest;
              (d) the training loader on the card over a mixed dataset,
              each image equal to cv2's decode resized; (e) host ms of the
              progressive entropy decode against baseline at 720x405 and
              1920x1080, device ms of the 4:1:1 reconstruction at bucket
              16, host ms of a 720x405 PNG decode; and, for the PxM, PAM,
              PFM, Sun raster, HDR and GIF fixtures of
              tests/data/torch_image_formats, (a) on the cv2 route against
              cv2.imdecode's digests, (b) through the same apps (the
              launches of every kernel in every tick), (d) the loader
              reading them under .png names; and the same for the TIFF and
              WebP fixtures of tests/data/torch_tiff_webp (the files cv2
              reads and the port refuses by name refused with their
              reason), with (e) host ms of a lossy WebP and an LZW TIFF
              decode at 720x405 and 1920x1080; and the JPEG 2000 fixtures
              of tests/data/torch_jpeg2000: (a) on the cv2 route against
              the digests (the files refused by name refused with their
              reason), (b) through the device-detect app and a host-prep
              app with clahe_device, each on the card against the CPU, one
              launch of each kernel in each frame tick, (d) the loader
              reading them under .png names, (e) host ms of a reversible
              and a lossy (compression 100) decode at 720x405 and 1920x1080

then a `{"kernels": [...]}` line (launches: the wire phase's coef run;
launches_sharded_tick: one sharded serving tick of two shards;
launches_final: the final phase's first scaled-decode serving run;
launches_formats: the formats phase's device-detect run; launches_mp4:
the video phase's mp4 engine run) and, last,
`{"ok": true, "device": ...}`.
Any failed phase makes it exit non-zero without the last line. It needs a
CUDA device and the repository checkout around it.

    python3 chip_smoke.py --phases device,build,kernels   # a short run

runs only the named phases and prints no contract lines.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import hashlib
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
    (kernels, copies, sets) of the trace, at their ns durations; everything
    runs on one stream, so they do not overlap. Busy ms is None when the
    trace holds no device activity."""
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
    # kineto's own events: prof.events() builds the CPU event tree, which
    # nothing here reads, at ~1.5 s of host time a window
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
            by_name.setdefault(e.name(), []).append(e.duration_ns() / 1e6)
    busy = sum(sum(v) for v in by_name.values()) / n
    top = sorted(((k, sum(v) / n, len(v) / n) for k, v in by_name.items()),
                 key=lambda kv: -kv[1])[:8]
    return (wall, busy if busy > 0 else None,
            sum(len(v) for v in by_name.values()) / n,
            [{"name": k[:80], "ms_per_call": ms, "per_call": c} for k, ms, c in top])


def backbone_state(ctx, name: str = "b0"):
    """Full-size parameters of backbone `name` from a seeded generator (the
    engine's init laws), with every batch norm's statistics (EfficientNet,
    Xception; the ViT has none) set to those of its input on one batch of
    random inputs. With the init laws alone B0's activations shrink by
    ~1e-14 over the 16 blocks and every face gets the same probability;
    set this way, each layer sees unit-scale inputs and the classifier's
    output depends on the face."""
    key = f"{name}_state"
    if key in ctx:
        return ctx[key]
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.efficientnet import BatchNorm
    model = backbones.build_model(backbones.make(name),
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
    ctx[key] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return ctx[key]


# ----------------------------------------------------------------- phases

# cuviddec.h enums: cudaVideoCodec_MPEG4 = 2, _H264 = 4; cudaVideoChromaFormat_420 = 1
_CUVID_CODECS = (("h264_high_8bit_420", 4), ("mpeg4_part2_8bit_420", 2))


def _cuvid_caps(nvcuvid, codec: int) -> dict:
    """cuvidGetDecoderCaps for `codec`, 8-bit 4:2:0, under torch's primary
    context of device 0 made current through libcuda; when that call fails,
    once more under a context of its own (cuCtxCreate), to tell a context
    fault from a decoder the machine does not expose."""
    import ctypes
    import torch

    class Caps(ctypes.Structure):   # CUVIDDECODECAPS, the fields every SDK has
        _fields_ = [("eCodecType", ctypes.c_int), ("eChromaFormat", ctypes.c_int),
                    ("nBitDepthMinus8", ctypes.c_uint), ("reserved1", ctypes.c_uint * 3),
                    ("bIsSupported", ctypes.c_ubyte), ("nNumNVDECs", ctypes.c_ubyte),
                    ("nOutputFormatMask", ctypes.c_ushort), ("nMaxWidth", ctypes.c_uint),
                    ("nMaxHeight", ctypes.c_uint), ("nMaxMBCount", ctypes.c_uint),
                    ("nMinWidth", ctypes.c_ushort), ("nMinHeight", ctypes.c_ushort),
                    ("tail", ctypes.c_ubyte * 128)]

    torch.zeros(1, device="cuda")   # the primary context exists
    cuda = ctypes.CDLL("libcuda.so.1")
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    for call, args in (("cuInit", (0,)), ("cuDeviceGet", (ctypes.byref(dev), 0)),
                       ("cuDevicePrimaryCtxRetain", (ctypes.byref(ctx), dev)),
                       ("cuCtxPushCurrent_v2", (ctx,))):
        rc = getattr(cuda, call)(*args)
        if rc:
            return {"error": f"{call} returned {rc}"}
    try:
        caps = Caps(eCodecType=codec, eChromaFormat=1, nBitDepthMinus8=0)
        rc = nvcuvid.cuvidGetDecoderCaps(ctypes.byref(caps))
    finally:
        cuda.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))
        cuda.cuDevicePrimaryCtxRelease_v2(dev)
    if rc:
        own = ctypes.c_void_p()
        rc_own = cuda.cuCtxCreate_v2(ctypes.byref(own), 0, dev)
        if rc_own == 0:
            try:
                caps = Caps(eCodecType=codec, eChromaFormat=1, nBitDepthMinus8=0)
                rc_own = nvcuvid.cuvidGetDecoderCaps(ctypes.byref(caps))
            finally:
                cuda.cuCtxDestroy_v2(own)
        if rc_own:
            return {"error": f"cuvidGetDecoderCaps returned {rc} (CUresult) under the "
                             f"primary context and {rc_own} under a context of its own"}
    return {"bIsSupported": caps.bIsSupported, "nNumNVDECs": caps.nNumNVDECs,
            "nMaxWidth": caps.nMaxWidth, "nMaxHeight": caps.nMaxHeight,
            "nMaxMBCount": caps.nMaxMBCount}


def _mp4_decoder_probe() -> dict:
    """Whether the machine's libraries could decode mp4 video: NVDEC's
    libnvcuvid.so.1 (with its decoder caps for H.264 High and MPEG-4 Part
    2) and FFmpeg's libavcodec load with ctypes, and their versions. A
    missing library is reported as missing; nothing uses either."""
    import ctypes
    import ctypes.util
    out = {}
    try:
        nvcuvid = ctypes.CDLL("libnvcuvid.so.1")
    except OSError as e:
        out["libnvcuvid"] = {"loaded": False, "error": str(e)}
    else:
        with open("/proc/self/maps") as fh:   # the file the loader resolved, with its version
            paths = {line.split()[-1] for line in fh if "libnvcuvid" in line}
        info = {"loaded": True, "files": sorted(paths)}
        cuda = ctypes.CDLL("libcuda.so.1")
        version = ctypes.c_int()
        if cuda.cuDriverGetVersion(ctypes.byref(version)) == 0:
            info["cuda_driver_version"] = version.value
        for label, codec in _CUVID_CODECS:
            try:
                info[label] = _cuvid_caps(nvcuvid, codec)
            except (OSError, AttributeError) as e:
                info[label] = {"error": str(e)}
        out["libnvcuvid"] = info
    names = [n for n in (ctypes.util.find_library("avcodec"),) if n] + [
        f"libavcodec.so.{v}" for v in range(62, 56, -1)] + ["libavcodec.so"]
    for name in names:
        try:
            avcodec = ctypes.CDLL(name)
        except OSError:
            continue
        avcodec.avcodec_version.restype = ctypes.c_uint
        v = avcodec.avcodec_version()
        out["libavcodec"] = {"loaded": True, "name": name,
                             "version": f"{v >> 16}.{(v >> 8) & 255}.{v & 255}"}
        break
    else:
        out["libavcodec"] = {"loaded": False, "tried": names}
    return out


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
    probe = _mp4_decoder_probe()
    print(json.dumps({"mp4_decoders": probe, "card": line}), flush=True)
    return {"name": name, "nvidia_smi": line, "count": torch.cuda.device_count(),
            "mp4_decoders": probe,
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
        "device_ms_f32_input": profile_device(
            lambda: preproc.preprocess_faces(faces_f32, 224), 20)[1],
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
                                         "ms_f32_input", "device_ms_f32_input",
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
    each frame. The background and the ellipse are separable: each is
    computed from a row and a column, broadcast with the same float
    operations in the same order as over a full grid."""
    import numpy as np
    yy, xx = np.arange(480)[:, None], np.arange(640)[None, :]
    f = 100 + 40 * np.sin(xx / 37.0 + t / 5.0) * np.cos(yy / 53.0)
    # gray noise: equal channels keep the background out of the skin range
    f = np.clip(f + rng.integers(-12, 13, (480, 640)), 0, 255).astype(np.uint8)
    f = np.repeat(f[..., None], 3, axis=2)
    if face:
        m = ((xx - 320 - 3 * t) / 90.0) ** 2 + ((yy - 240) / 120.0) ** 2 <= 1.0
        skin = np.array([140, 160, 210]) + rng.integers(-6, 7, (int(m.sum()), 3))
        f[m] = skin
    return f


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
    then with the jnp rung pinned (8 of the 16 streams), in one call."""
    from real_time_video_deepfake_detection_tpu_torch.pipeline import detector
    runs = {}
    for lab in ("cv2", "jnp"):
        saved, detector._LAB_BACKEND = detector._LAB_BACKEND, lab
        try:
            runs[lab] = _serve_run(ctx, host_prep=lab == "cv2",
                                   n_streams=16 if lab == "cv2" else 8)
        finally:
            detector._LAB_BACKEND = saved
    return {"lab_rung_cv2": runs["cv2"], "lab_rung_jnp": runs["jnp"]}


def _serve_run(ctx, host_prep, n_streams=16):
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine

    cfg = DetectorConfig(use_pallas_preproc=True, use_pallas_color=True,
                         face_backend="heuristic")
    engine = MultiStreamEngine(cfg, ServerConfig(max_streams=64, max_batch=64),
                               params=backbone_state(ctx), device="cuda")
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
    n_frames = 12
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
    model_cpu.load_state_dict(backbone_state(ctx))
    model_gpu = backbones.build_model(backbones.make("b0")).eval()
    model_gpu.load_state_dict(backbone_state(ctx))
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
    for k in preproc.entry_launches:
        preproc.entry_launches[k] = 0


def _read_entry_launches():
    """preprocess_faces launches by entry (u8 and f32 faces)."""
    from real_time_video_deepfake_detection_tpu_torch.kernels import preproc
    return dict(preproc.entry_launches)


def _read_launches():
    from real_time_video_deepfake_detection_tpu_torch.kernels import (
        clahe, color_stats, preproc)
    return {"preprocess_faces": preproc.launches,
            "unique_hue_count": color_stats.launches, **clahe.launches}


def _detect_serve(ctx, aligner=None, backbone="b0", clip_window=0, clip_head_params=None):
    """The device-detect engine with clahe_device on the card, 16 streams x
    12 capture frames from 16 threads; with an MTCNNAligner `aligner`, the
    cascade runs in the tick (mtcnn_device); `backbone` names the
    classifier, and clip_window > 0 puts the clip-attention head's verdict
    (the head's state dict `clip_head_params`) in place of the vote. Checks
    the responses (in clip mode: the clip keys, UNCERTAIN exactly while a
    stream has fewer than clip_min_frames face frames, both REAL and FAKE
    among the others, and a /reset that empties a stream's ring), that every kernel
    was launched (with MTCNN, the f32 preprocess entry too) and that faces
    were found; frames/s, the request latency and the median tick."""
    import dataclasses
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine

    proto, cm = _ssd_files(ctx)
    net = CaffeNet(proto, cm)   # the engine moves it to the card
    cfg = dataclasses.replace(_detect_cfg(), mtcnn_device=aligner is not None,
                              clip_window=clip_window)
    engine = MultiStreamEngine(
        cfg, ServerConfig(max_streams=64, max_batch=64, device_detect=True),
        params=backbone_state(ctx, backbone), spec=backbones.make(backbone), device="cuda",
        ssd_net=net, aligner=aligner, clip_head_params=clip_head_params)
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
    latency_ms, errors = [], []

    def client(s):
        try:
            for t in range(n_frames):
                t0 = time.perf_counter()
                results[s].append(engine.analyze(frames[s][t], f"stream-{s}"))
                latency_ms.append((time.perf_counter() - t0) * 1e3)
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
    launches, entries = _read_launches(), _read_entry_launches()
    after_reset = None
    if clip_window > 0 and not errors:
        engine.reset("stream-0")
        after_reset = engine.analyze(frames[0][0], "stream-0")
    engine.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")

    problems = []
    min_frames = min(engine.cfg.clip_min_frames, clip_window)
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
            if clip_window > 0:
                if not {"clip_probability", "clip_frames"} <= set(r):
                    problems.append(f"stream {s} frame {t}: no clip keys")
                elif (r["clip_frames"] < min_frames) != (r["confidence_level"] == "UNCERTAIN"):
                    problems.append(f"stream {s} frame {t}: {r['confidence_level']} with "
                                    f"{r['clip_frames']} clip frames")
                elif not 0.0 <= r["clip_probability"] <= 1.0:
                    problems.append(f"stream {s} frame {t}: clip_probability "
                                    f"{r['clip_probability']}")
            elif r["frame_count"] >= 10 and r["confidence_level"] == "UNCERTAIN":
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
    want_entry = "preprocess_faces_f32" if aligner is not None else "preprocess_faces_u8"
    if entries[want_entry] != launches["preprocess_faces"]:
        problems.append(f"preprocess_faces entries {entries}, want every launch {want_entry}")
    faces = [r for rs in results.values() for r in rs if r.get("analysis_mode") == "face+frame"]
    if not faces:
        problems.append("no frame had a detected face")
    face_probs = [r["face_probability"] for r in faces]
    if faces and not max(face_probs) - min(face_probs) > 1e-3:
        problems.append(f"the classifier gave every face the same probability {face_probs[0]}")
    clip = {}
    if clip_window > 0:
        answered = [r for rs in results.values() for r in rs if "clip_frames" in r]
        decided = [r["confidence_level"] for r in answered if r["clip_frames"] >= min_frames]
        if set(decided) != {"REAL", "FAKE"}:
            problems.append(f"decided clip verdicts {sorted(set(decided))}, want REAL and FAKE")
        want_after = {"clip_frames": int(after_reset.get("analysis_mode") == "face+frame"),
                      "frame_count": 1} if after_reset else None
        if not want_after or any(after_reset.get(k) != v for k, v in want_after.items()):
            problems.append(f"after /reset stream 0 answered {after_reset}")
        probs = [r["clip_probability"] for r in answered]
        clip = {"clip_window": clip_window, "clip_min_frames": min_frames,
                "max_clip_frames": max((r["clip_frames"] for r in answered), default=None),
                "decided_responses": len(decided), "fake_verdicts": decided.count("FAKE"),
                "clip_probability_range": [min(probs), max(probs)] if probs else None,
                "after_reset": after_reset and {k: after_reset.get(k)
                                                for k in ("clip_frames", "frame_count")}}
    if problems:
        raise AssertionError("; ".join(problems[:8]))
    return {"streams": n_streams, "frames_per_stream": n_frames, "frame_seed": seed,
            "backbone": backbone, **clip, "mtcnn_device": aligner is not None,
            "ticks": len(tick_ms), "mean_batch": statistics.mean(batch_sizes),
            "median_tick_ms": statistics.median(tick_ms), "wall_s": wall,
            "frames_per_s": n_streams * n_frames / wall,
            "request_ms_p50": float(np.percentile(latency_ms, 50)),
            "request_ms_p99": float(np.percentile(latency_ms, 99)),
            "frames_with_face": len(faces),
            "frames_with_ssd_face": sum(r["faces_detected"] > 0 for rs in results.values()
                                        for r in rs),
            "launches": launches, "preprocess_entry_launches": entries,
            "engine_metrics": engine.metrics,
            "face_probability_range": [min(face_probs), max(face_probs)]}


def phase_detect_serve(ctx):
    info = _detect_serve(ctx)
    ctx["launches"] = info["launches"]
    return info


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
    nets, models, steps, preps = {}, {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = backbones.build_model(backbones.make("b0")).eval()
        model.load_state_dict(backbone_state(ctx))
        models[dev] = model.to(dev)
        nets[dev] = CaffeNet(proto, cm).to(dev).eval()
        steps[dev] = make_device_step_detect(nets[dev], models[dev], cfg)
        preps[dev] = _make_detect_prep(nets[dev], cfg)[0]
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
    mtcnn = _mtcnn_tick_parity(ctx, nets, models, xs, xg, tick)
    ssd16 = _ssd_bf16_tick(nets["cuda"], models["cuda"], cfg, xg)
    return {"bucket": b, "faces_detected_frames": n_face, "max_float_diff": max_float_diff,
            "tolerance": 1e-4,
            "clahe_face_pixels_differing_gpu_vs_cpu": px_diff,
            "lab_face_pixels_differing_gpu_vs_cpu": lab_diff,
            "lab_ms_bucket64": lab_ms,
            "face_pixels_compared": int(face_rows.sum()) * 160 * 160,
            "median_tick_ms_bucket64": statistics.median(times),
            "profiled_tick": {"wall_ms": wall, "device_busy_ms": busy,
                              "device_idle_share": None if busy is None else 1 - busy / wall,
                              "device_activities": activities, "top": top},
            "mtcnn_tick": mtcnn, "ssd_bf16": ssd16}


def _mtcnn_weights(bias: float = 3.0):
    """The JAX package's init_random_mtcnn(5) draws with the class heads
    biased by -bias / +bias (cli/bench._decisive_mtcnn). At 3 the cascade
    accepts many crops and its scores do not saturate; the bench's 5 makes
    most of P-Net's top probabilities exact float32 ties."""
    from real_time_video_deepfake_detection_tpu_torch.cli.bench import _decisive_mtcnn
    return _decisive_mtcnn(5, bias)


def _profiled(fn, n=5):
    wall, busy, acts, top = profile_device(fn, n)
    return {"wall_ms": wall, "device_busy_ms": busy, "device_activities": acts,
            "device_idle_share": None if busy is None else 1 - busy / wall, "top": top[:4]}


def _mtcnn_tick_parity(ctx, nets, models, xs, xg, plain_tick):
    """The bucket-64 detect tick with the cascade in it (mtcnn_device and
    clahe_device), on the card against the CPU: has_face, face_bbox and
    faces_detected equal, floats within 1e-4 (face_probability on face
    rows); every kernel launched in the card's tick, the f32 preprocess
    entry included; wall, device-busy ms and activities beside the tick
    without the cascade, in turns."""
    import dataclasses
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models.mtcnn import build_nets
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
    b = xs[0].shape[0]
    cfg = dataclasses.replace(_detect_cfg(), mtcnn_device=True)
    steps = {dev: make_device_step_detect(nets[dev], models[dev], cfg,
                                          build_nets(_mtcnn_weights(), dev))
             for dev in ("cpu", "cuda")}
    out_c, st_c = steps["cpu"](*xs, init_stream_states(b + 1, cfg, "cpu"))
    _reset_launches()
    out_g, st_g = steps["cuda"](*xg, init_stream_states(b + 1, cfg, "cuda"))
    torch.cuda.synchronize()
    launches, entries = _read_launches(), _read_entry_launches()
    face = out_c["has_face"]
    pairs = [(k, out_c[k], out_g[k].cpu()) for k in out_c]
    pairs += [(f"state{i}", a, g.cpu()) for i, (a, g) in
              enumerate(zip(tree_leaves(st_c), tree_leaves(st_g)))]
    max_diff = 0.0
    for k, a, g in pairs:
        if k == "face_probability":   # the cascade's rejects hold no face
            a, g = a[face], g[face]
        if a.dtype.is_floating_point:
            d = float((a - g).abs().max()) if a.numel() else 0.0
            max_diff = max(max_diff, d)
            if not d <= 1e-4:
                raise AssertionError(f"mtcnn tick {k}: max abs diff {d} > 1e-4")
        elif not torch.equal(a, g):
            raise AssertionError(f"mtcnn tick {k}: {int((a != g).sum())} integers differ")
    n_ssd = int((out_c["faces_detected"] > 0).sum())
    if int(face.sum()) == 0:
        raise AssertionError(f"the cascade accepted none of {n_ssd} SSD faces")
    if min(launches.values()) < 1 or entries["preprocess_faces_f32"] < 1:
        raise AssertionError(f"mtcnn tick launches {launches}, entries {entries}")
    st = init_stream_states(b + 1, cfg, "cuda")

    def tick():
        steps["cuda"](*xg, st)

    for _ in range(3):
        tick()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    profiles = {"without_mtcnn": [], "with_mtcnn": []}
    for name in ("without_mtcnn", "with_mtcnn", "with_mtcnn", "without_mtcnn"):
        profiles[name].append(_profiled(plain_tick if name == "without_mtcnn" else tick))
    return {"rows_with_ssd_face": n_ssd, "rows_accepted_by_cascade": int(face.sum()),
            "max_float_diff": max_diff, "tolerance": 1e-4, "launches": launches,
            "preprocess_entry_launches": entries,
            "median_tick_ms_bucket64": statistics.median(times), "profiles": profiles}


def _ssd_bf16_tick(net, model, cfg, xg):
    """The bench's SSD-bf16 guard (its dict printed on a line of its own),
    then the bucket-64 detect tick's wall and device ms with the bf16 SSD
    against the f32 SSD, in turns."""
    import dataclasses
    import torch
    from real_time_video_deepfake_detection_tpu_torch.cli import bench as B
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)
    guard = B.detect_ssd_bf16_guard(device="cuda")
    emit({"ssd_bf16_guard": guard})
    b = xg[0].shape[0]
    ticks = {}
    for name, c in (("f32", cfg), ("bf16", dataclasses.replace(cfg, ssd_bf16=True))):
        step, st = make_device_step_detect(net, model, c), init_stream_states(b + 1, c, "cuda")
        ticks[name] = functools.partial(step, *xg, st)
        for _ in range(3):
            ticks[name]()
    torch.cuda.synchronize()
    profiles = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        profiles[name].append(_profiled(ticks[name]))
    return {"guard": guard, "profiles": profiles}


# ------------------------------------------------------------ decode, http

JPEG_DIR = os.path.join(REPO, "tests", "data", "torch_jpeg")
JPEG_MODES_DIR = os.path.join(REPO, "tests", "data", "torch_jpeg_modes")
ARITH_FRAMES = ("arith_seq_720x405_420.jpg", "arith_prog_720x405_420.jpg")
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
        if cpu is None or hashlib.sha256(cpu.tobytes()).hexdigest() != entry["native"]["sha256"]:
            problems.append(f"{name}: differs from the JAX package's libjpeg digest")
            continue
        gpu = J.reconstruct([J.decode_coefs(data[name])], "cuda")[0].cpu().numpy()
        if not (gpu == cpu).all():
            problems.append(f"{name}: {int((gpu != cpu).sum())} bytes differ on the card")
        checked += 1
    if problems:
        raise AssertionError("; ".join(problems))

    frame = data[FRAME_JPEG]
    jc = J.decode_coefs(frame)
    modes = {}
    for k in ARITH_FRAMES:   # the same frame arithmetic-coded, sequential and progressive
        with open(os.path.join(JPEG_MODES_DIR, k), "rb") as fh:
            modes[k] = fh.read()
        if not (J.decode_jpeg(modes[k]) == J.decode_jpeg(frame)).all():
            raise AssertionError(f"{k} decodes to other pixels than {FRAME_JPEG}")

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
            "entropy_ms_one_frame_arithmetic": {
                k: host_ms(lambda d=modes[k]: J.decode_coefs(d)) for k in ARITH_FRAMES},
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
    det = DeepfakeDetector(DetectorConfig().with_threshold(0.55), params=backbone_state(ctx),
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
        # progressive and truncated JPEGs decode (libjpeg pads the
        # truncated one); garbage answers 400
        statuses = {}
        for name, body, want in (("progressive", data["progressive_720x405_q85.jpg"], 200),
                                 ("truncated", data["truncated_720x405_q85.jpg"], 200),
                                 ("garbage", b"not an image", 400)):
            time.sleep(interval)
            st, r, _ = _http(op, url + "/analyze", body)
            statuses[name] = st
            if st != want or (want == 400 and r != {"error": "Invalid image format"}):
                problems.append(f"{name}: {st} {r}")
    if problems:
        raise AssertionError("single-stream: " + "; ".join(problems[:6]))
    return {"requests_200": len(lat), "latency_ms_p50": statistics.median(lat),
            "latency_ms_max": max(lat), "modes": sorted({r["analysis_mode"] for r in responses}),
            "verdict_last": responses[-1]["confidence_level"], "rate_limit_probe": 429,
            "after_reset_statuses": statuses, "stats_before_reset": stats,
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
        return MultiStreamEngine(_detect_cfg(), scfg, params=backbone_state(ctx), device="cuda",
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
            params=backbone_state(ctx), device="cuda", ssd_net=CaffeNet(proto, cm))
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


# ------------------------------------------------------------------- haar

HAAR_DIR = os.path.join(REPO, "tests", "data", "torch_haar")
HAAR_PHOTO = "grace_hopper.jpg"   # a frontal face, 512x600 baseline 4:2:0


def _haar_frames():
    """The frames of tests/data/torch_haar/expected.json (the JAX rung's raw
    window counts and boxes), decoded by the port: the photograph, the
    720x405 and 640x480 fixtures and the seeded noise frame."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    with open(os.path.join(HAAR_DIR, "expected.json")) as fh:
        expected = json.load(fh)
    frames = {}
    for name in expected["frames"]:
        if name == "noise":
            n = expected["noise"]
            frames[name] = np.random.default_rng(n["seed"]).integers(
                0, 256, n["shape"], dtype=np.uint8)
            continue
        with open(os.path.join(HAAR_DIR if name == HAAR_PHOTO else JPEG_DIR, name), "rb") as fh:
            frames[name] = decode_jpeg(fh.read())
    return expected["frames"], frames


def _haar_serve(ctx, face_backend, frames, aligner=None):
    """The host-prep engine, 16 streams x 12 frames from 16 threads, each
    stream cycling the three decoded fixtures; frames/s, the median tick,
    the face detector's and the aligner's ms per frame. `aligner`: None
    is the resize aligner."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine
    cfg = DetectorConfig(use_pallas_preproc=True, use_pallas_color=True,
                         face_backend=face_backend)
    engine = MultiStreamEngine(cfg, ServerConfig(max_streams=64, max_batch=64),
                               params=backbone_state(ctx), device="cuda", aligner=aligner)
    backend = engine.face_detector.backend
    tick_ms, detect_ms, align_ms = [], [], []
    dispatch, detector, align = engine._dispatch, engine.face_detector, engine.aligner

    def timed_dispatch(tick_cfg, arrays, states):
        t0 = time.perf_counter()
        out = dispatch(tick_cfg, arrays, states)
        torch.cuda.synchronize()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_detector(frame):
        t0 = time.perf_counter()
        boxes = detector(frame)
        detect_ms.append((time.perf_counter() - t0) * 1e3)
        return boxes

    align_crops = {}    # the crops handed to an MTCNN aligner: [crop, calls]

    def timed_aligner(crop):
        if aligner is not None:
            with lock:
                key = hashlib.sha1(np.ascontiguousarray(crop).tobytes()).hexdigest()
                align_crops.setdefault(key, [crop.copy(), 0])[1] += 1
        t0 = time.perf_counter()
        face = align(crop)
        align_ms.append((time.perf_counter() - t0) * 1e3)
        return face

    lock = threading.Lock()
    engine._dispatch, engine.face_detector = timed_dispatch, timed_detector
    engine.aligner = timed_aligner
    n_streams, n_frames = 16, 12
    names = list(frames)
    results = {s: [] for s in range(n_streams)}
    errors = []

    def client(s):
        try:
            for t in range(n_frames):
                name = names[(s + t) % len(names)]
                results[s].append((name, engine.analyze(frames[name], f"stream-{s}")))
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
        raise AssertionError(f"{face_backend} clients failed: {errors[:3]}")
    problems = [f"{face_backend} stream {s}: {name}: {r}" for s, rs in results.items()
                for name, r in rs if not r.get("success") or _SCHEMA - set(r)]
    problems += [f"kernel {k} was not launched" for k, n in launches.items() if n <= 0]
    if problems:
        raise AssertionError("; ".join(problems[:6]))
    faces = {}
    for rs in results.values():
        for name, r in rs:
            box = r.get("face_bbox")
            faces.setdefault(name, set()).add(
                (box["x"], box["y"], box["width"], box["height"]) if box else None)
    return {"backend": backend, "streams": n_streams, "frames_per_stream": n_frames,
            "frames_per_s": n_streams * n_frames / wall, "wall_s": wall,
            "ticks": len(tick_ms), "median_tick_ms": statistics.median(tick_ms),
            "detect_ms_per_frame_median": statistics.median(detect_ms),
            "detect_ms_per_frame_p90": float(np.percentile(detect_ms, 90)),
            "aligner": type(align).__name__, "aligned_face_frames": len(align_ms),
            "align_ms_per_face_frame_median": statistics.median(align_ms) if align_ms else None,
            "frames_answered_with_face": sum(r.get("analysis_mode") == "face+frame"
                                             for rs in results.values() for _, r in rs),
            "boxes_by_frame": {k: sorted(map(str, v)) for k, v in faces.items()},
            "served_by_frame": {k: sum(name == k for rs in results.values() for name, _ in rs)
                                for k in names},
            "launches": launches,
            **({"align_crops": list(align_crops.values())} if aligner is not None else {})}


def phase_haar(ctx):
    """The haar_native rung on the card's host: the C++ evaluator built
    from csrc/haar.cpp, its raw windows against the numpy evaluator's and
    its boxes against the JAX rung's on every fixture, the default ladder
    resolving to it, the single-stream server answering the photograph with
    one face, and host-prep serving with the cascade against the heuristic."""
    import numpy as np
    # the card's host has no OpenCV data files: the committed XML
    os.environ["HAARCASCADE_DIR"] = HAAR_DIR
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.models import haar_cascade as H
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
    from real_time_video_deepfake_detection_tpu_torch.pipeline.faces import FaceDetector
    from real_time_video_deepfake_detection_tpu_torch.serving.server import create_app
    from real_time_video_deepfake_detection_tpu_torch.utils import native_haar as N
    t0 = time.time()
    N.library()
    gpp_s = time.time() - t0
    expected, frames = _haar_frames()
    cascade = H.default_cascade()
    problems, per_frame = [], {}
    for name, bgr in frames.items():
        gray = H.bgr_to_gray_u8(bgr)
        native_ms = []
        for _ in range(5):
            t = time.perf_counter()
            raw = cascade.native().detect_raw(gray)
            native_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        raw_numpy = cascade.detect_raw(gray)
        numpy_ms = (time.perf_counter() - t) * 1e3
        boxes = [list(b) for b in H.detect_haar_native(bgr)]
        want = expected[name]
        if sorted(raw) != sorted(raw_numpy):
            problems.append(f"{name}: native and numpy raw windows differ")
        if len(raw) != want["raw_windows"] or boxes != want["boxes"]:
            problems.append(f"{name}: {len(raw)} raw windows, boxes {boxes}; the JAX rung: "
                            f"{want['raw_windows']}, {want['boxes']}")
        per_frame[name] = {"shape": list(bgr.shape), "raw_windows": len(raw), "boxes": boxes,
                           "native_ms_median": statistics.median(native_ms),
                           "numpy_ms": numpy_ms}
    detector = FaceDetector()
    calls = N.calls
    photo_boxes = detector(frames[HAAR_PHOTO])
    if detector.backend != "haar_native" or N.calls <= calls:
        problems.append(f"FaceDetector(): backend {detector.backend}, "
                        f"native calls {calls} -> {N.calls}")
    if photo_boxes != [tuple(b) for b in expected[HAAR_PHOTO]["boxes"]]:
        problems.append(f"FaceDetector() on the photograph: {photo_boxes}")

    det = DeepfakeDetector(DetectorConfig(), params=backbone_state(ctx), device="cuda")
    with open(os.path.join(HAAR_DIR, HAAR_PHOTO), "rb") as fh:
        photo = fh.read()
    with _serving(create_app(det, ServerConfig())) as url:
        st, r, sec = _http(_client(), url + "/analyze", photo)
    want_box = dict(zip(("x", "y", "width", "height"), expected[HAAR_PHOTO]["boxes"][0]))
    if (st != 200 or det.face_detector.backend != "haar_native"
            or r.get("faces_detected") != 1 or r.get("face_bbox") != want_box):
        problems.append(f"single-stream /analyze of the photograph: {st} {r}")
    if problems:
        raise AssertionError("; ".join(problems[:6]))

    served = {name: frames[name] for name in (HAAR_PHOTO, "frame_640x480_q85_420.jpg",
                                              "frame_720x405_q85_420.jpg")}
    calls = N.calls
    cascade_run = _haar_serve(ctx, "auto", served)
    cascade_run["native_calls"] = N.calls - calls
    heuristic_run = _haar_serve(ctx, "heuristic", served)
    # one native call per served frame, and each frame answered with the JAX
    # rung's box: a frame that fell through to the heuristic fails here
    n_served = cascade_run["streams"] * cascade_run["frames_per_stream"]
    if cascade_run["backend"] != "haar_native" or cascade_run["native_calls"] != n_served:
        raise AssertionError(f"host-prep serving on auto did not run the cascade on every "
                             f"frame: {cascade_run['backend']}, "
                             f"{cascade_run['native_calls']} calls for {n_served} frames")
    for name in served:
        want = {str(tuple(b)) for b in expected[name]["boxes"]} or {"None"}
        got = cascade_run["boxes_by_frame"][name]
        if len(got) != 1 or got[0] not in want:
            problems.append(f"host-prep serving on auto, {name}: boxes {got}, the JAX rung: "
                            f"{sorted(want)}")
    if problems:
        raise AssertionError("; ".join(problems))
    return {"gpp_seconds": gpp_s, "library": os.path.relpath(N.library()._name, REPO),
            "frames": per_frame,
            "native_ms_per_frame": {k: v["native_ms_median"] for k, v in per_frame.items()},
            "numpy_ms_per_frame": {k: v["numpy_ms"] for k, v in per_frame.items()},
            "face_detector_backend": detector.backend,
            "single_stream_photo": {"status": st, "faces_detected": r["faces_detected"],
                                    "face_bbox": r["face_bbox"], "ms": sec * 1e3},
            "host_prep_serving": {"auto": cascade_run, "heuristic": heuristic_run},
            "frames_per_s_cascade_vs_heuristic": [cascade_run["frames_per_s"],
                                                  heuristic_run["frames_per_s"]]}


# ------------------------------------------------------------------ mtcnn

def _mtcnn_crops(n: int, frames: dict):
    """n 160x160 RGB float crops, from SEED: half uniform noise, half cut at
    random offsets from the decoded frames of the haar phase."""
    import numpy as np
    rng = np.random.default_rng(SEED + 8)
    imgs = list(frames.values())
    crops = []
    for i in range(n):
        if i % 2:
            crops.append(rng.integers(0, 256, (160, 160, 3)))
            continue
        img = imgs[i // 2 % len(imgs)]
        y = int(rng.integers(0, img.shape[0] - 160 + 1))
        x = int(rng.integers(0, img.shape[1] - 160 + 1))
        crops.append(img[y:y + 160, x:x + 160, ::-1])
    return np.stack(crops).astype(np.float32)


def _pnet_ties(nets, crops, k=64):
    """Exact float32 ties among P-Net's top-k face probabilities of each
    pyramid level: (mean, max) over crops and levels of the number of the k
    values that equal another of them."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import mtcnn as M
    counts = []
    with torch.no_grad():
        for Wh, Ww, _ in M._pyramid(160, 160, torch.device("cpu")):
            x = M._normalize(M._area_resize_static(torch.from_numpy(crops), Wh, Ww))
            p = nets["pnet"](x.permute(0, 3, 1, 2))[0][:, 1].reshape(len(crops), -1)
            for row in M._top_k(p, k)[0].numpy():
                _, inv, cnt = np.unique(row, return_inverse=True, return_counts=True)
                counts.append(int((cnt[inv] > 1).sum()))
    return float(np.mean(counts)), int(max(counts))


def phase_mtcnn(ctx):
    """The MTCNN cascade on the card against the CPU, from_weights, and
    serving with it: in the device-detect tick beside the tick without it,
    and as the host-prep aligner beside the resize aligner."""
    import numpy as np
    import torch
    os.environ["HAARCASCADE_DIR"] = HAAR_DIR
    from real_time_video_deepfake_detection_tpu_torch.models import mtcnn as M
    sds = _mtcnn_weights()
    nets = {dev: M.build_nets(sds, dev) for dev in ("cpu", "cuda")}
    expected, frames = _haar_frames()
    crops = _mtcnn_crops(64, frames)
    ties3 = _pnet_ties(nets["cpu"], crops[:8])
    ties5 = _pnet_ties(M.build_nets(_mtcnn_weights(5.0), "cpu"), crops[:8])
    problems = []

    def compare(what, got, want):
        """(faces, scores, boxes) of the card against the CPU's."""
        fg, sg, bg = (t.cpu() for t in got)
        fc, sc, bc = want
        ok = sg > 0
        if not torch.equal(ok, sc > 0):
            problems.append(f"{what}: rows passing differ: {ok.tolist()} {(sc > 0).tolist()}")
            return 0.0, 0.0, 0.0
        d = (float((sg - sc).abs().max()), float((bg - bc)[ok].abs().max()) if ok.any() else 0.0,
             float((fg - fc)[ok].abs().max()) if ok.any() else 0.0)
        if not (d[0] <= 1e-5 and d[1] <= 1e-3 and d[2] <= 1e-3):
            problems.append(f"{what}: score, box, face max abs diff {d}")
        return d

    # 1. the in-tick cascade on a bucket of 64 crops
    out = {dev: M.mtcnn_align_batch(nets[dev], torch.from_numpy(crops).to(dev))
           for dev in ("cpu", "cuda")}
    batch_diff = compare("mtcnn_align_batch", out["cuda"], out["cpu"])
    g = torch.from_numpy(crops).cuda()
    batch_prof = _profiled(lambda: M.mtcnn_align_batch(nets["cuda"], g))
    batch_ms = time_cuda(lambda: M.mtcnn_align_batch(nets["cuda"], g), n=10)

    # 2. the host aligner: the photograph's face at the haar rung's box, and
    # crops of the 640x480 fixture
    aligners = {dev: M.MTCNNAligner(sds, device=dev) for dev in ("cpu", "cuda")}
    photo = frames[HAAR_PHOTO]
    fixture = frames["frame_640x480_q85_420.jpg"]
    x, y, w, h = 154, 105, 222, 222
    host_crops = {"photo_face": photo[y:y + h, x:x + w],
                  "fixture_center_200": fixture[140:340, 220:420],
                  "fixture_top_left_120x160": fixture[:120, :160],
                  "fixture_full": fixture}
    detect = {}
    for name, crop in host_crops.items():
        r = {dev: aligners[dev].detect(np.ascontiguousarray(crop)) for dev in ("cpu", "cuda")}
        (fg, sg, bg), (fc, sc, bc) = r["cuda"], r["cpu"]
        entry = {"shape": list(crop.shape), "score_cuda": sg, "score_cpu": sc}
        if (fg is None) != (fc is None):
            problems.append(f"detect {name}: card {sg}, CPU {sc}")
        elif fg is not None:
            entry["max_abs_diff"] = [abs(sg - sc), float(np.abs(bg - bc).max()),
                                     float(np.abs(fg - fc).max())]
            entry["box_cuda"] = [float(v) for v in bg]
            if not (entry["max_abs_diff"][0] <= 1e-5 and entry["max_abs_diff"][1] <= 1e-3
                    and entry["max_abs_diff"][2] <= 1e-3):
                problems.append(f"detect {name}: score, box, face diff {entry['max_abs_diff']}")
        detect[name] = entry
    face_crop = np.ascontiguousarray(host_crops["photo_face"])
    aligners["cuda"].detect(face_crop)
    detect_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        aligners["cuda"].detect(face_crop)
        detect_ms.append((time.perf_counter() - t0) * 1e3)
    detect_prof = _profiled(lambda: aligners["cuda"].detect(face_crop))

    # 3. from_weights: facenet's three files, then one prefixed file
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mtcnn_") as d:
        for net, sd in sds.items():
            torch.save(sd, os.path.join(d, f"{net}.pt"))
        torch.save({f"{net}.{k}": v for net, sd in sds.items() for k, v in sd.items()},
                   os.path.join(d, "bundle.pt"))
        loaded = {"directory": M.MTCNNAligner.from_weights(d, device="cuda"),
                  "file": M.MTCNNAligner.from_weights(os.path.join(d, "bundle.pt"),
                                                      device="cuda")}
    want = aligners["cuda"].detect(face_crop)
    for how, al in loaded.items():
        got = al.detect(face_crop)
        same_weights = all(torch.equal(al.nets[n].state_dict()[k].cpu(), v)
                           for n, sd in sds.items() for k, v in sd.items())
        if not same_weights or got[1] != want[1]:
            problems.append(f"from_weights ({how}): weights equal {same_weights}, "
                            f"score {got[1]} against {want[1]}")
    if problems:
        raise AssertionError("; ".join(problems[:6]))

    # 4. serving: the cascade in the device-detect tick beside the tick
    # without it, and the host-prep aligner beside the resize aligner
    detect_serve = {"without_mtcnn": _detect_serve(ctx),
                    "with_mtcnn": _detect_serve(ctx, aligners["cuda"])}
    served = {name: frames[name] for name in (HAAR_PHOTO, "frame_640x480_q85_420.jpg",
                                              "frame_720x405_q85_420.jpg")}
    host_prep = {"resize_aligner": _haar_serve(ctx, "auto", served),
                 "mtcnn_aligner": _haar_serve(ctx, "auto", served, aligners["cuda"])}
    # the aligner returned on every served frame that has a face (an
    # exception would answer forensic-only and go unrecorded), and answered
    # a face exactly where the CPU aligner accepts the crop it was handed
    run = host_prep["mtcnn_aligner"]
    want_calls = sum(n for name, n in run["served_by_frame"].items()
                     if expected[name]["boxes"])
    want_faces = sum(n for crop, n in run.pop("align_crops")
                     if aligners["cpu"].detect(crop)[0] is not None)
    if run["aligned_face_frames"] != want_calls or run["frames_answered_with_face"] != want_faces:
        raise AssertionError(
            f"host-prep serving with the MTCNN aligner: {run['aligned_face_frames']} aligner "
            f"returns for {want_calls} served frames with a face, "
            f"{run['frames_answered_with_face']} answered with a face where the CPU aligner "
            f"accepts {want_faces}")
    run["expected_aligner_returns"], run["expected_answered_with_face"] = want_calls, want_faces
    pick = ("frames_per_s", "request_ms_p50", "request_ms_p99", "median_tick_ms",
            "frames_with_face", "frames_with_ssd_face", "launches", "preprocess_entry_launches")
    return {"card": ctx["smi"],
            "weights": "init_random_mtcnn(5) draws, class heads -3/+3",
            "pnet_top64_exact_ties_mean_max": {"bias_3": ties3, "bias_5": ties5},
            "align_batch": {"crops": 64, "caps": [64, 16, 8],
                            "rows_passing": int((out["cuda"][1] > 0).sum()),
                            "max_abs_diff_score_box_face": batch_diff,
                            "ms_event_median": batch_ms, "profile": batch_prof},
            "detect": detect,
            "detect_ms_photo_face_median": statistics.median(detect_ms),
            "detect_profile_photo_face": detect_prof,
            "from_weights": sorted(loaded),
            "detect_serve": {k: {kk: v[kk] for kk in pick} for k, v in detect_serve.items()},
            "host_prep_serving": {k: {kk: v[kk] for kk in (
                "frames_per_s", "median_tick_ms", "detect_ms_per_frame_median", "aligner",
                "aligned_face_frames", "align_ms_per_face_frame_median",
                "frames_answered_with_face", "launches")} for k, v in host_prep.items()},
            "host_prep_mtcnn_expected": {k: host_prep["mtcnn_aligner"][k] for k in (
                "expected_aligner_returns", "expected_answered_with_face")}}


# ------------------------------------------------------------------ bench

def _float_tol(a) -> float:
    """GPU-against-CPU tolerance of a float tensor: 1e-4 of its largest
    magnitude, at least 1e-4."""
    return 1e-4 * max(1.0, float(a.abs().max()) if a.numel() else 0.0)


def _clip_models(ctx, name, cfg, dev, head_state=None):
    """{"backbone", "clip_head"} on `dev`: backbone_state's parameters and a
    temporal head drawn from SEED + 1, as the engine draws it, or loaded
    from `head_state`."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.temporal_head import TemporalHead
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import clip_head_spec
    model = backbones.build_model(backbones.make(name)).eval()
    model.load_state_dict(backbone_state(ctx, name))
    head = TemporalHead(clip_head_spec(cfg), torch.Generator().manual_seed(SEED + 1)).eval()
    if head_state is not None:
        head.load_state_dict(head_state)
    return {"backbone": model.to(dev), "clip_head": head.to(dev)}


def _decisive_clip_head(ctx, name, b=16, history=12, spread=6.0):
    """The seeded head (SEED + 1) scores every stream of the synthetic
    frames 0.04-0.09, far below the 0.55 threshold, so its verdict is
    always REAL. Here its output layer is rescaled from one run of the
    tick parity's ticks on the card: the decided streams' clip logits are
    stretched to `spread` logits, and the threshold is put in the middle of
    the widest gap between them that leaves at least a quarter of the
    streams on each side. Returns (the head's state dict on the CPU, what
    was measured)."""
    import math
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)

    key = ("decisive_clip_head", name)
    if key in ctx:
        return ctx[key]
    cfg = _clip_cfg(name)
    proto, cm = _ssd_files(ctx)
    net = CaffeNet(proto, cm).cuda().eval()
    models = _clip_models(ctx, name, cfg, "cuda")
    head = models["clip_head"]
    if bool(head.head.b.detach().any()):
        raise AssertionError("the seeded clip head's output bias is not zero")
    step = make_device_step_detect(net, models, cfg)
    states = init_stream_states(b + 1, cfg, "cuda")
    _, frames = _capture_frames(b, history + 1, net)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    slot_idx = torch.arange(b, dtype=torch.int32, device="cuda")
    for t in range(history + 1):
        x = torch.from_numpy(np.stack([frames[s][t] for s in range(b)])).cuda()
        out, states = step(x, active, slot_idx, states)
    p = out["clip_probability"].double().cpu()
    z = (torch.log(p) - torch.log1p(-p))[out["clip_frames"].cpu() >= cfg.clip_min_frames]
    z = sorted(z.tolist())
    if len(z) < 4:
        raise AssertionError(f"{name}: {len(z)} decided streams, want 4 to calibrate on")
    lo, hi = len(z) // 4, len(z) - len(z) // 4
    i = max(range(lo - 1, hi), key=lambda j: z[j + 1] - z[j])
    cut, scale = (z[i] + z[i + 1]) / 2, spread / (z[-1] - z[0])
    thr = cfg.detection_threshold
    with torch.no_grad():
        head.head.w.mul_(scale)
        head.head.b.fill_(math.log(thr / (1 - thr)) - scale * cut)
    state = {k: v.detach().cpu().clone() for k, v in head.state_dict().items()}
    ctx[key] = state, {"seeded_logits": [z[0], z[-1]], "scale": scale,
                       "margin_logit": scale * (z[i + 1] - z[i]) / 2,
                       "fake_streams_expected": len(z) - i - 1, "decided": len(z)}
    return ctx[key]


def _clip_cfg(name):
    """detect-parity's config in clip mode: the window of 64 frames (~2 s at
    30 fps), the head's feature width from the backbone."""
    import dataclasses
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    return dataclasses.replace(_detect_cfg(), clip_window=64,
                               clip_feature_dim=backbones.feature_dim(backbones.make(name)))


def _clip_backbone_parity(ctx, name):
    """(a) `name` at full width on the card against the CPU at
    (16, 224, 224, 3): pooled features and logits; then one bucket-64
    forward's device ms, activities and FLOPs (torch.utils.flop_counter,
    from the shapes)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    models = {}
    for dev in ("cpu", "cuda"):
        m = backbones.build_model(backbones.make(name)).eval()
        m.load_state_dict(backbone_state(ctx, name))
        models[dev] = m.to(dev)
    x = torch.randn((16, 224, 224, 3), generator=torch.Generator().manual_seed(SEED + 7))
    errs = {}
    with torch.no_grad():
        fc = models["cpu"].extract_features(x)
        fg = models["cuda"].extract_features(x.cuda())
        for k, a, g in (("features", fc, fg), ("logits", models["cpu"].apply_head(fc),
                                               models["cuda"].apply_head(fg))):
            err, tol = float((a - g.cpu()).abs().max()), _float_tol(a)
            if not err <= tol:
                raise AssertionError(f"{name} {k}: max abs diff {err} > {tol}")
            errs[k] = {"max_abs_err": err, "tolerance": tol, "max_abs": float(a.abs().max())}
        if not float(fc.std(0).max()) > 1e-3:
            raise AssertionError(f"{name}: every input gives the same features")
        x64 = torch.randn((64, 224, 224, 3), generator=torch.Generator().manual_seed(SEED + 8),
                          device="cpu").cuda()
        fwd = functools.partial(models["cuda"], x64)
        with FlopCounterMode(display=False) as counter:
            fwd()
        ms = time_cuda(fwd, n=20)
        wall, busy, acts, top = profile_device(fwd, 5)
    flops = float(counter.get_total_flops())
    return {"compared_at": list(x.shape), **errs,
            "params": sum(p.numel() for p in models["cpu"].parameters()),
            "bucket64_event_ms": ms, "bucket64_device_busy_ms": busy,
            "bucket64_device_activities": acts, "bucket64_gflop": flops / 1e9,
            "bucket64_f32_bound_ms": flops / ctx["peaks"][2] * 1e3,
            "top": top[:4]}


def _clip_tick_parity(ctx, name, b=16, history=12):
    """(b) The config-5 detect tick (clahe_device, the synthetic SSD,
    `name`, clip_window 64) at bucket b on the card and on the CPU, tick
    by tick over `history` ticks and one more: every output and state leaf,
    floats within _float_tol, integers and flags exactly."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves

    from real_time_video_deepfake_detection_tpu_torch.state import VERDICT_FAKE, VERDICT_REAL

    cfg = _clip_cfg(name)
    head_state, calibration = _decisive_clip_head(ctx, name, b, history)
    proto, cm = _ssd_files(ctx)
    nets, steps, states = {}, {}, {}
    for dev in ("cpu", "cuda"):
        nets[dev] = CaffeNet(proto, cm).to(dev).eval()
        steps[dev] = make_device_step_detect(
            nets[dev], _clip_models(ctx, name, cfg, dev, head_state), cfg)
        states[dev] = init_stream_states(b + 1, cfg, dev)
    seed, frames = _capture_frames(b, history + 1, nets["cuda"])
    active = torch.ones(b, dtype=torch.bool)
    slot_idx = torch.arange(b, dtype=torch.int32)
    max_diff = 0.0
    for t in range(history + 1):
        x = torch.from_numpy(np.stack([frames[s][t] for s in range(b)]))
        out_c, states["cpu"] = steps["cpu"](x, active, slot_idx, states["cpu"])
        out_g, states["cuda"] = steps["cuda"](x.cuda(), active.cuda(), slot_idx.cuda(),
                                              states["cuda"])
        pairs = [(k, out_c[k], out_g[k].cpu()) for k in out_c]
        pairs += [(f"state{i}", a, g.cpu()) for i, (a, g) in
                  enumerate(zip(tree_leaves(states["cpu"]), tree_leaves(states["cuda"])))]
        for k, a, g in pairs:
            if a.dtype.is_floating_point:
                d, tol = (float((a - g).abs().max()), _float_tol(a)) if a.numel() else (0.0, 0.0)
                max_diff = max(max_diff, d)
                if not d <= tol:
                    raise AssertionError(f"{name} tick {t} {k}: max abs diff {d} > {tol}")
            elif not torch.equal(a, g):
                raise AssertionError(f"{name} tick {t} {k}: {int((a != g).sum())} differ")
    n = out_c["clip_frames"]
    decided = int((n >= cfg.clip_min_frames).sum())
    if not decided or int(n.max()) >= cfg.clip_window:
        raise AssertionError(f"{name}: clip frames {n.tolist()}: want some streams past "
                             f"{cfg.clip_min_frames} and the rings partly full")
    verdicts = set(out_c["verdict"][n >= cfg.clip_min_frames].tolist())
    if verdicts != {VERDICT_REAL, VERDICT_FAKE}:
        raise AssertionError(f"{name}: decided verdicts {sorted(verdicts)}, want REAL and FAKE")
    return {"bucket": b, "ticks": history + 1, "frame_seed": seed, "max_float_diff": max_diff,
            "head_calibration": calibration,
            "fake_streams": int((out_c["verdict"] == VERDICT_FAKE).sum()),
            "clip_frames": n.tolist(), "streams_decided": decided,
            "verdicts": out_c["verdict"].tolist(),
            "clip_probability": [round(float(v), 6) for v in out_c["clip_probability"]]}


def _clip_tick_timing(ctx, b=64):
    """The bucket-64 config-5 tick (vit_b16, clip_window 64) on the card,
    in turns with the B0 detect tick of detect-parity on the same frames:
    median wall ms of 10 and a profiler window over 5 of each."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)

    proto, cm = _ssd_files(ctx)
    net = CaffeNet(proto, cm).cuda().eval()
    b0 = backbones.build_model(backbones.make("b0")).eval()
    b0.load_state_dict(backbone_state(ctx))
    ticks = {}
    cfg5 = _clip_cfg("vit_b16")
    head_state = _decisive_clip_head(ctx, "vit_b16")[0]
    for label, cfg, model in (("config5_vit_b16_clip64", cfg5,
                               _clip_models(ctx, "vit_b16", cfg5, "cuda", head_state)),
                              ("b0_detect", _detect_cfg(), b0.cuda())):
        step = make_device_step_detect(net, model, cfg)
        st = init_stream_states(b + 1, cfg, "cuda")
        ticks[label] = (step, st)
    rng = np.random.default_rng(SEED + 5)
    frames = torch.from_numpy(np.stack([_synthetic_frame(rng, i % 2 == 0, i % 12)
                                        for i in range(b)])).cuda()
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    slot_idx = torch.arange(b, dtype=torch.int32, device="cuda")
    out = {}
    for label in list(ticks) * 2:
        step, st = ticks[label]
        tick = functools.partial(step, frames, active, slot_idx, st)
        for _ in range(2):
            tick()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            tick()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        wall, busy, acts, top = profile_device(tick, 5)
        out.setdefault(label, []).append({
            "median_tick_ms": statistics.median(times), "wall_ms": wall,
            "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall,
            "device_activities": acts, "top": top[:5]})
    return out


def phase_clip(ctx):
    """BASELINE config 5: the ViT-B/16 and Xception backbones and the
    clip-attention head in the serving tick."""
    info = {name: _clip_backbone_parity(ctx, name) for name in ("vit_b16", "xception")}
    info["tick_vit_b16"] = _clip_tick_parity(ctx, "vit_b16")
    info["tick_xception"] = _clip_tick_parity(ctx, "xception")
    info["tick_bucket64"] = _clip_tick_timing(ctx)
    info["serve"] = _detect_serve(ctx, backbone="vit_b16", clip_window=64,
                                  clip_head_params=_decisive_clip_head(ctx, "vit_b16")[0])
    return info


# ----------------------------------------------------------------- train

TRAIN_FIXTURES = ("frame_640x480_q85_420.jpg", "frame_720x405_q85_420.jpg",
                  "q50_640x480_420.jpg", "q50_720x405_420.jpg", "q95_640x480_420.jpg",
                  "q95_720x405_420.jpg")
LOADER_BATCHES = 24   # of 32 images, in each epoch that (c) times


def _decoded_rgb(name):
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    with open(os.path.join(JPEG_DIR, name), "rb") as f:
        return decode_jpeg(f.read())[..., ::-1].copy()


def _train_crops(n: int, side: int, seed: int):
    """(n, side, side, 3) RGB u8 crops of the decoded 480x640 fixtures at
    seeded offsets: the loader's canvases."""
    import numpy as np
    frames = [_decoded_rgb(x) for x in TRAIN_FIXTURES if "640x480" in x]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = frames[i % len(frames)]
        y, x = rng.integers(0, f.shape[0] - side), rng.integers(0, f.shape[1] - side)
        out.append(f[y:y + side, x:x + side])
    return np.ascontiguousarray(np.stack(out))


def _train_dataset(root: str, per_class: int, val_per_class: int) -> str:
    """train/{real,fake} and val/{real,fake} of copies of the baseline
    fixtures, per_class (val_per_class) files each."""
    for split, n in (("train", per_class), ("val", val_per_class)):
        for c, label in enumerate(("real", "fake")):
            d = os.path.join(root, split, label)
            os.makedirs(d)
            for i in range(n):
                name = TRAIN_FIXTURES[(i + c) % len(TRAIN_FIXTURES)]
                shutil.copy(os.path.join(JPEG_DIR, name), os.path.join(d, f"{i:03d}_{name}"))
    return root


def _train_card_vs_cpu(ctx):
    """(a) Three fused steps on the card and on the CPU, same draws."""
    import copy
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
    from real_time_video_deepfake_detection_tpu_torch.models.efficientnet import (
        EfficientNet, EfficientNetSpec)
    from real_time_video_deepfake_detection_tpu_torch.train import steps
    b0 = EfficientNetSpec.make("b0")
    spec = dataclasses.replace(b0, blocks=b0.blocks[:4], resolution=64)
    cfg = TrainConfig(image_size=64, batch_size=8, head_dropout=0.0, lr=1e-3)
    model = EfficientNet(spec, generator=torch.Generator().manual_seed(SEED))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    states = {dev: steps.init_train_state(copy.deepcopy(model).to(dev), spec, cfg, 10, SEED)
              for dev in ("cpu", "cuda")}
    imgs = torch.from_numpy(_train_crops(8, 84, SEED))
    labels = torch.tensor([0.0, 1.0] * 4)
    draws = [steps.draw_step(states["cpu"], 8, 84) for _ in range(3)]
    losses, null = {"cpu": [], "cuda": []}, set()
    for k in range(3):
        for dev, st in states.items():
            m = steps.fused_train_step(st, imgs.to(dev), labels.to(dev),
                                       steps.draws_to(draws[k], dev))
            losses[dev].append(float(m["loss"]))
        if k == 0:
            null = {n for n, p in states["cpu"].model.named_parameters()
                    if p.grad is not None and float(p.grad.norm()) < 1e-6}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    if loss_rel > 1e-4:
        raise AssertionError(f"train (a): losses card {losses['cuda']} CPU {losses['cpu']}")
    lr_sum = sum(states["cpu"].sched(i) for i in range(3))
    card = {k: v.cpu() for k, v in states["cuda"].model.state_dict().items()}
    cpu = states["cpu"].model.state_dict()
    frozen = {n for n, p in states["cpu"].model.named_parameters() if not p.requires_grad}
    worst_delta, worst_stat, worst_fed, worst_key = 0.0, 0.0, 0.0, None
    for k, v in cpu.items():
        if k.endswith(".mean") or k.endswith(".var"):
            diff = float((card[k] - v).abs().max())
            # the head's batch means follow the noise-driven fc biases
            # (momentum 0.1): held to 0.3 of the Adam steps' sum instead
            if k.startswith("fc.bn") and k.endswith(".mean") and \
                    k.replace("bn", "fc").replace(".mean", ".b") in null:
                if diff > 0.3 * lr_sum:
                    raise AssertionError(f"train (a): {k} differs by {diff}")
                worst_fed = max(worst_fed, diff)
            elif diff > worst_stat:
                worst_stat, worst_key = diff, k
        elif k in frozen:
            if not (torch.equal(card[k], init[k]) and torch.equal(v, init[k])):
                raise AssertionError(f"train (a): frozen leaf {k} moved")
        elif k in null:
            if max(float((card[k] - init[k]).abs().max()),
                   float((v - init[k]).abs().max())) > 1.5 * lr_sum:
                raise AssertionError(f"train (a): {k} moved past its Adam bound")
        else:
            d_cpu, d_card = v - init[k], card[k] - init[k]
            rel = float((d_card - d_cpu).norm() / d_cpu.norm().clamp_min(1e-30))
            worst_delta = max(worst_delta, rel)
    if worst_delta > 1e-3 or worst_stat > 1e-5:
        raise AssertionError(f"train (a): weight delta {worst_delta}, statistics "
                             f"{worst_stat} ({worst_key})")
    return {"losses_card": losses["cuda"], "losses_cpu": losses["cpu"],
            "loss_max_rel_diff": loss_rel, "weight_delta_max_rel": worst_delta,
            "stat_max_abs_diff": worst_stat, "stat_worst": worst_key,
            "noise_fed_mean_max_abs_diff": worst_fed, "frozen_leaves": len(frozen),
            "noise_gradient_leaves": sorted(null), "count": states["cuda"].count}


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, *args, out_shape=None, **kw):
    """FLOPs of aten.convolution_backward with the groups counted: each of
    grad_input and grad_weight costs the forward's 2 * out * (in / groups)
    * kh * kw. torch.utils.flop_counter's own formula drops the groups, so
    it counts a depthwise backward as a dense one (x C)."""
    import math
    transposed, output_mask = args[4], args[7]
    fwd = 2 * math.prod(x_shape if transposed else grad_out_shape) * math.prod(w_shape[1:])
    return fwd * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def _train_full(ctx, bf16: bool, imgs, labels):
    """(b) Full-size B0, 224, batch 32: the step's times and FLOPs."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from real_time_video_deepfake_detection_tpu_torch.cli.bench import _bf16_peak_tflops
    from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.train import augment, steps
    spec = backbones.make("b0")
    cfg = TrainConfig(bf16_compute=bf16)
    model = backbones.build_model(spec, torch.Generator().manual_seed(SEED)).cuda()
    state = steps.init_train_state(model, spec, cfg, total_steps=1000, seed=SEED)
    torch.cuda.reset_peak_memory_stats()

    def step():
        return steps.fused_train_step(state, imgs, labels)

    for _ in range(5):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        m = step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"train (b): loss {float(m['loss'])}")
    wall, busy, acts, top = profile_device(step, 5)
    # the split: each part alone, timed with CUDA events
    parts = {}

    def aug():
        d = steps.draw_step(state, 32, 244)
        x = augment.apply_augment(imgs, d["augment"], 224)
        parts["x"], parts["d"] = augment.apply_mixup(x, labels, d["mixup"])[0], d

    def fwd_bwd():
        logits, stats = steps.forward_mixed(model, parts["x"], bf16, parts["d"]["masks"])
        loss = steps._focal(cfg, logits[:, 0], labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        parts["stats"] = stats

    def update():
        steps.apply_update(state, parts["stats"])

    split = {"augment_ms": time_cuda(aug, n=10, warmup=2),
             "forward_backward_ms": time_cuda(fwd_bwd, n=10, warmup=2),
             "update_ms": time_cuda(update, n=10, warmup=2)}
    with FlopCounterMode(display=False) as fc:
        step()
    flops_torch = fc.get_total_flops()
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: _conv_backward_flop}) as fc:
        step()
    flops = fc.get_total_flops()
    peak_bf16 = _bf16_peak_tflops(ctx["name"]) * 1e12
    med = statistics.median(walls)
    return {"precision": "bf16" if bf16 else "fp32", "step_wall_ms_median": med,
            "step_wall_ms_min": min(walls), "profiled_wall_ms": wall, "busy_ms": busy,
            "activities_per_step": acts,
            "idle_share": None if busy is None else max(0.0, 1.0 - busy / wall),
            "top_device": top[:5], **split, "images_per_s": 32 / (med / 1e3),
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "gflop_per_step": flops / 1e9, "gflop_per_step_flop_counter": flops_torch / 1e9,
            "bound_ms_fp32": flops / ctx["peaks"][2] * 1e3,
            "bound_ms_bf16": flops / peak_bf16 * 1e3 if peak_bf16 > 0 else None,
            "loss": float(m["loss"]), "count": state.count}


def _train_other_backbones(imgs, labels):
    """(b) One step each of vit_b16 and xception at batch 32."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.train import steps
    out = {}
    for name in ("vit_b16", "xception"):
        spec = backbones.make(name)
        model = backbones.build_model(spec, torch.Generator().manual_seed(SEED)).cuda()
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        state = steps.init_train_state(model, spec, TrainConfig(), total_steps=100, seed=SEED)
        t0 = time.perf_counter()
        m = steps.fused_train_step(state, imgs, labels)
        torch.cuda.synchronize()
        moved = sum(1 for k, p in model.named_parameters()
                    if p.requires_grad and not torch.equal(p, before[k]))
        if not bool(torch.isfinite(m["loss"])) or moved == 0 or state.count != 1:
            raise AssertionError(f"train (b) {name}: loss {float(m['loss'])}, {moved} moved")
        out[name] = {"loss": float(m["loss"]), "leaves_moved": moved,
                     "first_step_s": time.perf_counter() - t0}
        del model, state
    return out


def _train_loader(root: str):
    """(c) BatchLoader images/s over copies of the 480x640 and 720x405
    fixtures at the trainer's canvas (244): reconstructing on the card (the
    trainer's loader) and on the host CPU; the two give the same bytes.
    A first batch on each device builds the entropy decoder; then whole
    epochs are timed from iter() to the last batch, as the trainer meets
    them (3 on the card, 1 on the host), each of LOADER_BATCHES batches."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.train.data import (
        BatchLoader, DeepfakeDataset)
    ds = DeepfakeDataset(root, "train", 224)
    out, first = {}, {}
    for dev, epochs in (("cuda", 3), ("cpu", 1)):
        loader = BatchLoader(ds, 32, shuffle=True, seed=SEED, balanced=True, num_workers=8,
                             device=dev)
        it = iter(loader)
        first[dev] = next(it)[0].cpu()
        it.close()
        rates, n = [], 0
        for _ in range(epochs):
            t0 = time.perf_counter()
            n = sum(len(imgs) for imgs, _ in loader)
            torch.cuda.synchronize()
            rates.append(n / (time.perf_counter() - t0))
        out[dev] = {"images_per_epoch": n, "epochs": epochs, "images_per_s": rates,
                    "images_per_s_median": statistics.median(rates)}
    if not torch.equal(first["cuda"], first["cpu"]):
        raise AssertionError("train (c): the card's batch differs from the host's")
    return {"card": out["cuda"], "host": out["cpu"], "workers": 8,
            "batches_per_epoch": len(ds) // 32, "card_equals_host": True}


def _train_end_to_end(ctx, root: str):
    """(d) trainer.main for 2 epochs, a resumed third with the calibrator,
    then the batched app serving best_model.pt, and a clip head."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.temporal_head import (
        TemporalHeadSpec)
    from real_time_video_deepfake_detection_tpu_torch.pipeline.classify import (
        preprocess_aligned)
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import (
        preprocess_face_quality)
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
        MultiStreamEngine, create_batched_app)
    from real_time_video_deepfake_detection_tpu_torch.serving.server import _load_clip_head
    from real_time_video_deepfake_detection_tpu_torch.train import clip_head, trainer
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    from real_time_video_deepfake_detection_tpu_torch.utils.weights import load_params_and_meta
    ds = _train_dataset(os.path.join(root, "ds"), 16, 8)
    out = os.path.join(root, "out")
    argv = ["--dataset", ds, "--output-dir", out, "--batch-size", "8", "--num-workers", "8"]
    t0 = time.perf_counter()
    r2 = trainer.main(argv + ["--epochs", "2"])
    t2 = time.perf_counter()
    r3 = trainer.main(argv + ["--epochs", "3", "--fit-calibrator"])
    t3 = time.perf_counter()
    files = sorted(os.listdir(out))
    if files != ["best_model.pt", "calibrator.pkl", "resume_checkpoint.pt",
                 "training_log.json"] or [e["epoch"] for e in r3["log"]] != [0, 1, 2]:
        raise AssertionError(f"train (d): files {files}, log {r3['log']}")
    if r3["state"].step != 3 * r2["state"].step // 2:
        raise AssertionError("train (d): the third epoch did not resume the step count")

    spec = backbones.make("b0")
    weights = os.path.join(out, "best_model.pt")
    params, meta = load_params_and_meta(weights, spec)
    ema = backbones.build_model(spec).cuda().eval()
    ema.load_state_dict(params)
    cfg = DetectorConfig(use_pallas_preproc=True, use_pallas_color=True,
                         face_backend="haar_native")
    scfg = ServerConfig(max_streams=8, max_batch=8)
    engine = MultiStreamEngine(cfg, scfg, params=params, device="cuda")
    names = [os.path.join(HAAR_DIR, HAAR_PHOTO)] + [os.path.join(JPEG_DIR, x)
                                                      for x in TRAIN_FIXTURES[:2]]
    compared, worst = 0, 0.0
    opener = _client()
    try:
        with _serving(create_batched_app(engine, scfg)) as url:
            for i, path in enumerate(names * 2):
                with open(path, "rb") as f:
                    data = f.read()
                status, body, _ = _http(opener, url + "/analyze", data, sid=f"s{i % 3}")
                if status != 200:
                    raise AssertionError(f"train (d): status {status} {body}")
                if "face_probability" not in body:
                    continue
                frame = decode_jpeg(data)
                x, y, fw, fh = engine.face_detector(frame)[0]
                face = engine.aligner(preprocess_face_quality(frame[y:y + fh, x:x + fw]))
                with torch.no_grad():
                    xin = preprocess_aligned(torch.from_numpy(face)[None].cuda().float())
                    direct = float(torch.sigmoid(ema(xin))[0, 0])
                worst = max(worst, abs(direct - body["face_probability"]))
                compared += 1
    finally:
        engine.shutdown()
    if compared == 0 or worst > 1e-5:
        raise AssertionError(f"train (d): {compared} faces, max diff {worst}")

    # a clip head trained on the EMA backbone's features, saved, served
    rng = np.random.default_rng(SEED)
    clips = torch.from_numpy(rng.integers(0, 256, (8, 8, 160, 160, 3), dtype=np.uint8))
    feats = clip_head.extract_clip_features(ema, clips)
    labels = torch.tensor([0.0, 1.0] * 4, device=feats.device)
    head, log = clip_head.train_clip_head(feats, labels, TemporalHeadSpec(
        feature_dim=1280, window=8), epochs=5)
    head_path = os.path.join(root, "clip_head.pt")
    clip_head.save_head(head, head_path, log)
    ccfg = dataclasses.replace(cfg, clip_window=8)
    head_sd = _load_clip_head(head_path, ccfg, spec)
    engine = MultiStreamEngine(ccfg, scfg, params=params, device="cuda",
                               clip_head_params=head_sd)
    clip_frames = []
    try:
        if not all(torch.equal(v.cpu(), head.state_dict()[k].cpu())
                   for k, v in engine.tick_model["clip_head"].state_dict().items()):
            raise AssertionError("train (d): the engine's clip head is not the saved one")
        with _serving(create_batched_app(engine, scfg)) as url:
            with open(names[0], "rb") as f:
                data = f.read()
            for _ in range(3):
                status, body, _ = _http(opener, url + "/analyze", data, sid="clip")
                if status != 200 or "clip_frames" not in body:
                    raise AssertionError(f"train (d): clip response {status} {body}")
                clip_frames.append(body["clip_frames"])
    finally:
        engine.shutdown()
    return {"epochs_2_s": t2 - t0, "resume_epoch_s": t3 - t2, "files": files,
            "best": r3["best"], "best_meta": meta, "faces_compared": compared,
            "face_probability_max_abs_diff": worst, "clip_head_loss": [e["loss"] for e in log],
            "clip_frames": clip_frames}


def phase_train(ctx):
    """The trainer on the card: (a) card against CPU, (b) the full-size step
    in fp32 and bf16 and one step of the config-5 backbones, (c) the
    loader, (d) main end to end and serving its files."""
    import torch
    os.environ["HAARCASCADE_DIR"] = HAAR_DIR
    info = {"card_vs_cpu": _train_card_vs_cpu(ctx)}
    imgs = torch.from_numpy(_train_crops(32, 244, SEED + 1)).cuda()
    labels = torch.tensor([0.0, 1.0] * 16, device="cuda")
    info["b0_fp32"] = _train_full(ctx, False, imgs, labels)
    info["b0_bf16"] = _train_full(ctx, True, imgs, labels)
    info["other_backbones"] = _train_other_backbones(imgs, labels)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        info["loader"] = _train_loader(_train_dataset(os.path.join(root, "loader"),
                                                      16 * LOADER_BATCHES, 0))
        info["loader"]["step_images_per_s_fp32"] = info["b0_fp32"]["images_per_s"]
        info["end_to_end"] = _train_end_to_end(ctx, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return info


def _prep_python_route(jpeg: bytes):
    """The host prep that the one-call route replaces: decode_jpeg ->
    resize_analysis -> detect_heuristic -> preprocess_face_quality with the
    native Lab rung -> the resize aligner; (frame, aligned u8 or None, box
    or None), None when the decoder refuses the stream."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.models.heuristic_face import (
        detect_heuristic)
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import (
        _ResizeAligner, preprocess_face_quality)
    from real_time_video_deepfake_detection_tpu_torch.utils.host_resize import resize_analysis
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    frame = decode_jpeg(jpeg)
    if frame is None:
        return None
    small = resize_analysis(frame, 256, 256)
    faces = detect_heuristic(frame)
    if not faces:
        return small, None, None
    x, y, w, h = faces[0]
    crop = preprocess_face_quality(frame[y:y + h, x:x + w], lab_backend="native")
    return small, _ResizeAligner()(crop).astype(np.uint8), tuple(faces[0])


def _one_call_prep(jpegs):
    """(a) utils/native_prep.prep_frame on every committed fixture against
    the Python route, byte for byte; host ms of each on one thread."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils.native_prep import prep_frame
    faces, refused, aligned = 0, [], []
    for name, jpeg in sorted(jpegs.items()):
        got, want = prep_frame(jpeg, (256, 256), 160), _prep_python_route(jpeg)
        if want is None or got is None:
            if not (want is None and got is None):
                raise AssertionError(f"{name}: one route refused the stream, the other not")
            refused.append(name)
            continue
        same = (np.array_equal(got[0], want[0]) and got[2] == want[2]
                and (got[1] is None if want[1] is None else np.array_equal(got[1], want[1])))
        if not same:
            raise AssertionError(f"{name}: the one-call prep differs from the Python route")
        if got[1] is not None:
            faces += 1
            aligned.append(got[1])
    if faces < 8:
        raise AssertionError(f"only {faces} fixtures hold a face")
    jpeg = jpegs["frame_720x405_q85_420.jpg"]
    times = {"one_call": [], "python_route": []}
    for _ in range(15):
        for k, fn in (("one_call", lambda: prep_frame(jpeg, (256, 256), 160)),
                      ("python_route", lambda: _prep_python_route(jpeg))):
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return ({"fixtures_equal": len(jpegs) - len(refused), "faces": faces, "refused": refused,
             "host_ms_720x405": {k: statistics.median(v) for k, v in times.items()}},
            np.stack(aligned[:8]))


def _detector_gradcam(ctx, aligned):
    """(b) GradCAM of full-size B0 on 8 aligned faces, card against CPU."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.gradcam import gradcam
    from real_time_video_deepfake_detection_tpu_torch.pipeline.classify import preprocess_aligned
    models = {}
    for dev in ("cpu", "cuda"):
        m = backbones.build_model(backbones.make("b0")).eval()
        m.load_state_dict(backbone_state(ctx, "b0"))
        models[dev] = m.to(dev)
    x = preprocess_aligned(torch.from_numpy(aligned).to(torch.float32), 224)
    xg = x.cuda()
    hc, hg = gradcam(models["cpu"], x), gradcam(models["cuda"], xg).cpu()
    err, tol = float((hc - hg).abs().max()), 1e-3
    if not err <= tol:
        raise AssertionError(f"gradcam: card against CPU {err} > {tol}")
    peaks = hc.amax(dim=(1, 2))
    if not (float(peaks.min()) > 0.5 and float(hc.amin()) >= 0.0 and float(peaks.max()) <= 1.0):
        raise AssertionError(f"gradcam: heatmaps not spread over [0, 1]: peaks {peaks.tolist()}")
    if any(p.grad is not None for p in models["cuda"].parameters()):
        raise AssertionError("gradcam left a gradient on the model")
    ms = time_cuda(lambda: gradcam(models["cuda"], xg), n=20)
    wall, busy, acts, _ = profile_device(lambda: gradcam(models["cuda"], xg), 5)
    return {"faces": list(x.shape), "max_abs_err": err, "tolerance": tol, "ms": ms,
            "device_busy_ms": busy, "device_activities": acts,
            "mean_heat": float(hc.mean())}


def _detector_tta(ctx, crops):
    """(c) DeepfakeDetector(use_tta, 4 augmentations) on the card against
    the CPU from the same seed: each face's averaged probability, then ms
    per face on the card with and without TTA."""
    from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
    dets = {dev: DeepfakeDetector(DetectorConfig(), params=backbone_state(ctx, "b0"),
                                  device=dev, use_tta=True, num_tta_augmentations=4, seed=SEED)
            for dev in ("cpu", "cuda")}
    errs, probs = [], []
    for crop in crops:
        pc, pg = (dets[d].analyze_face(crop)[0] for d in ("cpu", "cuda"))
        if pc is None or pg is None:
            raise AssertionError("TTA: a face gave no probability")
        errs.append(abs(pc - pg))
        probs.append(pc)
    tol = 1e-4
    if not max(errs) <= tol:
        raise AssertionError(f"TTA: card against CPU {max(errs)} > {tol}")
    if dets["cpu"]._tta_rng.random() != dets["cuda"]._tta_rng.random():
        raise AssertionError("TTA: the two detectors drew different augmentations")
    det = dets["cuda"]
    times = {"tta4": [], "single": []}
    for crop in crops * 3:
        for k, on in (("tta4", True), ("single", False)):
            det.use_tta = on
            t0 = time.perf_counter()
            det.analyze_face(crop)
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {"faces": len(crops), "max_abs_err": max(errs), "tolerance": tol,
            "probabilities": probs,
            "ms_per_face": {k: statistics.median(v) for k, v in times.items()}}


def _detector_freq(jpegs):
    """(d) compute_frequency_features of a fixture on the card against the
    CPU."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops.freq_features import (
        compute_frequency_features)
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    img = torch.from_numpy(decode_jpeg(jpegs["frame_720x405_q85_420.jpg"]))
    fc = compute_frequency_features(img)
    ig = img.cuda()
    fg = compute_frequency_features(ig).cpu()
    err, tol = float((fc - fg).abs().max()), 1e-4
    if not err <= tol or fc.shape != (2, 224, 224):
        raise AssertionError(f"frequency features: {tuple(fc.shape)}, card against CPU {err}")
    return {"max_abs_err": err, "tolerance": tol,
            "ms": time_cuda(lambda: compute_frequency_features(ig), n=20)}


def _host_prep_e2e(ctx, one_call: bool):
    """(e) cli/bench.bench_e2e in host-prep mode (the heuristic rung), 64
    clients x 5 frames: through the one-call prep, or with the engine's
    rule forced off, through decode -> analyze (the cv2 Lab rung). The
    kernels' counts are set to 0 just before and read just after."""
    from real_time_video_deepfake_detection_tpu_torch.cli import bench as B
    from real_time_video_deepfake_detection_tpu_torch.serving import multi
    calls, prep = [0], multi.prep_frame

    def counted(*a, **kw):
        calls[0] += 1
        return prep(*a, **kw)

    saved = multi.MultiStreamEngine._native_prep_eligible
    multi.prep_frame = counted
    if not one_call:
        multi.MultiStreamEngine._native_prep_eligible = lambda self: False
    _reset_launches()
    try:
        r = B.bench_e2e(n_streams=64, frames_per_stream=5, device_detect=False, device="cuda")
    finally:
        launches = _read_launches()
        multi.prep_frame = prep
        multi.MultiStreamEngine._native_prep_eligible = saved
    if r["device"] != ctx["name"]:
        raise AssertionError(f"bench_e2e ran on {r['device']}")
    # the warm-up stream's frames come through the same route
    want = r["requests"] + 5 if one_call else 0
    if calls[0] != want:
        raise AssertionError(f"one_call={one_call}: {calls[0]} one-call preps, want {want}")
    missing = [k for k in ("preprocess_faces", "unique_hue_count") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"host-prep e2e: kernels {missing} were not launched")
    return {k: r[k] for k in ("mode", "requests", "fps", "req_ms_p50", "req_ms_p95", "ticks",
                              "ewma_batch_size", "ewma_host_prep_ms")} | {
        "one_call_preps": calls[0], "launches": launches}


def phase_detector(ctx):
    """The detector's off-path features and the one-call host prep on the
    card: (a) the one-call prep against the Python route on every fixture;
    (b) GradCAM, (c) TTA and (d) the frequency maps, card against CPU at
    B0's full width; (e) host-prep serving end to end through the one-call
    prep and through decode -> analyze, in turns."""
    from real_time_video_deepfake_detection_tpu_torch.models.heuristic_face import (
        detect_heuristic)
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    jpegs, _ = _jpegs()
    prep, aligned = _one_call_prep(jpegs)
    crops = []
    for name in ("frame_720x405_q85_420.jpg", "frame_640x480_q85_420.jpg",
                 "s422_319x241_q85.jpg", "q50_720x405_420.jpg"):
        frame = decode_jpeg(jpegs[name])
        x, y, w, h = detect_heuristic(frame)[0]
        crops.append(frame[y:y + h, x:x + w].copy())
    out = {"card": ctx["smi"], "one_call_prep": prep,
           "gradcam": _detector_gradcam(ctx, aligned), "tta": _detector_tta(ctx, crops),
           "frequency_features": _detector_freq(jpegs)}
    out["host_prep_e2e"] = [dict(route="one_call" if on else "decode_then_analyze",
                                 **_host_prep_e2e(ctx, on)) for on in (True, False, True, False)]
    return out


def phase_bench(ctx):
    """The port's serving benchmark (cli/bench.py): its main with the timed
    windows cut to 4 (from 6-12), its one JSON line checked for the MTCNN
    core and the SSD-bf16 guard; each function's result on a line of its
    own; every kernel's launches over the whole phase, all four in every
    detect tick (the hue kernel in every tick that runs the full forensics)
    and the f32 preprocess entry in every MTCNN tick."""
    import io
    from contextlib import redirect_stdout
    from real_time_video_deepfake_detection_tpu_torch.cli import bench as B
    # each detect tick's launches, counted around the steps the bench builds
    # (host-side counters: no sync, the windows' timing is kept)
    detect_ticks, make_step = [], B.make_device_step_detect

    def counted_make(net, model, cfg, *rest):
        step = make_step(net, model, cfg, *rest)

        def counted(*a):
            before, e0 = _read_launches(), _read_entry_launches()
            out = step(*a)
            after, e1 = _read_launches(), _read_entry_launches()
            detect_ticks.append({"mtcnn": cfg.mtcnn_device,
                                 "fast": cfg.forensic_schedule == "tick_fast",
                                 "f32_entry": e1["preprocess_faces_f32"]
                                 - e0["preprocess_faces_f32"],
                                 **{k: after[k] - before[k] for k in after}})
            return out
        return counted

    names = ("bench_core", "bf16_parity_guard", "tick_schedule_guard", "detect_ssd_bf16_guard",
             "bench_core_detect", "bench_e2e", "bench_prep_scaling")
    originals = {name: getattr(B, name) for name in names}
    runs = []

    def recorded(name):
        def run(*args, **kw):
            if name in ("bench_core", "bench_core_detect"):
                kw["n_windows"] = min(kw.get("n_windows", 10), 4)
            t0 = time.time()
            r = originals[name](*args, **kw)
            runs.append({"bench": name, "seconds": round(time.time() - t0, 3),
                         "kwargs": {k: v for k, v in kw.items() if k != "device"}, **r})
            return r
        return run

    for name in names:
        setattr(B, name, recorded(name))
    B.make_device_step_detect = counted_make
    _reset_launches()
    out = io.StringIO()
    try:
        with redirect_stdout(out):
            rc = B.main(["--device", "cuda"])
    finally:
        B.make_device_step_detect = make_step
        for name, fn in originals.items():
            setattr(B, name, fn)
    for r in runs:
        emit(r)
    launches = _read_launches()
    lines = out.getvalue().splitlines()
    problems = [f"kernel {k} was not launched" for k, n in launches.items() if n <= 0]
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"bench main: rc {rc}, {len(lines)} lines on stdout")
    line = json.loads(lines[0])
    emit({"bench_main": line})
    if not {"metric", "value", "unit", "mtcnn_core", "ssd", "ssd_bf16_guard"} <= set(line):
        problems.append(f"bench main's line lacks keys: {sorted(line)}")
    # the fast ticks of the tick schedule skip the colour signal, and with it
    # the hue kernel
    per_tick_min = {k: min(t[k] for t in detect_ticks
                           if not (k == "unique_hue_count" and t["fast"])) for k in launches}
    if min(per_tick_min.values()) <= 0:
        problems.append(f"a detect tick of the bench missed a kernel: {per_tick_min}")
    mtcnn_ticks = [t for t in detect_ticks if t["mtcnn"]]
    if not mtcnn_ticks or min(t["f32_entry"] for t in mtcnn_ticks) <= 0:
        problems.append(f"{len(mtcnn_ticks)} MTCNN ticks, the f32 preprocess entry missing")
    by_name = {}
    for r in runs:
        by_name.setdefault(r["bench"], []).append(r)
    if not all(r["ok"] for r in by_name["tick_schedule_guard"]):
        problems.append("the tick schedule's outputs differ from the frame schedule's")
    if {r["device"] for r in runs} != {ctx["name"]}:
        problems.append(f"devices {sorted({r['device'] for r in runs})}")
    if problems:
        raise AssertionError("; ".join(problems))
    detect = by_name["bench_core_detect"]
    return {"launches": launches, "card": ctx["smi"],
            "detect_ticks_counted": len(detect_ticks), "mtcnn_ticks_counted": len(mtcnn_ticks),
            "fast_forensic_ticks_counted": sum(t["fast"] for t in detect_ticks),
            "launches_per_detect_tick_min": per_tick_min,
            "main": {k: line[k] for k in ("value", "ssd", "ssd_bf16_guard", "mtcnn_core")},
            "classify_core": [{k: r[k] for k in ("kwargs", "fps", "tick_ms_p50", "tick_ms_p95")}
                              for r in by_name["bench_core"]],
            "detect_core": [{k: r[k] for k in ("kwargs", "ssd", "mtcnn", "fps", "tick_ms_p50",
                                               "tick_ms_p95", "req_ms_p50",
                                               "gflop_per_tick_conv_matmul",
                                               "mfu_pct_bf16peak")} for r in detect],
            "ssd_bf16_guard": by_name["detect_ssd_bf16_guard"][0],
            "e2e": [{k: r[k] for k in ("mode", "fps", "req_ms_p50", "req_ms_p95")}
                    for r in by_name["bench_e2e"]]}


# ------------------------------------------------------------ sharded

SHARD_MESH = ("cuda:0", "cuda:0")   # two shards on the one card
DP_BATCH, DP_STEPS, DP_TIMED = 32, 2, 5


def _same_outputs(what, want, got, want_states, got_states, n, only_face=False):
    """The unsharded tick's outputs (and the first n rows of its states)
    against the sharded tick's, gathered: floats within _float_tol,
    integers, flags and verdicts exactly; face_probability on face rows
    alone when `only_face` (the cascade's rejects hold no face). Returns
    the largest float difference."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
    face = want["has_face"].cpu() if only_face else None
    pairs = [(k, want[k], got[k]) for k in want]
    pairs += [(f"state{i}", a[:n], g) for i, (a, g) in
              enumerate(zip(tree_leaves(want_states), tree_leaves(got_states)))]
    if set(want) != set(got):
        raise AssertionError(f"{what}: keys {sorted(want)} against {sorted(got)}")
    worst = 0.0
    for k, a, g in pairs:
        a, g = a.cpu(), g.cpu()
        if k == "face_probability" and face is not None:
            a, g = a[face], g[face]
        if a.dtype.is_floating_point:
            d = float((a - g).abs().max()) if a.numel() else 0.0
            worst = max(worst, d)
            if not d <= _float_tol(a):
                raise AssertionError(f"{what} {k}: max abs diff {d} > {_float_tol(a)}")
        elif not torch.equal(a, g):
            raise AssertionError(f"{what} {k}: {int((a != g).sum())} values differ")
    return worst


def _check_sharded_launches(what, launches, entries, ticks, f32_entry=False):
    """Each kernel launched once per shard and tick."""
    want = len(SHARD_MESH) * ticks
    got = dict(launches, **({"preprocess_faces_f32": entries["preprocess_faces_f32"]}
                            if f32_entry else {}))
    if any(v != want for v in got.values()):
        raise AssertionError(f"{what}: launches {got}, want {want} of each "
                             f"({len(SHARD_MESH)} shards x {ticks} ticks)")
    return got


def _in_turns(fns, n=10):
    """Event ms of each named fn, in turns a, b, b, a: {name: [ms, ms]}."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        out[k].append(time_cuda(fns[k], n=n, warmup=2))
    return out


def _sharded_serving(ctx, b=64, ticks=2):
    """(a) make_sharded_device_step over two shards of cuda:0 against the
    unsharded dense tick (_step_core) at 64 streams, full-size B0 at 224,
    every kernel's flag on (u8 faces, clahe_device): outputs and states
    tick by tick; launches per shard; the two ticks' times in turns."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.ops.resize import resize_bilinear_u8_cv2
    from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as P
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        _step_core, init_stream_states, make_sharded_device_step)
    cfg = _detect_cfg()
    model = backbones.build_model(backbones.make("b0")).eval()
    model.load_state_dict(backbone_state(ctx))
    model = model.cuda()
    rng = np.random.default_rng(SEED + 11)
    ticks_in = []
    for t in range(ticks):
        cap = torch.from_numpy(np.stack([_synthetic_frame(rng, i % 2 == 0, t)
                                         for i in range(b)])).cuda()
        faces = cap[:, 160:320, 240:400].flip(-1).contiguous()
        ticks_in.append((resize_bilinear_u8_cv2(cap, 256, 256), faces,
                         torch.from_numpy(rng.random(b) < 0.7).cuda(),
                         torch.from_numpy(rng.integers(60, 200, (b, 2)).astype(np.int32)).cuda(),
                         torch.from_numpy(rng.random(b) < 0.9).cuda()))
    mesh = P.Mesh(SHARD_MESH)
    step = make_sharded_device_step(mesh, model, cfg)
    st_one = init_stream_states(b, cfg, "cuda")
    st_sh = P.shard_batch(mesh, init_stream_states(b, cfg, "cuda"))
    worst = 0.0
    for t, x in enumerate(ticks_in):
        out_one, st_one = _step_core(model, cfg, *x, st_one)
        torch.cuda.synchronize()
        _reset_launches()
        outs, st_sh = step(*x, st_sh)
        torch.cuda.synchronize()
        launches = _check_sharded_launches("serving tick", _read_launches(),
                                           _read_entry_launches(), 1)
        worst = max(worst, _same_outputs(f"serving tick {t}", out_one, P.gather(outs),
                                         st_one, P.gather(st_sh), b))
    x = ticks_in[-1]
    shards = [P.shard_batch(mesh, a) for a in x]
    fns = {"unsharded": lambda: _step_core(model, cfg, *x, st_one),
           "sharded_2": lambda: step(*shards, st_sh)}
    return {"streams": b, "ticks_compared": ticks, "max_float_diff": worst,
            "tolerance": "1e-4 of each tensor's largest magnitude",
            "launches_per_tick": launches, "tick_event_ms": _in_turns(fns),
            "profiles": {k: _profiled(fn) for k, fn in fns.items()}}


def _sharded_detect_form(ctx, form, net, b, ticks):
    """One form of (b): the sharded detect tick over two shards of cuda:0
    against the unsharded compact tick (make_device_step_detect, identity
    slots) on the same inputs; launches per shard of the sharded ticks."""
    import dataclasses
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.mtcnn import build_nets
    from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as P
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect, make_device_step_detect_wire,
        make_sharded_device_step_detect)
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    cfg, mtcnn, wire = _detect_cfg(), None, {}
    if form == "mtcnn":
        cfg = dataclasses.replace(cfg, mtcnn_device=True)
        mtcnn = build_nets(_mtcnn_weights(), "cuda")
    if form == "clip_vit_b16":
        cfg = _clip_cfg("vit_b16")
        model = _clip_models(ctx, "vit_b16", cfg, "cuda")
    else:
        model = backbones.build_model(backbones.make("b0")).eval()
        model.load_state_dict(backbone_state(ctx))
        model = model.cuda()
    if form == "coef":
        wire = {"wire": "coef", "capture_hw": (480, 640)}
        datas = [_jpegs()[0][WIRE_JPEGS[i % 3]] for i in range(b)]
        plane = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                 for a in J.decode_coefs_wire_batch(datas, 480, 640)[:3]]
        inputs = [plane] * ticks
        one = make_device_step_detect_wire(net, model, cfg, "coef", (480, 640), mtcnn)
    else:
        _, frames = _capture_frames(b, ticks, net)
        inputs = [[torch.from_numpy(np.stack([frames[s][t] for s in range(b)])).cuda()]
                  for t in range(ticks)]
        one = make_device_step_detect(net, model, cfg, mtcnn)
    sharded = make_sharded_device_step_detect(P.Mesh(SHARD_MESH), net, model, cfg, mtcnn,
                                              **wire)
    active = torch.ones(b, dtype=torch.bool, device="cuda")
    slot_idx = torch.arange(b, dtype=torch.int32, device="cuda")
    st_one = init_stream_states(b + 1, cfg, "cuda")
    st_sh = init_stream_states(b, cfg, "cuda")
    worst, faces, launches = 0.0, 0, {}
    for t, x in enumerate(inputs):
        out_one, st_one = one(*x, active, slot_idx, st_one)
        torch.cuda.synchronize()
        _reset_launches()
        outs, st_sh = sharded(*x, active, st_sh)
        torch.cuda.synchronize()
        launches = _check_sharded_launches(f"{form} tick", _read_launches(),
                                           _read_entry_launches(), 1, form == "mtcnn")
        got = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        worst = max(worst, _same_outputs(f"{form} tick {t}", out_one, got, st_one,
                                         P.gather(st_sh), b, form == "mtcnn"))
        faces += int(got["has_face"].sum())
    res = {"streams": b, "ticks_compared": ticks, "max_float_diff": worst,
           "face_rows": faces, "launches_per_tick": launches}
    if form == "bgr_clahe":
        x = inputs[-1]
        res["tick_event_ms"] = _in_turns({
            "unsharded": lambda: one(*x, active, slot_idx, st_one),
            "sharded_2": lambda: sharded(*x, active, st_sh)})
    return res


def _sharded_detect(ctx):
    """(b) The sharded detect tick in four forms, each against its
    unsharded tick on the card."""
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    net = CaffeNet(*_ssd_files(ctx)).cuda().eval()
    out = {}
    for form, b in (("bgr_clahe", 64), ("coef", 64), ("mtcnn", 64), ("clip_vit_b16", 16)):
        out[form] = _sharded_detect_form(ctx, form, net, b, 2)
    if out["bgr_clahe"]["face_rows"] == 0 or out["mtcnn"]["face_rows"] == 0:
        raise AssertionError("the sharded detect ticks found no face")
    return out


def _dp_state(device, seed=SEED):
    """Full-size B0 at 224 with TrainConfig's defaults, its weights from
    `seed`, its train state on `device`."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import TrainConfig
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.train import steps
    spec = backbones.make("b0")
    model = backbones.build_model(spec, torch.Generator().manual_seed(seed)).to(device)
    return steps.init_train_state(model, spec, TrainConfig(batch_size=DP_BATCH),
                                  total_steps=1000, seed=SEED)


def _dp_steps(state, step, imgs, labels, device):
    """DP_STEPS compared steps, then DP_TIMED timed ones: (metrics, wall ms
    of each timed step, the state's leaves after the compared steps). The
    compared steps run PyTorch's own convolutions, cuDNN off: cuDNN picks
    each convolution's algorithm by the workspace its allocator has cached
    at that moment, which differs from run to run in the gloo ranks (their
    copies run on side streams), and at batch 16 and 32 the picks differ in
    rounding; the first Adam steps turn that into sign flips of near-zero
    gradients (head.conv's delta 3.3e-2 relative from the one-process
    step's in some runs, 1.3e-3 in others, on an H100 80GB). The timed
    steps run with cuDNN."""
    import torch
    with torch.backends.cudnn.flags(enabled=False):
        metrics = [{k: float(v) for k, v in step(state, imgs, labels).items()}
                   for _ in range(DP_STEPS)]
    after = ({k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
             {k: v.detach().cpu().clone() for k, v in state.ema.items()})
    walls = []
    for _ in range(DP_TIMED):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        step(state, imgs, labels)
        torch.cuda.synchronize(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return metrics, walls, after


def _dp_rank(device, crops):
    """One rank of (c): its shard of the global batch `crops` (numpy)
    through make_sharded_train_step(fused_train_step)."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as P
    from real_time_video_deepfake_detection_tpu_torch.train import steps
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = _dp_state(device)
    b = DP_BATCH // P.world_size()
    rows = slice(P.rank() * b, (P.rank() + 1) * b)
    imgs = torch.from_numpy(crops[rows]).to(device)
    labels = torch.tensor([0.0, 1.0] * (DP_BATCH // 2))[rows].to(device)
    metrics, walls, (model, ema) = _dp_steps(
        state, steps.make_sharded_train_step(steps.fused_train_step), imgs, labels, device)
    return {"rank": P.rank(), "device": str(device), "metrics": metrics, "walls_ms": walls,
            "model": model, "ema": ema}


def _dp_one_process(device, crops):
    """The reference of (c), in a fresh process as the ranks are (in this
    script's own process, the allocator's state after the earlier phases
    can steer cuDNN to other algorithms, whose rounding noise flips the
    sign of Adam's first steps on near-zero gradients): fused_train_step
    on the whole batch; the leaves whose first gradient is rounding noise,
    the parameters before and after, each step's wall ms."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.train import steps
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = _dp_state(device)
    init = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    imgs = torch.from_numpy(crops).to(device)
    labels = torch.tensor([0.0, 1.0] * (DP_BATCH // 2)).to(device)
    null = set()

    def first(st, x, y):
        m = steps.fused_train_step(st, x, y)
        if not null:
            null.update(n for n, p in st.model.named_parameters()
                        if p.grad is not None and float(p.grad.norm()) < 1e-6)
        return m

    metrics, walls, (model, ema) = _dp_steps(state, first, imgs, labels, device)
    return {"metrics": metrics, "walls_ms": walls, "model": model, "ema": ema, "init": init,
            "null": sorted(null), "lr_sum": sum(state.sched(i) for i in range(DP_STEPS))}


def _dp_train(ctx):
    """(c) make_sharded_train_step on 2 gloo ranks that both sit on cuda:0
    (nccl refuses two ranks on one card) against the one-process
    fused_train_step on the card (in a fresh process too), same seed and so
    the same draws: losses within 1e-5, parameters, statistics and EMA
    within atol 2e-5 and rtol 2e-4 (a leaf of rounding-noise gradient
    within its Adam bound, the head means it feeds within 0.3 of it),
    weight deltas within 1e-2; the ranks alike bit for bit; then each
    version's step wall ms."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as P
    crops = _train_crops(DP_BATCH, 244, SEED)
    t0 = time.time()
    # the ranks share the host's cores
    threads = max(1, (os.cpu_count() or 2) // len(SHARD_MESH))
    ranks = P.spawn(_dp_rank, list(SHARD_MESH), args=(crops,), backend="gloo", timeout=600,
                    num_threads=threads)
    spawn_s = time.time() - t0
    ref, = P.spawn(_dp_one_process, [SHARD_MESH[0]], args=(crops,), backend="gloo",
                   timeout=600, num_threads=threads)
    metrics, walls, model, ema = ref["metrics"], ref["walls_ms"], ref["model"], ref["ema"]
    init, null, lr_sum = ref["init"], set(ref["null"]), ref["lr_sum"]
    r0, r1 = ranks
    for k in r0["model"]:
        if not torch.equal(r0["model"][k], r1["model"][k]):
            raise AssertionError(f"train (c): the ranks' {k} differ")
    loss_diff = max(abs(a["loss"] - m["loss"]) for a, m in zip(r0["metrics"], metrics))
    if loss_diff > 1e-5 or any(a["accuracy"] != m["accuracy"]
                               for a, m in zip(r0["metrics"], metrics)):
        raise AssertionError(f"train (c): DP {r0['metrics']} one process {metrics}")
    worst = {"value": 0.0, "delta_rel": 0.0, "noise": 0.0}
    for k, v in model.items():
        got = r0["model"][k]
        if k in null:
            worst["noise"] = max(worst["noise"], float((got - init[k]).abs().max()))
            if worst["noise"] > 1.5 * lr_sum:
                raise AssertionError(f"train (c): {k} moved past its Adam bound")
            continue
        fed = (k.startswith("fc.bn") and k.endswith(".mean")
               and k.replace("bn", "fc").replace(".mean", ".b") in null)
        np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=2e-4,
                                   atol=0.3 * lr_sum if fed else 2e-5, err_msg=k)
        worst["value"] = max(worst["value"], float((got - v).abs().max()))
        if v.dtype.is_floating_point and not torch.equal(v, init[k]) and \
                not (k.endswith(".mean") or k.endswith(".var")):
            d, w = got - init[k], v - init[k]
            rel = float((d - w).norm() / w.norm())
            worst["delta_rel"] = max(worst["delta_rel"], rel)
            if rel > 1e-2:
                raise AssertionError(f"train (c): {k} delta differs by {rel} (relative)")
    for k, v in ema.items():
        tol = 1.5 * lr_sum if k in null else 2e-5
        np.testing.assert_allclose(r0["ema"][k].numpy(), v.numpy(), rtol=2e-4, atol=tol,
                                   err_msg=f"ema {k}")
    return {"global_batch": DP_BATCH, "ranks": [r["device"] for r in ranks],
            "backend": "gloo", "steps_compared": DP_STEPS, "loss_max_abs_diff": loss_diff,
            "losses": [m["loss"] for m in metrics], "max_abs_diff": worst,
            "noise_gradient_leaves": len(null),
            "step_wall_ms": {"one_process": walls, "dp_rank0": r0["walls_ms"],
                             "dp_rank1": r1["walls_ms"]},
            "step_wall_ms_median": {"one_process": statistics.median(walls),
                                    "dp": statistics.median(r0["walls_ms"])},
            "spawn_and_run_seconds": spawn_s}


def phase_sharded(ctx):
    """The stream-sharded ticks and data-parallel training on the one card:
    (a) the serving tick, (b) the detect tick in four forms, (c) the
    2-rank training step."""
    t0 = time.time()
    serving = _sharded_serving(ctx)
    t1 = time.time()
    detect = _sharded_detect(ctx)
    t2 = time.time()
    train = _dp_train(ctx)
    ctx["sharded_launches"] = serving["launches_per_tick"]
    return {"mesh": list(SHARD_MESH), "card": ctx["smi"], "serving": serving,
            "detect": detect, "train": train,
            "part_seconds": {"serving": t1 - t0, "detect": t2 - t1,
                             "train": time.time() - t2}}


# ------------------------------------------------------------------- video

VIDEO_FRAMES = 48
SINGLE_FRAMES = 16   # of the video that (b) analyzes on the card and on the CPU
TREE_FRAMES = 24


def _video_frames(n: int, seed: int):
    """(JPEG bytes, decoded frame) of n 480x640 frames: every 8th the
    committed fixture's own bytes, the others encode_jpeg(q95) of the
    fixture with the photograph's face pasted in, moving 2 px down and 1
    right a frame (and by `seed` more)."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils.host_resize import resize_area_u8
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_encode import encode_jpeg
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import decode_jpeg
    with open(os.path.join(JPEG_DIR, "frame_640x480_q85_420.jpg"), "rb") as fh:
        fixture = fh.read()
    with open(os.path.join(HAAR_DIR, HAAR_PHOTO), "rb") as fh:
        photo = resize_area_u8(decode_jpeg(fh.read()), 320, 272)
    base = decode_jpeg(fixture)
    scene = base.copy()
    scene[80:400, 300:572] = photo
    out = []
    for i in range(n):
        if i % 8 == 0:
            out.append((fixture, base))
            continue
        f = np.ascontiguousarray(np.roll(scene, (2 * (i + seed), i + seed), (0, 1)))
        data = encode_jpeg(f, 95)
        out.append((data, decode_jpeg(data)))
    return out


def _write_video(path: str, frames, fps: float = 25.0) -> None:
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoWriter
    wr = VideoWriter(path, "MJPG", fps, (640, 480))
    for data, _ in frames:
        wr.write_jpeg(data)
    wr.release()


def _video_io(root: str):
    """(a) The writer and reader round trip (each frame as utils/mjpeg
    decodes its JPEG alone, which is cv2.VideoCapture's decode), seeks
    (every frame a keyframe: cv2 lands on frame i), and the host times."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils import mjpeg
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_encode import encode_jpeg
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    frames = _video_frames(VIDEO_FRAMES, 0)
    path = os.path.join(root, "video.avi")
    _write_video(path, frames)
    reader = VideoReader(path)
    if not reader.is_opened() or reader.frame_count != VIDEO_FRAMES or reader.fps != 25.0:
        raise AssertionError(f"video (a): {reader.reason} {reader.frame_count} {reader.fps}")
    wants = [mjpeg.decode_frame(data)[0] for data, _ in frames]
    t0 = time.perf_counter()
    for i, want in enumerate(wants):
        ok, got = reader.read()
        if not ok or not np.array_equal(got, want):
            raise AssertionError(f"video (a): frame {i} differs from its decode")
    read_ms = (time.perf_counter() - t0) * 1e3 / VIDEO_FRAMES
    for i in (47, 0, 13, 13, 8, 31):
        reader.seek(i)
        if not np.array_equal(reader.read()[1], wants[i]):
            raise AssertionError(f"video (a): seek({i}) landed elsewhere")
    frame = frames[1][1]
    crop = np.ascontiguousarray(frame[100:324, 300:524])

    def host_ms(fn, n=20):
        fn()
        t = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            t.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(t)

    return frames, path, {
        "frames": VIDEO_FRAMES, "seeks_checked": 6, "read_ms_per_frame": read_ms,
        "encode_ms_224x224_q95": host_ms(lambda: encode_jpeg(crop, 95)),
        "encode_ms_480x640_q95": host_ms(lambda: encode_jpeg(frame, 95)),
        "bytes_per_frame_480x640_q95": len(frames[1][0])}


MJPEG_DIR = os.path.join(REPO, "tests", "data", "torch_mjpeg")


def _mjpeg_fixtures():
    """(a3) Motion-JPEG AVI as cv2.VideoCapture(path) reads it (utils/mjpeg,
    csrc/mjpeg.cpp on the host): every file of tests/data/torch_mjpeg read
    in order and after seek(i) at every i, each frame's sha256, the frame
    count and fps against the committed digests of cv2's default backend;
    the arithmetic-coded and damaged files stopped where they must, with
    the reason named; host ms a frame of the 4:2:2 and 4:2:0 files."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    with open(os.path.join(MJPEG_DIR, "digests.json")) as fh:
        files = json.load(fh)["files"]

    def reads(path, seek=None):
        r = VideoReader(path)
        if seek is not None:
            r.seek(seek)
        out = []
        while True:
            ok, f = r.read()
            if not ok:
                return out, r
            out.append({"sha256": _sha(f), "shape": list(f.shape)})

    problems, stopped, checked = [], {}, 0
    for name, e in sorted(files.items()):
        path = os.path.join(MJPEG_DIR, name)
        got, r = reads(path)
        if (r.frame_count, r.fps) != (e["frame_count"], e["fps"]):
            problems.append(f"{name}: count/fps {r.frame_count} {r.fps}")
        if r.reason:   # a refused or damaged frame: the frames before it
            stopped[name] = r.reason
            if got != e["read"][:len(got)] or len(got) >= max(len(e["read"]), 1):
                problems.append(f"{name}: frames before the stop")
            continue
        checked += len(got)
        if got != e["read"]:
            problems.append(f"{name}: sequential frames")
        for i, want in e["seek"].items():
            checked += len(want)
            if reads(path, int(i))[0] != want:
                problems.append(f"{name}: seek({i})")
    if problems or len(stopped) != 2:
        raise AssertionError(f"Motion-JPEG fixtures: {problems[:6]} {stopped}")
    ms = {}
    for name in ("port_s422_96x64.avi", "cv2_ffmpeg_96x64.avi"):
        r = VideoReader(os.path.join(MJPEG_DIR, name))
        t0 = time.perf_counter()
        n = sum(1 for _ in iter(lambda: r.read()[0] or None, None))
        ms[name] = (time.perf_counter() - t0) * 1e3 / max(n, 1)
    return {"files": len(files), "frames_checked": checked, "stopped": stopped,
            "host_ms_per_frame_96x64": ms}


def _writer_replay():
    """(a4) The mp4v writer past avienc's 1 GiB and movenc's 4 GiB: the
    packet sizes and key flags of tools/torch_writer_large_proof.py's runs
    replayed through the muxers with dummy payloads, the SHA-256 of every
    byte outside the payloads held to cv2's file's."""
    sys.path.insert(0, REPO)
    from tests import torch_writer_replay as replay
    out = {}
    for kind, run in sorted(replay.load()["runs"].items()):
        t0 = time.perf_counter()
        sink = replay.replay(run)
        ok = sink.digest() == run["nonpayload_sha256"] and sink.tell() == run["file_size"]
        if not ok:
            raise AssertionError(f"writer replay {kind}: the container bytes differ")
        out[kind] = {"packets": len(run["keys"]), "file_bytes": run["file_size"],
                     "seconds": time.perf_counter() - t0}
    return out


def _mp4v_writer(root: str):
    """(a2) The mp4v writer against cv2's bytes: every case of
    tests/torch_mpeg4_scenes.CASES written and its SHA-256 held to the
    digest of cv2.VideoWriter's file; the writer's ms per frame (cv2's
    conversion, the encode, the mux) at 640x360 and 1920x1080."""
    import hashlib
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoWriter
    from tests import torch_mpeg4_scenes as scenes
    with open(os.path.join(MP4V_WRITER_DIR, "digests.json")) as fh:
        ref = json.load(fh)["cases"]
    if set(ref) != set(scenes.CASES):
        raise AssertionError("video (a2): the digests name other cases than the scenes")
    t0 = time.perf_counter()
    for name in sorted(ref):
        _, _, _, _, fps, ext = scenes.CASES[name]
        frames = scenes.case_frames(name)
        path = os.path.join(root, "writer" + ext)
        wr = VideoWriter(path, "mp4v", fps, (frames[0].shape[1], frames[0].shape[0]))
        for f in frames:
            wr.write(f)
        wr.release()
        with open(path, "rb") as fh:
            data = fh.read()
        if hashlib.sha256(data).hexdigest() != ref[name]["sha256"]:
            raise AssertionError(f"video (a2): {name}: {len(data)} bytes, not cv2's "
                                 f"{ref[name]['bytes']}")
    checked_s = time.perf_counter() - t0
    ms = {}
    for h, w, n in ((360, 640, 25), (1080, 1920, 13)):
        frames = scenes.frames("pan", n, h, w)
        wr = VideoWriter(os.path.join(root, "timed.mp4"), "mp4v", 25, (w, h))
        t = []
        for f in frames:
            t1 = time.perf_counter()
            wr.write(f)
            t.append((time.perf_counter() - t1) * 1e3)
        wr.release()
        ms[f"{w}x{h}"] = {"frames": n, "mean_ms": statistics.mean(t), "i_vop_ms": t[0],
                          "median_p_vop_ms": statistics.median(t[1:12])}
    return {"cases_equal_to_cv2": len(ref), "cases_seconds": checked_s,
            "writer_ms_per_frame": ms}


@contextlib.contextmanager
def _recording():
    """Records what cli/analyze draws and writes: the label strings
    (ops/draw.put_text), each frame's GradCAM boxes (the detector's
    last_gradcams after predict) and the annotated frames before they are
    encoded (utils/video.VideoWriter.write)."""
    from real_time_video_deepfake_detection_tpu_torch.ops import draw
    from real_time_video_deepfake_detection_tpu_torch.pipeline import detector
    from real_time_video_deepfake_detection_tpu_torch.utils import video
    rec = {"texts": [], "boxes": [], "frames": [], "decoded": []}
    put_text, predict, write = draw.put_text, detector.DeepfakeDetector.predict, \
        video.VideoWriter.write

    def put_text_rec(img, text, *a, **k):
        rec["texts"][-1].append(text)
        return put_text(img, text, *a, **k)

    def predict_rec(self, frame):
        rec["texts"].append([])
        out = predict(self, frame)
        rec["boxes"].append([box for box, _ in self.last_gradcams])
        return out

    def write_rec(self, frame):
        rec["frames"].append(frame.copy())
        write(self, frame)
        rec["decoded"].append(self.reconstruction())

    draw.put_text, detector.DeepfakeDetector.predict, video.VideoWriter.write = \
        put_text_rec, predict_rec, write_rec
    try:
        yield rec
    finally:
        draw.put_text, detector.DeepfakeDetector.predict, video.VideoWriter.write = \
            put_text, predict, write


def _analyze_single(root: str, path: str, weights: str):
    """(b) cli/analyze.main on the video's first SINGLE_FRAMES frames with
    --gradcam --output .avi --json, on the card and on the CPU, and on its
    first SINGLE_FRAMES // 2 with --output .mp4; each output read back."""
    out = {}
    for ext, frames in ((".avi", SINGLE_FRAMES), (".mp4", SINGLE_FRAMES // 2)):
        out[ext] = _analyze_single_ext(root, path, weights, ext, frames)
    out[".avi"]["step_ms_card"] = _predict_steps_ms(path, weights)
    return out


def _analyze_single_ext(root: str, path: str, weights: str, ext: str, n: int):
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.cli import analyze
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    runs = {}
    for dev in ("cuda", "cpu"):
        out_json = os.path.join(root, f"single_{dev}.json")
        output = os.path.join(root, f"single_{dev}{ext}")
        with _recording() as rec:
            t0 = time.perf_counter()
            analyze.main([path, "--weights", weights, "--gradcam", "--json", out_json,
                          "--max-frames", str(n), "--output", output, "--device", dev])
            seconds = time.perf_counter() - t0
        with open(out_json) as fh:
            runs[dev] = (json.load(fh), rec, seconds)
        reader = VideoReader(output)
        if reader.frame_count != n or reader.fps != 25.0 or len(rec["decoded"]) != n:
            raise AssertionError(f"video (b) {ext} {dev}: {reader.reason} {reader.frame_count} "
                                 f"frames at {reader.fps}")
        for i, want in enumerate(rec["decoded"]):
            ok, got = reader.read()
            if not ok or not np.array_equal(got, want):
                raise AssertionError(f"video (b) {ext} {dev}: frame {i} read back differs "
                                     "from the encoder's reconstruction")
    (jg, rg, sg), (jc, rc, _) = runs["cuda"], runs["cpu"]
    if len(jg["frames"]) != n or len(rg["frames"]) != n:
        raise AssertionError(f"video (b): {len(jg['frames'])} frames analyzed")
    worst, compared, gradcam_frames = 0.0, 0, 0
    for i, (a, b) in enumerate(zip(jg["frames"], jc["frames"])):
        for k in ("frame_count", "faces_detected", "confidence_level", "analysis_mode"):
            if a[k] != b[k]:
                raise AssertionError(f"video (b): frame {i} {k}: card {a[k]} CPU {b[k]}")
        worst = max(worst, abs(a["temporal_average"] - b["temporal_average"]))
        if rg["boxes"][i] != rc["boxes"][i]:
            raise AssertionError(f"video (b): frame {i} GradCAM boxes differ")
        gradcam_frames += bool(rg["boxes"][i])
        if rg["texts"][i] == rc["texts"][i]:
            outside = np.ones(rg["frames"][i].shape[:2], bool)
            for x, y, w, h in rg["boxes"][i]:
                outside[y:y + h, x:x + w] = False
            if not np.array_equal(rg["frames"][i][outside], rc["frames"][i][outside]):
                raise AssertionError(f"video (b): frame {i} differs outside its boxes")
            compared += 1
    if worst > 1e-4 or jg["summary"]["final_verdict"] != jc["summary"]["final_verdict"]:
        raise AssertionError(f"video (b): temporal averages {worst} apart, verdicts "
                             f"{jg['summary']['final_verdict']} {jc['summary']['final_verdict']}")
    if gradcam_frames == 0 or compared < n // 2:
        raise AssertionError(f"video (b): {gradcam_frames} frames with a face, "
                             f"{compared} compared")
    return {"frames": n, "frames_with_gradcam": gradcam_frames,
            "frames_compared_outside_boxes": compared, "temporal_average_max_abs_diff": worst,
            "final_verdict": jg["summary"]["final_verdict"],
            "faces_detected": sum(f["faces_detected"] for f in jg["frames"]),
            "frames_read_back_equal": 2 * n,
            "frames_per_s_card": n / sg, "seconds_card": sg}


def _predict_steps_ms(path: str, weights: str, n: int = 12):
    """Median host ms of each step of one analyzed frame on the card, each
    ending in a synchronize: the read, the forensics, the cascade, the face
    (Lab, CLAHE, B0) with and without GradCAM, the overlay, the mp4v encode
    of the annotated frame (utils/mpeg4.Encoder, as --output's writer)."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import DetectorConfig
    from real_time_video_deepfake_detection_tpu_torch.pipeline.detector import DeepfakeDetector
    from real_time_video_deepfake_detection_tpu_torch.utils import mpeg4
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    from real_time_video_deepfake_detection_tpu_torch.utils.weights import load_params_any
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    det = DeepfakeDetector(DetectorConfig(), params=load_params_any(weights, backbones.make("b0")),
                           enable_gradcam=True, device="cuda")
    reader = VideoReader(path)
    encoder = mpeg4.Encoder(640, 480, 1, 25, 2 * 25 * 640 * 480, True)
    steps = {k: [] for k in ("read", "forensics", "cascade", "face_gradcam", "face",
                             "predict_whole", "overlay", "encode")}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[key].append((time.perf_counter() - t0) * 1e3)
        return out

    for i in range(n + 2):
        ok, frame = timed("read", reader.read)
        timed("forensics", lambda: det.analyze_frame_forensics(frame))
        boxes = timed("cascade", lambda: det.face_detector(frame))
        if boxes:
            x, y, w, h = boxes[0]
            face = frame[y:y + h, x:x + w]
            det.enable_gradcam = True
            timed("face_gradcam", lambda: det.analyze_face(face))
            det.enable_gradcam = False
            timed("face", lambda: det.analyze_face(face))
            det.enable_gradcam = True
        annotated = timed("predict_whole", lambda: det.predict(frame))[0]
        timed("overlay", lambda: det._draw_overlay(frame.copy(), 10, 40, 100, 120, 0.7, "FAKE"))
        timed("encode", lambda: encoder.encode(annotated, i))
    return {k: statistics.median(v[2:]) for k, v in steps.items() if len(v) > 2}


def _analyze_multi(root: str, weights: str):
    """(c) cli/analyze.main over 4 videos through the batched engine on the
    card."""
    from real_time_video_deepfake_detection_tpu_torch.cli import analyze
    paths = []
    for k in range(4):
        paths.append(os.path.join(root, f"multi_{k}.avi"))
        _write_video(paths[-1], _video_frames(TREE_FRAMES, 5 * k + 1))
    out_json = os.path.join(root, "multi.json")
    t0 = time.perf_counter()
    analyze.main(paths + ["--weights", weights, "--json", out_json, "--device", "cuda"])
    seconds = time.perf_counter() - t0
    with open(out_json) as fh:
        out = json.load(fh)
    bad = [v for v in out["videos"] if "error" in v or v["frames"] != TREE_FRAMES]
    if bad or out["max_batch_seen"] < 2:
        raise AssertionError(f"video (c): {bad}, max batch {out['max_batch_seen']}")
    return {"videos": 4, "frames_total": out["frames_total"], "ticks": out["engine_ticks"],
            "max_batch_seen": out["max_batch_seen"],
            "verdicts": [v["final_verdict"] for v in out["videos"]],
            "frames_per_s": out["frames_total"] / seconds, "seconds": seconds}


def _clip_head_cli(ctx, root: str, weights: str):
    """(d) train/clip_head.main on the card over train/{real,fake} x 4 and
    val/{real,fake} x 1, window 16, 160 px crops, B0, 30 epochs; the head
    served by the batched engine; feature-extraction ms per frame."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine
    from real_time_video_deepfake_detection_tpu_torch.serving.server import _load_clip_head
    from real_time_video_deepfake_detection_tpu_torch.train import clip_head
    tree = os.path.join(root, "tree")
    k = 0
    for split, n in (("train", 4), ("val", 1)):
        for label in ("real", "fake"):
            d = os.path.join(tree, split, label)
            os.makedirs(d)
            for i in range(n):
                # Motion-JPEG AVIs named .mp4: the readers go by content, and
                # face_extract globs *.mp4 as the JAX tool does
                _write_video(os.path.join(d, f"{label}{i}.mp4"),
                             _video_frames(TREE_FRAMES, 3 * k + (label == "fake")))
                k += 1
    out = os.path.join(root, "clip_head.pt")
    t0 = time.perf_counter()
    res = clip_head.main(["--videos", tree, "--clip-window", "16", "--crop-size", "160",
                          "--epochs", "30", "--backbone-weights", weights, "--out", out,
                          "--device", "cuda"])
    seconds = time.perf_counter() - t0
    if res.get("val_n") != 2 or not np.isfinite(res["train_log_tail"][-1]["loss"]):
        raise AssertionError(f"video (d): {res}")
    spec = backbones.make("b0")
    cfg = DetectorConfig(clip_window=16)
    head = _load_clip_head(out, cfg, spec)
    engine = MultiStreamEngine(cfg, ServerConfig(max_streams=4), params=backbone_state(ctx),
                               spec=spec, clip_head_params=head, device="cuda")
    try:
        frames = _video_frames(3, 7)
        for _, f in frames:
            r = engine.analyze(f, "clip")
    finally:
        engine.shutdown()
    if "clip_probability" not in r:
        raise AssertionError(f"video (d): the clip head's response {r}")
    model = backbones.build_model(spec)
    model.load_state_dict(backbone_state(ctx))
    model = model.cuda().eval()
    clips = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (16, 16, 160, 160, 3), dtype=np.uint8))
    ms = time_cuda(lambda: clip_head.extract_clip_features(model, clips, batch_frames=256),
                   n=5, warmup=1)
    return {"clips": {"train": 8, "val": 2}, "window": 16, "crop": 160, "epochs": 30,
            "train_log_tail": res["train_log_tail"], "val_acc": res["val_acc"],
            "clip_probability": r["clip_probability"], "main_seconds": seconds,
            "feature_ms_per_frame_batch256": ms / 256}


def _face_extract(ctx, root: str):
    """(e) data_tools/face_extract.preextract over the tree's train videos
    with the synthetic SSD on the card and on the CPU: the same files."""
    from real_time_video_deepfake_detection_tpu_torch.data_tools import face_extract
    caffemodel = _ssd_files(ctx)[1]
    trees = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(root, f"faces_{dev}")
        t0 = time.perf_counter()
        stats = face_extract.preextract(os.path.join(root, "tree", "train"), out,
                                        frames_per_video=6, ssd_weights=caffemodel, device=dev)
        seconds = time.perf_counter() - t0
        files = {}
        for dirpath, _, names in os.walk(out):
            for name in names:
                with open(os.path.join(dirpath, name), "rb") as fh:
                    files[os.path.relpath(os.path.join(dirpath, name), out)] = fh.read()
        trees[dev] = (stats, files, seconds)
    (sg, fg, tg), (sc, fc, _) = trees["cuda"], trees["cpu"]
    if sg != sc or fg != fc or not fg:
        raise AssertionError(f"video (e): card {sg} {sorted(fg)[:4]} CPU {sc} {sorted(fc)[:4]}")
    written = sg["real"] + sg["fake"]
    return {"crops_written": sg, "files_after_balance": len(fg), "seconds_card": tg,
            "crops_per_s_card": written / tg}


MP4_DIR = os.path.join(REPO, "tests", "data", "torch_mp4")


def _mp4_demux():
    """(f) utils/mp4.demux of every mp4/mov fixture: its sample table
    against libavformat's packets (packets.json), frame count and fps
    against cv2.VideoCapture's, the refusals, VideoReader's reason (none
    for the H.264 files, Baseline and High); host ms of a demux."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils import mp4
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    with open(os.path.join(MP4_DIR, "packets.json")) as fh:
        records = json.load(fh)["files"]
    out = {}
    for name, rec in sorted(records.items()):
        path = os.path.join(MP4_DIR, name)
        with open(path, "rb") as fh:
            data = fh.read()
        want = rec["libavformat"]
        try:
            track = mp4.demux(data)
        except mp4.Mp4Error as e:
            if want is not None and "fragmented" not in name:
                raise AssertionError(f"mp4 {name}: refused ({e}), libavformat reads it")
            out[name] = {"refused": str(e)}
            continue
        table = np.stack([track.offsets, track.sizes, track.dts, track.pts,
                          track.keyframes.astype(np.int64), track.discard.astype(np.int64)],
                         1).tolist()
        cv = rec["cv2"]
        if table != want["packets"] or (track.frame_count, track.fps) != (
                cv["frame_count"], cv["fps"]):
            raise AssertionError(f"mp4 {name}: the sample table or the counts differ")
        reason = VideoReader(path).reason
        if reason:   # avc1 and mp4v open (tests/data/torch_mpeg4 for mp4v)
            raise AssertionError(f"mp4 {name}: VideoReader says {reason!r}")
        t = []
        for _ in range(20):
            t0 = time.perf_counter()
            mp4.demux(data)
            t.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"codec": track.codec_name, "samples": len(table),
                     "discarded": int(track.discard.sum()), "frame_count": track.frame_count,
                     "fps": track.fps, "demux_host_ms": statistics.median(t), "bytes": len(data),
                     "reader": reason or "opened"}
    return {"files": out}


H264_DIR = os.path.join(REPO, "tests", "data", "torch_h264")
H264_HIGH_DIR = os.path.join(REPO, "tests", "data", "torch_h264_high")
MPEG4_DIR = os.path.join(REPO, "tests", "data", "torch_mpeg4")
MP4V_WRITER_DIR = os.path.join(REPO, "tests", "data", "torch_mpeg4_writer")
MP4_CLIP = os.path.join(H264_HIGH_DIR, "hi_640x360.mp4")   # x264's High defaults
MP4V_CLIP = os.path.join(MPEG4_DIR, "cv2_640x360.mp4")     # cv2.VideoWriter's mp4v
# the feature each refused fixture is named by
REFUSED_WHY = {"hi_mbaff_160x96.mp4": "MBAFF", "hi422_160x96.mp4": "4:2:2 chroma",
               "xvid_160x96.mp4": "Xvid", "xvid_gmc_160x96.mp4": "GMC",
               "interlaced_160x96.mp4": "interlaced coding"}
# the High files whose every seek is held (B-pyramid, temporal direct, open GOP)
HIGH_SWEPT = ("hi_640x360.mp4", "hi_temporal_320x180.mp4", "hi_opengop_256x144.mp4")


def _h264_path(key: str, root: str = H264_DIR) -> str:
    return os.path.join(os.path.dirname(H264_DIR), key) if "/" in key else \
        os.path.join(root, key)


def _mp4_fixtures():
    """(g) every H.264 and MPEG-4 Part 2 fixture (tests/data/torch_h264,
    torch_h264_high and torch_mpeg4, and the torch_mp4 files) read by
    VideoReader sequentially and after seek(i) from 0 to the frame count,
    each on a fresh reader: every i on the Baseline and mp4v files and
    HIGH_SWEPT, i = 0, the middle and the end on the other High files; every
    frame's sha256 and shape against the committed digests of
    cv2.VideoCapture's frames (digests.json). The refusal files stay
    unopened, their feature named. The files are checked on a thread each."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    records = {}
    for root in (H264_DIR, H264_HIGH_DIR, MPEG4_DIR):
        with open(os.path.join(root, "digests.json")) as fh:
            records.update({(root, k): r for k, r in json.load(fh)["files"].items()})

    def digest(frame):
        return None if frame is None else {
            "sha256": hashlib.sha256(np.ascontiguousarray(frame).tobytes()).hexdigest(),
            "shape": list(frame.shape)}

    def check(item):
        (root, key), rec = item
        path = _h264_path(key, root)
        r = VideoReader(path)
        if rec.get("refused"):
            why = REFUSED_WHY[key]
            if r.is_opened() or why not in r.reason:
                raise AssertionError(f"mp4 {key}: not refused by name: {r.reason}")
            return key, {"refused": r.reason}
        if not r.is_opened() or (r.frame_count, r.fps) != (rec["frame_count"], rec["fps"]):
            raise AssertionError(f"mp4 {key}: {r.reason} {r.frame_count} {r.fps}")
        seq = []
        while True:
            ok, frame = r.read()
            if not ok:
                break
            seq.append(digest(frame))
        if seq != rec["read"]:
            n = min(len(seq), len(rec["read"]))
            bad = next((i for i in range(n) if seq[i] != rec["read"][i]), n)
            raise AssertionError(f"mp4 {key}: read {len(seq)} frames of {len(rec['read'])}, "
                                 f"frame {bad} differs from cv2's")
        n = len(rec["seek"])
        swept = root != H264_HIGH_DIR or key in HIGH_SWEPT or key.startswith("torch_mp4/")
        seeks = range(n) if swept else sorted({0, n // 2, n - 1})
        for i in seeks:
            r = VideoReader(path)
            r.seek(i)
            if digest(r.read()[1]) != rec["seek"][i]:
                raise AssertionError(f"mp4 {key}: seek({i}) differs from cv2's landing")
        return key, {"frames": len(seq), "frame_count": r.frame_count, "seeks": len(seeks)}

    # one file a thread: the decoder and the conversion run without the GIL
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        out = dict(pool.map(check, sorted(records.items())))
    return {"files": out, "frames_checked": sum(v.get("frames", 0) + v.get("seeks", 0)
                                                for v in out.values()),
            "seconds": time.perf_counter() - t0}


def _mp4_decode_ms():
    """Host ms per frame of the Baseline and High 640x360 and 1920x1080
    clips and of the cv2-written mp4v 640x360 and 1920x1080 files:
    VideoReader.read (decode and BGR conversion), the decode alone
    (utils/h264.Decoder, utils/mpeg4.Decoder) and the conversion alone; the
    mean of one pass over the clip."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils import h264, mp4, mpeg4
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    out = {}
    for root, name in ((H264_DIR, "cb_640x360.mp4"), (H264_DIR, "cb_1920x1080.mp4"),
                       (H264_HIGH_DIR, "hi_640x360.mp4"), (H264_HIGH_DIR, "hi_1920x1080.mp4"),
                       (MPEG4_DIR, "cv2_640x360.mp4"), (MPEG4_DIR, "cv2_1920x1080.mp4")):
        path = os.path.join(root, name)
        with open(path, "rb") as fh:
            data = fh.read()
        track = mp4.demux(data)
        r = VideoReader(path)
        t0, n = time.perf_counter(), 0
        while r.read()[0]:
            n += 1
        read = (time.perf_counter() - t0) * 1e3 / n
        if track.codec == "mp4v":
            d = mpeg4.Decoder(track.decoder_config)
        else:
            d = h264.Decoder(track.avc.nal_length_size, track.avc.sps + track.avc.pps)
        planes, t0 = [], time.perf_counter()
        for i in range(len(track.sizes)):
            off = int(track.offsets[i])
            d.decode(data[off:off + int(track.sizes[i])], int(track.pts[i]))
            while d.peek() is not None:
                planes.append(d.take(bgr=False, planes=True)[1])
        dec = (time.perf_counter() - t0) * 1e3 / len(planes)
        t0 = time.perf_counter()
        for y, u, v in planes:
            h264.yuv420_to_bgr(y, u, v)
        conv = (time.perf_counter() - t0) * 1e3 / len(planes)
        out[name] = {"codec": track.codec, "frames_read": n,
                     "size": [int(track.height), int(track.width)],
                     "read_ms_per_frame": read, "decode_ms_per_frame": dec,
                     "convert_ms_per_frame": conv, "read_fps": 1e3 / read}
    return out


def _mp4_engine(ctx, clip=MP4_CLIP, n_frames=47, need_face=True):
    """A clip (the High 640x360 one, or the cv2-written mp4v 640x360 one)
    through MultiStreamEngine on the card in device-detect mode
    (_detect_cfg: the preprocess, hue and both CLAHE kernels; the synthetic
    SSD; full-size B0): VideoReader's frames into engine.analyze, one tick
    each, the launches counted from 0 and each kernel's held to the ticks;
    then one bucket-8 detect tick of the clip's first frames on the card
    against the same tick on the CPU."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import MultiStreamEngine
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
    from real_time_video_deepfake_detection_tpu_torch.utils.video import VideoReader
    proto, cm = _ssd_files(ctx)
    cfg = _detect_cfg()
    engine = MultiStreamEngine(cfg, ServerConfig(max_streams=8, max_batch=8, device_detect=True),
                               params=backbone_state(ctx), spec=backbones.make("b0"),
                               device="cuda", ssd_net=CaffeNet(proto, cm))
    _reset_launches()
    t0 = time.time()
    try:
        reader, frames = VideoReader(clip), []
        while True:
            ok, frame = reader.read()
            if not ok:
                break
            frames.append(engine.analyze(frame, "mp4"))
        wall = time.time() - t0
        launches = _read_launches()
        ticks = engine.metrics["ticks"]
    finally:
        engine.shutdown()
    bad = [r for r in frames if not r.get("success") or _SCHEMA - set(r)]
    faces = sum(r.get("analysis_mode") == "face+frame" for r in frames)
    if bad or len(frames) != n_frames or (need_face and not faces):
        raise AssertionError(f"mp4 engine: {len(frames)} responses, {len(bad)} bad, "
                             f"{faces} with a face")
    if not all(n == ticks for n in launches.values()):
        raise AssertionError(f"mp4 engine: kernels not launched once a tick ({ticks}): "
                             f"{launches}")
    # one tick on the card against the CPU
    reader, frames8 = VideoReader(clip), []
    for _ in range(8):
        frames8.append(reader.read()[1])
    b = len(frames8)
    xs = [torch.from_numpy(np.stack(frames8)), torch.ones(b, dtype=torch.bool),
          torch.arange(b, dtype=torch.int32)]
    outs = {}
    for d in ("cpu", "cuda"):
        model = backbones.build_model(backbones.make("b0")).eval()
        model.load_state_dict(backbone_state(ctx))
        step = make_device_step_detect(CaffeNet(proto, cm).to(d).eval(), model.to(d), cfg)
        with torch.no_grad():
            outs[d] = step(*[x.to(d) for x in xs], init_stream_states(b + 1, cfg, d))
    (out_c, st_c), (out_g, st_g) = outs["cpu"], outs["cuda"]
    worst = 0.0
    pairs = [(k, out_c[k], out_g[k].cpu()) for k in out_c]
    pairs += [(f"state{i}", a, g.cpu()) for i, (a, g) in
              enumerate(zip(tree_leaves(st_c), tree_leaves(st_g)))]
    for k, a, g in pairs:
        if a.dtype.is_floating_point:
            diff = float((a - g).abs().max()) if a.numel() else 0.0
            worst = max(worst, diff)
            if not diff <= 1e-4:
                raise AssertionError(f"mp4 tick {k}: max abs diff {diff} > 1e-4")
        elif not torch.equal(a, g):
            raise AssertionError(f"mp4 tick {k}: {int((a != g).sum())} integers differ")
    return {"clip": os.path.relpath(clip, REPO), "frames": len(frames), "frames_with_face": faces,
            "launches": launches, "ticks": ticks, "wall_s": wall,
            "frames_per_s": len(frames) / wall,
            "engine_metrics": engine.metrics,
            "tick_bucket": b, "tick_faces": int(out_c["has_face"].sum()),
            "tick_max_float_diff_vs_cpu": worst, "tolerance": 1e-4}


def _mp4_analyze(root: str, weights: str):
    """cli/analyze.main on the High 640x360 mp4 (single, 24 frames, --json)
    and on three mp4s through the batched engine (the clip, the Baseline
    face clip and the 160x96 file, whose discarded 48th sample is not
    read)."""
    from real_time_video_deepfake_detection_tpu_torch.cli import analyze
    single = os.path.join(root, "mp4_single.json")
    t0 = time.perf_counter()
    analyze.main([MP4_CLIP, "--weights", weights, "--json", single, "--max-frames", "24",
                  "--device", "cuda"])
    t_single = time.perf_counter() - t0
    paths = [MP4_CLIP, os.path.join(H264_DIR, "cb_face_272x320.mp4"),
             os.path.join(MP4_DIR, "baseline_160x96.mp4")]
    multi = os.path.join(root, "mp4_multi.json")
    t0 = time.perf_counter()
    analyze.main(paths + ["--weights", weights, "--json", multi, "--device", "cuda"])
    t_multi = time.perf_counter() - t0
    with open(single) as fh:
        js = json.load(fh)
    with open(multi) as fh:
        jm = json.load(fh)
    if js["summary"]["frames"] != 24 or len(js["frames"]) != 24:
        raise AssertionError(f"mp4 analyze single: {js['summary']}")
    bad = [v for v in jm["videos"] if "error" in v]
    if bad or jm["frames_total"] != 47 + 14 + 47 or jm["max_batch_seen"] < 2:
        raise AssertionError(f"mp4 analyze multi: {bad} {jm['frames_total']} "
                             f"{jm['max_batch_seen']}")
    return {"single": {"frames": 24, "verdict": js["summary"]["final_verdict"],
                       "faces_detected": sum(f["faces_detected"] for f in js["frames"]),
                       "frames_per_s": 24 / t_single},
            "multi": {"videos": 3, "frames_total": jm["frames_total"],
                      "max_batch_seen": jm["max_batch_seen"], "ticks": jm["engine_ticks"],
                      "verdicts": [v["final_verdict"] for v in jm["videos"]],
                      "frames_per_s": jm["frames_total"] / t_multi}}


def _mp4_decode(ctx, root: str, weights: str):
    """(g) H.264 and MPEG-4 Part 2 mp4 in: the Baseline, High and mp4v
    fixtures against cv2's digests, the host decode ms per frame at 640x360
    and 1920x1080 of each, the High 640x360 clip and the cv2-written mp4v
    640x360 file through the device-detect engine (every kernel launched
    once a tick) with one tick each against the CPU, and cli/analyze on
    mp4s, single and batched."""
    engine = _mp4_engine(ctx)
    t0 = time.time()
    engine_mp4v = _mp4_engine(ctx, MP4V_CLIP, 12, need_face=False)
    engine_mp4v["part_s"] = time.time() - t0
    ctx["mp4_launches"] = engine["launches"]
    ctx["mp4v_launches"] = engine_mp4v["launches"]
    return {"fixtures": _mp4_fixtures(), "decode_ms": _mp4_decode_ms(), "engine": engine,
            "engine_mp4v": engine_mp4v, "analyze": _mp4_analyze(root, weights)}


def phase_video(ctx):
    """Video in and out: (a) the Motion-JPEG writer and reader, (a3) the
    Motion-JPEG fixtures against cv2's digests, (a4) the writer's
    large-file forms replayed, (a2) the mp4v writer against cv2's digests,
    (b) the single-video analyzer card
    against CPU with mp4v --output in AVI and mp4, (c) the batched analyzer over 4 videos, (d)
    the clip-head trainer's CLI, (e) the face pre-extraction, (f) the mp4
    demuxer, (g) H.264 and MPEG-4 Part 2 mp4 decode."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.train.checkpoint import save_checkpoint
    os.environ["HAARCASCADE_DIR"] = HAAR_DIR
    root = tempfile.mkdtemp(prefix="chip_smoke_video_")
    try:
        weights = os.path.join(root, "b0.pt")
        save_checkpoint(weights, {"params": backbone_state(ctx), "metadata": {}})
        parts, times = {}, {}
        t0 = time.time()
        _, path, parts["io"] = _video_io(root)
        for name, fn in (("mjpeg_fixtures", _mjpeg_fixtures),
                         ("writer_replay", _writer_replay),
                         ("mp4v_writer", lambda: _mp4v_writer(root)),
                         ("single", lambda: _analyze_single(root, path, weights)),
                         ("multi", lambda: _analyze_multi(root, weights)),
                         ("clip_head", lambda: _clip_head_cli(ctx, root, weights)),
                         ("face_extract", lambda: _face_extract(ctx, root)),
                         ("mp4_demux", _mp4_demux),
                         ("mp4", lambda: _mp4_decode(ctx, root, weights))):
            times[name] = time.time() - t0
            parts[name] = fn()
            print(json.dumps({"video": name, "card": ctx["smi"], **parts[name]}), flush=True)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"card": ctx["smi"], **parts, "part_started_s": times}



# ------------------------------------------------------------------- final

FINAL_CLIP = (4, 4096, 63)   # streams, frames (two minutes at ~30 fps), block
FINAL_TP = (("vit_b16", 64, (2, 2)), ("vit_l16", 16, (1, 2)))   # name, bucket, dp x tp
FINAL_SIZES = ((1080, 1920), (1440, 2560))   # decode at M = 6 and M = 4 for 480x640
FINAL_STREAMS, FINAL_FRAMES = 16, 8


def _final_blockwise():
    """(a) TemporalHead.forward_blockwise at config 5's head width over a
    4,096-frame clip of 4 streams, block 63 (one stream with a masked tail,
    one with every third frame masked, one whose first 8 windows are
    wholly masked), on the card against the CPU within 1e-5; ms on the
    card."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models.temporal_head import (
        TemporalHead, TemporalHeadSpec)
    n, t, block = FINAL_CLIP
    spec = TemporalHeadSpec(feature_dim=768, dim=256, depth=2, heads=4, window=64)
    head = TemporalHead(spec, torch.Generator().manual_seed(SEED + 1)).eval()
    feats = torch.randn((n, t, spec.feature_dim), generator=torch.Generator().manual_seed(SEED + 3))
    mask = torch.ones((n, t), dtype=torch.bool)
    mask[1, 3000:] = False
    mask[2, ::3] = False
    mask[3, :8 * block] = False
    with torch.no_grad():
        want = head.forward_blockwise(feats, mask, block=block)
        head, fg, mg = head.cuda(), feats.cuda(), mask.cuda()
        got = head.forward_blockwise(fg, mg, block=block).cpu()
        diff = float((got - want).abs().max())
        if not diff <= 1e-5:
            raise AssertionError(f"blockwise head: card against CPU {diff} > 1e-5")
        ms = time_cuda(lambda: head.forward_blockwise(fg, mg, block=block), n=5, warmup=1)
        _, busy, acts, _ = profile_device(lambda: head.forward_blockwise(fg, mg, block=block), 2)
    return {"streams": n, "frames": t, "block": block, "windows": -(-t // block),
            "spec": dataclasses.asdict(spec), "max_abs_diff_vs_cpu": diff, "tolerance": 1e-5,
            "logits": got.tolist(), "event_ms": ms, "device_busy_ms": busy,
            "device_activities": acts}


def _final_tp():
    """(b) The tensor-parallel forward (parallel/tensor_parallel.py) of
    ViT-B/16 at bucket 64 on a 2x2 mesh and of ViT-L/16 at bucket 16 on
    1x2, every entry cuda:0, against the unsharded forward within 2e-4
    (JAX's tolerance); event and device ms of both."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.parallel.mesh import gather, grid_mesh
    from real_time_video_deepfake_detection_tpu_torch.parallel.tensor_parallel import (
        make_tp_forward)
    out = {}
    for name, b, shape in FINAL_TP:
        model = backbones.build_model(backbones.make(name),
                                      torch.Generator().manual_seed(SEED)).cuda().eval()
        x = torch.randn((b, 224, 224, 3), generator=torch.Generator().manual_seed(SEED + 4))
        x = x.cuda()
        fwd = make_tp_forward(grid_mesh(["cuda:0"] * (shape[0] * shape[1]), shape), model)

        def unsharded():
            with torch.no_grad():
                return model(x)

        want, got = unsharded(), gather(fwd(x))
        diff = float((got - want).abs().max())
        if not diff <= 2e-4:
            raise AssertionError(f"TP {name}: against the unsharded forward {diff} > 2e-4")
        timing = {}
        for label, fn in (("unsharded", unsharded), ("tp", lambda: fwd(x)),
                          ("tp", lambda: fwd(x)), ("unsharded", unsharded)):
            _, busy, acts, _ = profile_device(fn, 2)
            timing.setdefault(label, []).append({"event_ms": time_cuda(fn, n=5, warmup=1),
                                                 "device_ms": busy, "device_activities": acts})
        out[name] = {"bucket": b, "mesh": list(shape), "max_abs_diff": diff,
                     "tolerance": 2e-4, "timing": timing}
        del model, fwd, x
        torch.cuda.empty_cache()
    return out


def _big_jpegs(net):
    """{(h, w): [per stream, FINAL_FRAMES JPEGs]}: the capture frames of
    FINAL_STREAMS // 2 streams, each resized (cv2's INTER_LINEAR) to h x w
    and encoded at q85 (utils/jpeg_encode, cv2.imencode's stream)."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops.resize import resize_bilinear_u8_cv2
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_encode import encode_jpeg
    half = FINAL_STREAMS // 2
    _, frames = _capture_frames(half, FINAL_FRAMES, net)
    out = {}
    for h, w in FINAL_SIZES:
        out[(h, w)] = [[encode_jpeg(resize_bilinear_u8_cv2(torch.from_numpy(f), h, w).numpy(), 85)
                        for f in frames[s]] for s in range(half)]
    return out


def _final_digests():
    """(c1) Every accepted fixture at every scale M a size hint selects,
    reconstructed on the card: the digests of JAX's native libjpeg decode
    (tests/data/torch_jpeg/scaled_digests.json)."""
    import hashlib
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
        decode_coefs, reconstruct)
    with open(os.path.join(JPEG_DIR, "scaled_digests.json")) as fh:
        ref = json.load(fh)
    n = 0
    for name, scales in ref["files"].items():
        with open(os.path.join(JPEG_DIR, name), "rb") as fh:
            jc = decode_coefs(fh.read())
        for m, entry in scales.items():
            img = reconstruct([jc], "cuda", scale=int(m)).cpu().numpy()[0]
            if list(img.shape) != entry["shape"] or \
                    hashlib.sha256(img.tobytes()).hexdigest() != entry["sha256"]:
                raise AssertionError(f"scaled decode of {name} at M={m} differs from libjpeg's")
            n += 1
    return {"decodes_equal_to_libjpeg": n, "files": len(ref["files"]),
            "libjpeg_turbo": ref["libjpeg_turbo"]}


def _final_tick_parity(ctx, net_files, streams):
    """(c3) One bucket-16 tick of the JPEGs' first frames: the pooled scaled
    decode (frames_at) and the detect tick on the card against the CPU:
    frames byte for byte, outputs and states as detect-parity holds them."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.models import backbones
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.batcher import (
        init_stream_states, make_device_step_detect)
    from real_time_video_deepfake_detection_tpu_torch.state.tree import tree_leaves
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
        decode_coefs_batch, frames_at)
    cfg = _detect_cfg()
    coefs = decode_coefs_batch([s[0] for s in streams])
    b = len(coefs)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = backbones.build_model(backbones.make("b0")).eval()
        model.load_state_dict(backbone_state(ctx))
        step = make_device_step_detect(CaffeNet(*net_files).to(dev).eval(), model.to(dev), cfg)
        frames = frames_at(coefs, dev, (480, 640), scaled=True)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        slot_idx = torch.arange(b, dtype=torch.int32, device=dev)
        out, st = step(frames, active, slot_idx, init_stream_states(b + 1, cfg, dev))
        outs[dev] = (frames.cpu(), {k: v.cpu() for k, v in out.items()},
                     [t.cpu() for t in tree_leaves(st)])
    (fc, oc, sc), (fg, og, sg) = outs["cpu"], outs["cuda"]
    if not torch.equal(fc, fg):
        raise AssertionError(f"scaled decode: {int((fc != fg).sum())} bytes differ card/CPU")
    worst = 0.0
    pairs = [(k, oc[k], og[k]) for k in oc] + [(f"state{i}", a, g)
                                              for i, (a, g) in enumerate(zip(sc, sg))]
    for k, a, g in pairs:
        if a.dtype.is_floating_point:
            d = float((a - g).abs().max()) if a.numel() else 0.0
            worst = max(worst, d)
            if not d <= 1e-4:
                raise AssertionError(f"scaled tick {k}: max abs diff {d} > 1e-4")
        elif not torch.equal(a, g):
            raise AssertionError(f"scaled tick {k}: {int((a != g).sum())} integers differ")
    return {"bucket": b, "frames_equal": True, "max_float_diff": worst, "tolerance": 1e-4,
            "faces": int(oc["has_face"].sum())}


def _final_serve(ctx, net_files, streams, scaled):
    """(c2) create_batched_app over the device-detect engine (clahe_device)
    on 127.0.0.1, FINAL_STREAMS client threads each posting its
    FINAL_FRAMES JPEGs back to back, with or without ingest_scaled_decode:
    every answer 200 with the schema and frame_count, every kernel
    launched in the run, frames/s and the request p50/p99."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
        MultiStreamEngine, create_batched_app)
    scfg = ServerConfig(max_streams=64, max_batch=64, device_detect=True,
                        ingest_scaled_decode=scaled)
    engine = MultiStreamEngine(_detect_cfg(), scfg, params=backbone_state(ctx), device="cuda",
                               ssd_net=CaffeNet(*net_files))
    results = {s: [] for s in range(len(streams))}
    lat, errors = [], []
    op = _client()
    with _serving(create_batched_app(engine, scfg)) as url:
        def client(s):
            try:
                for jpeg in streams[s]:
                    st, r, sec = _http(op, url + "/analyze", jpeg, sid=f"stream-{s}")
                    results[s].append((st, r))
                    lat.append(sec * 1e3)
            except Exception as e:   # reported below; the phase fails on it
                errors.append(f"stream {s}: {type(e).__name__}: {e}")

        _reset_launches()
        t0 = time.time()
        threads = [threading.Thread(target=client, args=(s,)) for s in range(len(streams))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.time() - t0
        launches = _read_launches()
    engine.shutdown()
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"clients failed: {errors[:3]}")
    problems = [f"stream {s} frame {t}: {st} {r}" for s, rs in results.items()
                for t, (st, r) in enumerate(rs)
                if st != 200 or _SCHEMA - set(r) or r.get("frame_count") != t + 1]
    problems += [f"kernel {k} was not launched" for k, n in launches.items() if n <= 0]
    if problems:
        raise AssertionError("scaled serve: " + "; ".join(problems[:6]))
    n = sum(len(rs) for rs in results.values())
    return {"scaled_decode": scaled, "requests": n, "frames_per_s": n / wall, "wall_s": wall,
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)), "launches": launches,
            "frames_with_face": sum("face_bbox" in r for rs in results.values() for _, r in rs),
            "ewma_host_prep_ms": engine.metrics["ewma_host_prep_ms"],
            "ticks": engine.metrics["ticks"]}


def _final_scaled(ctx):
    """(c) The DCT-scaled decode: the card against libjpeg's digests; the
    scaled detect tick card against CPU; device-detect serving of 1080p
    and 1440p JPEGs with and then without it; the bench's pooled
    decode at one thread, exact against fast1, for each size."""
    from real_time_video_deepfake_detection_tpu_torch.cli.bench import bench_prep_scaling
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.ops.jpeg_scaled import pick_scale
    digests = _final_digests()
    net_files = _ssd_files(ctx)
    big = _big_jpegs(CaffeNet(*net_files).cuda().eval())
    streams = [s for size in FINAL_SIZES for s in big[size]]
    scales = {f"{h}x{w}": pick_scale(h, w, 2 * 640) for h, w in FINAL_SIZES}
    parity = _final_tick_parity(ctx, net_files, streams)
    serve = [_final_serve(ctx, net_files, streams, scaled) for scaled in (True, False)]
    ctx["final_launches"] = serve[0]["launches"]
    prep = {f"{h}x{w}": bench_prep_scaling(
                n=FINAL_STREAMS, threads=(1,), repeats=3, device="cuda",
                jpegs=[j for s in big[(h, w)] for j in s], hw=(480, 640))
            for h, w in FINAL_SIZES}
    return {"scales_at_capture_480x640": scales, "digests": digests, "tick_parity": parity,
            "serve_scaled_then_full": serve, "prep_scaling_ms": prep}


def _flat_tensors(tree, prefix=""):
    """{path: tensor} of the tensors of a nested state dict."""
    import torch
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        return _flat_tensors(dict(enumerate(tree)), prefix)
    return {prefix[:-1]: tree} if isinstance(tree, torch.Tensor) else {}


def _dcp_rank(device, crops, ckdir):
    """One rank of (d): one data-parallel fused step of full-size B0 on its
    shard, save_checkpoint_dcp, a state of other weights restored onto a
    template of the live one (equal to it, every tensor of the train state
    bit for bit), then one more step of both. The step runs with torch's
    deterministic algorithms, so that two runs of it from equal states can
    be held to each other bit for bit."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as P
    from real_time_video_deepfake_detection_tpu_torch.train import checkpoint as CK
    from real_time_video_deepfake_detection_tpu_torch.train import steps
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    state = _dp_state(device)
    b = DP_BATCH // P.world_size()
    rows = slice(P.rank() * b, (P.rank() + 1) * b)
    imgs = torch.from_numpy(crops[rows]).to(device)
    labels = torch.tensor([0.0, 1.0] * (DP_BATCH // 2))[rows].to(device)
    step = steps.make_sharded_train_step(steps.fused_train_step)
    step(state, imgs, labels)
    saved_rng = state.gen_host.get_state()
    t0 = time.perf_counter()
    CK.save_checkpoint_dcp(ckdir, state.state_dict(), {"step": 1}, saved_rng)
    save_s = time.perf_counter() - t0
    restored = _dp_state(device, seed=SEED + 7)
    t0 = time.perf_counter()
    sd, meta, rng = CK.load_checkpoint_dcp(ckdir, CK.template_like(state.state_dict()))
    restored.load_state_dict(sd)
    load_s = time.perf_counter() - t0

    def differing():
        a, b_ = _flat_tensors(state.state_dict()), _flat_tensors(restored.state_dict())
        return sorted(k for k in a if k not in b_ or not torch.equal(a[k], b_[k]))

    before = differing()
    n_tensors = len(_flat_tensors(state.state_dict()))
    m_live = {k: float(v) for k, v in step(state, imgs, labels).items()}
    m_rest = {k: float(v) for k, v in step(restored, imgs, labels).items()}
    after = differing()
    return {"rank": P.rank(), "metrics_live": m_live, "metrics_restored": m_rest,
            "train_state_tensors": n_tensors, "differing_after_restore": before[:8],
            "differing_after_next_step": after[:8], "meta": meta,
            "rng_restored": bool(torch.equal(rng, saved_rng)),
            "save_s": save_s, "load_s": load_s,
            "files": sorted(os.listdir(os.path.join(ckdir, "state")))}


def _final_checkpoint():
    """(d) The JAX dry run's section 1b on 2 gloo ranks of cuda:0: the
    resumed step equals the uninterrupted one bit for bit."""
    from real_time_video_deepfake_detection_tpu_torch.parallel import mesh as P
    crops = _train_crops(DP_BATCH, 244, SEED)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_dcp_")
    try:
        threads = max(1, (os.cpu_count() or 2) // len(SHARD_MESH))
        t0 = time.time()
        ranks = P.spawn(_dcp_rank, list(SHARD_MESH), args=(crops, os.path.join(ckdir, "ck")),
                        backend="gloo", timeout=600, num_threads=threads)
        spawn_s = time.time() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    for r in ranks:
        if r["differing_after_restore"] or r["differing_after_next_step"] \
                or r["metrics_live"] != r["metrics_restored"] \
                or r["meta"] != {"step": 1} or not r["rng_restored"]:
            raise AssertionError(f"dcp: rank {r['rank']} resumed differently: {r}")
    return {"ranks": ranks, "backend": "gloo", "global_batch": DP_BATCH,
            "spawn_and_run_seconds": spawn_s}


def _final_fetchers():
    """(e) cli/fetch_weights --list and --dry-run: nothing is fetched."""
    import io
    from real_time_video_deepfake_detection_tpu_torch.cli import fetch_weights
    out = {}
    dest = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    try:
        for label, argv in (("list", ["--list"]), ("dry_run", ["--dry-run", "--dest", dest])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                fetch_weights.main(argv)
            out[label] = buf.getvalue().splitlines()
        if os.listdir(dest):
            raise AssertionError(f"--dry-run wrote {os.listdir(dest)}")
    finally:
        shutil.rmtree(dest, ignore_errors=True)
    if len(out["list"]) != 7 or any("would fetch" not in line and "[skip]" not in line
                                    for line in out["dry_run"]):
        raise AssertionError(f"fetch_weights: {out}")
    return out


def phase_final(ctx):
    """The last modules: (a) the blockwise clip head, (b) the
    tensor-parallel ViT, (c) the DCT-scaled decode, (d) the sharded-state
    checkpoint, (e) the fetchers; each part's dict on a line of its own as
    it ends."""
    seconds = {}
    for key, fn in (("blockwise_head", _final_blockwise), ("tensor_parallel", _final_tp),
                    ("scaled_decode", lambda: _final_scaled(ctx)),
                    ("dcp_checkpoint", _final_checkpoint), ("fetchers", _final_fetchers)):
        t0 = time.time()
        info = fn()
        seconds[key] = time.time() - t0
        emit({"final_part": key, "seconds": seconds[key], "card": ctx["smi"], **info})
    return {"card": ctx["smi"], "part_seconds": seconds}


# ---------------------------------------------------------------- formats

FORMATS_DIR = os.path.join(REPO, "tests", "data", "torch_formats")
# one input per route and layout, for the apps: progressive, 4:1:1, 4:4:0,
# RGB, CMYK and YCCK JPEGs, an EXIF orientation, PNGs and BMPs, a baseline
# and a progressive stream cut inside their scans (libjpeg pads them, and
# block-smooths the progressive one), and a stream cut inside its headers,
# which both routes refuse
# (and from tests/data/torch_jpeg_modes) arithmetic-coded sequential,
# progressive, CMYK, DAC-conditioned and cut streams, lossless RGB frames
# (one subsampled), and a gray lossless and a 12-bit frame, which both
# routes refuse as JAX's do
FORMAT_APP_INPUTS = (
    "prog_420_83x41.jpg", "prog_420_640x480.jpg", "s411_83x41.jpg", "s440_83x41.jpg",
    "rgb_adobe_83x41.jpg", "cmyk_83x41.jpg", "ycck_83x41.jpg", "exif6_83x41.jpg",
    "png_rgb16_83x41.png", "png_adam7_palette2_83x41.png", "bmp_rle8_83x41.bmp",
    "bmp32_83x41.bmp", "base_420_83x41.jpg@649", "prog_420_83x41.jpg@272",
    "base_420_83x41.jpg@304", "arith_seq_720x405_420.jpg", "arith_prog_s411_83x41.jpg",
    "arith_seq_cmyk_83x41.jpg", "arith_prog_dac_s444_319x241.jpg",
    "arith_prog_420_83x41.jpg@537", "lossless_rgb_p5_83x41.jpg",
    "lossless_sub_2x2_rgb_83x41.jpg", "lossless_gray_p1_83x41.jpg",
    "bits12_sof1_rgb_83x41.jpg")
# (and from tests/data/torch_image_formats) PxM, PAM, PFM (the gray one
# cv2 returns with one channel), Sun raster, Radiance HDR and GIF, with a
# run-length Sun raster, an XYZE file and a GIF index past its palette,
# which both routes refuse
IMAGE_FORMATS_DIR = os.path.join(REPO, "tests", "data", "torch_image_formats")
IMAGE_FORMAT_APP_INPUTS = (
    "p1_ascii_83x41.pbm", "p2_comment_maxval100_83x41.pgm", "p6_16bit_83x41.ppm",
    "pam_blackandwhite_83x41.pam", "pfm_bigendian_scale2_83x41.pfm", "pfm_gray_83x41.pfm",
    "ras8_colormap_83x41.ras", "ras32_83x41.ras", "hdr_rle_cv2_83x41.hdr",
    "gif_transparent_offset_83x41.gif", "gif_interlaced_83x41.gif",
    "ras_rle_refused_83x41.ras", "hdr_xyze_refused_83x41.hdr",
    "gif_index_past_palette_refused_83x41.gif")
FORMAT_APP_INPUTS += IMAGE_FORMAT_APP_INPUTS
# (and from tests/data/torch_tiff_webp) TIFF (LZW with the predictor, JPEG
# with YCbCr, an orientation-6 tiled file) and WebP (lossless, lossy, lossy
# with alpha, animated), with a TIFF and a WebP both routes refuse
TIFF_WEBP_DIR = os.path.join(REPO, "tests", "data", "torch_tiff_webp")
TIFF_WEBP_APP_INPUTS = (
    "tiff_cv2_lzw_pred_83x41.tif", "tiff_jpeg_ycbcr420_83x41.tif",
    "tiff_orientation6_tiles_83x41.tif", "webp_cv2_lossless_83x41.webp",
    "webp_cv2_q50_83x41.webp", "webp_cv2_bgra_q80_83x41.webp",
    "webp_cv2_animation_q60_83x41.webp", "tiff_zstd_refused_83x41.tif",
    "webp_alph_damaged_refused_83x41.webp")
FORMAT_APP_INPUTS += TIFF_WEBP_APP_INPUTS
# (and from tests/data/torch_jpeg2000) JPEG 2000: cv2's reversible and
# lossy JP2, a lossy layered raw codestream, a palette, sYCC, every
# code-block style, and a cut file and an HTJ2K one, which both routes refuse
JPEG2000_DIR = os.path.join(REPO, "tests", "data", "torch_jpeg2000")
JPEG2000_APP_INPUTS = (
    "j2k_cv2_q1000_83x41.jp2", "j2k_cv2_q100_83x41.jp2", "j2k_pil_raw_lossy_layers_83x41.j2k",
    "j2k_box_pclr_rgb_83x41.jp2", "j2k_box_colr_sycc_83x41.jp2",
    "j2k_opj_style_all_lossy_83x41.j2k", "j2k_cut_60_refused_83x41.j2k",
    "j2k_htj2k_cblk_style_83x41.j2k")
FORMAT_APP_INPUTS += JPEG2000_APP_INPUTS
JPEG2000_APP_REFUSED = ("j2k_cut_60_refused_83x41.j2k", "j2k_htj2k_cblk_style_83x41.j2k")
FORMAT_APP_REFUSED = ("base_420_83x41.jpg@304", "lossless_gray_p1_83x41.jpg",
                      "bits12_sof1_rgb_83x41.jpg", "ras_rle_refused_83x41.ras",
                      "hdr_xyze_refused_83x41.hdr", "gif_index_past_palette_refused_83x41.gif",
                      "tiff_zstd_refused_83x41.tif", "webp_alph_damaged_refused_83x41.webp"
                      ) + JPEG2000_APP_REFUSED
FORMAT_LOADER_INPUTS = ("prog_420_83x41.jpg", "exif6_83x41.jpg", "exif3_83x41.jpg",
                        "png_rgb8_83x41.png", "png_exif6_83x41.png", "cmyk_83x41.jpg",
                        "s411_83x41.jpg", "png_adam7_rgb16_83x41.png",
                        "arith_prog_s411_83x41.jpg", "arith_seq_cmyk_83x41.jpg",
                        "lossless_rgb_p2_83x41.jpg", "lossless_sub_2x1_rgb_83x41.jpg")
# image files the loader reads by content under a .png name, as cv2.imread does
FORMAT_LOADER_MISNAMED = ("p6_83x41.ppm", "gif_cv2_83x41.gif", "ras24_cv2_83x41.ras",
                          "hdr_rle_cv2_83x41.hdr", "pam_rgb_cv2_83x41.pam",
                          "tiff_cv2_lzw_pred_83x41.tif", "tiff_ycbcr42_83x41.tif",
                          "webp_cv2_lossless_83x41.webp", "webp_cv2_bgra_q80_83x41.webp",
                          "j2k_cv2_q1000_83x41.jp2", "j2k_pil_raw_lossy_layers_83x41.j2k",
                          "j2k_box_cdef_reversed_83x41.jp2")


def _format_inputs(directory=FORMATS_DIR):
    """({key: bytes}, digests) of tests/data/torch_formats (or another
    fixture directory with a digests.json of its inputs): "<file>@<n>" is
    the first n bytes of <file>."""
    with open(os.path.join(directory, "digests.json")) as fh:
        digests = json.load(fh)["inputs"]
    files, out = {}, {}
    for key in digests:
        name, _, cut = key.partition("@")
        if name not in files:
            with open(os.path.join(directory, name), "rb") as fh:
                files[name] = fh.read()
        out[key] = files[name][:int(cut)] if cut else files[name]
    return out, digests


def _sha(img) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()


def _matches(img, want) -> bool:
    if want is None or img is None:
        return want is None and img is None
    return list(img.shape) == want["shape"] and _sha(img) == want["sha256"]


def _formats_on_card(inputs, digests):
    """(a) Every input on each route, the reconstruction on the card: the
    libjpeg route at full size and at every M a hint selects against the
    JAX package's libjpeg digests; the cv2 route (JPEG reconstructed on the
    card and turned by its EXIF orientation; PNG and BMP on the host)
    against cv2.imdecode's."""
    from real_time_video_deepfake_detection_tpu_torch.utils import exif
    from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    problems, decodes = [], 0
    for key, e in sorted(digests.items()):
        data = inputs[key]
        if e["native"] is not None:
            jc = J.decode_coefs(data, "native")
            for m, want in [("8", e["native"])] + sorted(e["scaled"].items()):
                got = J.reconstruct([jc], "cuda", scale=int(m))[0].cpu().numpy()
                decodes += 1
                if not _matches(got, want):
                    problems.append(f"{key} native M={m}")
        elif data[:2] == b"\xff\xd8" and ID.native_route(data) is not None:
            problems.append(f"{key}: the libjpeg route decodes what JAX's refuses")
        if data.startswith(ID.JPEG_SIGNATURE):
            try:
                jc = J.decode_coefs(data, "cv2")
            except J.JpegError as err:   # a lossless frame decodes on the host
                got = ID.cv2_route(data) if err.status == J.LOSSLESS else None
            else:
                got = exif.apply_orientation(J.reconstruct([jc], "cuda")[0],
                                             exif.jpeg_orientation(data)).cpu().numpy()
        else:
            got = ID.cv2_route(data)
        decodes += 1
        if not _matches(got, e["cv2"]):
            problems.append(f"{key} cv2 route")
    if problems:
        raise AssertionError("formats on the card: " + "; ".join(problems[:8]))
    return {"inputs": len(digests), "decodes_checked": decodes,
            "smoothed_inputs": sorted(k for k, e in digests.items() if e["smoothed"])}


def _image_formats_on_card(inputs, digests):
    """(a) Every fixture of tests/data/torch_image_formats through the cv2
    route (utils/pxm, sunras, hdr, gif: host decoders, csrc/image_host.cpp)
    against cv2.imdecode's digest, the frame carried to the card and back
    unchanged; host ms of each family's fixture."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
    problems, ms = [], {}
    for key, e in sorted(digests.items()):
        t = time.perf_counter()
        got = ID.cv2_route(inputs[key])
        ms[key] = (time.perf_counter() - t) * 1e3
        if got is not None:
            got = torch.from_numpy(got).cuda().cpu().numpy()
        if not _matches(got, e["cv2"]):
            problems.append(key)
    if problems:
        raise AssertionError("image formats on the card: " + "; ".join(problems[:8]))
    return {"inputs": len(digests), "refused": sorted(k for k, e in digests.items()
                                                      if e["cv2"] is None),
            "host_ms_first_decode": ms}


def _tiff_webp_on_card(inputs, digests):
    """(a) Every fixture of tests/data/torch_tiff_webp through the cv2
    route (utils/tiff.py, csrc/tiff.cpp, the port's JPEG decoder for
    JPEG-in-TIFF; utils/webp.py, csrc/webp_lossless.cpp, csrc/vp8.cpp)
    against cv2.imdecode's digest, the frame carried to the card and back
    unchanged; the fixtures cv2 reads and the port refuses by name refused
    with their reason; host ms of each fixture's first decode (the
    libraries built on first use)."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
    from real_time_video_deepfake_detection_tpu_torch.utils import tiff
    problems, ms = [], {}
    for key, e in sorted(digests.items()):
        data = inputs[key]
        if "not_ported" in e:
            try:
                tiff.decode_tiff(data)
                problems.append(f"{key}: decoded, not refused by name")
            except tiff.NotPorted as err:
                if e["not_ported"] not in str(err):
                    problems.append(f"{key}: {err}")
            continue
        t = time.perf_counter()
        got = ID.cv2_route(data)
        ms[key] = (time.perf_counter() - t) * 1e3
        if got is not None:
            got = torch.from_numpy(got).cuda().cpu().numpy()
        if not _matches(got, e["cv2"]):
            problems.append(key)
    if problems:
        raise AssertionError("TIFF and WebP on the card: " + "; ".join(problems[:8]))
    return {"inputs": len(digests),
            "refused": sorted(k for k, e in digests.items() if e["cv2"] is None),
            "refused_by_name": sorted(k for k, e in digests.items() if "not_ported" in e),
            "host_ms_first_decode": ms}


def _tiff_webp_timing(inputs):
    """(e) Host ms (median of 10) of the decode of a lossy WebP (quality 80,
    committed) and of an LZW TIFF with the predictor (as cv2 writes one,
    built here from the same frame: tests/torch_tiff_webp_writers.lzw_tiff)
    of the 720x405 and 1920x1080 JPEG fixture frames; the TIFF decode is
    held to the frame it was built from."""
    import numpy as np
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    from real_time_video_deepfake_detection_tpu_torch.utils.tiff import decode_tiff
    from real_time_video_deepfake_detection_tpu_torch.utils.webp import decode_webp
    sys.path.insert(0, REPO)
    from tests.torch_tiff_webp_writers import lzw_tiff

    def host_ms(fn, n=10):
        fn()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    with open(os.path.join(JPEG_DIR, FRAME_JPEG), "rb") as fh:
        frames = {"720x405": J.decode_jpeg(fh.read())}
    frames["1920x1080"] = J.decode_jpeg(inputs["prog_420_1920x1080.jpg"])
    out = {}
    for label, bgr in frames.items():
        webp_bytes = inputs[f"webp_timing_q80_{label}.webp"]
        tiff_bytes = lzw_tiff(np.ascontiguousarray(bgr[..., ::-1]))
        if not np.array_equal(decode_tiff(tiff_bytes), bgr):
            raise AssertionError(f"the {label} LZW TIFF does not decode to its frame")
        out[label] = {"webp_lossy_ms": host_ms(lambda: decode_webp(webp_bytes)),
                      "tiff_lzw_ms": host_ms(lambda: decode_tiff(tiff_bytes)),
                      "bytes": {"webp_lossy": len(webp_bytes), "tiff_lzw": len(tiff_bytes)}}
    return out


def _jpeg2000_on_card(inputs, digests):
    """(a) Every fixture of tests/data/torch_jpeg2000 through the cv2 route
    (utils/jpeg2000.py, csrc/jpeg2000.cpp) against cv2.imdecode's digest,
    the frame carried to the card and back unchanged; the fixtures refused
    by name refused with their reason; host ms of each fixture's first
    decode (the library built on first use)."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.utils import image_decode as ID
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg2000
    problems, ms = [], {}
    for key, e in sorted(digests.items()):
        data = inputs[key]
        if "not_ported" in e:
            try:
                jpeg2000.decode_jpeg2000(data)
                problems.append(f"{key}: decoded, not refused by name")
            except jpeg2000.NotPorted as err:
                if e["not_ported"] not in str(err):
                    problems.append(f"{key}: {err}")
            continue
        t = time.perf_counter()
        got = ID.cv2_route(data)
        ms[key] = (time.perf_counter() - t) * 1e3
        if got is not None:
            got = torch.from_numpy(got).cuda().cpu().numpy()
        if not _matches(got, e["cv2"]):
            problems.append(key)
    if problems:
        raise AssertionError("JPEG 2000 on the card: " + "; ".join(problems[:8]))
    return {"inputs": len(digests),
            "refused": sorted(k for k, e in digests.items() if e["cv2"] is None),
            "refused_by_name": sorted(k for k, e in digests.items() if "not_ported" in e),
            "host_ms_first_decode": ms}


def _jpeg2000_host_prep(ctx, inputs):
    """(b) The batched host-prep app (heuristic faces, the preproc and hue
    kernels, clahe_device; full-size B0) on the card, on 127.0.0.1: every
    input of JPEG2000_APP_INPUTS on a stream of its own, the refused ones
    a 400 and the others a verdict, one launch of each kernel in each
    frame tick (the launches counted from 0). The device-detect app of
    _formats_http holds the same inputs' responses to the CPU's."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import (
        DetectorConfig, ServerConfig)
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
        MultiStreamEngine, create_batched_app)
    scfg = ServerConfig(max_streams=16, max_batch=8)
    cfg = DetectorConfig(use_pallas_preproc=True, use_pallas_color=True, clahe_device=True,
                         face_backend="heuristic")
    card = MultiStreamEngine(cfg, scfg, params=backbone_state(ctx), device="cuda")
    tick_launches, frames_per_tick = [], []
    dispatch = card._dispatch

    def counted_dispatch(tick_cfg, arrays, states):
        before = _read_launches()
        out = dispatch(tick_cfg, arrays, states)
        torch.cuda.synchronize()
        after = _read_launches()
        tick_launches.append({k: after[k] - before[k] for k in after})
        frames_per_tick.append(int(arrays[4].sum()))
        return out

    card._dispatch = counted_dispatch
    op = _client()
    got, problems = {}, []
    try:
        with _serving(create_batched_app(card, scfg)) as url_card:
            _reset_launches()
            for i, key in enumerate(JPEG2000_APP_INPUTS):
                got[key] = _http(op, url_card + "/analyze", inputs[key], sid=f"j{i}")[:2]
            launches = _read_launches()
    finally:
        card.shutdown()
    statuses = {k: st for k, (st, _) in got.items()}
    if {k for k, st in statuses.items() if st != 200} != set(JPEG2000_APP_REFUSED):
        problems.append(f"statuses {statuses}")
    for k, (st, body) in got.items():
        if st == 200 and not isinstance(body.get("fake_probability"), float):
            problems.append(f"{k}: no verdict: {sorted(body)}")
    for i, (tl, n) in enumerate(zip(tick_launches, frames_per_tick)):
        if any(v != 1 for v in tl.values()):
            problems.append(f"tick {i} ({n} frames): not one launch of each kernel: {tl}")
    if not tick_launches:
        problems.append("no tick ran")
    if problems:
        raise AssertionError("JPEG 2000 host prep: " + "; ".join(problems[:8]))
    return {"inputs": list(JPEG2000_APP_INPUTS), "statuses": statuses,
            "ticks": len(tick_launches), "frames_per_tick": frames_per_tick,
            "launches": launches, "launches_per_tick": tick_launches}


def _jpeg2000_timing(inputs, digests):
    """(e) Host ms (median of 5 at 720x405, of 3 at 1920x1080) of the
    decode of a reversible and a lossy (cv2's compression 100) JP2 of the
    JPEG fixture frames, each decode held to its digest."""
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg2000 import decode_jpeg2000

    def host_ms(fn, n):
        fn()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    out = {}
    for label, n in (("720x405", 5), ("1920x1080", 3)):
        row = {}
        for kind in ("lossless", "q100"):
            key = f"j2k_timing_{kind}_{label}.jp2"
            data = inputs[key]
            if not _matches(decode_jpeg2000(data), digests[key]["cv2"]):
                raise AssertionError(f"{key} differs from its digest")
            row[f"{kind}_ms"] = host_ms(lambda: decode_jpeg2000(data), n)
            row[f"{kind}_bytes"] = len(data)
        out[label] = row
    return out


def _formats_http(ctx, inputs):
    """(b) The batched device-detect app (as detect-serve, full-size B0) on
    the card and on the CPU, each on 127.0.0.1: every input of
    FORMAT_APP_INPUTS on a stream of its own; the launches of the card's
    ticks counted from 0. (c) The coef wire plane on the card: the
    progressive capture-size stream and a cut of it go through the wire,
    the whole one answering as the bgr plane answers it (the cut one
    carries libjpeg's coefficients, which are not block-smoothed, as the
    JAX package's plane carries them)."""
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.models.caffe_net import CaffeNet
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import (
        MultiStreamEngine, create_batched_app)
    import torch
    proto, cm = _ssd_files(ctx)
    scfg = ServerConfig(max_streams=48, max_batch=8, device_detect=True)

    def engine(device, cfg=scfg):
        return MultiStreamEngine(_detect_cfg(), cfg, params=backbone_state(ctx), device=device,
                                 ssd_net=CaffeNet(proto, cm))

    card, cpu = engine("cuda"), engine("cpu")
    tick_launches = []
    dispatch = card._dispatch

    def counted_dispatch(tick_cfg, arrays, states):
        before = _read_launches()
        out = dispatch(tick_cfg, arrays, states)
        torch.cuda.synchronize()
        after = _read_launches()
        tick_launches.append({k: after[k] - before[k] for k in after})
        return out

    card._dispatch = counted_dispatch
    op = _client()
    got, problems, max_diff = {}, [], 0.0
    try:
        with _serving(create_batched_app(card, scfg)) as url_card, \
                _serving(create_batched_app(cpu, scfg)) as url_cpu:
            _reset_launches()
            for i, key in enumerate(FORMAT_APP_INPUTS):
                got[key] = _http(op, url_card + "/analyze", inputs[key], sid=f"f{i}")[:2]
            launches = _read_launches()
            for i, key in enumerate(FORMAT_APP_INPUTS):
                want = _http(op, url_cpu + "/analyze", inputs[key], sid=f"f{i}")[:2]
                diff = _response_diff(got[key], want, key, tol=1e-3)
                max_diff = max(max_diff, diff[0])
                problems += diff[1]
            wire = _formats_wire(engine, op, url_card, inputs)
    finally:
        card.shutdown()
        cpu.shutdown()
    statuses = {k: st for k, (st, _) in got.items()}
    if {k for k, st in statuses.items() if st != 200} != set(FORMAT_APP_REFUSED) or \
            any(statuses[k] != 400 for k in FORMAT_APP_REFUSED):
        problems.append(f"statuses {statuses}")
    for i, tl in enumerate(tick_launches):
        if min(tl.values()) <= 0:
            problems.append(f"tick {i}: a kernel was not launched: {tl}")
    if problems:
        raise AssertionError("formats http: " + "; ".join(problems[:8]))
    ctx["formats_launches"] = launches
    return {"inputs": list(FORMAT_APP_INPUTS), "statuses": statuses,
            "card_vs_cpu_max_float_diff": max_diff, "float_tolerance": 1e-3,
            "ticks": len(tick_launches), "launches": launches,
            "launches_per_tick": tick_launches, "coef_plane": wire}


def _response_diff(got, want, what, tol):
    """(largest float difference, problems) between two (status, body)
    responses: the same status and keys, strings and integers equal, a
    face box within 1 px, floats within `tol`."""
    (st_g, g), (st_w, w) = got, want
    if st_g != st_w or set(g) != set(w):
        return 0.0, [f"{what}: {st_g} {sorted(g)} vs {st_w} {sorted(w)}"]
    worst, problems = 0.0, []
    for k in set(w) - {"processing_time_ms", "device"}:
        a, b = g[k], w[k]
        if isinstance(b, float):
            worst = max(worst, abs(a - b))
            if abs(a - b) > tol:
                problems.append(f"{what} {k}: {a} vs {b}")
        elif k == "face_bbox" and isinstance(b, dict):
            if set(a) != set(b) or max(abs(a[q] - b[q]) for q in b) > 1:
                problems.append(f"{what} {k}: {a} vs {b}")
        elif a != b:
            problems.append(f"{what} {k}: {a} vs {b}")
    return worst, problems


def _formats_wire(engine, op, url_bgr, inputs):
    """(c) of _formats_http, beside the bgr engine at `url_bgr`."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.core.config import ServerConfig
    from real_time_video_deepfake_detection_tpu_torch.ops.jpeg_decode import bgr_from_coefs_420
    from real_time_video_deepfake_detection_tpu_torch.serving.multi import create_batched_app
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    full = inputs["prog_420_640x480.jpg"]
    sos = [i for i in range(len(full) - 1) if full[i:i + 2] == b"\xff\xda"]
    streams = {"progressive": full, "progressive_cut": full[:(sos[2] + sos[3]) // 2],
               "arithmetic": inputs["arith_seq_640x480_420.jpg"]}
    # the plane's reconstruction on the card equals the libjpeg decode
    cy, cc, qt, ok = J.decode_coefs_wire_batch([full], 480, 640)
    frame = bgr_from_coefs_420(torch.from_numpy(cy).cuda(), torch.from_numpy(cc).cuda(),
                               torch.from_numpy(qt.astype("int32")).cuda(), 480, 640)[0]
    with open(os.path.join(FORMATS_DIR, "digests.json")) as fh:
        want = json.load(fh)["inputs"]["prog_420_640x480.jpg"]["native"]
    if not (ok.all() and _matches(frame.cpu().numpy(), want)):
        raise AssertionError("the coef plane of the progressive stream differs on the card")
    wcfg = ServerConfig(max_streams=8, max_batch=8, device_detect=True, ingest_plane="coef")
    eng = engine("cuda", wcfg)
    rows = []
    dispatch = eng._dispatch_wire
    eng._dispatch_wire = lambda cfg, arrays, states: (
        rows.append(int(arrays[-2].sum())) or dispatch(cfg, arrays, states))
    problems, out = [], {}
    try:
        with _serving(create_batched_app(eng, wcfg)) as url:
            for name, data in streams.items():
                a = _http(op, url + "/analyze", data, sid=f"w-{name}")[:2]
                out[name] = a[0]
                if name != "progressive_cut":   # it carries libjpeg's unsmoothed coefficients
                    b = _http(op, url_bgr + "/analyze", data, sid=f"w-{name}")[:2]
                    problems += _response_diff(a, b, name, tol=1e-6)[1]
    finally:
        eng.shutdown()
    if problems or rows != [1] * len(streams) or set(out.values()) != {200}:
        raise AssertionError(f"coef plane: wire rows {rows}; " + "; ".join(problems[:4]))
    return {"statuses": out, "wire_rows": rows, "reconstruction_equals_digest": True}


def _formats_loader(inputs, digests):
    """(d) The training loader on the card over a dataset of the mixed
    inputs (progressive and EXIF-rotated JPEGs, CMYK, PNGs): each image
    against cv2's decode (the digest) resized on the host."""
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops.resize import resize_bilinear_u8_cv2
    from real_time_video_deepfake_detection_tpu_torch.train import data as TD
    from real_time_video_deepfake_detection_tpu_torch.utils.image_decode import cv2_route
    root = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    try:
        source = {}   # the name in the dataset -> the fixture
        for i, name in enumerate(FORMAT_LOADER_INPUTS + FORMAT_LOADER_MISNAMED):
            d = os.path.join(root, "val", ("real", "fake")[i % 2])
            os.makedirs(d, exist_ok=True)
            src = os.path.join(FORMATS_DIR, name)
            for other in (JPEG_MODES_DIR, IMAGE_FORMATS_DIR, TIFF_WEBP_DIR, JPEG2000_DIR):
                if not os.path.exists(src):
                    src = os.path.join(other, name)
            as_name = name if name in FORMAT_LOADER_INPUTS else name.rsplit(".", 1)[0] + ".png"
            source[as_name] = name
            shutil.copy(src, os.path.join(d, as_name))
        ds = TD.DeepfakeDataset(root, "val", 224)
        loader = TD.BatchLoader(ds, 4, shuffle=False, drop_last=False, num_workers=4,
                                device="cuda")
        batches = [x for x, _ in loader]
        got = torch.cat(batches).cpu()
        for k, (path, _) in enumerate(ds.samples):
            name = source[os.path.basename(path)]
            frame = cv2_route(inputs[name], from_file=True)
            if not _matches(frame, digests[name]["cv2"]):
                raise AssertionError(f"{path}: the host decode differs from cv2's")
            want = resize_bilinear_u8_cv2(torch.from_numpy(frame)[None], 224, 224,
                                          cv2_rows=True).flip(-1)[0]
            if not torch.equal(got[k], want):
                raise AssertionError(f"{path}: the loader's image on the card differs")
        return {"images": len(ds), "batches": len(batches), "device": str(batches[0].device),
                "misnamed_png": sorted(k for k, v in source.items() if k != v)}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _png_bytes(bgr) -> bytes:
    """An 8-bit RGB PNG of `bgr` (filter None, zlib level 6)."""
    import struct
    import zlib
    h, w = bgr.shape[:2]
    raw = b"".join(b"\0" + row.tobytes() for row in bgr[..., ::-1])

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _formats_timing(inputs):
    """(e) Host ms of the entropy decode of progressive against baseline
    streams of one picture at 720x405 (the committed pair) and 1920x1080
    (the progressive fixture and its decode re-encoded baseline at q85);
    device ms of the 4:1:1 reconstruction of 16 640x480 streams on the
    card; host ms of the PNG decode at 720x405."""
    import numpy as np
    import torch
    from real_time_video_deepfake_detection_tpu_torch.ops.jpeg_decode import bgr_from_components
    from real_time_video_deepfake_detection_tpu_torch.utils import jpeg_ingest as J
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_encode import encode_jpeg
    from real_time_video_deepfake_detection_tpu_torch.utils.png import decode_png

    def host_ms(fn, n=20):
        fn()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    with open(os.path.join(JPEG_DIR, "progressive_720x405_q85.jpg"), "rb") as fh:
        prog720 = fh.read()
    with open(os.path.join(JPEG_DIR, FRAME_JPEG), "rb") as fh:
        base720 = fh.read()
    prog1080 = inputs["prog_420_1920x1080.jpg"]
    frame1080 = J.decode_jpeg(prog1080)
    base1080 = encode_jpeg(frame1080, 85)
    out = {}
    for label, prog, base in (("720x405", prog720, base720), ("1920x1080", prog1080, base1080)):
        out[f"entropy_host_ms_{label}"] = {
            "progressive": host_ms(lambda: J.decode_coefs(prog)),
            "baseline": host_ms(lambda: J.decode_coefs(base)),
            "bytes": {"progressive": len(prog), "baseline": len(base)}}
    group = J.decode_coefs_batch([inputs["s411_640x480.jpg"]] * 16)
    jc = group[0]
    coefs = [torch.from_numpy(np.stack([g.coefs[c] for g in group])).cuda() for c in range(3)]
    qtabs = torch.from_numpy(np.stack([g.qtabs.astype("int32") for g in group])).cuda()

    def rec():
        return bgr_from_components(coefs, qtabs, jc.factors, jc.height, jc.width, color=jc.color)

    wall, busy, acts, top = profile_device(rec, 20)
    out["s411_640x480_reconstruct_bucket16"] = {
        "factors": jc.factors, "event_ms": time_cuda(rec, n=20), "device_ms": busy,
        "device_activities": acts, "top": top[:4]}
    png = _png_bytes(J.decode_jpeg(base720))
    out["png_decode_host_ms_720x405"] = {"ms": host_ms(lambda: decode_png(png), n=10),
                                         "bytes": len(png)}
    return out


def phase_formats(ctx):
    """Every image the JAX package decodes on its serving and training
    paths: (a) the fixtures' frames on the card against the digests, the
    arithmetic, lossless and 12-bit ones too, the PxM, PAM, PFM, Sun
    raster, HDR and GIF ones, the TIFF and WebP ones and the JPEG 2000
    ones, (b) the batched device-detect app on the card against the CPU
    app, launches counted, and a host-prep app over the JPEG 2000 inputs,
    (c) a progressive and an arithmetic stream through the coef plane,
    (d) the loader on the card over mixed formats, (e) decode times (WebP,
    LZW TIFF and JPEG 2000 at 720x405 and 1920x1080 among them)."""
    inputs, digests = _format_inputs()
    modes, mode_digests = _format_inputs(JPEG_MODES_DIR)
    images, image_digests = _format_inputs(IMAGE_FORMATS_DIR)
    tw, tw_digests = _format_inputs(TIFF_WEBP_DIR)
    j2k, j2k_digests = _format_inputs(JPEG2000_DIR)
    everything = {**inputs, **modes, **images, **tw, **j2k}
    t0 = time.time()
    out = {"card": ctx["smi"]}
    for key, fn in (("on_card", lambda: _formats_on_card(inputs, digests)),
                    ("jpeg_modes_on_card", lambda: _formats_on_card(modes, mode_digests)),
                    ("image_formats_on_card", lambda: _image_formats_on_card(images,
                                                                             image_digests)),
                    ("tiff_webp_on_card", lambda: _tiff_webp_on_card(tw, tw_digests)),
                    ("jpeg2000_on_card", lambda: _jpeg2000_on_card(j2k, j2k_digests)),
                    ("http", lambda: _formats_http(ctx, everything)),
                    ("jpeg2000_host_prep", lambda: _jpeg2000_host_prep(ctx, j2k)),
                    ("loader", lambda: _formats_loader(everything, {**digests, **mode_digests,
                                                                    **image_digests,
                                                                    **tw_digests,
                                                                    **j2k_digests})),
                    ("timing", lambda: _formats_timing(inputs)),
                    ("tiff_webp_timing", lambda: _tiff_webp_timing(everything)),
                    ("jpeg2000_timing", lambda: _jpeg2000_timing(j2k, j2k_digests))):
        t = time.time()
        out[key] = fn()
        out[key]["seconds"] = time.time() - t
    out["seconds"] = time.time() - t0
    return out


PHASES = (("device", phase_device), ("build", phase_build),
          ("kernels", phase_kernels), ("serve", phase_serve),
          ("parity", phase_parity), ("detect-serve", phase_detect_serve),
          ("detect-parity", phase_detect_parity), ("decode", phase_decode),
          ("http", phase_http), ("wire", phase_wire), ("haar", phase_haar),
          ("mtcnn", phase_mtcnn), ("clip", phase_clip), ("train", phase_train),
          ("detector", phase_detector), ("sharded", phase_sharded),
          ("bench", phase_bench), ("video", phase_video), ("final", phase_final),
          ("formats", phase_formats))


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
            "name", "route", "source", "replaces")} | {"launches": ctx["launches"][k],
                                                        "launches_sharded_tick":
                                                        ctx["sharded_launches"][k],
                                                        "launches_final":
                                                        ctx["final_launches"][k],
                                                        "launches_formats":
                                                        ctx["formats_launches"][k],
                                                        "launches_mp4":
                                                        ctx["mp4_launches"][k],
                                                        "launches_mp4v":
                                                        ctx["mp4v_launches"][k]}
            | {key: v[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})
    emit({"kernels": kernels, "card": ctx["smi"]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
