"""Write the fixtures of the PyTorch port's H.264 decoder
(tests/data/torch_h264/): x264 Constrained Baseline mp4s of seeded
synthetic scenes, and digests.json with what cv2.VideoCapture and the
system libavcodec make of each, and of the Baseline file of
tests/data/torch_mp4/.

    python tools/make_torch_h264_fixtures.py

The files cover: 640x360 (coded 368: frame cropping; 48 frames, keyint
12), 1920x1080 (coded 1088), four slices a picture, partitions=all (P 8x8
sub-partitions down to 4x4), ref=16, deblocking off and offsets -3:-3 and
3:3, constrained intra prediction, a chroma QP offset, qp=4 (level
escapes), periodic intra refresh, the BT.709 and the full-range VUI flags
and a 202x114 size (a width that is not a multiple of 8 or 16); and, for
the entry points' tests, 272x320 clips of the face photograph of
tests/data/torch_haar moving as tests/test_torch_analyze.face_frames moves
it, and of a scene without a face.

Per file: cv2's CAP_PROP_FRAME_COUNT, CAP_PROP_FPS, width and height; the
sha256 and shape of every frame cv2.VideoCapture reads sequentially
("read"), and of the frame read after set(CAP_PROP_POS_FRAMES, i) at every
i from 0 to the frame count ("seek", null where nothing is read); the
sha256 of the Y, U and V planes of every frame the system libavcodec
decodes (thread_count=1), with each frame's pts and whether its packet was
flagged discarded (AV_PKT_FLAG_DISCARD: kept here, dropped by cv2).

The C programs are built with gcc in a temporary directory against the
system FFmpeg (-lavformat -lavcodec -lavutil, libx264 for the writer); the
port links none of them. cv2 bundles FFmpeg 8.0 of its own. x264 and
FFmpeg versions change the mp4 bytes; the tests read the committed files.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import zlib

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "torch_h264")
MP4_DIR = os.path.join(REPO, "tests", "data", "torch_mp4")
SEED = 17

WRITE_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
/* h264write OUT YUV W H FRAMES FPS PARAMS COLOR [PROFILE [PIXFMT]]: the
   FRAMES frames of the raw file YUV (yuv420p, or PIXFMT "yuv422p")
   encoded by libx264 (profile PROFILE, baseline by default, preset medium,
   x264-params PARAMS) and muxed as mp4. FPS: "NUM" or "NUM/DEN". COLOR:
   "-", "bt709" (primaries, transfer and matrix BT.709, limited range) or
   "full" (BT.601, full range). B-frames are left to the preset and PARAMS
   except in baseline. */
int main(int argc, char** argv) {
  if (argc < 9 || argc > 11) return 2;
  const char *out = argv[1], *yuv = argv[2], *params = argv[7], *color = argv[8];
  const char *profile = argc > 9 ? argv[9] : "baseline";
  int p422 = argc > 10 && !strcmp(argv[10], "yuv422p");
  int w = atoi(argv[3]), h = atoi(argv[4]), n = atoi(argv[5]), fps = atoi(argv[6]), den = 1;
  if (strchr(argv[6], '/')) den = atoi(strchr(argv[6], '/') + 1);
  FILE* in = fopen(yuv, "rb");
  if (!in) return 3;
  AVFormatContext* oc = NULL;
  if (avformat_alloc_output_context2(&oc, NULL, "mp4", out) < 0) return 3;
  const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
  if (!codec) return 4;
  AVStream* st = avformat_new_stream(oc, NULL);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  c->width = w;
  c->height = h;
  c->time_base = (AVRational){den, fps};
  c->framerate = (AVRational){fps, den};
  c->pix_fmt = p422 ? AV_PIX_FMT_YUV422P : AV_PIX_FMT_YUV420P;
  c->max_b_frames = strcmp(profile, "baseline") ? -1 : 0;
  c->thread_count = 1;
  if (!strcmp(color, "bt709")) {
    c->color_primaries = AVCOL_PRI_BT709;
    c->color_trc = AVCOL_TRC_BT709;
    c->colorspace = AVCOL_SPC_BT709;
    c->color_range = AVCOL_RANGE_MPEG;
  } else if (!strcmp(color, "full")) {
    c->color_primaries = AVCOL_PRI_SMPTE170M;
    c->color_trc = AVCOL_TRC_SMPTE170M;
    c->colorspace = AVCOL_SPC_SMPTE170M;
    c->color_range = AVCOL_RANGE_JPEG;
  }
  av_opt_set(c->priv_data, "profile", profile, 0);
  av_opt_set(c->priv_data, "preset", "medium", 0);
  av_opt_set(c->priv_data, "x264-params", params, 0);
  if (oc->oformat->flags & AVFMT_GLOBALHEADER) c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c, codec, NULL) < 0) return 5;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (avio_open(&oc->pb, out, AVIO_FLAG_WRITE) < 0) return 6;
  if (avformat_write_header(oc, NULL) < 0) return 7;
  AVFrame* f = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  f->format = c->pix_fmt;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 0);
  for (int i = 0; i <= n; ++i) {
    AVFrame* src = NULL;
    if (i < n) {
      av_frame_make_writable(f);
      for (int p = 0; p < 3; ++p) {
        int pw = p ? w / 2 : w, ph = p && !p422 ? h / 2 : h;
        for (int y = 0; y < ph; ++y)
          if (fread(f->data[p] + y * f->linesize[p], 1, pw, in) != (size_t)pw) return 9;
      }
      f->pts = i;
      src = f;
    }
    if (avcodec_send_frame(c, src) < 0) return 8;
    while (avcodec_receive_packet(c, pkt) == 0) {
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(oc, pkt);
    }
  }
  av_write_trailer(oc);
  avio_closep(&oc->pb);
  fclose(in);
  return 0;
}
"""

YUVDUMP_C = r"""
#include <stdio.h>
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
/* yuvdump IN OUT: every frame of IN's first video stream decoded by
   libavcodec (thread_count=1), its planes written to OUT at the picture's
   size; on stdout a JSON list of [pts, discarded] per frame. A packet
   flagged AV_PKT_FLAG_DISCARD is decoded all the same and marked. */
int main(int argc, char** argv) {
  AVFormatContext* ic = NULL;
  av_log_set_level(AV_LOG_QUIET);
  if (avformat_open_input(&ic, argv[1], NULL, NULL) < 0) return 3;
  if (avformat_find_stream_info(ic, NULL) < 0) return 3;
  int v = av_find_best_stream(ic, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
  if (v < 0) return 3;
  const AVCodec* codec = avcodec_find_decoder(ic->streams[v]->codecpar->codec_id);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(c, ic->streams[v]->codecpar);
  c->thread_count = 1;
  if (avcodec_open2(c, codec, NULL) < 0) return 4;
  FILE* out = fopen(argv[2], "wb");
  AVPacket* pkt = av_packet_alloc();
  AVFrame* f = av_frame_alloc();
  long long discarded[4096];
  int nd = 0, first = 1, eof = 0;
  printf("[");
  while (!eof) {
    if (av_read_frame(ic, pkt) < 0) {
      eof = 1;
      avcodec_send_packet(c, NULL);
    } else {
      if (pkt->stream_index != v) { av_packet_unref(pkt); continue; }
      if (pkt->flags & AV_PKT_FLAG_DISCARD) {
        if (nd < 4096) discarded[nd++] = pkt->pts;
        pkt->flags &= ~AV_PKT_FLAG_DISCARD;
      }
      avcodec_send_packet(c, pkt);
      av_packet_unref(pkt);
    }
    while (avcodec_receive_frame(c, f) == 0) {
      int d = 0;
      for (int i = 0; i < nd; ++i) d |= discarded[i] == f->pts;
      printf("%s[%lld, %d]", first ? "" : ", ", (long long)f->pts, d);
      first = 0;
      for (int p = 0; p < 3; ++p) {
        int pw = p ? (f->width + 1) / 2 : f->width, ph = p ? (f->height + 1) / 2 : f->height;
        for (int y = 0; y < ph; ++y) fwrite(f->data[p] + y * f->linesize[p], 1, pw, out);
      }
    }
  }
  printf("]\n");
  fclose(out);
  return 0;
}
"""

PHOTO = os.path.join(REPO, "tests", "data", "torch_haar", "grace_hopper.jpg")

# name: (width, height, frames, fps, x264-params, colour[, content])
FIXTURES = {
    "cb_face_272x320.mp4": (272, 320, 14, 12, "keyint=6:crf=18", "-", "face"),
    "cb_plain_272x320.mp4": (272, 320, 10, 12, "keyint=5:crf=22", "-"),
    "cb_640x360.mp4": (640, 360, 48, 25, "keyint=12:min-keyint=12:crf=26", "-"),
    "cb_1920x1080.mp4": (1920, 1080, 12, 25, "keyint=12:min-keyint=12:crf=30", "-"),
    "cb_slices4_320x180.mp4": (320, 180, 16, 25, "keyint=8:slices=4:crf=24", "-"),
    "cb_partall_320x180.mp4": (320, 180, 16, 25,
                               "keyint=16:partitions=all:subme=9:crf=20", "-"),
    "cb_ref16_256x144.mp4": (256, 144, 36, 25, "keyint=40:ref=16:crf=24", "-"),
    "cb_nodeblock_256x144.mp4": (256, 144, 16, 25, "keyint=8:no-deblock=1:crf=28", "-"),
    "cb_deblock_m3_256x144.mp4": (256, 144, 16, 25, "keyint=8:deblock=-3,-3:crf=30", "-"),
    "cb_deblock_p3_256x144.mp4": (256, 144, 16, 25, "keyint=8:deblock=3,3:crf=30", "-"),
    "cb_cip_256x144.mp4": (256, 144, 16, 25, "keyint=8:constrained-intra=1:crf=24", "-"),
    "cb_cqp_256x144.mp4": (256, 144, 16, 25, "keyint=8:chroma-qp-offset=5:crf=26", "-"),
    "cb_qp4_96x64.mp4": (96, 64, 6, 25, "keyint=3:qp=4", "-"),
    "cb_refresh_256x144.mp4": (256, 144, 32, 25, "keyint=10:intra-refresh=1:crf=24", "-"),
    "cb_bt709_256x144.mp4": (256, 144, 12, 25, "keyint=6:crf=24", "bt709"),
    "cb_full_256x144.mp4": (256, 144, 12, 25, "keyint=6:crf=24", "full"),
    "cb_202x114.mp4": (202, 114, 16, 25, "keyint=8:crf=24", "-"),
}


def scene(w: int, h: int, n: int, seed: int) -> bytes:
    """n yuv420p frames of a seeded synthetic scene: a panning gradient
    with a sinusoid texture and a few moving, coloured discs and boxes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    cyy, cxx = np.mgrid[:h // 2, :w // 2].astype(np.float32)
    shapes = [(rng.uniform(0, w), rng.uniform(0, h), rng.uniform(-4, 4), rng.uniform(-3, 3),
               rng.uniform(0.05, 0.2) * min(w, h), rng.integers(30, 230), rng.integers(40, 216),
               rng.integers(40, 216), rng.integers(0, 2)) for _ in range(6)]
    fx, fy = rng.uniform(0.05, 0.3, 2)
    out = []
    for i in range(n):
        y = (60 + 100 * (xx + 2 * i) / w + 40 * (yy + i) / h
             + 18 * np.sin(fx * (xx + 3 * i)) * np.cos(fy * (yy - i)))
        u = 128 + 40 * np.sin((cxx + i) / max(w, 1) * 6.0) + 0 * cyy
        v = 128 + 40 * np.cos((cyy - i) / max(h, 1) * 5.0) + 0 * cxx
        for (sx, sy, vx, vy, r, ly, lu, lv, box) in shapes:
            px, py = sx + vx * i, sy + vy * i
            if box:
                m = (abs(xx - px) < r) & (abs(yy - py) < r * 0.6)
                cm = (abs(cxx - px / 2) < r / 2) & (abs(cyy - py / 2) < r * 0.3)
            else:
                m = (xx - px) ** 2 + (yy - py) ** 2 < r * r
                cm = (cxx - px / 2) ** 2 + (cyy - py / 2) ** 2 < r * r / 4
            y = np.where(m, ly + 20 * np.sin(xx * 0.7 + i) * np.sin(yy * 0.5), y)
            u = np.where(cm, lu, u)
            v = np.where(cm, lv, v)
        for p in (y, u, v):
            out.append(np.clip(np.rint(p), 0, 255).astype(np.uint8).tobytes())
    return b"".join(out)


def face_clip(w: int, h: int, n: int) -> bytes:
    """n yuv420p frames of the photograph moving 2 px down and 1 px right a
    frame (wrapping round), as tests/test_torch_analyze.face_frames."""
    img = cv2.resize(cv2.imread(PHOTO), (w, h), interpolation=cv2.INTER_AREA)
    return b"".join(cv2.cvtColor(np.ascontiguousarray(np.roll(img, (2 * i, i), (0, 1))),
                                 cv2.COLOR_BGR2YUV_I420).tobytes() for i in range(n))


def build(tmp: str) -> dict:
    """Compile the C programs into `tmp`; {name: executable}."""
    tools = {}
    for name, src in (("h264write", WRITE_C), ("yuvdump", YUVDUMP_C)):
        path = os.path.join(tmp, name)
        with open(path + ".c", "w") as fh:
            fh.write(src)
        subprocess.run(["gcc", "-O2", path + ".c", "-o", path, "-lavformat", "-lavcodec",
                        "-lavutil"], check=True)
        tools[name] = path
    return tools


def digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def cv2_record(path: str) -> dict:
    cap = cv2.VideoCapture(path)
    rec = {"frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT), "fps": cap.get(cv2.CAP_PROP_FPS),
           "width": cap.get(cv2.CAP_PROP_FRAME_WIDTH),
           "height": cap.get(cv2.CAP_PROP_FRAME_HEIGHT), "read": []}
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        rec["read"].append(digest(frame))
    cap.release()
    rec["seek"] = []
    for i in range(int(rec["frame_count"]) + 1):
        cap = cv2.VideoCapture(path)
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, frame = cap.read()
        rec["seek"].append(digest(frame) if ok else None)
        cap.release()
    return rec


def yuv_record(tools, tmp: str, path: str) -> list:
    raw = os.path.join(tmp, "planes.yuv")
    frames = json.loads(subprocess.run([tools["yuvdump"], path, raw], check=True,
                                       capture_output=True, text=True).stdout)
    with open(raw, "rb") as fh:
        data = fh.read()
    cap = cv2.VideoCapture(path)
    w, h = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)), int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    sizes = (w * h, ((w + 1) // 2) * ((h + 1) // 2), ((w + 1) // 2) * ((h + 1) // 2))
    out, off = [], 0
    for pts, discarded in frames:
        e = {"pts": pts, "discarded": bool(discarded)}
        for name, size in zip("yuv", sizes):
            e[name] = hashlib.sha256(data[off:off + size]).hexdigest()
            off += size
        out.append(e)
    if off != len(data):
        raise SystemExit(f"{path}: the plane dump has {len(data) - off} bytes left over")
    return out


def main() -> int:
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        tools = build(tmp)
        for name, (w, h, n, fps, params, color, *content) in sorted(FIXTURES.items()):
            yuv = os.path.join(tmp, "in.yuv")
            seed = SEED + zlib.crc32(name.encode())   # each scene its own, whatever the list
            with open(yuv, "wb") as fh:
                fh.write(face_clip(w, h, n) if content else scene(w, h, n, seed))
            path = os.path.join(OUT, name)
            subprocess.run([tools["h264write"], path, yuv, str(w), str(h), str(n), str(fps),
                            params, color], check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        paths = {name: os.path.join(OUT, name) for name in FIXTURES}
        paths["torch_mp4/baseline_160x96.mp4"] = os.path.join(MP4_DIR, "baseline_160x96.mp4")
        for name, path in sorted(paths.items()):
            records[name] = dict(cv2_record(path), yuv=yuv_record(tools, tmp, path),
                                 bytes=os.path.getsize(path))
    with open(os.path.join(OUT, "digests.json"), "w") as fh:
        json.dump({"cv2": cv2.__version__, "files": records}, fh, indent=1, sort_keys=True)
        fh.write("\n")
    total = sum(r["bytes"] for r in records.values())
    print(f"wrote {len(FIXTURES)} mp4s ({total} bytes with the torch_mp4 one) and "
          f"digests.json to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
