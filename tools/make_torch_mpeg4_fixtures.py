"""Write the fixtures of the PyTorch port's MPEG-4 Part 2 decode
(tests/data/torch_mpeg4/): mp4v mp4s written by cv2.VideoWriter with the
call the JAX analyzer makes for its --output (cli/analyze.py:
VideoWriter_fourcc(*"mp4v")), and by the system libavcodec's mpeg4
encoder with one option apart in each file; digests.json with what
cv2.VideoCapture and the system libavcodec make of each, as
tools/make_torch_h264_fixtures.py records them for the H.264 files.

    python tools/make_torch_mpeg4_fixtures.py

cv2.VideoWriter files: 640x360 at 25 and at 30000/1001 fps, 1920x1080,
1080x1920, 202x114 (a size that is not a multiple of 16), and 272x320
clips of the face photograph and of a scene without a face for the entry
points' tests. libavcodec mpeg4 files (a scene with a moving patch of
black noise, whose samples of 0 and 255 tell the x86 no-rounding
averages apart): 4MV (also with quarter-pel at 202x114), AC prediction
(aic), resync markers (ps), data partitioning, qscale 1 (the escape
modes) and 31, adaptive quantisation (dquant with AC prediction, and with
B-frames for dbquant), gop 1 and 300, 1, 2 and 3 B-frames, MPEG
quantisation with the default and with custom matrices,
quarter-pel alone and with B-frames, a closed and an open GOV, a VO
header with a video_signal_type (BT.709, full range) and not-coded VOPs
spliced over repeated frames. Three files are for the refusals alone,
with cv2's frame count and no frames: libxvid's default, libxvid with GMC
and libavcodec's interlaced coding (ildct and ilme). The digests of
tests/data/torch_mp4/mp4v_160x96.mp4 are kept too.

"yuv" holds the system libavcodec's (FFmpeg 5.1) planes: its x86
put_no_rnd x2 / y2 of 16-pixel rows rounds differently from cv2's FFmpeg
8 where a sample is 0 (utils/mpeg4.Decoder(approx16=True) follows it).

The C writer is built with gcc in a temporary directory against the
system FFmpeg (-lavformat -lavcodec -lavutil); the port links none of it.
cv2 bundles FFmpeg 8.0 of its own. FFmpeg versions change the mp4 bytes;
the tests read the committed files.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import zlib

import cv2
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import make_torch_h264_fixtures as base  # noqa: E402

OUT = os.path.join(base.REPO, "tests", "data", "torch_mpeg4")
SEED = 19

WRITE_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
/* m4vwrite OUT YUV W H FRAMES FPS OPTS: the FRAMES yuv420p frames of YUV
   encoded by libavcodec's mpeg4 encoder (or libxvid) and muxed as mp4.
   FPS: "NUM" or "NUM/DEN". OPTS: "-" or comma-separated: enc=libxvid,
   q=N (constant qscale), br=N (bit rate), gop=N, bf=N, mv4, aic, ps=N,
   dp, mpegq, matrix (custom matrices), qpel, closed, ilace, gmc
   (libxvid), aq (adaptive quantisation), vst (a VO video_signal_type:
   BT.709 primaries, transfer and matrix, full range), nvop=K (packet K
   replaced by a not-coded VOP with its times; repeatable). */
static int has(const char* opts, const char* key, const char** val) {
  size_t n = strlen(key);
  for (const char* p = opts; p && *p;) {
    if (!strncmp(p, key, n) && (p[n] == ',' || p[n] == 0 || p[n] == '=')) {
      if (val) *val = p[n] == '=' ? p + n + 1 : NULL;
      return 1;
    }
    p = strchr(p, ',');
    if (p) ++p;
  }
  return 0;
}
typedef struct { uint8_t* b; int n; int bit; } BW;
static void put(BW* w, int n, unsigned v) {
  for (int i = n - 1; i >= 0; --i) {
    if (w->bit == 0) w->b[w->n++] = 0;
    if ((v >> i) & 1) w->b[w->n - 1] |= 0x80 >> w->bit;
    w->bit = (w->bit + 1) & 7;
  }
}
static void stuff(BW* w) { put(w, 1, 0); while (w->bit) put(w, 1, 1); }
static void signal_type(AVCodecContext* c) {
  uint8_t* e = c->extradata; int n = c->extradata_size, at = -1, end = n;
  for (int i = 0; i + 3 < n; ++i)
    if (!e[i] && !e[i + 1] && e[i + 2] == 1 && e[i + 3] == 0xB5) { at = i; break; }
  if (at < 0) exit(11);
  for (int i = at + 4; i + 2 < n; ++i) if (!e[i] && !e[i + 1] && e[i + 2] == 1) { end = i; break; }
  uint8_t vo[16]; BW w = {vo, 0, 0};
  put(&w, 1, 1); put(&w, 4, e[at + 4] >> 3 & 15); put(&w, 3, 1); put(&w, 4, 1);
  put(&w, 1, 1); put(&w, 3, 5); put(&w, 1, 1); put(&w, 1, 1); put(&w, 8, 1); put(&w, 8, 1);
  put(&w, 8, 1); stuff(&w);
  uint8_t* out = av_mallocz(n - (end - at - 4) + w.n + AV_INPUT_BUFFER_PADDING_SIZE);
  memcpy(out, e, at + 4);
  memcpy(out + at + 4, vo, w.n);
  memcpy(out + at + 4 + w.n, e + end, n - end);
  c->extradata_size = at + 4 + w.n + n - end;
  av_free(c->extradata);
  c->extradata = out;
}
static void not_coded(AVPacket* pkt, int tib) {
  uint8_t* d = pkt->data; int at = -1;
  for (int i = 0; i + 3 < pkt->size; ++i)
    if (!d[i] && !d[i + 1] && d[i + 2] == 1 && d[i + 3] == 0xB6) { at = i; break; }
  if (at < 0) exit(12);
  int pos = (at + 4) * 8;
#define BIT(p) ((d[(p) >> 3] >> (7 - ((p) & 7))) & 1)
  uint8_t out[32]; BW w = {out, 0, 0};
  put(&w, 32, 0x1B6);
  put(&w, 2, BIT(pos) << 1 | BIT(pos + 1)); pos += 2;
  while (BIT(pos)) { put(&w, 1, 1); ++pos; }
  put(&w, 1, 0); ++pos;
  put(&w, 1, 1); ++pos;
  unsigned t = 0;
  for (int i = 0; i < tib; ++i) t = t << 1 | BIT(pos++);
  put(&w, tib, t); put(&w, 1, 1); put(&w, 1, 0); stuff(&w);
  memcpy(pkt->data, out, w.n);
  av_shrink_packet(pkt, w.n);
}
int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const char *out = argv[1], *yuv = argv[2], *opts = argv[7], *v;
  int w = atoi(argv[3]), h = atoi(argv[4]), n = atoi(argv[5]), fps = atoi(argv[6]), den = 1;
  if (strchr(argv[6], '/')) den = atoi(strchr(argv[6], '/') + 1);
  FILE* in = fopen(yuv, "rb");
  if (!in) return 3;
  AVFormatContext* oc = NULL;
  if (avformat_alloc_output_context2(&oc, NULL, "mp4", out) < 0) return 3;
  char encname[32] = "mpeg4";
  if (has(opts, "enc", &v)) {
    strncpy(encname, v, 31);
    if (strchr(encname, ',')) *strchr(encname, ',') = 0;
  }
  const AVCodec* codec = avcodec_find_encoder_by_name(encname);
  if (!codec) return 4;
  AVStream* st = avformat_new_stream(oc, NULL);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  c->width = w;
  c->height = h;
  c->time_base = (AVRational){den, fps};
  c->framerate = (AVRational){fps, den};
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->thread_count = 1;
  c->gop_size = has(opts, "gop", &v) ? atoi(v) : 12;
  c->max_b_frames = has(opts, "bf", &v) ? atoi(v) : 0;
  int q = has(opts, "q", &v) ? atoi(v) : 0;
  if (q) {
    c->flags |= AV_CODEC_FLAG_QSCALE;
    c->global_quality = q * FF_QP2LAMBDA;
  }
  if (has(opts, "br", &v)) c->bit_rate = atoi(v);
  if (has(opts, "mv4", NULL)) c->flags |= AV_CODEC_FLAG_4MV;
  if (has(opts, "aic", NULL)) c->flags |= AV_CODEC_FLAG_AC_PRED;
  if (has(opts, "qpel", NULL)) c->flags |= AV_CODEC_FLAG_QPEL;
  if (has(opts, "closed", NULL)) {  /* libavcodec refuses it with scene-change detection */
    c->flags |= AV_CODEC_FLAG_CLOSED_GOP;
    av_opt_set_int(c->priv_data, "sc_threshold", 1000000000, 0);
  }
  if (has(opts, "ilace", NULL))
    c->flags |= AV_CODEC_FLAG_INTERLACED_DCT | AV_CODEC_FLAG_INTERLACED_ME;
  if (has(opts, "ps", &v)) av_opt_set_int(c->priv_data, "ps", atoi(v), 0);
  if (has(opts, "dp", NULL)) av_opt_set_int(c->priv_data, "data_partitioning", 1, 0);
  if (has(opts, "mpegq", NULL)) av_opt_set_int(c->priv_data, "mpeg_quant", 1, 0);
  if (has(opts, "gmc", NULL)) av_opt_set_int(c->priv_data, "gmc", 1, 0);
  if (has(opts, "aq", NULL)) {
    c->lumi_masking = 0.4f;
    c->spatial_cplx_masking = 0.4f;
    c->dark_masking = 0.3f;
  }
  if (has(opts, "matrix", NULL)) {
    c->intra_matrix = av_malloc(64 * sizeof(uint16_t));
    c->inter_matrix = av_malloc(64 * sizeof(uint16_t));
    for (int i = 0; i < 64; ++i) {
      c->intra_matrix[i] = i ? 10 + (i * 7) % 23 + (i >> 3) : 8;
      c->inter_matrix[i] = 12 + (i * 5) % 19 + (i & 7);
    }
  }
  if (oc->oformat->flags & AVFMT_GLOBALHEADER) c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c, codec, NULL) < 0) return 5;
  if (has(opts, "vst", NULL)) signal_type(c);
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  if (avio_open(&oc->pb, out, AVIO_FLAG_WRITE) < 0) return 6;
  if (avformat_write_header(oc, NULL) < 0) return 7;
  int tib = 1;
  while ((1 << tib) < fps) ++tib;
  AVFrame* f = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  f->format = c->pix_fmt;
  f->width = w;
  f->height = h;
  av_frame_get_buffer(f, 0);
  int k = 0;
  for (int i = 0; i <= n; ++i) {
    AVFrame* src = NULL;
    if (i < n) {
      av_frame_make_writable(f);
      for (int p = 0; p < 3; ++p) {
        int pw = p ? w / 2 : w, ph = p ? h / 2 : h;
        for (int y = 0; y < ph; ++y)
          if (fread(f->data[p] + y * f->linesize[p], 1, pw, in) != (size_t)pw) return 9;
      }
      f->pts = i;
      if (q) f->quality = c->global_quality;
      src = f;
    }
    if (avcodec_send_frame(c, src) < 0) return 8;
    while (avcodec_receive_packet(c, pkt) == 0) {
      char key[32];
      snprintf(key, sizeof key, "nvop=%d", k);
      const char* at = strstr(opts, key);
      if (at && (!at[strlen(key)] || at[strlen(key)] == ',')) not_coded(pkt, tib);
      ++k;
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

# cv2.VideoWriter files: name: (width, height, frames, fps[, content])
CV2_WRITTEN = {
    "cv2_640x360.mp4": (640, 360, 12, 25),
    "cv2_ntsc_640x360.mp4": (640, 360, 8, 30000 / 1001),
    "cv2_1920x1080.mp4": (1920, 1080, 2, 25),
    "cv2_1080x1920.mp4": (1080, 1920, 2, 30),
    "cv2_202x114.mp4": (202, 114, 20, 25),
    "cv2_face_272x320.mp4": (272, 320, 14, 12, "face"),
    "cv2_plain_272x320.mp4": (272, 320, 7, 12),
}
# libavcodec mpeg4 files: name: (width, height, frames, fps, options)
ENCODED = {
    "mv4_256x144.mp4": (256, 144, 20, "25", "q=5,mv4"),
    "mv4_qpel_202x114.mp4": (202, 114, 16, "25", "q=5,mv4,qpel"),
    "aic_256x144.mp4": (256, 144, 16, "25", "q=5,aic"),
    "ps_256x144.mp4": (256, 144, 16, "25", "q=5,mv4,ps=200"),
    "dp_256x144.mp4": (256, 144, 16, "25", "q=5,mv4,aic,dp,ps=250"),
    "q1_96x64.mp4": (96, 64, 8, "25", "q=1,gop=4"),
    "q31_256x144.mp4": (256, 144, 16, "25", "q=31"),
    "dquant_256x144.mp4": (256, 144, 20, "25", "br=150000,aq,aic"),
    "dquant_bf2_256x144.mp4": (256, 144, 20, "25", "br=150000,aq,bf=2"),
    "gop1_160x96.mp4": (160, 96, 8, "25", "q=5,gop=1"),
    "gop300_160x96.mp4": (160, 96, 24, "25", "q=6,gop=300"),
    "bf1_256x144.mp4": (256, 144, 20, "25", "q=5,bf=1"),
    "bf2_256x144.mp4": (256, 144, 26, "25", "q=5,bf=2,mv4"),
    "bf3_256x144.mp4": (256, 144, 26, "30000/1001", "q=5,bf=3"),
    "mpegq_256x144.mp4": (256, 144, 16, "25", "q=4,mpegq,mv4"),
    "mpegq_matrix_256x144.mp4": (256, 144, 16, "25", "q=3,mpegq,matrix,bf=1"),
    "qpel_256x144.mp4": (256, 144, 16, "25", "q=5,qpel,mv4"),
    "qpel_bf2_256x144.mp4": (256, 144, 20, "25", "q=5,qpel,bf=2"),
    "closed_bf2_160x96.mp4": (160, 96, 30, "25", "q=5,bf=2,gop=8,closed"),
    "open_bf2_160x96.mp4": (160, 96, 30, "25", "q=5,bf=2,gop=8"),
    "bt709full_160x96.mp4": (160, 96, 10, "25", "q=5,vst"),
    "nvop_160x96.mp4": (160, 96, 20, "25", "q=5,nvop=6,nvop=13", "repeat"),
}
REFUSED = {
    "xvid_160x96.mp4": (160, 96, 8, "25", "enc=libxvid,q=5"),
    "xvid_gmc_160x96.mp4": (160, 96, 8, "25", "enc=libxvid,q=5,gmc"),
    "interlaced_160x96.mp4": (160, 96, 8, "25", "q=5,ilace"),
}
MP4V_OLD = "torch_mp4/mp4v_160x96.mp4"


def dark_scene(w: int, h: int, n: int, seed: int, repeat=()) -> bytes:
    """base.scene with a patch of black noise (luma 0-2, chroma 0/1 and
    254/255) crossing it; frame k of `repeat` repeats frame k - 1."""
    raw = np.frombuffer(base.scene(w, h, n, seed), np.uint8).copy()
    size = w * h * 3 // 2
    yy, xx = np.mgrid[:h, :w]
    frames = raw.reshape(n, size)
    for i in range(n):
        y = frames[i, :w * h].reshape(h, w)
        u = frames[i, w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
        v = frames[i, w * h + w * h // 4:].reshape(h // 2, w // 2)
        m = (abs(xx - (w // 6 + 3 * i)) < w // 8) & (abs(yy - (h // 3 + i)) < h // 6)
        y[m] = ((xx[m] + yy[m] + i) % 3).astype(np.uint8)
        cm = m[::2, ::2]
        u[cm] = ((xx[::2, ::2][cm] + i) % 2).astype(np.uint8)
        v[cm] = (255 - yy[::2, ::2][cm] % 2).astype(np.uint8)
    for k in repeat:
        frames[k] = frames[k - 1]
    return frames.tobytes()


def cv2_write(path: str, frames_yuv: bytes, w: int, h: int, n: int, fps: float) -> None:
    """The JAX analyzer's writer: cv2.VideoWriter(path, fourcc 'mp4v', fps,
    (w, h)) fed BGR frames."""
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    size = w * h * 3 // 2
    for i in range(n):
        i420 = np.frombuffer(frames_yuv[i * size:(i + 1) * size], np.uint8).reshape(h * 3 // 2, w)
        writer.write(cv2.cvtColor(i420, cv2.COLOR_YUV2BGR_I420))
    writer.release()


def main() -> int:
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        tools = base.build(tmp)
        src = os.path.join(tmp, "m4vwrite.c")
        with open(src, "w") as fh:
            fh.write(WRITE_C)
        tools["m4vwrite"] = os.path.join(tmp, "m4vwrite")
        subprocess.run(["gcc", "-O2", src, "-o", tools["m4vwrite"], "-lavformat", "-lavcodec",
                        "-lavutil"], check=True)
        for name, (w, h, n, fps, *content) in sorted(CV2_WRITTEN.items()):
            seed = SEED + zlib.crc32(name.encode())
            yuv = base.face_clip(w, h, n) if content else base.scene(w, h, n, seed)
            cv2_write(os.path.join(OUT, name), yuv, w, h, n, fps)
        for name, (w, h, n, fps, opts, *content) in sorted({**ENCODED, **REFUSED}.items()):
            seed = SEED + zlib.crc32(name.encode())
            yuv = os.path.join(tmp, "in.yuv")
            repeat = [int(k.split("=")[1]) for k in opts.split(",") if k.startswith("nvop=")]
            with open(yuv, "wb") as fh:
                fh.write(dark_scene(w, h, n, seed, repeat if content == ["repeat"] else ()))
            subprocess.run([tools["m4vwrite"], os.path.join(OUT, name), yuv, str(w), str(h),
                            str(n), fps, opts], check=True, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        paths = {name: os.path.join(OUT, name) for name in {**CV2_WRITTEN, **ENCODED}}
        paths[MP4V_OLD] = os.path.join(base.MP4_DIR, os.path.basename(MP4V_OLD))
        for name, path in sorted(paths.items()):
            records[name] = dict(base.cv2_record(path), yuv=base.yuv_record(tools, tmp, path),
                                 bytes=os.path.getsize(path))
        for name in sorted(REFUSED):
            cap = cv2.VideoCapture(os.path.join(OUT, name))
            records[name] = {"frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT), "refused": True,
                             "bytes": os.path.getsize(os.path.join(OUT, name))}
            cap.release()
    with open(os.path.join(OUT, "digests.json"), "w") as fh:   # one line a file
        fh.write('{"cv2": %s, "files": {\n' % json.dumps(cv2.__version__))
        fh.write(",\n".join(
            f"{json.dumps(k)}: {json.dumps(v, sort_keys=True, separators=(',', ':'))}"
            for k, v in sorted(records.items())))
        fh.write("\n}}\n")
    total = sum(r["bytes"] for k, r in records.items() if "/" not in k)
    print(f"wrote {len(records) - 1} mp4s ({total} bytes) and digests.json to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
