"""Write the fixtures of the PyTorch port's arithmetic-coded, lossless and
12-bit JPEG decode into tests/data/torch_jpeg_modes/ and of its mp4
demuxer into tests/data/torch_mp4/, with what the JAX package's routes make
of each.

    python tools/make_torch_jpeg_mode_fixtures.py

JPEG inputs (tests/data/torch_jpeg_modes/, digests.json):
- arithmetic-coded copies (SOF9 sequential, SOF10 progressive) of the
  extension's 720x405 frame, of the 640x480 capture-shape frame (the wire
  planes' shape), of the 319x241 restart, gray and 4:4:4 fixtures and of
  the 83x41 4:1:1 and CMYK ones; copies with restart intervals and with
  non-default DAC conditioning (L=1, U=3, K=2); the sequential and
  progressive arithmetic copies of the 83x41 baseline fixture, whose cut
  points are keyed "<file>@<length>", and the cuts of a q30 one whose
  coefficients (read as zeros past the end) dequantise largest, past the
  16 bits libjpeg-turbo's SIMD IDCTs hold;
- lossless (SOF3) 83x41 frames: RGB with predictors 1-7, a point transform,
  restarts every two rows, gray, JFIF-YCbCr, written by GDCM's IJG libjpeg
  8 (`jpeg_simple_lossless`); and from the encoder below what GDCM does not
  write: 2-, 5- and 7-bit samples, subsampled components, CMYK, and a
  restart interval inside a row (which cv2 refuses);
- 12-bit SOF1 and 12- and 16-bit SOF3 frames (GDCM's 12- and 16-bit
  libraries), which every decoder refuses.
Per input: "native", the sha256 and shape of the JAX package's libjpeg
decode (utils/native_ingest.decode_jpeg) or null; "cv2", cv2.imdecode's
(IMREAD_COLOR) or null; "scaled", the native decode at each DCT scale M/8
a size hint selects; "smoothed", whether libjpeg block-smooths it.

mp4 inputs (tests/data/torch_mp4/, packets.json), about 160x96: x264 High
(CABAC, B-frames, so ctts and an edit list; the moov after the mdat),
Constrained Baseline (+faststart), the High stream muxed as QuickTime mov,
cv2.VideoWriter's mp4v (what the JAX analyzer's --output writes), a
fragmented mp4 and an audio-only one. Per file: libavformat's video packets
[offset, size, dts, pts, key, discard (AV_PKT_FLAG_DISCARD)] with its
codec, size, time base, nb_frames and average frame rate (null when it
finds no video stream), and cv2.VideoCapture's isOpened,
CAP_PROP_FRAME_COUNT, CAP_PROP_FPS and frame size.

The C writers are built with gcc in a temporary directory: a libjpeg
transcoder (-ljpeg, libjpeg-turbo 2.1.5 with arithmetic coding), GDCM's
lossless and 12-bit writers (-lgdcmjpeg8/12/16 with its headers), a
libavformat + libx264 muxer and a libavformat packet dump (-lavformat
-lavcodec -lavutil). The port links none of them. Needs cv2 and the JAX
package's native library (JAX itself does not run). x264 and FFmpeg
versions change the mp4 bytes; the tests read the committed dumps.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import cv2
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_OUT = os.path.join(REPO, "tests", "data", "torch_jpeg_modes")
MP4_OUT = os.path.join(REPO, "tests", "data", "torch_mp4")
SEED = 16
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from make_torch_scaled_jpeg_digests import native_decode, scale_hint  # noqa: E402

ARITH_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
/* arith IN OUT PROGRESSIVE RESTART L U K: IN's coefficients rewritten
   arithmetic-coded (SOF9, or SOF10 with libjpeg's simple progression),
   with DAC conditioning L, U (DC) and K (AC) on every table */
int main(int argc, char** argv) {
  if (argc != 8) return 2;
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e1, e2;
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) return 2;
  d.err = jpeg_std_error(&e1);
  jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, in);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&e2);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = TRUE;
  if (atoi(argv[3])) jpeg_simple_progression(&c);
  c.restart_interval = atoi(argv[4]);
  for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
    c.arith_dc_L[t] = atoi(argv[5]);
    c.arith_dc_U[t] = atoi(argv[6]);
    c.arith_ac_K[t] = atoi(argv[7]);
  }
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_finish_decompress(&d);
  fclose(out);
  return 0;
}
"""

GDCM_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include "jpeglib.h"
/* gdcm RAW OUT W H NCOMP COLOR PREDICTOR PT RESTART QUALITY: the (H, W,
   NCOMP) samples of RAW (JSAMPLEs) as a lossless frame with predictor
   PREDICTOR (1-7) and point transform PT, or, with PREDICTOR 0, a
   sequential frame at QUALITY; COLOR 0 gray, 1 RGB, 2 JFIF YCbCr */
int main(int argc, char** argv) {
  if (argc != 11) return 2;
  int w = atoi(argv[3]), h = atoi(argv[4]), nc = atoi(argv[5]), color = atoi(argv[6]);
  int predictor = atoi(argv[7]);
  size_t n = (size_t)w * h * nc;
  JSAMPLE* px = malloc(n * sizeof(JSAMPLE));
  FILE* f = fopen(argv[1], "rb");
  if (!f || fread(px, sizeof(JSAMPLE), n, f) != n) return 2;
  fclose(f);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = nc;
  c.in_color_space = nc == 1 ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_set_defaults(&c);
  if (predictor) {
    jpeg_simple_lossless(&c, predictor, atoi(argv[8]));
    if (color == 1) jpeg_set_colorspace(&c, JCS_RGB);
    if (color == 2) {
      jpeg_set_colorspace(&c, JCS_YCbCr);
      for (int i = 0; i < 3; ++i) c.comp_info[i].h_samp_factor = c.comp_info[i].v_samp_factor = 1;
    }
  } else {
    jpeg_set_quality(&c, atoi(argv[10]), TRUE);
  }
  c.restart_interval = atoi(argv[9]);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * nc;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  fclose(out);
  return 0;
}
"""

MP4WRITE_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
/* mp4write OUT FORMAT CODEC W H FRAMES FPS PROFILE BFRAMES MOVFLAGS: FRAMES
   seeded moving frames (or, with CODEC aac, a second of silence) muxed by
   libavformat's FORMAT ("mp4" or "mov"); PROFILE and BFRAMES go to libx264,
   MOVFLAGS (or "-") to the muxer */
int main(int argc, char** argv) {
  if (argc != 11) return 2;
  const char *out = argv[1], *fmt = argv[2], *cname = argv[3];
  int w = atoi(argv[4]), h = atoi(argv[5]), n = atoi(argv[6]), fps = atoi(argv[7]);
  int audio = strcmp(cname, "aac") == 0;
  AVFormatContext* oc = NULL;
  if (avformat_alloc_output_context2(&oc, NULL, fmt, out) < 0) return 3;
  const AVCodec* codec = avcodec_find_encoder_by_name(cname);
  if (!codec) return 4;
  AVStream* st = avformat_new_stream(oc, NULL);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  if (audio) {
    c->sample_fmt = AV_SAMPLE_FMT_FLTP;
    c->sample_rate = 44100;
    c->bit_rate = 64000;
    av_channel_layout_default(&c->ch_layout, 1);
    c->time_base = (AVRational){1, 44100};
  } else {
    c->width = w;
    c->height = h;
    c->time_base = (AVRational){1, fps};
    c->framerate = (AVRational){fps, 1};
    c->pix_fmt = AV_PIX_FMT_YUV420P;
    c->gop_size = 12;
    c->max_b_frames = atoi(argv[9]);
    c->thread_count = 1;
    av_opt_set(c->priv_data, "profile", argv[8], 0);
    av_opt_set(c->priv_data, "preset", "medium", 0);
    av_opt_set(c->priv_data, "crf", "28", 0);
  }
  if (oc->oformat->flags & AVFMT_GLOBALHEADER) c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c, codec, NULL) < 0) return 5;
  avcodec_parameters_from_context(st->codecpar, c);
  st->time_base = c->time_base;
  AVDictionary* opts = NULL;
  if (strcmp(argv[10], "-")) av_dict_set(&opts, "movflags", argv[10], 0);
  if (avio_open(&oc->pb, out, AVIO_FLAG_WRITE) < 0) return 6;
  if (avformat_write_header(oc, &opts) < 0) return 7;
  AVFrame* f = av_frame_alloc();
  AVPacket* pkt = av_packet_alloc();
  if (audio) {
    f->format = c->sample_fmt;
    f->nb_samples = c->frame_size;
    f->sample_rate = c->sample_rate;
    av_channel_layout_copy(&f->ch_layout, &c->ch_layout);
  } else {
    f->format = c->pix_fmt;
    f->width = w;
    f->height = h;
  }
  av_frame_get_buffer(f, 0);
  int count = audio ? 44100 / c->frame_size : n;
  unsigned seed = 16;
  for (int i = 0; i <= count; ++i) {
    AVFrame* in = NULL;
    if (i < count) {
      av_frame_make_writable(f);
      if (audio) {
        memset(f->data[0], 0, f->nb_samples * sizeof(float));
        f->pts = (int64_t)i * c->frame_size;
      } else {
        for (int y = 0; y < h; ++y)
          for (int x = 0; x < w; ++x) {
            seed = seed * 1103515245u + 12345u;
            f->data[0][y * f->linesize[0] + x] =
                (uint8_t)(((x + 2 * i) * 3 + (y + i) * 2) & 0xFF) ^ ((seed >> 16) & 7);
          }
        for (int y = 0; y < h / 2; ++y)
          for (int x = 0; x < w / 2; ++x) {
            f->data[1][y * f->linesize[1] + x] = (uint8_t)(128 + ((x + i) & 31));
            f->data[2][y * f->linesize[2] + x] = (uint8_t)(128 - ((y + 2 * i) & 31));
          }
        f->pts = i;
      }
      in = f;
    }
    if (avcodec_send_frame(c, in) < 0) return 8;
    while (avcodec_receive_packet(c, pkt) == 0) {
      av_packet_rescale_ts(pkt, c->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(oc, pkt);
    }
  }
  av_write_trailer(oc);
  avio_closep(&oc->pb);
  return 0;
}
"""

MP4DUMP_C = r"""
#include <stdio.h>
#include <libavformat/avformat.h>
/* mp4dump IN: libavformat's view of IN's first video stream as JSON, or
   null: codec, size, time base, nb_frames, average frame rate and every
   packet [offset, size, dts, pts, key, discard] */
int main(int argc, char** argv) {
  AVFormatContext* ic = NULL;
  av_log_set_level(AV_LOG_QUIET);
  if (avformat_open_input(&ic, argv[1], NULL, NULL) < 0) {
    printf("null\n");
    return 0;
  }
  int v = av_find_best_stream(ic, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
  if (v < 0) {
    printf("null\n");
    return 0;
  }
  AVStream* st = ic->streams[v];
  printf("{\"codec\": \"%s\", \"width\": %d, \"height\": %d, \"time_base\": [%d, %d], "
         "\"nb_frames\": %lld, \"avg_frame_rate\": [%d, %d], \"packets\": [",
         avcodec_get_name(st->codecpar->codec_id), st->codecpar->width, st->codecpar->height,
         st->time_base.num, st->time_base.den, (long long)st->nb_frames,
         st->avg_frame_rate.num, st->avg_frame_rate.den);
  AVPacket* pkt = av_packet_alloc();
  int first = 1;
  while (av_read_frame(ic, pkt) >= 0) {
    if (pkt->stream_index == v) {
      printf("%s[%lld, %d, %lld, %lld, %d, %d]", first ? "" : ", ", (long long)pkt->pos,
             pkt->size, (long long)pkt->dts, (long long)pkt->pts,
             (pkt->flags & AV_PKT_FLAG_KEY) ? 1 : 0, (pkt->flags & AV_PKT_FLAG_DISCARD) ? 1 : 0);
      first = 0;
    }
    av_packet_unref(pkt);
  }
  printf("]}\n");
  avformat_close_input(&ic);
  return 0;
}
"""


def build(tmp: str, names=("arith", "gdcm8", "gdcm12", "gdcm16", "mp4write",
                           "mp4dump")) -> dict:
    """Compile the C writers `names` into `tmp`; {name: executable}."""
    av = ["-lavformat", "-lavcodec", "-lavutil"]
    recipes = {"arith": (ARITH_C, ["-ljpeg"]), "mp4write": (MP4WRITE_C, av),
               "mp4dump": (MP4DUMP_C, av)}
    for bits in (8, 12, 16):
        recipes[f"gdcm{bits}"] = (GDCM_C, [f"-I/usr/include/gdcm-3.0/gdcmjpeg/{bits}",
                                           f"-lgdcmjpeg{bits}"])
    tools = {}
    for name in names:
        src, args = recipes[name]
        path = os.path.join(tmp, name)
        with open(path + ".c", "w") as fh:
            fh.write(src)
        subprocess.run(["gcc", "-O2", path + ".c", "-o", path, *args], check=True)
        tools[name] = path
    return tools


def _run_file(tools, tmp, name, args, data: bytes = b"") -> bytes:
    src, out = os.path.join(tmp, "in.bin"), os.path.join(tmp, "out.bin")
    with open(src, "wb") as fh:
        fh.write(data)
    subprocess.run([tools[name], src, out, *map(str, args)], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    with open(out, "rb") as fh:
        return fh.read()


def arith(tools, tmp, data: bytes, progressive: bool, restart: int = 0,
          dac=(0, 1, 5)) -> bytes:
    """`data`'s coefficients arithmetic-coded by libjpeg."""
    return _run_file(tools, tmp, "arith", [int(progressive), restart, *dac], data)


def gdcm(tools, tmp, samples: np.ndarray, bits: int, color: int, predictor: int,
         pt: int = 0, restart: int = 0, quality: int = 90) -> bytes:
    """A GDCM libjpeg frame of (H, W, C) samples: lossless with predictor
    1-7, or sequential at `quality` with predictor 0."""
    h, w, nc = samples.shape
    raw = samples.astype(np.uint8 if bits == 8 else np.uint16).tobytes()
    return _run_file(tools, tmp, f"gdcm{bits}", [w, h, nc, color, predictor, pt, restart,
                                                 quality], raw)


def lossless(planes, factors, precision: int, predictor: int, pt: int = 0,
             restart_mcus: int = 0, color: str = "rgb", hw=None) -> bytes:
    """A lossless (SOF3) stream of component planes (each at its own size
    for sampling `factors`), one interleaved scan (ITU-T T.81 Annex H):
    differences from predictor 1-7 (the first row of the scan and of each
    restart interval from the left, its first sample from 2^(P - Pt - 1)),
    Huffman-coded with one table over categories 0-16. `color` "rgb" writes
    an Adobe marker (transform 0) and component ids R, G, B; "cmyk" an
    Adobe marker and ids 1-4; anything else no marker, ids 1..n."""
    nc = len(planes)
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    height, width = hw or planes[0].shape
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    lengths = {s: min(2 + s // 2, 16) for s in range(17)}
    order = sorted(lengths, key=lambda s: (lengths[s], s))
    codes, code, prev = {}, 0, 0
    for s in order:
        code <<= lengths[s] - prev
        prev = lengths[s]
        codes[s] = (code, lengths[s])
        code += 1
    counts = [sum(1 for s in order if lengths[s] == n) for n in range(1, 17)]
    out = bytearray(b"\xff\xd8")
    if color in ("rgb", "cmyk"):
        out += b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    ids = [82, 71, 66] if color == "rgb" else list(range(1, nc + 1))
    sof = bytes([precision]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") + bytes([nc])
    sof += b"".join(bytes([ids[c], factors[c][0] << 4 | factors[c][1], 0]) for c in range(nc))
    out += b"\xff\xc3" + (len(sof) + 2).to_bytes(2, "big") + sof
    dht = bytes([0]) + bytes(counts) + bytes(order)
    out += b"\xff\xc4" + (len(dht) + 2).to_bytes(2, "big") + dht
    if restart_mcus:
        out += b"\xff\xdd\x00\x04" + restart_mcus.to_bytes(2, "big")
    sos = bytes([nc]) + b"".join(bytes([ids[c], 0]) for c in range(nc)) + bytes([predictor, 0, pt])
    out += b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos
    grids = [np.pad(p.astype(np.int64), ((0, mcuy * v - p.shape[0]), (0, mcux * h - p.shape[1])),
                    mode="edge") >> pt for p, (h, v) in zip(planes, factors)]
    init = 1 << (precision - pt - 1)
    acc, nbits, data = 0, 0, bytearray()

    def put(value, n):
        nonlocal acc, nbits
        for i in range(n - 1, -1, -1):
            acc = (acc << 1) | ((value >> i) & 1)
            nbits += 1
            if nbits == 8:
                data.append(acc)
                if acc == 0xFF:
                    data.append(0)
                acc, nbits = 0, 0

    def flush():
        if nbits:
            put((1 << (8 - nbits)) - 1, 8 - nbits)

    first_row = [0] * nc
    rst = 0
    for i in range(mcux * mcuy):
        my, mx = divmod(i, mcux)
        if restart_mcus and i and i % restart_mcus == 0:
            flush()
            data += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            first_row = [my * v for _, v in factors]
        for c, (g, (h, v)) in enumerate(zip(grids, factors)):
            for yy in range(v):
                for xx in range(h):
                    y, x = my * v + yy, mx * h + xx
                    if y == first_row[c]:
                        p = init if x == 0 else g[y, x - 1]
                    elif x == 0:
                        p = g[y - 1, 0]
                    else:
                        ra, rb, rc = g[y, x - 1], g[y - 1, x], g[y - 1, x - 1]
                        p = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                             rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1]
                    d = (int(g[y, x]) - int(p)) & 0xFFFF
                    d = d - 65536 if d >= 32768 else d
                    s = 0 if d == 0 else (16 if d == -32768 else abs(d).bit_length())
                    put(*codes[s])
                    if 0 < s < 16:
                        put(d if d > 0 else d + (1 << s) - 1, s)
    flush()
    return bytes(out + data + b"\xff\xd9")


def image(h: int, w: int, rng) -> np.ndarray:
    """An (h, w, 3) u8 RGB image: gradients and a little noise."""
    yy, xx = np.mgrid[:h, :w]
    f = np.stack([100 + 60 * np.sin(xx / 7.0), 120 + 50 * np.cos(yy / 5.0),
                  90 + 40 * np.sin((xx + yy) / 9.0)], -1) + rng.integers(-5, 6, (h, w, 3))
    return np.clip(f, 0, 255).astype(np.uint8)


def _read(*parts) -> bytes:
    with open(os.path.join(REPO, "tests", "data", *parts), "rb") as fh:
        return fh.read()


def jpeg_inputs(tools, tmp, rng) -> dict:
    f = {}
    for src, name in ((("torch_jpeg", "frame_720x405_q85_420.jpg"), "720x405_420"),
                      (("torch_jpeg", "frame_640x480_q85_420.jpg"), "640x480_420"),
                      (("torch_jpeg", "restart_319x241_q85.jpg"), "restart_319x241"),
                      (("torch_jpeg", "gray_319x241_q85.jpg"), "gray_319x241"),
                      (("torch_jpeg", "s444_319x241_q85.jpg"), "s444_319x241"),
                      (("torch_formats", "s411_83x41.jpg"), "s411_83x41"),
                      (("torch_formats", "cmyk_83x41.jpg"), "cmyk_83x41"),
                      (("torch_formats", "base_420_83x41.jpg"), "420_83x41")):
        data = _read(*src)
        restart = 7 if name.startswith("restart") else 0
        f[f"arith_seq_{name}.jpg"] = arith(tools, tmp, data, False, restart)
        f[f"arith_prog_{name}.jpg"] = arith(tools, tmp, data, True, restart)
    s444 = _read("torch_jpeg", "s444_319x241_q85.jpg")
    f["arith_seq_dac_s444_319x241.jpg"] = arith(tools, tmp, s444, False, 0, (1, 3, 2))
    f["arith_prog_dac_s444_319x241.jpg"] = arith(tools, tmp, s444, True, 0, (1, 3, 2))
    f["arith_prog_restart_420_83x41.jpg"] = arith(
        tools, tmp, _read("torch_formats", "base_420_83x41.jpg"), True, 3)
    coarse = cv2.imencode(".jpg", image(41, 83, np.random.default_rng(SEED + 1))[..., ::-1],
                          [cv2.IMWRITE_JPEG_QUALITY, 30])[1].tobytes()
    f["arith_seq_q30_420_83x41.jpg"] = arith(tools, tmp, coarse, False)

    rgb = image(41, 83, rng)
    for p in range(1, 8):
        f[f"lossless_rgb_p{p}_83x41.jpg"] = gdcm(tools, tmp, rgb, 8, 1, p)
    f["lossless_rgb_pt2_83x41.jpg"] = gdcm(tools, tmp, rgb, 8, 1, 5, pt=2)
    f["lossless_rgb_restart_83x41.jpg"] = gdcm(tools, tmp, rgb, 8, 1, 6, restart=2 * 83)
    f["lossless_gray_p1_83x41.jpg"] = gdcm(tools, tmp, rgb[..., :1], 8, 0, 1)
    f["lossless_gray_p7_83x41.jpg"] = gdcm(tools, tmp, rgb[..., :1], 8, 0, 7)
    f["lossless_jfif_ycc_83x41.jpg"] = gdcm(tools, tmp, rgb, 8, 2, 1)
    planes = [rgb[..., c] for c in range(3)]
    for bits in (2, 5, 7):
        f[f"lossless_{bits}bit_rgb_83x41.jpg"] = lossless(
            [p >> (8 - bits) for p in planes], [(1, 1)] * 3, bits, 4)
    f["lossless_sub_2x2_rgb_83x41.jpg"] = lossless(
        [planes[0], planes[1][::2, ::2], planes[2][::2, ::2]], [(2, 2), (1, 1), (1, 1)], 8, 7)
    f["lossless_sub_2x1_rgb_83x41.jpg"] = lossless(
        [planes[0], planes[1][:, ::2], planes[2][:, ::2]], [(2, 1), (1, 1), (1, 1)], 8, 1)
    f["lossless_noids_83x41.jpg"] = lossless(planes, [(1, 1)] * 3, 8, 3, color="")
    f["lossless_cmyk_83x41.jpg"] = lossless(planes + [255 - planes[0]], [(1, 1)] * 4, 8, 2,
                                            color="cmyk")
    f["lossless_midrow_restart_83x41.jpg"] = lossless(planes, [(1, 1)] * 3, 8, 6,
                                                      restart_mcus=10)
    rgb12 = rgb.astype(np.uint16) * 16
    f["bits12_sof1_rgb_83x41.jpg"] = gdcm(tools, tmp, rgb12, 12, 1, 0)
    f["bits12_sof1_gray_83x41.jpg"] = gdcm(tools, tmp, rgb12[..., :1], 12, 0, 0)
    f["bits12_sof3_rgb_83x41.jpg"] = gdcm(tools, tmp, rgb12, 12, 1, 1)
    f["bits16_sof3_rgb_83x41.jpg"] = gdcm(tools, tmp, rgb.astype(np.uint16) * 257, 16, 1, 1)
    return f


def cuts(data: bytes) -> list:
    """Cut points of a stream: inside its headers, inside its first scan,
    between scans, and just before its EOI marker."""
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    n = len(data)
    pts = {sos[0] // 2, sos[0] + 40, (sos[0] + n) // 2, (sos[0] + 3 * n) // 4, n - 2, n - 1}
    for s in sos[1:]:
        pts.update((s - 3, s + 20))
    return sorted(p for p in pts if 2 < p < n)


def largest_coefficient_cuts(data: bytes, n: int) -> list:
    """The n cut points (from the first SOS on) whose decodes by the port
    hold the largest dequantised coefficients."""
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
        JpegError, decode_coefs)
    scored = []
    for cut in range(data.index(b"\xff\xda"), len(data)):
        try:
            jc = decode_coefs(data[:cut])
        except JpegError:
            continue
        scored.append((max(int(np.abs(c.astype(np.int64) * q.astype(np.int64)).max())
                           for c, q in zip(jc.coefs, jc.qtabs)), cut))
    return sorted(cut for _, cut in sorted(scored, reverse=True)[:n])


def jpeg_dims(data: bytes):
    """(height, width) from the first SOF marker (any SOFn)."""
    i = 2
    while i + 9 < len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF):
            i += 1
            continue
        marker = data[i + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (int.from_bytes(data[i + 5:i + 7], "big"),
                    int.from_bytes(data[i + 7:i + 9], "big"))
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    raise ValueError("no SOF marker")


def digest(img):
    if img is None:
        return None
    return {"sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
            "shape": list(img.shape)}


def mp4_inputs(tools, tmp) -> dict:
    out = {}
    for name, args in (("high_160x96.mp4", ["mp4", "libx264", 160, 96, 48, 25, "high", 3, "-"]),
                       ("baseline_160x96.mp4", ["mp4", "libx264", 160, 96, 48, 25, "baseline",
                                                0, "faststart"]),
                       ("high_160x96.mov", ["mov", "libx264", 160, 96, 30, 30, "high", 2, "-"]),
                       ("fragmented_160x96.mp4", ["mp4", "libx264", 160, 96, 24, 25, "high", 2,
                                                  "frag_keyframe+empty_moov"]),
                       ("audio_only.mp4", ["mp4", "aac", 0, 0, 0, 0, "-", 0, "-"])):
        path = os.path.join(tmp, name)
        subprocess.run([tools["mp4write"], path, *map(str, args)], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        with open(path, "rb") as fh:
            out[name] = fh.read()
    path = os.path.join(tmp, "mp4v_160x96.mp4")   # what the JAX analyzer's --output writes
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (160, 96))
    yy, xx = np.mgrid[:96, :160]
    for i in range(30):
        f = np.stack([(xx * 2 + i * 5) % 256, (yy * 3 + i * 2) % 256, (xx + yy + i) % 256], -1)
        wr.write(f.astype(np.uint8))
    wr.release()
    with open(path, "rb") as fh:
        out["mp4v_160x96.mp4"] = fh.read()
    return out


def mp4_record(tools, path: str) -> dict:
    dump = json.loads(subprocess.run([tools["mp4dump"], path], check=True, capture_output=True,
                                     text=True).stdout)
    cap = cv2.VideoCapture(path)
    props = {"opened": bool(cap.isOpened()),
             "frame_count": cap.get(cv2.CAP_PROP_FRAME_COUNT),
             "fps": cap.get(cv2.CAP_PROP_FPS),
             "width": cap.get(cv2.CAP_PROP_FRAME_WIDTH),
             "height": cap.get(cv2.CAP_PROP_FRAME_HEIGHT)}
    cap.release()
    return {"libavformat": dump, "cv2": props}


def main() -> int:
    from real_time_video_deepfake_detection_tpu.utils.native_ingest import decode_jpeg, get_lib
    from real_time_video_deepfake_detection_tpu_torch.utils.jpeg_ingest import (
        JpegError, decode_coefs)
    lib = get_lib()
    if lib is None:
        raise SystemExit("the JAX package's native ingest library did not build")
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        tools = build(tmp)
        files = jpeg_inputs(tools, tmp, rng)
        videos = mp4_inputs(tools, tmp)
        for out_dir in (JPEG_OUT, MP4_OUT):
            shutil.rmtree(out_dir, ignore_errors=True)
            os.makedirs(out_dir)
        entries = dict(files)
        for base in ("arith_seq_420_83x41.jpg", "arith_prog_420_83x41.jpg"):
            for p in cuts(files[base]):
                entries[f"{base}@{p}"] = files[base][:p]
        base = "arith_seq_q30_420_83x41.jpg"
        for p in largest_coefficient_cuts(files[base], 3):
            entries[f"{base}@{p}"] = files[base][:p]
        out = {}
        for key, data in sorted(entries.items()):
            if "@" not in key:
                with open(os.path.join(JPEG_OUT, key), "wb") as fh:
                    fh.write(data)
            native = decode_jpeg(data)
            e = {"native": digest(native),
                 "cv2": digest(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))}
            if native is not None:
                h, w = jpeg_dims(data)
                e["scaled"] = {}
                for m in range(1, 9):
                    hint = scale_hint(h, w, m)
                    if hint:
                        e["scaled"][str(m)] = dict(digest(native_decode(lib, data, hint)),
                                                   hint=hint)
            try:
                e["smoothed"] = decode_coefs(data, "native").smoothing
            except JpegError:
                e["smoothed"] = False
            out[key] = e
        with open(os.path.join(JPEG_OUT, "digests.json"), "w") as fh:
            json.dump({"cv2": cv2.__version__, "inputs": out}, fh, indent=1, sort_keys=True)
            fh.write("\n")
        records = {}
        for name, data in sorted(videos.items()):
            path = os.path.join(MP4_OUT, name)
            with open(path, "wb") as fh:
                fh.write(data)
            records[name] = mp4_record(tools, path)
        with open(os.path.join(MP4_OUT, "packets.json"), "w") as fh:
            json.dump({"cv2": cv2.__version__, "files": records}, fh, indent=1, sort_keys=True)
            fh.write("\n")
    print(f"wrote {len(files)} JPEGs ({len(out)} digests) to {JPEG_OUT} and {len(videos)} "
          f"videos to {MP4_OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
