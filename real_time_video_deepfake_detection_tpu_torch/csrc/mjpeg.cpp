// Motion-JPEG frame decoder on the host: one AVI chunk's JPEG frame as
// cv2.VideoCapture's default (FFmpeg) backend gives it, that is as cv2 5.0's
// bundled libavcodec 62.28 mjpeg decoder computes its planes and libswscale
// 9.5 converts them to BGR24 (SWS_BICUBIC at the same size, the frame's
// BT.470BG matrix at full range).
//
// The entropy decode is csrc/jpeg_entropy.cpp's (libjpeg's and libavcodec's
// coefficients agree on an intact Huffman stream; a code not in its table,
// or a run past the end of a block, which libavcodec stops at and libjpeg
// reads on from, makes the frame damaged); then, as mjpegdec.c:
//   - the DC predictor starts at 4 << 8 = 1024 in dequantised units (the
//     level shift), so a block's DC is coef * q + 1024, saturated to 16 bits
//     in a sequential frame (av_clip_int16) and wrapped in a progressive one;
//     each AC coefficient is coef * q wrapped to 16 bits (an int16 store);
//   - the IDCT is libavcodec's x86-64 simple_idct8 (csrc/simple_idct.cpp),
//     put with saturation to [0, 255];
//   - the pixel format follows the sampling factors after mjpegdec's
//     halving of all-even factors: one component gray8, three YCbCr
//     components yuvj444p (1x1 1x1 1x1), yuvj422p (2x1 1x1 1x1), yuvj420p
//     (2x2 1x1 1x1), yuvj411p (4x1 1x1 1x1) or yuvj440p (1x2 1x1 1x1).
// The conversion is csrc/yuv2bgr.cpp's: gray and 4:4:4 through the
// full-chroma output, 4:2:0 and 4:2:2 at an even height through the
// unscaled yuv2rgb path, the rest (4:2:0 and 4:2:2 at an odd height, 4:1:1,
// 4:4:0) through libswscale's scaled path.
//
// Refused with a code of its own (utils/mjpeg.py names each): arithmetic
// coding (libavcodec's decoder refuses it too, and cv2 reads no frame),
// lossless frames, precisions other than 8 bits, RGB / CMYK / YCCK frames
// and other sampling factors. A frame whose data ends
// early or whose entropy-coded data is corrupt is "damaged" (libavcodec
// conceals it; utils/video.VideoReader stops there). Plain C interface,
// bound with ctypes, built with g++ at first use.

#include "jpeg_entropy.cpp"
#include "simple_idct.cpp"
#include "yuv2bgr.cpp"

namespace mjpeg {

enum Format { kGray8 = 0, k420 = 1, k422 = 2, k444 = 3, k411 = 4, k440 = 5 };

enum Refusal {
  kArithmetic = -20,
  kLosslessFrame = -21,
  kPrecision = -22,
  kColour = -23,
  kSampling = -24,
};

// probe output (kProbeLen int32): height, width, format, components,
// (h, v) of components 0-2 after the halving, progressive, precision,
// colour space (jpeg_entropy.cpp's ColorSpace)
constexpr int kProbeLen = 13;

struct Probe {
  int status = 0;
  int32_t out[kProbeLen] = {0};
  int32_t info[kInfoLen] = {0};
};

Probe probe(const uint8_t* data, size_t len) {
  Probe p;
  Decoder dec(data, len);
  int s = dec.run(nullptr, nullptr, nullptr);
  memcpy(p.info, dec.info, sizeof(p.info));
  int32_t* o = p.out;
  o[0] = dec.info[0];
  o[1] = dec.info[1];
  o[3] = dec.ncomp;
  o[10] = dec.progressive;
  o[11] = dec.precision;
  o[12] = dec.info[15];
  if (s == kLossless) {
    p.status = kLosslessFrame;
    return p;
  }
  if (dec.precision != 8) {   // read_sof refuses it after reading it
    p.status = kPrecision;
    return p;
  }
  if (s != kOk) {
    p.status = s;
    return p;
  }
  if (dec.arith) {
    p.status = kArithmetic;
    return p;
  }
  int h[3] = {1, 1, 1}, v[3] = {1, 1, 1};
  const int n = dec.ncomp < 3 ? dec.ncomp : 3;
  for (int c = 0; c < n; ++c) {
    h[c] = dec.info[7 + 2 * c];
    v[c] = dec.info[8 + 2 * c];
  }
  // mjpegdec.c: factors that are all even are halved, once
  bool even_h = true, even_v = true;
  for (int c = 0; c < n; ++c) {
    even_h = even_h && h[c] % 2 == 0;
    even_v = even_v && v[c] % 2 == 0;
  }
  for (int c = 0; c < n; ++c) {
    if (even_h) h[c] /= 2;
    if (even_v) v[c] /= 2;
    o[4 + 2 * c] = h[c];
    o[5 + 2 * c] = v[c];
  }
  if (dec.ncomp == 1) {
    o[2] = kGray8;
    return p;
  }
  if (dec.ncomp != 3 || dec.info[15] != kYCbCr) {
    p.status = kColour;
    return p;
  }
  const bool chroma_1x1 = h[1] == 1 && v[1] == 1 && h[2] == 1 && v[2] == 1;
  if (chroma_1x1 && h[0] == 1 && v[0] == 1) {
    o[2] = k444;
  } else if (chroma_1x1 && h[0] == 2 && v[0] == 1) {
    o[2] = k422;
  } else if (chroma_1x1 && h[0] == 2 && v[0] == 2) {
    o[2] = k420;
  } else if (chroma_1x1 && h[0] == 4 && v[0] == 1) {
    o[2] = k411;
  } else if (chroma_1x1 && h[0] == 1 && v[0] == 2) {
    o[2] = k440;
  } else {
    p.status = kSampling;
  }
  return p;
}

// Chroma subsampling (log2) of a format across and down.
void subsampling(int format, int* sx, int* sy) {
  *sx = format == k411 ? 2 : (format == k444 || format == k440 || format == kGray8 ? 0 : 1);
  *sy = format == k420 || format == k440 ? 1 : 0;
}

}  // namespace mjpeg

extern "C" {

int mjpeg_probe_len(void) { return mjpeg::kProbeLen; }

// The frame header of one JPEG frame into out (kProbeLen); 0 when the frame
// is decoded, else a negative code (jpeg_entropy.cpp's Status or
// mjpeg::Refusal).
int mjpeg_probe(const uint8_t* data, size_t len, int32_t* out) {
  const mjpeg::Probe p = mjpeg::probe(data, len);
  memcpy(out, p.out, sizeof(p.out));
  return p.status;
}

// One frame: its planes into y (h, w) and, unless gray, u and v (the
// format's chroma size; null skips the planes), and its BGR24 pixels into
// bgr (h, w, 3; null skips the conversion). 0, a refusal of mjpeg_probe,
// kTruncated when the data ends early, or kCorrupt.
int mjpeg_decode(const uint8_t* data, size_t len, uint8_t* y, uint8_t* u, uint8_t* v,
                 uint8_t* bgr) {
  using namespace mjpeg;
  const Probe p = probe(data, len);
  if (p.status != kOk) return p.status;
  const int32_t* info = p.info;
  const int ncomp = info[2], mcux = info[5], mcuy = info[6];
  int64_t total = 0, at[kMaxComps];
  for (int c = 0; c < ncomp; ++c) {
    at[c] = total;
    total += int64_t(mcuy) * info[8 + 2 * c] * mcux * info[7 + 2 * c] * 64;
  }
  std::vector<int16_t> coefs(total, 0);
  std::vector<uint16_t> qt(ncomp * 64, 0);
  Decoder dec(data, len);
  const int s = dec.run(info, coefs.data(), qt.data());
  if (s != kOk) return s == kTruncated ? kTruncated : (s < 0 ? s : kCorrupt);
  if (dec.src.eof || dec.overran) return kTruncated;
  if (dec.huff_errors) return kCorrupt;   // libavcodec stops at a bad code

  const int h = p.out[0], w = p.out[1], format = p.out[2];
  const bool progressive = p.out[10];
  int sx = 0, sy = 0;
  subsampling(format, &sx, &sy);
  const int ch = (h + (1 << sy) - 1) >> sy, cw = (w + (1 << sx) - 1) >> sx;
  std::vector<uint8_t> planes[3];
  int pitch[3] = {0, 0, 0};
  for (int c = 0; c < (format == kGray8 ? 1 : 3); ++c) {
    const int bh = mcuy * info[8 + 2 * c], bw = mcux * info[7 + 2 * c];
    pitch[c] = bw * 8;
    planes[c].assign(size_t(bh) * 8 * pitch[c], 0);
    const uint16_t* q = qt.data() + 64 * c;
    int16_t block[64];
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        const int16_t* cf = coefs.data() + at[c] + (int64_t(by) * bw + bx) * 64;
        // 32-bit products that wrap, as mjpegdec.c's
        const int32_t dc = int32_t(uint32_t(int32_t(cf[0])) * q[0] + 1024u);
        block[0] = progressive ? int16_t(uint16_t(dc)) : simple_idct::sat16(dc);
        for (int k = 1; k < 64; ++k) block[k] = int16_t(uint16_t(uint32_t(int32_t(cf[k])) * q[k]));
        simple_idct::idct_put(planes[c].data() + int64_t(by) * 8 * pitch[c] + bx * 8, pitch[c],
                              block);
      }
  }
  if (y) {
    for (int r = 0; r < h; ++r) memcpy(y + int64_t(r) * w, planes[0].data() + int64_t(r) * pitch[0], w);
    if (format != kGray8 && u && v)
      for (int r = 0; r < ch; ++r) {
        memcpy(u + int64_t(r) * cw, planes[1].data() + int64_t(r) * pitch[1], cw);
        memcpy(v + int64_t(r) * cw, planes[2].data() + int64_t(r) * pitch[2], cw);
      }
  }
  if (bgr) {
    constexpr int kBt470bg = 5;
    if (format == kGray8)
      yuv444_to_bgr(planes[0].data(), pitch[0], nullptr, nullptr, 0, w, h, bgr, 3 * w, kBt470bg, 1);
    else if (format == k444)
      yuv444_to_bgr(planes[0].data(), pitch[0], planes[1].data(), planes[2].data(), pitch[1], w,
                    h, bgr, 3 * w, kBt470bg, 1);
    else if ((format == k420 || format == k422) && !(h & 1))   // the unscaled path
      yuv_nearest_to_bgr(planes[0].data(), pitch[0], planes[1].data(), planes[2].data(),
                         pitch[1], w, h, bgr, 3 * w, kBt470bg, 1, format == k420 ? 1 : 0);
    else
      yuv_scaled_to_bgr(planes[0].data(), pitch[0], planes[1].data(), planes[2].data(),
                        pitch[1], w, h, sx, sy, bgr, 3 * w, kBt470bg, 1);
  }
  return 0;
}

}  // extern "C"
