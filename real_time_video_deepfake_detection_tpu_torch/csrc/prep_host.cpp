// One-call host prep of a request in host-prep serving: the port's
// counterpart of the JAX package's ingest_prep_frame (native/ingest.cpp).
//
//   JPEG decode -> analysis resize (ah, aw) -> heuristic face detection on
//   the decoded frame -> crop -> Lab -> CLAHE on L (clip 2.0, 8x8 tiles)
//   -> BGR -> RGB -> align resize (align, align)
//
// all in one call, bound with ctypes (utils/native_prep.py), which releases
// the GIL while it runs. Each step equals its Python counterpart byte for
// byte:
//
//   decode      utils/jpeg_ingest.decode_jpeg: the entropy decoder and the
//               host inverse DCT of jpeg_entropy.cpp (included below, not
//               copied), then ops/jpeg_decode.bgr_from_components'
//               upsampling and colour conversion (libjpeg's defaults)
//   resizes     utils/host_resize.resize_analysis (cv2's INTER_LINEAR in
//               fixed point), a copy of the JAX package's resize_u8_cv2
//   detection   models/heuristic_face.detect_heuristic's first box, a copy
//               of detect_heuristic_native
//   Lab         the native float pair of lab_host.cpp (included below)
//   CLAHE       ops/clahe.clahe_u8_numpy, a copy of clahe_u8_native
//
// Built with the JAX package's flags (g++ -O3 -march=native
// -ffp-contract=off), so that its float steps round as JAX's library does.

#include "jpeg_entropy.cpp"
#include "lab_host.cpp"

#include <cmath>
#include <vector>

namespace prep {

// ------------------------------------------------------------- decode

constexpr int kScaleBits = 16;
constexpr int32_t kOneHalf = int32_t(1) << (kScaleBits - 1);

constexpr int32_t fix(double x) { return static_cast<int32_t>(x * (1 << kScaleBits) + 0.5); }

// One component's samples (ch, cw), up by whole factors (sx, sy) as
// jdsample.c picks the method (ops/jpeg_decode._upsample): h2v2 and h2v1
// fancy when the component is wider than 2 samples, h1v2 fancy, and
// replication for every other ratio.
std::vector<uint8_t> upsample(const uint8_t* p, int pitch, int ch, int cw, int sx, int sy) {
  const int oh = ch * sy, ow = cw * sx;
  std::vector<uint8_t> out(static_cast<size_t>(oh) * ow);
  auto at = [&](int y, int x) -> int32_t {
    y = std::min(std::max(y, 0), ch - 1);
    x = std::min(std::max(x, 0), cw - 1);
    return p[static_cast<size_t>(y) * pitch + x];
  };
  const bool small = cw <= 2;
  const bool fancy = (sx == 2 && sy <= 2 && !small) || (sx == 1 && sy == 2);
  for (int y = 0; y < ch; ++y) {
    for (int x = 0; x < cw; ++x) {
      const int32_t c = at(y, x);
      if (!fancy) {
        for (int dy = 0; dy < sy; ++dy)
          for (int dx = 0; dx < sx; ++dx)
            out[static_cast<size_t>(y * sy + dy) * ow + sx * x + dx] = static_cast<uint8_t>(c);
      } else if (sx == 2 && sy == 2) {
        // triangle filter over columns of (3 * row + the row above/below)
        for (int dy = 0; dy < 2; ++dy) {
          const int nb = dy == 0 ? y - 1 : y + 1;
          auto colsum = [&](int xx) { return at(y, xx) * 3 + at(nb, xx); };
          const int32_t s = colsum(x);
          const int32_t even = x == 0 ? (s * 4 + 8) >> 4 : (s * 3 + colsum(x - 1) + 8) >> 4;
          const int32_t odd = x == cw - 1 ? (s * 4 + 7) >> 4 : (s * 3 + colsum(x + 1) + 7) >> 4;
          uint8_t* row = out.data() + static_cast<size_t>(2 * y + dy) * ow;
          row[2 * x] = static_cast<uint8_t>(even);
          row[2 * x + 1] = static_cast<uint8_t>(odd);
        }
      } else if (sx == 2) {   // h2v1
        uint8_t* row = out.data() + static_cast<size_t>(y) * ow;
        row[2 * x] = static_cast<uint8_t>((c * 3 + at(y, x - 1) + 1) >> 2);
        row[2 * x + 1] = static_cast<uint8_t>((c * 3 + at(y, x + 1) + 2) >> 2);
      } else {   // h1v2
        out[static_cast<size_t>(2 * y) * ow + x] =
            static_cast<uint8_t>((c * 3 + at(y - 1, x) + 1) >> 2);
        out[static_cast<size_t>(2 * y + 1) * ow + x] =
            static_cast<uint8_t>((c * 3 + at(y + 1, x) + 2) >> 2);
      }
    }
  }
  return out;
}

// A stream -> (h, w, 3) BGR u8, libjpeg's default decode to BGR as the
// JAX package's prep_frame runs it; 0 or a negative status: the entropy
// decoder's, or -6 for CMYK and YCCK (utils/jpeg_ingest.STATUS).
int decode_bgr(const uint8_t* data, size_t len, std::vector<uint8_t>* bgr, int* out_h,
               int* out_w) {
  Decoder probe(data, len);
  if (const int s = probe.run(nullptr, nullptr, nullptr)) return s;
  const int32_t* info = probe.info;
  const int space = info[15];
  if (space == kCMYK || space == kYCCK) return -6;
  const int height = info[0], width = info[1], ncomp = info[2];
  const int hmax = info[3], vmax = info[4], mcux = info[5], mcuy = info[6];
  std::vector<int64_t> offset(ncomp + 1, 0);
  for (int c = 0; c < ncomp; ++c)
    offset[c + 1] = offset[c] + int64_t(mcuy) * info[8 + 2 * c] * mcux * info[7 + 2 * c] * 64;
  std::vector<int16_t> coefs(offset[ncomp], 0);
  std::vector<uint16_t> qtabs(static_cast<size_t>(ncomp) * 64);
  int32_t extra[kExtraLen];
  if (const int s = jpeg_decode_coefs_impl(data, len, info, coefs.data(), qtabs.data(), extra,
                                           true))
    return s;

  std::vector<std::vector<uint8_t>> planes(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const int h = info[7 + 2 * c], v = info[8 + 2 * c];
    const int bh = mcuy * v, bw = mcux * h;
    std::vector<uint8_t> samples(static_cast<size_t>(bh) * 8 * bw * 8);
    idct_plane(coefs.data() + offset[c], qtabs.data() + 64 * c, bh, bw, samples.data());
    const int ch = (height * v + vmax - 1) / vmax, cw = (width * h + hmax - 1) / hmax;
    planes[c] = upsample(samples.data(), bw * 8, ch, cw, hmax / h, vmax / v);
    // the upsampled plane is at least (height, width); keep its pitch
    std::vector<uint8_t> crop(static_cast<size_t>(height) * width);
    const int pitch = cw * (hmax / h);
    for (int y = 0; y < height; ++y)
      memcpy(crop.data() + static_cast<size_t>(y) * width,
             planes[c].data() + static_cast<size_t>(y) * pitch, width);
    planes[c].swap(crop);
  }
  bgr->resize(static_cast<size_t>(height) * width * 3);
  uint8_t* o = bgr->data();
  const size_t n = static_cast<size_t>(height) * width;
  if (ncomp == 1) {
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = planes[0][i];
  } else if (space == kRGB) {
    for (size_t i = 0; i < n; ++i) {
      o[3 * i] = planes[2][i];
      o[3 * i + 1] = planes[1][i];
      o[3 * i + 2] = planes[0][i];
    }
  } else {   // jdcolor.c ycc_rgb_convert
    auto clamp = [](int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; ++i) {
      const int32_t y = planes[0][i], cb = planes[1][i] - 128, cr = planes[2][i] - 128;
      o[3 * i + 0] = clamp(y + ((fix(1.77200) * cb + kOneHalf) >> kScaleBits));
      o[3 * i + 1] = clamp(y + ((-fix(0.34414) * cb + -fix(0.71414) * cr + kOneHalf - 1) >>
                                kScaleBits));
      o[3 * i + 2] = clamp(y + ((fix(1.40200) * cr + kOneHalf) >> kScaleBits));
    }
  }
  *out_h = height;
  *out_w = width;
  return 0;
}

// ------------------------------------------------------------- resize
//
// cv2 INTER_LINEAR on u8 in fixed point (INTER_RESIZE_COEF_BITS 11),
// positions in double with the residual in float as resize.cpp keeps it,
// and the exact-2x rewrite to 2x2 area averaging; the JAX package's
// resize_u8_cv2, as it stands.

struct LinTab {
  std::vector<int> s0, s1;
  std::vector<int32_t> a0, a1;
};

LinTab make_tab(int src, int dst) {
  LinTab t;
  t.s0.resize(dst);
  t.s1.resize(dst);
  t.a0.resize(dst);
  t.a1.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int x = 0; x < dst; ++x) {
    float f = static_cast<float>((x + 0.5) * scale - 0.5);
    int sx = static_cast<int>(std::floor(f));
    f -= static_cast<float>(sx);
    if (sx < 0) {
      sx = 0;
      f = 0.0f;
    }
    if (sx >= src - 1) {
      sx = src - 1;
      f = 0.0f;
    }
    t.s0[x] = sx;
    t.s1[x] = std::min(sx + 1, src - 1);
    t.a1[x] = static_cast<int32_t>(std::nearbyintf(f * 2048.0f));
    t.a0[x] = static_cast<int32_t>(std::nearbyintf((1.0f - f) * 2048.0f));
  }
  return t;
}

void resize_u8_cv2(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh, int dw) {
  if (sh == dh && sw == dw) {
    memcpy(dst, src, static_cast<size_t>(sh) * sw * 3);
    return;
  }
  if (sh == 2 * dh && sw == 2 * dw) {
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = src + static_cast<size_t>(2 * y) * sw * 3;
      const uint8_t* r1 = r0 + static_cast<size_t>(sw) * 3;
      uint8_t* d = dst + static_cast<size_t>(y) * dw * 3;
      for (int x = 0; x < dw; ++x) {
        for (int c = 0; c < 3; ++c) {
          const int i = (2 * x) * 3 + c;
          const int s = r0[i] + r0[i + 3] + r1[i] + r1[i + 3];
          d[x * 3 + c] = static_cast<uint8_t>((s + 2) >> 2);
        }
      }
    }
    return;
  }
  const LinTab tx = make_tab(sw, dw);
  const LinTab ty = make_tab(sh, dh);
  std::vector<int32_t> hbuf(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw * 3;
    int32_t* hrow = hbuf.data() + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const uint8_t* p0 = srow + tx.s0[x] * 3;
      const uint8_t* p1 = srow + tx.s1[x] * 3;
      for (int c = 0; c < 3; ++c) hrow[x * 3 + c] = p0[c] * tx.a0[x] + p1[c] * tx.a1[x];
    }
  }
  for (int y = 0; y < dh; ++y) {
    const int32_t* r0 = hbuf.data() + static_cast<size_t>(ty.s0[y]) * dw * 3;
    const int32_t* r1 = hbuf.data() + static_cast<size_t>(ty.s1[y]) * dw * 3;
    const int32_t b0 = ty.a0[y], b1 = ty.a1[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int i = 0; i < dw * 3; ++i) {
      int32_t v = ((b0 * (r0[i] >> 4)) >> 16) + ((b1 * (r1[i] >> 4)) >> 16);
      v = (v + 2) >> 2;
      drow[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// ------------------------------------------------- heuristic detection
//
// models/heuristic_face.detect_heuristic: the YCrCb skin mask in float32
// in numpy's order of operations, the 2nd and 98th percentiles of the
// mask's coordinates with numpy's linear interpolation, then the size,
// density and aspect gates.

bool detect_heuristic(const uint8_t* bgr, int h, int w, int box[4]) {
  if (h < 40 || w < 40) return false;
  std::vector<uint8_t> mask(static_cast<size_t>(h) * w);
  std::vector<int64_t> xhist(w, 0), yhist(h, 0);
  int64_t count = 0;
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = bgr + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const float b = row[x * 3 + 0];
      const float g = row[x * 3 + 1];
      const float r = row[x * 3 + 2];
      const float yy = 0.299f * r + 0.587f * g + 0.114f * b;
      const float cr = (r - yy) * 0.713f + 128.0f;
      const float cb = (b - yy) * 0.564f + 128.0f;
      const bool skin = cr >= 133.0f && cr <= 173.0f && cb >= 77.0f && cb <= 127.0f;
      mask[static_cast<size_t>(y) * w + x] = skin;
      if (skin) {
        ++count;
        ++xhist[x];
        ++yhist[y];
      }
    }
  }
  const double frac = static_cast<double>(count) / (static_cast<double>(h) * w);
  if (frac < 0.04) return false;

  auto order_stat = [](const std::vector<int64_t>& hist, int64_t k) {
    int64_t seen = 0;
    for (size_t v = 0; v < hist.size(); ++v) {
      seen += hist[v];
      if (seen > k) return static_cast<int64_t>(v);
    }
    return static_cast<int64_t>(hist.size() - 1);
  };
  auto percentile = [&](const std::vector<int64_t>& hist, double q) {
    const double pos = static_cast<double>(count - 1) * q / 100.0;
    const int64_t lo = static_cast<int64_t>(std::floor(pos));
    const double f = pos - static_cast<double>(lo);
    const int64_t a = order_stat(hist, lo);
    const int64_t b = f > 0.0 ? order_stat(hist, lo + 1) : a;
    return static_cast<double>(a) + (static_cast<double>(b) - a) * f;
  };
  const int x1 = static_cast<int>(percentile(xhist, 2.0));
  const int x2 = static_cast<int>(percentile(xhist, 98.0));
  const int y1 = static_cast<int>(percentile(yhist, 2.0));
  const int y2 = static_cast<int>(percentile(yhist, 98.0));
  const int bw = x2 - x1, bh = y2 - y1;
  if (bw < 40 || bh < 40) return false;
  int64_t inner = 0;
  for (int y = y1; y < y2; ++y)
    for (int x = x1; x < x2; ++x) inner += mask[static_cast<size_t>(y) * w + x];
  const double density = static_cast<double>(inner) / (static_cast<double>(bw) * bh);
  if (density < 0.45) return false;
  const double ar = static_cast<double>(bw) / std::max(bh, 1);
  if (ar < 0.3 || ar > 2.5) return false;
  box[0] = x1;
  box[1] = y1;
  box[2] = bw;
  box[3] = bh;
  return true;
}

// ---------------------------------------------------------------- CLAHE
//
// ops/clahe.clahe_u8_numpy: cv2 5.0's padding rule (a divisible side gets
// a full extra tile whenever the other side is padded) with reflect-101,
// clip and uniform redistribution with residual stepping, rounded-CDF
// LUTs, float32 bilinear LUT interpolation in numpy's order.

void clahe_u8(const uint8_t* src, int h, int w, double clip_limit, int tiles, uint8_t* dst) {
  const bool pad = (h % tiles) != 0 || (w % tiles) != 0;
  const int ph = pad ? tiles - (h % tiles) : 0;
  const int pw = pad ? tiles - (w % tiles) : 0;
  const int tile_h = (h + ph) / tiles;
  const int tile_w = (w + pw) / tiles;
  const int H = h + ph, W = w + pw;
  std::vector<uint8_t> img(static_cast<size_t>(H) * W);
  for (int y = 0; y < H; ++y) {
    const int sy = y < h ? y : 2 * (h - 1) - y;
    for (int x = 0; x < W; ++x) {
      const int sx = x < w ? x : 2 * (w - 1) - x;
      img[static_cast<size_t>(y) * W + x] = src[static_cast<size_t>(sy) * w + sx];
    }
  }
  const int tile_area = tile_h * tile_w;
  const int clip =
      clip_limit > 0.0 ? std::max(static_cast<int>(clip_limit * tile_area / 256), 1) : 0;

  std::vector<uint8_t> luts(static_cast<size_t>(tiles) * tiles * 256);
  std::vector<int64_t> hist(256);
  for (int ty = 0; ty < tiles; ++ty) {
    for (int tx = 0; tx < tiles; ++tx) {
      std::fill(hist.begin(), hist.end(), 0);
      for (int y = ty * tile_h; y < (ty + 1) * tile_h; ++y)
        for (int x = tx * tile_w; x < (tx + 1) * tile_w; ++x)
          ++hist[img[static_cast<size_t>(y) * W + x]];
      if (clip > 0) {
        int64_t excess = 0;
        for (int i = 0; i < 256; ++i)
          if (hist[i] > clip) {
            excess += hist[i] - clip;
            hist[i] = clip;
          }
        const int64_t batch = excess / 256;
        const int64_t residual = excess - batch * 256;
        for (int i = 0; i < 256; ++i) hist[i] += batch;
        if (residual) {
          const int step = std::max(static_cast<int>(256 / residual), 1);
          for (int64_t r = 0; r < residual; ++r) hist[r * step] += 1;
        }
      }
      const double scale = 255.0 / tile_area;
      int64_t cdf = 0;
      uint8_t* lut = luts.data() + (static_cast<size_t>(ty) * tiles + tx) * 256;
      for (int i = 0; i < 256; ++i) {
        cdf += hist[i];
        const double v = std::nearbyint(cdf * scale);
        lut[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }

  for (int y = 0; y < h; ++y) {
    const float tyf = y * (1.0f / tile_h) - 0.5f;
    const int ty1 = static_cast<int>(std::floor(tyf));
    const float ya = tyf - ty1;
    const int ty1c = std::min(std::max(ty1, 0), tiles - 1);
    const int ty2c = std::min(std::max(ty1 + 1, 0), tiles - 1);
    for (int x = 0; x < w; ++x) {
      const float txf = x * (1.0f / tile_w) - 0.5f;
      const int tx1 = static_cast<int>(std::floor(txf));
      const float xa = txf - tx1;
      const int tx1c = std::min(std::max(tx1, 0), tiles - 1);
      const int tx2c = std::min(std::max(tx1 + 1, 0), tiles - 1);
      const uint8_t v = img[static_cast<size_t>(y) * W + x];
      const float tl = luts[(static_cast<size_t>(ty1c) * tiles + tx1c) * 256 + v];
      const float tr = luts[(static_cast<size_t>(ty1c) * tiles + tx2c) * 256 + v];
      const float bl = luts[(static_cast<size_t>(ty2c) * tiles + tx1c) * 256 + v];
      const float br = luts[(static_cast<size_t>(ty2c) * tiles + tx2c) * 256 + v];
      const float top = tl * (1.0f - xa) + tr * xa;
      const float bot = bl * (1.0f - xa) + br * xa;
      float out = top * (1.0f - ya) + bot * ya;
      out = std::nearbyintf(out);
      dst[static_cast<size_t>(y) * w + x] =
          static_cast<uint8_t>(out < 0 ? 0 : (out > 255 ? 255 : out));
    }
  }
}

}  // namespace prep

extern "C" {

// The per-request prep of host-prep serving in one call.
// out_frame: (ah, aw, 3) u8 BGR analysis frame, written unless refused;
// out_aligned: (align, align, 3) u8 RGB aligned face, written iff a face;
// out_box: x, y, w, h on the decoded frame, written iff a face.
// Returns 1 (a face), 0 (no face), or the entropy decoder's negative
// status when it refuses the stream.
int prep_frame(const uint8_t* data, size_t len, uint8_t* out_frame, int ah, int aw,
               uint8_t* out_aligned, int align, int32_t* out_box) {
  std::vector<uint8_t> frame;
  int h = 0, w = 0;
  if (const int s = prep::decode_bgr(data, len, &frame, &h, &w)) return s;
  prep::resize_u8_cv2(frame.data(), h, w, out_frame, ah, aw);

  int box[4];
  if (!prep::detect_heuristic(frame.data(), h, w, box)) return 0;
  const int x = box[0], y = box[1], bw = box[2], bh = box[3];
  const int n = bh * bw;
  std::vector<uint8_t> crop(static_cast<size_t>(n) * 3);
  for (int yy = 0; yy < bh; ++yy)
    memcpy(crop.data() + static_cast<size_t>(yy) * bw * 3,
           frame.data() + (static_cast<size_t>(y + yy) * w + x) * 3, static_cast<size_t>(bw) * 3);
  // Lab -> CLAHE on L -> BGR (pipeline/detector.preprocess_face_quality,
  // the native rung)
  std::vector<uint8_t> lab(static_cast<size_t>(n) * 3), l(n), l_eq(n);
  lab_bgr2lab(crop.data(), n, lab.data());
  for (int i = 0; i < n; ++i) l[i] = lab[static_cast<size_t>(i) * 3];
  prep::clahe_u8(l.data(), bh, bw, 2.0, 8, l_eq.data());
  for (int i = 0; i < n; ++i) lab[static_cast<size_t>(i) * 3] = l_eq[i];
  lab_lab2bgr(lab.data(), n, crop.data());
  // BGR -> RGB and the resize aligner
  for (int i = 0; i < n; ++i)
    std::swap(crop[static_cast<size_t>(i) * 3], crop[static_cast<size_t>(i) * 3 + 2]);
  prep::resize_u8_cv2(crop.data(), bh, bw, out_aligned, align, align);
  out_box[0] = x;
  out_box[1] = y;
  out_box[2] = bw;
  out_box[3] = bh;
  return 1;
}

}  // extern "C"
