// yuv420p / yuv422p / yuv444p / gray -> BGR24 at the same size, as
// cv2.VideoCapture's FFmpeg backend converts a decoded frame (cv2 5.0 calls
// sws_scale with SWS_BICUBIC on the bundled libswscale 9.5).
//
// 4:2:0 and 4:2:2 at an even height: libswscale's unscaled yuv2rgb path,
// whose x86 SIMD routine cv2's frame buffers always run to the end of the
// row. Each luma sample takes the chroma sample at (x >> 1, y >> 1) (4:2:0)
// or (x >> 1, y) (4:2:2): no interpolation. The SIMD routine works in
// 16-bit lanes:
//   y' = ((Y << 3) - yOffset) * yCoeff >> 16          (signed, not clamped)
//   B  = y' + ((U << 3) - 1024) * ubCoeff >> 16
//   G  = y' + ((U << 3) - 1024) * ugCoeff >> 16 + ((V << 3) - 1024) * vgCoeff >> 16
//   R  = y' + ((V << 3) - 1024) * vrCoeff >> 16
// each >> 16 the high half of a signed 16x16 product (pmulhw), the result
// saturated to 0..255. The coefficients are libswscale's
// ff_yuv2rgb_c_init_tables at brightness 0, contrast and saturation 1.0,
// from the stream's matrix (VUI matrix_coefficients, as FFmpeg 8 passes the
// frame's colour space) and range (video_full_range_flag).
//
// 4:4:4 and gray: no unscaled converter takes them, and input chroma that
// is not subsampled makes libswscale interpolate chroma in full
// (SWS_FULL_CHR_H_INT); at an unchanged size both scalers are the identity
// (one tap of 1 << 14: Y << 7 in 15 bits), and yuv2rgb_full_1_c writes
//   Y' = (Y << 9) * yCoeff + (1 << 21)   (full range: no offset)
//   R  = Y' + (V - 128 << 9) * v2r,  G = Y' + (V - 128 << 9) * v2g + (U - 128 << 9) * u2g,
//   B  = Y' + (U - 128 << 9) * u2b
// clipped to [0, 2^30) when any of the three leaves it, then >> 22; the
// coefficients are ff_yuv2rgb_c_init_tables' yuv2rgb_* at 1 << 13. Gray
// (no chroma) comes out as B = G = R = Y at full range.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace yuv2bgr {

// ff_yuv2rgb_coeffs: crv, cbu, cgu, cgv by matrix_coefficients (AVColorSpace)
static const int32_t kInvTables[11][4] = {
    {104597, 132201, 25675, 53279},  // 0: RGB / none
    {117489, 138438, 13975, 34925},  // 1: BT.709
    {104597, 132201, 25675, 53279},  // 2: unspecified
    {104597, 132201, 25675, 53279},  // 3: reserved
    {104448, 132798, 24759, 53109},  // 4: FCC
    {104597, 132201, 25675, 53279},  // 5: BT.470BG
    {104597, 132201, 25675, 53279},  // 6: SMPTE 170M
    {117579, 136230, 16907, 35559},  // 7: SMPTE 240M
    {104597, 132201, 25675, 53279},  // 8: YCgCo (sws_getCoefficients' default)
    {110013, 140363, 12277, 42626},  // 9: BT.2020 NCL
    {110013, 140363, 12277, 42626},  // 10: BT.2020 CL
};

struct Coeffs {
  int y, vr, ub, vg, ug, yoff;
};

static int round_to_int16(int64_t f) {
  int64_t r = (f + (1 << 15)) >> 16;
  if (r < -32768) r = -32768;
  if (r > 32767) r = 32767;
  return (int)r;
}

static Coeffs coeffs(int matrix, int full_range) {
  const int32_t* inv = kInvTables[(matrix < 0 || matrix > 10) ? 2 : matrix];
  int64_t crv = inv[0], cbu = inv[1], cgu = -inv[2], cgv = -inv[3];
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  const int64_t contrast = 1 << 16, saturation = 1 << 16;
  cy = (cy * contrast) >> 16;
  crv = (crv * contrast * saturation) >> 32;
  cbu = (cbu * contrast * saturation) >> 32;
  cgu = (cgu * contrast * saturation) >> 32;
  cgv = (cgv * contrast * saturation) >> 32;
  Coeffs c;
  c.y = round_to_int16(cy * (1 << 13));
  c.vr = round_to_int16(crv * (1 << 13));
  c.ub = round_to_int16(cbu * (1 << 13));
  c.vg = round_to_int16(cgv * (1 << 13));
  c.ug = round_to_int16(cgu * (1 << 13));
  c.yoff = round_to_int16(oy * (1 << 3));
  return c;
}

// yuv2rgb_y_coeff, _y_offset, _v2r, _v2g, _u2g, _u2b (the full-chroma path)
struct FullCoeffs {
  int64_t y, yoff, vr, vg, ug, ub;
};

static FullCoeffs full_coeffs(int matrix, int full_range) {
  const int32_t* inv = kInvTables[(matrix < 0 || matrix > 10) ? 2 : matrix];
  int64_t crv = inv[0], cbu = inv[1], cgu = -inv[2], cgv = -inv[3];
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  FullCoeffs c;
  c.y = round_to_int16(cy * (1 << 13));
  c.yoff = round_to_int16(oy * (1 << 9));
  c.vr = round_to_int16(crv * (1 << 13));
  c.vg = round_to_int16(cgv * (1 << 13));
  c.ug = round_to_int16(cgu * (1 << 13));
  c.ub = round_to_int16(cbu * (1 << 13));
  return c;
}

// av_clip_uintp2(v, 30) of an int
static inline int64_t clip30(uint32_t v) {
  const int32_t s = (int32_t)v;
  return s < 0 ? 0 : (s > (1 << 30) - 1 ? (1 << 30) - 1 : s);
}

static inline int16_t sat16(int v) {
  return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

static inline int mulhi(int a, int b) { return (a * b) >> 16; }

static inline uint8_t u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }


// ------------------------------------------------ the scaled (bicubic) path
//
// libswscale converts 4:2:0 and 4:2:2 at an odd height, and 4:1:1 and
// 4:4:0 at any size, through its scaled path even at an unchanged size:
// chroma rows are scaled horizontally (8 to 15 bits: sum of src x the
// filter, >> 7) to half the width (or the whole width where it
// interpolates chroma in full: an odd width, or chroma that is not
// subsampled at all), then each output row is filtered vertically from the
// chroma rows and converted. The filters are initFilter's for SWS_BICUBIC
// (B 0, C 0.6) at the chroma siting libswscale derives for these formats
// (both sides centred: position 128), normalised to 1 << 14 (horizontal,
// taps aligned to 4) and 1 << 12 (vertical, aligned to 2); the luma
// filters are the identity. The output stage depends on the row and on
// the vertical chroma filter: a filter of one tap, or of two summing to
// 4096, is libswscale's "1" stage (its second coefficient the blend), any
// other its "X" stage; every row but the last two runs the x86 mmxext
// routines (the 16-bit pmulhw arithmetic of the unscaled path; X sums each
// tap's pmulhw onto a rounder of 4, 1 shifts right by 4 and blends two
// rows as (a + b) >> 5 unsigned), and the last two rows the C ones
// (yuv2rgb_1_c / yuv2rgb_X_c through ff_yuv2rgb_c_init_tables' lookup
// tables; 1 blends as (a (4096 - alpha) + b alpha + 2^18) >> 19). Full
// chroma is C on every row (yuv2rgb_full_1_c, _X_c and the full write).

struct Filter {
  int size = 1;
  std::vector<int> pos;
  std::vector<int32_t> coef;   // size taps a row
};

static int64_t cdiv(int64_t a, int64_t b) { return a / b; }   // C truncation
static int64_t rounded_div(int64_t a, int64_t b) {
  return a >= 0 ? (a + (b >> 1)) / b : (a - (b >> 1)) / b;
}
static int av_log2(int64_t v) {
  int n = 0;
  while (v > 1) {
    v >>= 1;
    ++n;
  }
  return n;
}

// libswscale's initFilter for SWS_BICUBIC (the default parameters).
static Filter init_filter(int64_t xinc, int src_w, int dst_w, int align, int64_t one,
                          int src_pos, int dst_pos) {
  const int64_t fone = int64_t(1) << (54 - std::min(av_log2(src_w / dst_w), 8));
  int fsize;
  std::vector<int64_t> f;
  std::vector<int> pos(dst_w);
  if (std::llabs(xinc - 0x10000) < 10 && src_pos == dst_pos) {   // unscaled
    fsize = 1;
    f.assign(dst_w, fone);
    for (int i = 0; i < dst_w; ++i) pos[i] = i;
  } else {
    const int size_factor = 4;
    fsize = xinc <= (1 << 16) ? 1 + size_factor
                              : 1 + (size_factor * src_w + dst_w - 1) / dst_w;
    fsize = std::max(std::min(fsize, src_w - 2), 1);
    f.assign(int64_t(dst_w) * fsize, 0);
    int64_t x_dst_in_src = ((dst_pos * xinc) >> 7) - ((src_pos * int64_t(0x10000)) >> 7);
    const int64_t B = 0, C = int64_t(0.6 * (1 << 24));
    for (int i = 0; i < dst_w; ++i) {
      int xx = (int)cdiv(x_dst_in_src - (fsize - 2) * (int64_t(1) << 16), int64_t(1) << 17);
      pos[i] = xx;
      for (int j = 0; j < fsize; ++j) {
        int64_t d = std::llabs(int64_t(xx) * (int64_t(1) << 17) - x_dst_in_src) << 13;
        if (xinc > (1 << 16)) d = d * dst_w / src_w;
        int64_t coeff;
        if (d >= int64_t(1) << 31) {
          coeff = 0;
        } else {
          const int64_t dd = (d * d) >> 30, ddd = (dd * d) >> 30;
          if (d < int64_t(1) << 30)
            coeff = (12 * (int64_t(1) << 24) - 9 * B - 6 * C) * ddd +
                    (-18 * (int64_t(1) << 24) + 12 * B + 6 * C) * dd +
                    (6 * (int64_t(1) << 24) - 2 * B) * (int64_t(1) << 30);
          else
            coeff = (-B - 6 * C) * ddd + (6 * B + 30 * C) * dd + (-12 * B - 48 * C) * d +
                    (8 * B + 24 * C) * (int64_t(1) << 30);
        }
        coeff /= (int64_t(1) << 54) / fone;
        f[int64_t(i) * fsize + j] = coeff;
        ++xx;
      }
      x_dst_in_src += 2 * xinc;
    }
  }
  // reduce: drop near-zero taps on the left, count them on the right
  int min_size = 0;
  for (int i = dst_w - 1; i >= 0; --i) {
    int64_t* row = f.data() + int64_t(i) * fsize;
    int mn = fsize;
    int64_t cut = 0;
    for (int j = 0; j < fsize; ++j) {
      cut += std::llabs(row[0]);
      if ((double)cut > 0.002 * (double)fone) break;
      if (i < dst_w - 1 && pos[i] >= pos[i + 1]) break;
      for (int k = 1; k < fsize; ++k) row[k - 1] = row[k];
      row[fsize - 1] = 0;
      ++pos[i];
    }
    cut = 0;
    for (int j = fsize - 1; j > 0; --j) {
      cut += std::llabs(row[j]);
      if ((double)cut > 0.002 * (double)fone) break;
      --mn;
    }
    min_size = std::max(min_size, mn);
  }
  if (min_size == 1 && align == 2) align = 1;   // the unscaled vertical case
  const int size = (min_size + align - 1) & ~(align - 1);
  std::vector<int64_t> g(int64_t(dst_w) * size, 0);
  for (int i = 0; i < dst_w; ++i)
    for (int j = 0; j < size && j < fsize; ++j) g[int64_t(i) * size + j] = f[int64_t(i) * fsize + j];
  // the borders
  for (int i = 0; i < dst_w; ++i) {
    int64_t* row = g.data() + int64_t(i) * size;
    if (pos[i] < 0) {
      for (int j = 1; j < size; ++j) {
        const int left = std::max(j + pos[i], 0);
        row[left] += row[j];
        row[j] = 0;
      }
      pos[i] = 0;
    }
    if (pos[i] + size > src_w) {
      const int shift = pos[i] + std::min(size - src_w, 0);
      int64_t acc = 0;
      for (int j = size - 1; j >= 0; --j)
        if (pos[i] + j >= src_w) {
          acc += row[j];
          row[j] = 0;
        }
      for (int j = size - 1; j >= 0; --j) row[j] = j < shift ? 0 : row[j - shift];
      pos[i] -= shift;
      row[src_w - 1 - pos[i]] += acc;
    }
  }
  Filter out;
  out.size = size;
  out.pos = pos;
  out.coef.assign(int64_t(dst_w) * size, 0);
  for (int i = 0; i < dst_w; ++i) {
    const int64_t* row = g.data() + int64_t(i) * size;
    int64_t sum = 0;
    for (int j = 0; j < size; ++j) sum += row[j];
    sum = (sum + one / 2) / one;
    if (!sum) sum = 1;
    int64_t error = 0;
    for (int j = 0; j < size; ++j) {
      const int64_t v = row[j] + error;
      const int64_t iv = rounded_div(v, sum);
      out.coef[int64_t(i) * size + j] = (int32_t)iv;
      error = v - iv * sum;
    }
  }
  return out;
}

static int local_pos(int sub) { return (((128 << sub) - 128) + 128) >> sub; }

// ff_yuv2rgb_c_init_tables' 24-bit lookup: y_table, and the offsets into it
// of r, g and b by V, U (and g's V term), headroom 512 on either side.
struct CTables {
  enum { kHead = 512, kLumaHead = 512 };
  uint8_t y[1024 + 2 * kLumaHead];
  int rv[256 + 2 * kHead], gu[256 + 2 * kHead], bu[256 + 2 * kHead], gv[256 + 2 * kHead];
};

static void c_tables(int matrix, int full_range, CTables* t) {
  const int32_t* inv = kInvTables[(matrix < 0 || matrix > 10) ? 2 : matrix];
  int64_t crv = inv[0], cbu = inv[1], cgu = -inv[2], cgv = -inv[3];
  int64_t cy = 1 << 16, oy = 0;
  if (!full_range) {
    cy = (cy * 255) / 219;
    oy = 16 << 16;
  } else {
    crv = (crv * 224) / 255;
    cbu = (cbu * 224) / 255;
    cgu = (cgu * 224) / 255;
    cgv = (cgv * 224) / 255;
  }
  crv = ((crv * (1 << 16)) + 0x8000) / std::max<int64_t>(cy, 1);
  cbu = ((cbu * (1 << 16)) + 0x8000) / std::max<int64_t>(cy, 1);
  cgu = ((cgu * (1 << 16)) + 0x8000) / std::max<int64_t>(cy, 1);
  cgv = ((cgv * (1 << 16)) + 0x8000) / std::max<int64_t>(cy, 1);
  int64_t yb = -(int64_t(384) << 16) - CTables::kLumaHead * cy - oy;
  for (int i = 0; i < 1024 + 2 * CTables::kLumaHead; ++i) {
    const int64_t v = (yb + 0x8000) >> 16;
    t->y[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    yb += cy;
  }
  const int yoffs = 384 + CTables::kLumaHead;
  auto fill = [&](int* table, int64_t inc) {
    for (int i = 0; i < 256 + 2 * CTables::kHead; ++i) {
      const int64_t c = i - CTables::kHead;
      const int64_t cb = (c < 0 ? 0 : (c > 255 ? 255 : c)) * inc;
      table[i] = (int)(yoffs - (inc >> 9) + (cb >> 16));
    }
  };
  fill(t->rv, crv);
  fill(t->gu, cgu);
  fill(t->bu, cbu);
  for (int i = 0; i < 256 + 2 * CTables::kHead; ++i) {
    const int64_t c = i - CTables::kHead;
    t->gv[i] = (int)(-(cgv >> 9) + (((c < 0 ? 0 : (c > 255 ? 255 : c)) * cgv) >> 16));
  }
}

}  // namespace yuv2bgr

extern "C" {

// Convert a (h, w) yuv420p (vshift 1: chroma planes ((h+1)/2, (w+1)/2)) or
// yuv422p (vshift 0: chroma planes (h, (w+1)/2)) frame to BGR24 rows of
// `bgr_stride` bytes, nearest chroma.
void yuv_nearest_to_bgr(const uint8_t* y, int y_stride, const uint8_t* u, const uint8_t* v,
                        int c_stride, int w, int h, uint8_t* bgr, int bgr_stride, int matrix,
                        int full_range, int vshift) {
  using namespace yuv2bgr;
  const Coeffs c = coeffs(matrix, full_range);
  // every term of the sum depends on one sample: tables of 256
  int ty[256], tub[256], tug[256], tvg[256], tvr[256];
  for (int i = 0; i < 256; ++i) {
    int s = sat16((i << 3) - 1024);
    ty[i] = mulhi(sat16((i << 3) - c.yoff), c.y);
    tub[i] = mulhi(s, c.ub);
    tug[i] = mulhi(s, c.ug);
    tvg[i] = mulhi(s, c.vg);
    tvr[i] = mulhi(s, c.vr);
  }
  for (int row = 0; row < h; ++row) {
    const uint8_t* py = y + (int64_t)row * y_stride;
    const uint8_t* pu = u + (int64_t)(row >> vshift) * c_stride;
    const uint8_t* pv = v + (int64_t)(row >> vshift) * c_stride;
    uint8_t* out = bgr + (int64_t)row * bgr_stride;
    for (int x = 0; x < w; ++x) {
      int yy = ty[py[x]], cu = pu[x >> 1], cv = pv[x >> 1];
      // |each sum| < 2^15: the SIMD routine's saturating adds never clip
      out[3 * x] = u8(yy + tub[cu]);
      out[3 * x + 1] = u8(yy + tug[cu] + tvg[cv]);
      out[3 * x + 2] = u8(yy + tvr[cv]);
    }
  }
}

void yuv420_to_bgr(const uint8_t* y, int y_stride, const uint8_t* u, const uint8_t* v,
                   int c_stride, int w, int h, uint8_t* bgr, int bgr_stride, int matrix,
                   int full_range) {
  yuv_nearest_to_bgr(y, y_stride, u, v, c_stride, w, h, bgr, bgr_stride, matrix, full_range, 1);
}

// Convert a (h, w) yuv444p frame (u, v null: gray) to BGR24 rows of
// `bgr_stride` bytes through libswscale's full-chroma output.
void yuv444_to_bgr(const uint8_t* y, int y_stride, const uint8_t* u, const uint8_t* v,
                   int c_stride, int w, int h, uint8_t* bgr, int bgr_stride, int matrix,
                   int full_range) {
  using namespace yuv2bgr;
  const FullCoeffs c = full_coeffs(matrix, full_range);
  for (int row = 0; row < h; ++row) {
    const uint8_t* py = y + (int64_t)row * y_stride;
    const uint8_t* pu = u ? u + (int64_t)row * c_stride : nullptr;
    const uint8_t* pv = v ? v + (int64_t)row * c_stride : nullptr;
    uint8_t* out = bgr + (int64_t)row * bgr_stride;
    for (int x = 0; x < w; ++x) {
      const int64_t uu = pu ? (int64_t)(pu[x] - 128) * 512 : 0;
      const int64_t vv = pv ? (int64_t)(pv[x] - 128) * 512 : 0;
      const uint32_t yy = (uint32_t)(((int64_t)py[x] * 512 - c.yoff) * c.y + (1 << 21));
      uint32_t r = yy + (uint32_t)(vv * c.vr);
      uint32_t g = yy + (uint32_t)(vv * c.vg) + (uint32_t)(uu * c.ug);
      uint32_t b = yy + (uint32_t)(uu * c.ub);
      if ((r | g | b) & 0xC0000000u) {
        r = (uint32_t)clip30(r);
        g = (uint32_t)clip30(g);
        b = (uint32_t)clip30(b);
      }
      out[3 * x] = (uint8_t)(b >> 22);
      out[3 * x + 1] = (uint8_t)(g >> 22);
      out[3 * x + 2] = (uint8_t)(r >> 22);
    }
  }
}


// Convert a (h, w) frame whose chroma planes (u, v: c_stride bytes a row)
// are subsampled by 2^sx across and 2^sy down through libswscale's scaled
// path (see above): 4:2:0 / 4:2:2 at an odd height, 4:1:1 (sx 2), 4:4:0.
void yuv_scaled_to_bgr(const uint8_t* y, int y_stride, const uint8_t* u, const uint8_t* v,
                       int c_stride, int w, int h, int sx, int sy, uint8_t* bgr,
                       int bgr_stride, int matrix, int full_range) {
  using namespace yuv2bgr;
  const bool full = (w & 1) || (sx == 0 && sy == 0);
  const int csw = (w + (1 << sx) - 1) >> sx, csh = (h + (1 << sy) - 1) >> sy;
  const int cdw = full ? w : (w + 1) >> 1;
  const Filter hf = init_filter(((int64_t(csw) << 16) + (cdw >> 1)) / cdw, csw, cdw, 4, 1 << 14,
                                local_pos(sx), local_pos(full ? 0 : 1));
  const Filter vf = init_filter(((int64_t(csh) << 16) + (h >> 1)) / h, csh, h, 2, 1 << 12,
                                local_pos(sy), local_pos(0));
  // chroma rows scaled across: 15 bits
  std::vector<int32_t> cu(int64_t(csh) * cdw), cv(int64_t(csh) * cdw);
  for (int r = 0; r < csh; ++r)
    for (int i = 0; i < cdw; ++i) {
      int64_t su = 0, sv = 0;
      for (int j = 0; j < hf.size; ++j) {
        const int x = std::min(std::max(hf.pos[i] + j, 0), csw - 1);
        const int32_t c = hf.coef[int64_t(i) * hf.size + j];
        su += int64_t(u[int64_t(r) * c_stride + x]) * c;
        sv += int64_t(v[int64_t(r) * c_stride + x]) * c;
      }
      cu[int64_t(r) * cdw + i] = (int32_t)std::min<int64_t>(su >> 7, 32767);
      cv[int64_t(r) * cdw + i] = (int32_t)std::min<int64_t>(sv >> 7, 32767);
    }
  const Coeffs mc = coeffs(matrix, full_range);
  const FullCoeffs fc = full_coeffs(matrix, full_range);
  static thread_local CTables tab;
  c_tables(matrix, full_range, &tab);
  for (int r = 0; r < h; ++r) {
    const uint8_t* py = y + int64_t(r) * y_stride;
    uint8_t* out = bgr + int64_t(r) * bgr_stride;
    const int32_t* c = vf.coef.data() + int64_t(r) * vf.size;
    std::vector<int> taps(vf.size);
    for (int j = 0; j < vf.size; ++j) taps[j] = std::min(std::max(vf.pos[r] + j, 0), csh - 1);
    bool one_stage = vf.size == 1;
    int alpha = 0;
    if (vf.size == 2 && c[0] + c[1] == 4096 && (unsigned)c[1] <= 4096u) {
      one_stage = true;
      alpha = c[1];
    }
    const bool last = r >= h - 2;
    for (int x = 0; x < w; ++x) {
      const int ci = full ? x : x >> 1;
      const int64_t y15 = int64_t(py[x]) << 7;
      auto tap_u = [&](int j) { return (int64_t)cu[int64_t(taps[j]) * cdw + ci]; };
      auto tap_v = [&](int j) { return (int64_t)cv[int64_t(taps[j]) * cdw + ci]; };
      uint8_t* o = out + 3 * x;
      if (full) {   // yuv2rgb_full_1_c / _X_c, then the full write
        int64_t Y, U, V;
        if (one_stage) {
          Y = y15 * 4;
          if (alpha == 0) {
            U = (tap_u(0) - (128 << 7)) * 4;
            V = (tap_v(0) - (128 << 7)) * 4;
          } else {
            U = (tap_u(0) * (4096 - alpha) + tap_u(1) * alpha - (int64_t(128) << 19)) >> 10;
            V = (tap_v(0) * (4096 - alpha) + tap_v(1) * alpha - (int64_t(128) << 19)) >> 10;
          }
        } else {
          Y = ((1 << 9) + y15 * 4096) >> 10;
          int64_t su = (1 << 9) - (int64_t(128) << 19), sv = su;
          for (int j = 0; j < vf.size; ++j) {
            su += tap_u(j) * c[j];
            sv += tap_v(j) * c[j];
          }
          U = su >> 10;
          V = sv >> 10;
        }
        const uint32_t yy = (uint32_t)((Y - fc.yoff) * fc.y + (1 << 21));
        uint32_t rr = yy + (uint32_t)(V * fc.vr);
        uint32_t gg = yy + (uint32_t)(V * fc.vg) + (uint32_t)(U * fc.ug);
        uint32_t bb = yy + (uint32_t)(U * fc.ub);
        if ((rr | gg | bb) & 0xC0000000u) {
          rr = (uint32_t)clip30(rr);
          gg = (uint32_t)clip30(gg);
          bb = (uint32_t)clip30(bb);
        }
        o[0] = (uint8_t)(bb >> 22);
        o[1] = (uint8_t)(gg >> 22);
        o[2] = (uint8_t)(rr >> 22);
        continue;
      }
      if (!last) {   // the mmxext routines
        int y8, u8v, v8v;
        if (one_stage) {
          y8 = (int)(y15 >> 4);
          if (alpha < 2048) {
            u8v = (int)(tap_u(0) >> 4);
            v8v = (int)(tap_v(0) >> 4);
          } else {
            u8v = (int)(uint16_t(tap_u(0) + tap_u(1)) >> 5);
            v8v = (int)(uint16_t(tap_v(0) + tap_v(1)) >> 5);
          }
        } else {
          y8 = 4 + mulhi((int)y15, 4096);
          int16_t su = 4, sv = 4;
          for (int j = 0; j < vf.size; ++j) {
            su = (int16_t)(su + mulhi((int)tap_u(j), c[j]));
            sv = (int16_t)(sv + mulhi((int)tap_v(j), c[j]));
          }
          u8v = su;
          v8v = sv;
        }
        const int uu = sat16(u8v - 1024), vv = sat16(v8v - 1024);
        const int yy = mulhi(sat16(y8 - mc.yoff), mc.y);
        const int g = sat16(mulhi(uu, mc.ug) + mulhi(vv, mc.vg));
        o[0] = u8(sat16(yy + mulhi(uu, mc.ub)));
        o[1] = u8(sat16(yy + g));
        o[2] = u8(sat16(yy + mulhi(vv, mc.vr)));
        continue;
      }
      int64_t Y, U, V;   // the C routines, through the lookup tables
      if (one_stage) {
        Y = (y15 + 64) >> 7;
        if (alpha == 0) {
          U = (tap_u(0) + 64) >> 7;
          V = (tap_v(0) + 64) >> 7;
        } else {
          U = (tap_u(0) * (4096 - alpha) + tap_u(1) * alpha + (int64_t(128) << 11)) >> 19;
          V = (tap_v(0) * (4096 - alpha) + tap_v(1) * alpha + (int64_t(128) << 11)) >> 19;
        }
      } else {
        Y = ((int64_t(1) << 18) + y15 * 4096) >> 19;
        int64_t su = int64_t(1) << 18, sv = su;
        for (int j = 0; j < vf.size; ++j) {
          su += tap_u(j) * c[j];
          sv += tap_v(j) * c[j];
        }
        U = su >> 19;
        V = sv >> 19;
      }
      const int ui = (int)U + CTables::kHead, vi = (int)V + CTables::kHead;
      o[0] = tab.y[tab.bu[ui] + Y];
      o[1] = tab.y[tab.gu[ui] + tab.gv[vi] + Y];
      o[2] = tab.y[tab.rv[vi] + Y];
    }
  }
}

}  // extern "C"
