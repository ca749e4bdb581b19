// yuv420p -> BGR24 at the same size, as cv2.VideoCapture's FFmpeg backend
// converts a decoded frame (cv2 5.0 calls sws_scale with SWS_BICUBIC on the
// bundled libswscale 9.5; at an unchanged size libswscale takes its unscaled
// yuv2rgb path, whose x86 SIMD routine cv2's frame buffers always run to
// the end of the row).
//
// Each 2x2 luma block shares the chroma sample at (x >> 1, y >> 1): no
// interpolation. The SIMD routine works in 16-bit lanes:
//   y' = ((Y << 3) - yOffset) * yCoeff >> 16          (signed, not clamped)
//   B  = y' + ((U << 3) - 1024) * ubCoeff >> 16
//   G  = y' + ((U << 3) - 1024) * ugCoeff >> 16 + ((V << 3) - 1024) * vgCoeff >> 16
//   R  = y' + ((V << 3) - 1024) * vrCoeff >> 16
// each >> 16 the high half of a signed 16x16 product (pmulhw), the result
// saturated to 0..255. The coefficients are libswscale's
// ff_yuv2rgb_c_init_tables at brightness 0, contrast and saturation 1.0,
// from the stream's matrix (VUI matrix_coefficients, as FFmpeg 8 passes the
// frame's colour space) and range (video_full_range_flag).

#include <cstdint>

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

static inline int16_t sat16(int v) {
  return (int16_t)(v < -32768 ? -32768 : (v > 32767 ? 32767 : v));
}

static inline int mulhi(int a, int b) { return (a * b) >> 16; }

static inline uint8_t u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

}  // namespace yuv2bgr

extern "C" {

// Convert a (h, w) yuv420p frame (chroma planes ((h+1)/2, (w+1)/2)) to
// BGR24 rows of `bgr_stride` bytes.
void yuv420_to_bgr(const uint8_t* y, int y_stride, const uint8_t* u, const uint8_t* v,
                   int c_stride, int w, int h, uint8_t* bgr, int bgr_stride, int matrix,
                   int full_range) {
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
    const uint8_t* pu = u + (int64_t)(row >> 1) * c_stride;
    const uint8_t* pv = v + (int64_t)(row >> 1) * c_stride;
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

}  // extern "C"
