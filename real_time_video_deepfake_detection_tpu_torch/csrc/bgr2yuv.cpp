// BGR24 -> yuv420p at the same size, as cv2.VideoWriter's FFmpeg backend
// converts each frame before its encoder sees it (cv2 5.0 calls sws_scale
// with SWS_BICUBIC on the bundled libswscale 9.5; at an unchanged size
// libswscale takes its unscaled bgr24ToYv12Wrapper -> ff_rgb24toyv12 path).
//
// cv2 first drops an odd last column and an odd last row (the frame is cut
// to even sizes). Then, with libswscale's default BT.601 limited-range
// input table (RGB2YUV_SHIFT 15):
//   Y = ((RY * R + GY * G + BY * B) >> 15) + 16                for each pixel
//   U = ((RU * r + GU * g + BU * b) >> 15) + 128               for each 2x2 block
//   V = ((RV * r + GV * g + BV * b) >> 15) + 128
// where r, g, b are the block's four samples summed and shifted right by 2
// (the floor of their mean), and each product sum is shifted arithmetically.

#include <cstdint>

namespace bgr2yuv {

enum {
  kShift = 15,
  kRY = 8414,    // (int)(0.299 * 219 / 255 * (1 << 15) + 0.5)
  kGY = 16519,   // 0.587
  kBY = 3208,    // 0.114
  kRU = -4865,   // -(int)(0.169 * 224 / 255 * (1 << 15) + 0.5)
  kGU = -9528,   // -0.331
  kBU = 14392,   // 0.500
  kRV = 14392,   // 0.500
  kGV = -12061,  // -0.419
  kBV = -2332,   // -0.081
};

// w and h even; src rows of src_stride bytes (B, G, R per pixel)
static void convert(const uint8_t* src, int64_t src_stride, int w, int h, uint8_t* y,
                    int64_t y_stride, uint8_t* u, uint8_t* v, int64_t c_stride) {
  for (int r = 0; r < h; r += 2) {
    const uint8_t* s0 = src + (int64_t)r * src_stride;
    const uint8_t* s1 = s0 + src_stride;
    uint8_t* y0 = y + (int64_t)r * y_stride;
    uint8_t* y1 = y0 + y_stride;
    uint8_t* ur = u + (int64_t)(r >> 1) * c_stride;
    uint8_t* vr = v + (int64_t)(r >> 1) * c_stride;
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = s0 + 3 * x;
      const uint8_t* q = s1 + 3 * x;
      y0[x] = (uint8_t)(((kRY * p[2] + kGY * p[1] + kBY * p[0]) >> kShift) + 16);
      y1[x] = (uint8_t)(((kRY * q[2] + kGY * q[1] + kBY * q[0]) >> kShift) + 16);
    }
    for (int x = 0; x < w; x += 2) {
      const uint8_t* p = s0 + 3 * x;
      const uint8_t* q = s1 + 3 * x;
      int b = (p[0] + p[3] + q[0] + q[3]) >> 2;
      int g = (p[1] + p[4] + q[1] + q[4]) >> 2;
      int rr = (p[2] + p[5] + q[2] + q[5]) >> 2;
      ur[x >> 1] = (uint8_t)(((kRU * rr + kGU * g + kBU * b) >> kShift) + 128);
      vr[x >> 1] = (uint8_t)(((kRV * rr + kGV * g + kBV * b) >> kShift) + 128);
    }
  }
}

}  // namespace bgr2yuv
