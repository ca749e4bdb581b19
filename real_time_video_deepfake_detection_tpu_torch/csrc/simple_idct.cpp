// libavcodec's x86-64 IDCT, shared by the MPEG-4 Part 2 decoder
// (csrc/mpeg4.cpp) and the Motion-JPEG decoder (csrc/mjpeg.cpp): for 8-bit
// content ff_idctdsp_init_x86 picks the SSE2 / AVX simple_idct8 for both
// codecs (idct_algo auto), whatever the caller. #included, not built alone.

#ifndef SIMPLE_IDCT_CPP
#define SIMPLE_IDCT_CPP

#include <cstdint>

namespace simple_idct {

inline int16_t sat16(int32_t v) {
  return (int16_t)(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
}

inline uint8_t put8(int32_t v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// libavcodec's x86-64 simple_idct8 (SSE2 / AVX, FF_IDCT_PERM_TRANSPOSE) on
// a block in natural order: each row (W4 = 16383, rounding 1 << 10, >> 11,
// saturated to 16 bits; a row of DC alone becomes DC << 3, wrapping), then
// each column (32 added to the DC in 16 bits, >> 20). `out` gets the
// 32-bit column results; put and add saturate them.
inline void idct(const int16_t* in, int32_t* out) {
  enum { W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520 };
  int16_t t[64];
  for (int r = 0; r < 8; ++r) {
    const int16_t* x = in + 8 * r;
    int16_t* y = t + 8 * r;
    if (!(x[1] | x[2] | x[3] | x[4] | x[5] | x[6] | x[7])) {
      int16_t d = (int16_t)(uint16_t)((uint32_t)(uint16_t)x[0] << 3);
      for (int k = 0; k < 8; ++k) y[k] = d;
      continue;
    }
    uint32_t a0 = (uint32_t)(W4 * x[0]) + 1024u, a1 = a0, a2 = a0, a3 = a0;
    a0 += (uint32_t)(W2 * x[2]) + (uint32_t)(W4 * x[4]) + (uint32_t)(W6 * x[6]);
    a1 += (uint32_t)(W6 * x[2]) - (uint32_t)(W4 * x[4]) - (uint32_t)(W2 * x[6]);
    a2 += -(uint32_t)(W6 * x[2]) - (uint32_t)(W4 * x[4]) + (uint32_t)(W2 * x[6]);
    a3 += -(uint32_t)(W2 * x[2]) + (uint32_t)(W4 * x[4]) - (uint32_t)(W6 * x[6]);
    uint32_t b0 = (uint32_t)(W1 * x[1]) + (uint32_t)(W3 * x[3]) + (uint32_t)(W5 * x[5]) +
                  (uint32_t)(W7 * x[7]);
    uint32_t b1 = (uint32_t)(W3 * x[1]) - (uint32_t)(W7 * x[3]) - (uint32_t)(W1 * x[5]) -
                  (uint32_t)(W5 * x[7]);
    uint32_t b2 = (uint32_t)(W5 * x[1]) - (uint32_t)(W1 * x[3]) + (uint32_t)(W7 * x[5]) +
                  (uint32_t)(W3 * x[7]);
    uint32_t b3 = (uint32_t)(W7 * x[1]) - (uint32_t)(W5 * x[3]) + (uint32_t)(W3 * x[5]) -
                  (uint32_t)(W1 * x[7]);
    y[0] = sat16((int32_t)(a0 + b0) >> 11);
    y[7] = sat16((int32_t)(a0 - b0) >> 11);
    y[1] = sat16((int32_t)(a1 + b1) >> 11);
    y[6] = sat16((int32_t)(a1 - b1) >> 11);
    y[2] = sat16((int32_t)(a2 + b2) >> 11);
    y[5] = sat16((int32_t)(a2 - b2) >> 11);
    y[3] = sat16((int32_t)(a3 + b3) >> 11);
    y[4] = sat16((int32_t)(a3 - b3) >> 11);
  }
  for (int c = 0; c < 8; ++c) {
    int16_t x[8];
    for (int k = 0; k < 8; ++k) x[k] = t[8 * k + c];
    int16_t x0 = (int16_t)(uint16_t)((uint16_t)x[0] + 32);
    uint32_t a0 = (uint32_t)(W4 * x0), a1 = a0, a2 = a0, a3 = a0;
    a0 += (uint32_t)(W2 * x[2]) + (uint32_t)(W4 * x[4]) + (uint32_t)(W6 * x[6]);
    a1 += (uint32_t)(W6 * x[2]) - (uint32_t)(W4 * x[4]) - (uint32_t)(W2 * x[6]);
    a2 += -(uint32_t)(W6 * x[2]) - (uint32_t)(W4 * x[4]) + (uint32_t)(W2 * x[6]);
    a3 += -(uint32_t)(W2 * x[2]) + (uint32_t)(W4 * x[4]) - (uint32_t)(W6 * x[6]);
    uint32_t b0 = (uint32_t)(W1 * x[1]) + (uint32_t)(W3 * x[3]) + (uint32_t)(W5 * x[5]) +
                  (uint32_t)(W7 * x[7]);
    uint32_t b1 = (uint32_t)(W3 * x[1]) - (uint32_t)(W7 * x[3]) - (uint32_t)(W1 * x[5]) -
                  (uint32_t)(W5 * x[7]);
    uint32_t b2 = (uint32_t)(W5 * x[1]) - (uint32_t)(W1 * x[3]) + (uint32_t)(W7 * x[5]) +
                  (uint32_t)(W3 * x[7]);
    uint32_t b3 = (uint32_t)(W7 * x[1]) - (uint32_t)(W5 * x[3]) + (uint32_t)(W3 * x[5]) -
                  (uint32_t)(W1 * x[7]);
    out[8 * 0 + c] = (int32_t)(a0 + b0) >> 20;
    out[8 * 7 + c] = (int32_t)(a0 - b0) >> 20;
    out[8 * 1 + c] = (int32_t)(a1 + b1) >> 20;
    out[8 * 6 + c] = (int32_t)(a1 - b1) >> 20;
    out[8 * 2 + c] = (int32_t)(a2 + b2) >> 20;
    out[8 * 5 + c] = (int32_t)(a2 - b2) >> 20;
    out[8 * 3 + c] = (int32_t)(a3 + b3) >> 20;
    out[8 * 4 + c] = (int32_t)(a3 - b3) >> 20;
  }
}

inline void idct_put(uint8_t* dst, int stride, const int16_t* block) {
  int32_t r[64];
  idct(block, r);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) dst[y * stride + x] = put8(r[8 * y + x]);
}

inline void idct_add(uint8_t* dst, int stride, const int16_t* block) {
  int32_t r[64];
  idct(block, r);
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) {
      int64_t v = (int64_t)r[8 * y + x] + dst[y * stride + x];
      dst[y * stride + x] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
}

}  // namespace simple_idct

#endif  // SIMPLE_IDCT_CPP
