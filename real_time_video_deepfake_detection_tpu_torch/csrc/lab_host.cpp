// Float-formula sRGB <-> Lab (D65) on u8 pixels: the `native` rung of the
// host-side face-quality CLAHE (pipeline/detector.preprocess_face_quality).
//
// The port's own copy of the JAX package's native Lab pair (GammaTab,
// bgr_to_lab_u8 and lab_to_bgr_u8 in native/ingest.cpp), kept to the same
// arithmetic so that, built with the same flags (g++ -O3 -march=native
// -ffp-contract=off; utils/native_lab.py), it returns the same bytes. It is
// within a few steps of cv2's 8-bit tables, not equal to them: the port's
// `cv2` rung is ops/lab_u8.py. Plain C interface, bound with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

inline float srgb_to_linear(float c) {
  return c <= 0.04045f ? c / 12.92f : std::pow((c + 0.055f) / 1.055f, 2.4f);
}

inline float linear_to_srgb(float c) {
  return c <= 0.0031308f ? c * 12.92f : 1.055f * std::pow(c, 1.0f / 2.4f) - 0.055f;
}

// u8 -> linear (one powf per entry), and linear -> sRGB as a 4097-point
// table read with linear interpolation
struct GammaTab {
  float fwd[256];
  float inv[4097];
  GammaTab() {
    for (int i = 0; i < 256; ++i) fwd[i] = srgb_to_linear(i / 255.0f);
    for (int i = 0; i <= 4096; ++i) inv[i] = linear_to_srgb(i / 4096.0f);
  }
};
const GammaTab kGamma;

inline float linear_to_srgb_fast(float c) {
  c = std::min(std::max(c, 0.0f), 1.0f) * 4096.0f;
  const int i = static_cast<int>(c);
  const float f = c - i;
  return i >= 4096 ? kGamma.inv[4096] : kGamma.inv[i] * (1.0f - f) + kGamma.inv[i + 1] * f;
}

inline float lab_f(float t) { return t > 0.008856f ? std::cbrt(t) : 7.787f * t + 16.0f / 116.0f; }

inline uint8_t to_u8(float v) {
  v = std::nearbyintf(v);
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

}  // namespace

extern "C" {

// n BGR u8 pixels -> n Lab u8 pixels (L scaled to 0..255, a and b offset by 128).
void lab_bgr2lab(const uint8_t* bgr, int64_t n, uint8_t* lab) {
  const float Xn = 0.950456f, Zn = 1.088754f;
  for (int64_t i = 0; i < n; ++i) {
    const float b = kGamma.fwd[bgr[i * 3 + 0]];
    const float g = kGamma.fwd[bgr[i * 3 + 1]];
    const float r = kGamma.fwd[bgr[i * 3 + 2]];
    const float X = (0.412453f * r + 0.357580f * g + 0.180423f * b) / Xn;
    const float Y = 0.212671f * r + 0.715160f * g + 0.072169f * b;
    const float Z = (0.019334f * r + 0.119193f * g + 0.950227f * b) / Zn;
    const float fy = lab_f(Y);
    const float L = Y > 0.008856f ? 116.0f * std::cbrt(Y) - 16.0f : 903.3f * Y;
    lab[i * 3 + 0] = to_u8(L * 255.0f / 100.0f);
    lab[i * 3 + 1] = to_u8(500.0f * (lab_f(X) - fy) + 128.0f);
    lab[i * 3 + 2] = to_u8(200.0f * (fy - lab_f(Z)) + 128.0f);
  }
}

// n Lab u8 pixels -> n BGR u8 pixels.
void lab_lab2bgr(const uint8_t* lab, int64_t n, uint8_t* bgr) {
  const float Xn = 0.950456f, Zn = 1.088754f;
  auto finv = [](float t) {
    const float t3 = t * t * t;
    return t3 > 0.008856f ? t3 : (t - 16.0f / 116.0f) / 7.787f;
  };
  for (int64_t i = 0; i < n; ++i) {
    const float L = lab[i * 3 + 0] * 100.0f / 255.0f;
    const float a = lab[i * 3 + 1] - 128.0f;
    const float bb = lab[i * 3 + 2] - 128.0f;
    const float fy = (L + 16.0f) / 116.0f;
    const float Y = L > 8.0f ? fy * fy * fy : L / 903.3f;
    const float X = finv(fy + a / 500.0f) * Xn;
    const float Z = finv(fy - bb / 200.0f) * Zn;
    const float r = 3.240479f * X - 1.537150f * Y - 0.498535f * Z;
    const float g = -0.969256f * X + 1.875991f * Y + 0.041556f * Z;
    const float b = 0.055648f * X - 0.204043f * Y + 1.057311f * Z;
    bgr[i * 3 + 0] = to_u8(linear_to_srgb_fast(b) * 255.0f);
    bgr[i * 3 + 1] = to_u8(linear_to_srgb_fast(g) * 255.0f);
    bgr[i * 3 + 2] = to_u8(linear_to_srgb_fast(r) * 255.0f);
  }
}

}  // extern "C"
