// Host image helpers of the port's PNG decoder (utils/png.py): the PNG row
// filters (None, Sub, Up, Average, Paeth) undone and Adam7 interlacing
// merged, as libpng's png_read_row does. Zlib inflation stays in Python.
// Plain C interface, bound with ctypes, built with g++ at first use
// (utils/host_build.py). The bytes come from the network: every read is
// checked against the inflated length.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Unfilters `rows` rows of `rowbytes` bytes (each led by its filter byte)
// from `src` into `dst`; `bpp` is the filter's byte distance. Returns the
// bytes read, or -1 for an unknown filter.
int64_t unfilter(const uint8_t* src, int rows, int64_t rowbytes, int bpp, uint8_t* dst) {
  std::vector<uint8_t> prev(rowbytes, 0);
  for (int y = 0; y < rows; ++y) {
    const int f = src[0];
    const uint8_t* in = src + 1;
    uint8_t* out = dst + y * rowbytes;
    for (int64_t i = 0; i < rowbytes; ++i) {
      const int a = i >= bpp ? out[i - bpp] : 0;
      const int b = prev[i];
      const int c = i >= bpp ? prev[i - bpp] : 0;
      int v = in[i];
      switch (f) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: return -1;
      }
      out[i] = static_cast<uint8_t>(v);
    }
    memcpy(prev.data(), out, rowbytes);
    src += rowbytes + 1;
  }
  return int64_t(rows) * (rowbytes + 1);
}

// Sample x of a row of packed `depth`-bit samples (depth 1, 2, 4, 8; 16
// gives its high byte), as an 8-bit value without rescaling.
inline uint8_t sample(const uint8_t* row, int64_t x, int depth) {
  if (depth == 8) return row[x];
  if (depth == 16) return row[2 * x];
  const int64_t bit = x * depth;
  const int shift = 8 - depth - static_cast<int>(bit & 7);
  return static_cast<uint8_t>((row[bit >> 3] >> shift) & ((1 << depth) - 1));
}

}  // namespace

extern "C" {

// The image of a PNG's inflated IDAT data: (h, w, channels) 8-bit samples
// into `out` (16-bit samples keep their high byte, 1-, 2- and 4-bit ones
// their value). interlace 1 is Adam7. Returns 0, -1 when the data ends
// before the image, -2 for an unknown filter type.
int png_unfilter(const uint8_t* data, size_t len, int w, int h, int depth, int channels,
                 int interlace, uint8_t* out) {
  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  const int bits = depth * channels;
  const int bpp = bits >= 8 ? bits / 8 : 1;
  const int passes = interlace ? 7 : 1;
  size_t at = 0;
  std::vector<uint8_t> img;
  for (int p = 0; p < passes; ++p) {
    const int x0 = interlace ? kPass[p][0] : 0, y0 = interlace ? kPass[p][1] : 0;
    const int dx = interlace ? kPass[p][2] : 1, dy = interlace ? kPass[p][3] : 1;
    const int pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    const int ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    if (pw == 0 || ph == 0) continue;   // an empty pass has no rows at all
    const int64_t rowbytes = (int64_t(pw) * bits + 7) / 8;
    const int64_t need = int64_t(ph) * (rowbytes + 1);
    if (need > static_cast<int64_t>(len - at)) return -1;
    img.resize(static_cast<size_t>(int64_t(ph) * rowbytes));
    if (unfilter(data + at, ph, rowbytes, bpp, img.data()) < 0) return -2;
    at += static_cast<size_t>(need);
    for (int y = 0; y < ph; ++y) {
      const uint8_t* row = img.data() + y * rowbytes;
      uint8_t* orow = out + (int64_t(y0) + int64_t(y) * dy) * w * channels;
      for (int x = 0; x < pw; ++x)
        for (int c = 0; c < channels; ++c)
          orow[(int64_t(x0) + int64_t(x) * dx) * channels + c] =
              sample(row, int64_t(x) * channels + c, depth);
    }
  }
  return 0;
}

}  // extern "C"
