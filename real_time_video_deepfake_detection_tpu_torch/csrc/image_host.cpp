// Host image helpers of the port's image decoders, the per-pixel loops
// that stay out of Python: the PNG row filters (None, Sub, Up, Average,
// Paeth) undone and Adam7 interlacing merged, as libpng's png_read_row does
// (utils/png.py; zlib inflation stays in Python); cv2's ASCII number reader
// of PBM / PGM / PPM (utils/pxm.py); Radiance's flat and run-length
// scanlines (utils/hdr.py); GIF's LZW (utils/gif.py). Plain C interface,
// bound with ctypes, built with g++ at first use (utils/host_build.py). The
// bytes come from the network: every read is checked against their length.

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

inline bool is_space(int c) { return c == ' ' || (c >= '\t' && c <= '\r'); }
inline bool is_digit(int c) { return c >= '0' && c <= '9'; }

}  // namespace

extern "C" {

// cv2's PxM ReadNumber, `count` times from data[pos]: whitespace and '#'
// comments (to a CR or LF) skipped before each number, its digits read (at
// most `maxdigits` when that is not 0) and, when it stops at a non-digit,
// that byte consumed. The numbers go to `out`. Returns the position after
// the last, -1 at a byte that is none of these or at the end of the data
// (cv2's stream throws there), -2 for a number past INT_MAX.
int64_t pxm_numbers(const uint8_t* data, int64_t len, int64_t pos, int64_t count, int maxdigits,
                    int32_t* out) {
  for (int64_t n = 0; n < count; ++n) {
    if (pos >= len) return -1;
    int code = data[pos++];
    while (!is_digit(code)) {
      if (code == '#') {
        do {
          if (pos >= len) return -1;
          code = data[pos++];
        } while (code != '\n' && code != '\r');
        if (pos >= len) return -1;
        code = data[pos++];
      } else if (is_space(code)) {
        while (is_space(code)) {
          if (pos >= len) return -1;
          code = data[pos++];
        }
      } else {
        return -1;
      }
    }
    int64_t val = 0;
    int digits = 0;
    for (;;) {
      val = val * 10 + (code - '0');
      if (val > 2147483647) return -2;
      if (maxdigits != 0 && ++digits >= maxdigits) break;
      if (pos >= len) return -1;
      code = data[pos++];
      if (!is_digit(code)) break;
    }
    out[n] = static_cast<int32_t>(val);
  }
  return pos;
}

// Radiance RGBE_ReadPixels_RLE from data[pos]: (h, w) pixels of 4 bytes
// into `rgbe`. A width under 8 or over 0x7fff reads flat; else each
// scanline opens with 2, 2 and its width (16 bits), then its four
// components run-length coded (a count over 128 repeats one byte, up to
// 128 copies that many); a scanline that opens otherwise makes that pixel
// and all that follow flat. Returns 0, -1 at the end of the data, -2 for a
// scanline of another width, -3 for a bad run.
int hdr_pixels(const uint8_t* data, int64_t len, int64_t pos, int w, int h, uint8_t* rgbe) {
  const int64_t total = int64_t(w) * h;
  auto flat = [&](int64_t from) {
    const int64_t n = total - from;
    if (n * 4 > len - pos) return -1;
    memcpy(rgbe + from * 4, data + pos, static_cast<size_t>(n * 4));
    return 0;
  };
  if (w < 8 || w > 0x7fff) return flat(0);
  std::vector<uint8_t> line(static_cast<size_t>(w) * 4);
  for (int y = 0; y < h; ++y) {
    if (4 > len - pos) return -1;
    const uint8_t* head = data + pos;
    if (head[0] != 2 || head[1] != 2 || (head[2] & 0x80)) return flat(int64_t(y) * w);
    pos += 4;
    if (((head[2] << 8) | head[3]) != w) return -2;
    uint8_t* ptr = line.data();
    for (int c = 0; c < 4; ++c) {
      uint8_t* end = line.data() + int64_t(c + 1) * w;
      while (ptr < end) {
        if (2 > len - pos) return -1;
        int count = data[pos], value = data[pos + 1];
        pos += 2;
        if (count > 128) {
          count -= 128;
          if (count == 0 || count > end - ptr) return -3;
          memset(ptr, value, count);
          ptr += count;
        } else {
          if (count == 0 || count > end - ptr) return -3;
          *ptr++ = static_cast<uint8_t>(value);
          if (--count > 0) {
            if (count > len - pos) return -1;
            memcpy(ptr, data + pos, count);
            pos += count;
            ptr += count;
          }
        }
      }
    }
    uint8_t* row = rgbe + int64_t(y) * w * 4;
    for (int x = 0; x < w; ++x)
      for (int c = 0; c < 4; ++c) row[4 * x + c] = line[int64_t(c) * w + x];
  }
  return 0;
}

// A GIF image's LZW data (its sub-blocks joined): `npix` palette indices
// into `out`, as cv2 5.0's GIF decoder reads them. Codes are LSB first,
// min_size + 1 bits wide after a clear, one bit wider once the table
// reaches the width's limit (at most 12 bits; a full table takes no more
// entries). Returns 0; -1 for a code past the table or a first code that
// is not a literal, -2 when the codes make more pixels than the image, -3
// when they end (at the end code or the data's end) before it is full, -4
// for bytes after the end code.
int gif_lzw(const uint8_t* data, int64_t len, int min_size, uint8_t* out, int64_t npix) {
  const int clear = 1 << min_size, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096), length(4096);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < clear; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int size = min_size + 1, next = eoi + 1, prev = -1;
  int64_t bitpos = 0, n = 0;
  const int64_t bits = len * 8;
  while (bitpos + size <= bits) {
    int code = 0;
    for (int b = 0; b < size; ++b, ++bitpos)
      code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    if (code == clear) {
      size = min_size + 1;
      next = eoi + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) {
      if (n != npix) return -3;
      return (bitpos + 7) / 8 == len ? 0 : -4;
    }
    int emit = code;
    if (prev < 0) {
      if (code >= clear) return -1;
    } else if (code > next || (code == next && next >= 4096)) {
      return -1;
    }
    if (prev >= 0 && next < 4096) {   // the new entry: prev + the first byte of code's string
      prefix[next] = static_cast<uint16_t>(prev);
      first[next] = first[prev];
      suffix[next] = code == next ? first[prev] : first[code];
      length[next] = static_cast<uint16_t>(length[prev] + 1);
      ++next;
      if (next == (1 << size) && size < 12) ++size;
    }
    const int64_t l = length[emit];
    if (n + l > npix) return -2;
    for (int64_t i = l - 1, c = emit; i >= 0; --i, c = prefix[c]) out[n + i] = suffix[c];
    n += l;
    prev = emit;
  }
  return n == npix ? 0 : -3;
}

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
