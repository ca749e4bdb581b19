// WebP lossless (VP8L) decode, as libwebp's vp8l_dec.c decodes it, for the
// port's WebP decoder (utils/webp.py): the image header, the four
// transforms (predictor with its 14 modes, cross-colour, subtract-green,
// colour indexing with pixel bundling) undone in reverse order, the colour
// cache, the meta-Huffman image with its groups, simple and normal
// Huffman codes (canonical, complete or a single symbol, as
// VP8LBuildHuffmanTable accepts them), LZ77 copies with the 120-entry
// distance map. The same stream without its header is an ALPH chunk's
// lossless alpha plane (its green channel), whose end-of-data rule
// follows libwebp's two alpha paths. libwebp's bit reader takes the data
// as zero-padded to 8 bytes and calls a stream that consumed more bits
// than that damaged. Plain C interface, bound with ctypes, built with g++
// at first use (utils/host_build.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kLiterals = 256, kLengthCodes = 24, kDistCodes = 40, kMaxCacheBits = 11;
constexpr int kAlphabet[5] = {kLiterals + kLengthCodes, 256, 256, 256, kDistCodes};
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2,  3,  4,  5,  16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
// (dx, dy) of the 120 short distance codes: dist = dx + dy * xsize
constexpr int8_t kPlane[120][2] = {
    {0, 1}, {1, 0}, {1, 1}, {-1, 1}, {0, 2}, {2, 0}, {1, 2}, {-1, 2}, {2, 1}, {-2, 1},
    {2, 2}, {-2, 2}, {0, 3}, {3, 0}, {1, 3}, {-1, 3}, {3, 1}, {-3, 1}, {2, 3}, {-2, 3},
    {3, 2}, {-3, 2}, {0, 4}, {4, 0}, {1, 4}, {-1, 4}, {4, 1}, {-4, 1}, {3, 3}, {-3, 3},
    {2, 4}, {-2, 4}, {4, 2}, {-4, 2}, {0, 5}, {3, 4}, {-3, 4}, {4, 3}, {-4, 3}, {5, 0},
    {1, 5}, {-1, 5}, {5, 1}, {-5, 1}, {2, 5}, {-2, 5}, {5, 2}, {-5, 2}, {4, 4}, {-4, 4},
    {3, 5}, {-3, 5}, {5, 3}, {-5, 3}, {0, 6}, {6, 0}, {1, 6}, {-1, 6}, {6, 1}, {-6, 1},
    {2, 6}, {-2, 6}, {6, 2}, {-6, 2}, {4, 5}, {-4, 5}, {5, 4}, {-5, 4}, {3, 6}, {-3, 6},
    {6, 3}, {-6, 3}, {0, 7}, {7, 0}, {1, 7}, {-1, 7}, {5, 5}, {-5, 5}, {7, 1}, {-7, 1},
    {4, 6}, {-4, 6}, {6, 4}, {-6, 4}, {2, 7}, {-2, 7}, {7, 2}, {-7, 2}, {3, 7}, {-3, 7},
    {7, 3}, {-7, 3}, {5, 6}, {-5, 6}, {6, 5}, {-6, 5}, {8, 0}, {4, 7}, {-4, 7}, {7, 4},
    {-7, 4}, {8, 1}, {8, 2}, {6, 6}, {-6, 6}, {8, 3}, {5, 7}, {-5, 7}, {7, 5}, {-7, 5},
    {8, 4}, {6, 7}, {-6, 7}, {7, 6}, {-7, 6}, {8, 5}, {7, 7}, {-7, 7}, {8, 6}, {8, 7}};

// LSB-first bits over the data, zero past its end; eos() is libwebp's
// VP8LIsEndOfStream: more bits consumed than max(len, 8) bytes hold.
struct Bits {
  const uint8_t* p;
  int64_t len, pos = 0;
  int bit(void) {
    const int64_t i = pos >> 3;
    const int b = i < len ? (p[i] >> (pos & 7)) & 1 : 0;
    ++pos;
    return b;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v |= static_cast<uint32_t>(bit()) << i;
    return v;
  }
  bool eos() const { return pos > 8 * (len > 8 ? len : 8); }
};

// A canonical prefix code: complete, or one symbol read with no bits.
struct Huffman {
  int single = -1;
  int count[16] = {0};
  std::vector<int> sorted;

  bool build(const int* lengths, int n) {
    int nonzero = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
      if (lengths[s]) ++nonzero;
    }
    if (nonzero == 0) return false;
    sorted.clear();
    for (int l = 1; l <= 15; ++l)
      for (int s = 0; s < n; ++s)
        if (lengths[s] == l) sorted.push_back(s);
    if (nonzero == 1) {
      single = sorted[0];
      return true;
    }
    int open = 1;
    for (int l = 1; l <= 15; ++l) {
      open = open * 2 - count[l];
      if (open < 0) return false;
    }
    return open == 0;
  }
  int read(Bits& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0, index = 0;
    for (int l = 1; l <= 15; ++l) {
      code |= br.bit();
      const int c = count[l];
      if (code - first < c) return sorted[index + code - first];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return sorted.back();   // not reached: the code is complete
  }
  bool trivial() const { return single >= 0; }
};

struct Group {
  Huffman h[5];
};

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Decoder {
  Bits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
};

bool read_code(Decoder& d, int alphabet, Huffman* out) {
  Bits& br = d.br;
  std::vector<int> lengths(alphabet > 280 ? alphabet : 280, 0);
  if (br.read(1)) {   // simple code
    const int num = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (num == 2) lengths[br.read(8)] = 1;
  } else {
    int cl[19] = {0};
    const int num = br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Huffman lc;
    if (!lc.build(cl, 19)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) return false;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int c = lc.read(br);
      if (c < 16) {
        lengths[symbol++] = c;
        if (c) prev = c;
      } else {
        static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        const int slot = c - 16;
        int repeat = br.read(extra[slot]) + offset[slot];
        if (symbol + repeat > alphabet) return false;
        const int l = c == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = l;
      }
    }
  }
  if (br.eos()) return false;
  return out->build(lengths.data(), alphabet);
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int copy_value(int sym, Bits& br) {   // GetCopyDistance / GetCopyLength
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

inline int plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist = kPlane[code - 1][0] + kPlane[code - 1][1] * xsize;
  return dist >= 1 ? dist : 1;
}

// The entropy-coded image of xsize x ysize: level 0 reads the transforms
// and the meta-Huffman image; `alpha` (an ALPH plane) takes
// DecodeAlphaData's end-of-data rule where libwebp takes its 8-bit path.
// Returns 0, or -1 for a damaged stream.
int decode_image(Decoder& d, int xsize, int ysize, bool level0, std::vector<uint32_t>* out,
                 bool alpha);

int read_codes_and_data(Decoder& d, int xsize, int ysize, bool level0, std::vector<uint32_t>* out,
                        bool alpha) {
  Bits& br = d.br;
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) return -1;
  }
  int huff_bits = 0, huff_xsize = 0;
  std::vector<uint32_t> huff_image;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    huff_bits = br.read(3) + 2;
    huff_xsize = subsample(xsize, huff_bits);
    const int huff_ysize = subsample(ysize, huff_bits);
    if (decode_image(d, huff_xsize, huff_ysize, false, &huff_image, false) != 0) return -1;
    for (auto& v : huff_image) {
      v = (v >> 8) & 0xffff;
      if (static_cast<int>(v) >= num_groups) num_groups = static_cast<int>(v) + 1;
    }
  }
  if (br.eos()) return -1;
  std::vector<Group> groups(num_groups);
  for (int g = 0; g < num_groups; ++g)
    for (int j = 0; j < 5; ++j) {
      int alphabet = kAlphabet[j];
      if (j == 0 && cache_bits > 0) alphabet += 1 << cache_bits;
      if (!read_code(d, alphabet, &groups[g].h[j])) return -1;
    }
  // DecodeAlphaData's 8-bit path: colour indexing alone, Is8bOptimizable
  bool eight_bit = alpha && cache_bits == 0 && d.transforms.size() == 1 &&
                   d.transforms[0].type == 3;
  for (auto& g : groups)
    if (!g.h[1].trivial() || !g.h[2].trivial() || !g.h[3].trivial()) eight_bit = false;

  const int64_t total = int64_t(xsize) * ysize;
  out->assign(static_cast<size_t>(total), 0);
  uint32_t* data = out->data();
  std::vector<uint32_t> cache(cache_bits > 0 ? (1u << cache_bits) : 0);
  auto group_at = [&](int x, int y) -> const Group& {
    if (!huff_bits) return groups[0];
    return groups[huff_image[(y >> huff_bits) * huff_xsize + (x >> huff_bits)]];
  };
  int64_t pos = 0, cached = 0;
  int x = 0, y = 0;
  auto insert_cache = [&]() {
    if (cache_bits > 0)
      for (; cached < pos; ++cached)
        cache[(0x1e35a7bdu * data[cached]) >> (32 - cache_bits)] = data[cached];
  };
  while (pos < total) {
    const Group& g = group_at(x, y);
    if (eight_bit && br.eos()) return -1;   // DecodeAlphaData stops at the end of the data
    const int code = g.h[0].read(br);
    if (code < kLiterals) {
      if (eight_bit) {
        data[pos] = static_cast<uint32_t>(code) << 8;
      } else {
        const uint32_t red = g.h[1].read(br), blue = g.h[2].read(br), a = g.h[3].read(br);
        data[pos] = (a << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      }
      ++pos;
      if (++x >= xsize) {
        x = 0;
        ++y;
      }
    } else if (code < kLiterals + kLengthCodes) {
      const int length = copy_value(code - kLiterals, br);
      const int dist_sym = g.h[4].read(br);
      const int dist = plane_distance(xsize, copy_value(dist_sym, br));
      if (!eight_bit && br.eos()) return -1;
      if (pos < dist || total - pos < length) return -1;
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      x += length;
      while (x >= xsize) {
        x -= xsize;
        ++y;
      }
    } else {
      const int key = code - (kLiterals + kLengthCodes);
      insert_cache();
      data[pos] = cache[key];
      ++pos;
      if (++x >= xsize) {
        x = 0;
        ++y;
      }
    }
    insert_cache();
    if (!eight_bit && br.eos()) return -1;
  }
  if (!eight_bit && br.eos()) return -1;
  return 0;
}

int decode_image(Decoder& d, int xsize, int ysize, bool level0, std::vector<uint32_t>* out,
                 bool alpha) {
  Bits& br = d.br;
  int tx = xsize;
  if (level0) {
    while (br.read(1)) {
      const int type = br.read(2);
      if (d.seen & (1u << type)) return -1;
      d.seen |= 1u << type;
      Transform t;
      t.type = type;
      t.xsize = tx;
      t.ysize = ysize;
      t.bits = 0;
      if (type == 0 || type == 1) {
        t.bits = br.read(3) + 2;
        if (decode_image(d, subsample(tx, t.bits), subsample(ysize, t.bits), false, &t.data,
                         false) != 0)
          return -1;
      } else if (type == 3) {
        const int ncolors = br.read(8) + 1;
        t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        tx = subsample(t.xsize, t.bits);
        std::vector<uint32_t> pal;
        if (decode_image(d, ncolors, 1, false, &pal, false) != 0) return -1;
        // ExpandColorMap: byte-wise deltas, entries past the palette zero
        t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
        uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 0; i < 4; ++i) nd[i] = od[i];
        for (int i = 4; i < 4 * ncolors; ++i) nd[i] = static_cast<uint8_t>(od[i] + nd[i - 4]);
      }
      d.transforms.push_back(std::move(t));
    }
  }
  return read_codes_and_data(d, tx, ysize, level0, out, alpha);
}

inline uint32_t avg2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

uint32_t predict(int mode, uint32_t L, const uint32_t* top) {
  const uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return avg2(avg2(L, TR), T);
    case 6: return avg2(L, TL);
    case 7: return avg2(L, T);
    case 8: return avg2(TL, T);
    case 9: return avg2(T, TR);
    case 10: return avg2(avg2(L, TL), avg2(T, TR));
    case 11: {
      int s = 0;
      for (int sh = 0; sh < 32; sh += 8)
        s += sub3((T >> sh) & 0xff, (L >> sh) & 0xff, (TL >> sh) & 0xff);
      return s <= 0 ? T : L;
    }
    case 12: {
      uint32_t r = 0;
      for (int sh = 0; sh < 32; sh += 8)
        r |= clip255(((L >> sh) & 0xff) + ((T >> sh) & 0xff) - ((TL >> sh) & 0xff)) << sh;
      return r;
    }
    case 13: {
      const uint32_t a = avg2(L, T);
      uint32_t r = 0;
      for (int sh = 0; sh < 32; sh += 8) {
        const int ac = (a >> sh) & 0xff, bc = (TL >> sh) & 0xff;
        r |= clip255(static_cast<uint32_t>(ac + (ac - bc) / 2)) << sh;
      }
      return r;
    }
    default: return 0xff000000u;   // 0, and the sentinels 14 and 15
  }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

// VP8LInverseTransform over the whole image; `img` holds t.xsize columns
// after it (the colour-indexing transform widens its input).
void inverse(const Transform& t, std::vector<uint32_t>& img) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 0) {
    std::vector<uint32_t> out(img.size() + 1);
    uint32_t* o = out.data() + 1;   // one spare word before row 0 for TL at (1, 0)
    const uint32_t* in = img.data();
    o[0] = add_pixels(in[0], 0xff000000u);
    for (int x = 1; x < w; ++x) o[x] = add_pixels(in[x], o[x - 1]);
    const int tiles = subsample(w, t.bits);
    for (int y = 1; y < h; ++y) {
      uint32_t* row = o + int64_t(y) * w;
      const uint32_t* top = row - w;
      const uint32_t* src = in + int64_t(y) * w;
      row[0] = add_pixels(src[0], top[0]);
      const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles;
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(src[x], predict(mode, row[x - 1], top + x));
      }
    }
    img.assign(out.begin() + 1, out.end());
  } else if (t.type == 1) {
    const int tiles = subsample(w, t.bits);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t code = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
        const int8_t g2r = static_cast<int8_t>(code & 0xff), g2b = static_cast<int8_t>(code >> 8);
        const int8_t r2b = static_cast<int8_t>(code >> 16);
        uint32_t& p = img[int64_t(y) * w + x];
        const int8_t green = static_cast<int8_t>(p >> 8);
        int red = (p >> 16) & 0xff, blue = p & 0xff;
        red = (red + delta(g2r, green)) & 0xff;
        blue += delta(g2b, green);
        blue += delta(r2b, static_cast<int8_t>(red));
        blue &= 0xff;
        p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
      }
  } else if (t.type == 2) {
    for (auto& p : img) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else {
    const int pw = subsample(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * h);
    const int per = 1 << t.bits, bpp = 8 >> t.bits, bmask = (1 << bpp) - 1;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (img[int64_t(y) * pw + (x >> t.bits)] >> 8) & 0xff;
        const int idx = t.bits ? (packed >> ((x & (per - 1)) * bpp)) & bmask : packed;
        out[int64_t(y) * w + x] = t.data[idx];
      }
    img.swap(out);
  }
}

}  // namespace

extern "C" {

// A VP8L bitstream (its 5-byte header first), or an ALPH chunk's lossless
// payload (alpha != 0: no header; w x h given): the w x h ARGB pixels into
// `argb`. Returns 0, -1 for a damaged or truncated stream, -2 for a
// header that is not w x h.
int vp8l_decode(const uint8_t* data, int64_t len, int alpha, int w, int h, uint32_t* argb) {
  Decoder d;
  d.br = Bits{data, len};
  if (!alpha) {
    if (d.br.read(8) != 0x2f) return -2;
    const int hw = d.br.read(14) + 1, hh = d.br.read(14) + 1;
    d.br.read(1);
    if (d.br.read(3) != 0 || hw != w || hh != h || d.br.eos()) return -2;
  }
  std::vector<uint32_t> img;
  if (decode_image(d, w, h, true, &img, alpha != 0) != 0) return -1;
  for (int i = static_cast<int>(d.transforms.size()) - 1; i >= 0; --i)
    inverse(d.transforms[i], img);
  memcpy(argb, img.data(), sizeof(uint32_t) * static_cast<size_t>(w) * h);
  return 0;
}

}  // extern "C"
