// Host loops of the port's TIFF decoder (utils/tiff.py), as libtiff 4.7.1
// runs them under cv2 5.0's 8-bit read: the LZW decoder of tif_lzw.c (the
// MSB-first codes with their early width change, and the old bit-reversed
// "compat" codes), PackBits (tif_packbits.c), the horizontal predictor
// (tif_predict.c), and the RGBA conversion of tif_getimage.c that
// TIFFReadRGBAStrip / TIFFReadRGBATile run: the put routines for gray,
// palette, RGB (8 and 16 bits, with associated, unassociated or no alpha),
// separated CMYK and YCbCr (its lookup tables and the block layouts of the
// subsampled put routines), their skews, and the orientation flips of
// gtStripContig / gtTileContig. Plain C interface, bound with ctypes, built
// with g++ at first use (utils/host_build.py). The bytes come from the
// network: every read is checked against their length.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------- LZW

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kCsize = (1 << kBitsMax) - 1 + 1024;   // MAXCODE(BITS_MAX) + 1024

struct Code {
  int next;        // index of the prefix entry, -1 for none
  uint16_t length;
  uint8_t value, firstchar;
};

inline int maxcode(int n) { return (1 << n) - 1; }

// tif_lzw.c LZWDecode (libtiff >= 4.5): the table starts empty (the first
// code must be a clear), codes are read MSB first, the width grows one code
// early. Fills out[0:occ]. Returns 1, or 0 on error (data ending before the
// buffer is full: the bytes decoded so far stay; a code not yet in the
// table or no end code before the data runs out: the rest of the buffer is
// zeroed).
int lzw_new(const uint8_t* data, int64_t len, uint8_t* out, int64_t occ) {
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; ++c) tab[c] = {-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
  tab[kClear] = tab[kEoi] = {-1, 0, 0, 0};
  int free_ent = -1;   // dec_codetab - 1: no entry may be added before a clear
  int nbits = kBitsMin, mask = maxcode(kBitsMin), maxc = mask - 1;
  int old = 0;
  int64_t bitpos = 0;
  const int64_t bits = len * 8;
  uint8_t* op = out;
  auto next_code = [&](int* code) -> bool {
    if (bitpos + nbits > bits) return false;
    const int64_t byte = bitpos >> 3;
    uint32_t w = static_cast<uint32_t>(data[byte]) << 16;   // the code spans at most 3 bytes
    if (byte + 1 < len) w |= static_cast<uint32_t>(data[byte + 1]) << 8;
    if (byte + 2 < len) w |= data[byte + 2];
    *code = static_cast<int>((w >> (24 - (bitpos & 7) - nbits)) & ((1u << nbits) - 1));
    bitpos += nbits;
    return true;
  };
  auto fail_zero = [&]() {
    memset(op, 0, static_cast<size_t>(occ));
    return 0;
  };
  auto add = [&](int value_of) {
    Code& e = tab[free_ent];
    e.value = static_cast<uint8_t>(value_of);
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = static_cast<uint16_t>(tab[old].length + 1);
    if (++free_ent > maxc) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      mask = maxcode(nbits);
      maxc = mask - 1;
      if (free_ent >= kCsize) free_ent = -1;
    }
  };
  if (occ == 0) return 1;
  for (;;) {
    int code;
    if (!next_code(&code)) return fail_zero();
    if (code == kEoi) break;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      mask = maxcode(kBitsMin);
      maxc = mask - 1;
      do {
        if (!next_code(&code)) return fail_zero();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return fail_zero();
      *op++ = static_cast<uint8_t>(code);
      old = code;
      if (--occ == 0) return 1;
      continue;
    }
    if (code < 256) {
      if (free_ent < 0 || code > free_ent) return fail_zero();
      add(code);
      old = code;
      *op++ = static_cast<uint8_t>(code);
      if (--occ == 0) return 1;
      continue;
    }
    // code >= 258
    if (free_ent < 0 || code > free_ent) return fail_zero();
    add(code == free_ent ? tab[old].firstchar : tab[code].firstchar);
    old = code;
    const int64_t l = tab[code].length;
    if (l > occ) {   // the string is cut at the buffer's end
      int c = code;
      while (tab[c].length > occ) c = tab[c].next;
      for (int64_t i = occ - 1; i >= 0; --i, c = tab[c].next) op[i] = tab[c].value;
      return 1;
    }
    int c = code;
    for (int64_t i = l - 1; i >= 0; --i, c = tab[c].next) op[i] = tab[c].value;
    op += l;
    occ -= l;
    if (occ == 0) return 1;
  }
  return 0;   // an end code before the buffer is full: "Not enough data"
}

// tif_lzw.c LZWDecodeCompat: LSB-first codes, the width grows when the
// table passes the width's limit. A missing end code ends the data.
int lzw_compat(const uint8_t* data, int64_t len, uint8_t* out, int64_t occ) {
  std::vector<Code> tab(kCsize);
  for (int c = 0; c < 256; ++c) tab[c] = {-1, 1, static_cast<uint8_t>(c), static_cast<uint8_t>(c)};
  tab[kClear] = tab[kEoi] = {-1, 0, 0, 0};
  int free_ent = -1;
  int nbits = kBitsMin, mask = maxcode(kBitsMin), maxc = mask;
  int old = 0;
  int64_t bitpos = 0;
  const int64_t bits = len * 8;
  uint8_t* op = out;
  auto next_code = [&]() -> int {
    if (bits - bitpos < nbits) return kEoi;   // "not terminated with EOI code"
    int c = 0;
    for (int b = 0; b < nbits; ++b, ++bitpos) c |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    return c;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kCsize; ++i) tab[i] = {0, 0, 0, 0};
        nbits = kBitsMin;
        mask = maxcode(kBitsMin);
        maxc = mask;
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return 0;
      *op++ = static_cast<uint8_t>(code);
      --occ;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCsize) return 0;
    Code& e = tab[free_ent];
    e.next = old;
    e.firstchar = tab[old].firstchar;
    e.length = static_cast<uint16_t>(tab[old].length + 1);
    e.value = code < free_ent ? tab[code].firstchar : e.firstchar;
    if (++free_ent > maxc) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      mask = maxcode(nbits);
      maxc = mask;
    }
    old = code;
    if (code >= 256) {
      if (tab[code].length == 0) return 0;
      if (tab[code].length > occ) {
        int c = code;
        while (tab[c].length > occ) c = tab[c].next;
        for (int64_t i = occ - 1; i >= 0; --i, c = tab[c].next) op[i] = tab[c].value;
        occ = 0;
        break;
      }
      const int64_t l = tab[code].length;
      int c = code;
      for (int64_t i = l - 1; i >= 0 && c >= 0; --i, c = tab[c].next) op[i] = tab[c].value;
      op += l;
      occ -= l;
    } else {
      *op++ = static_cast<uint8_t>(code);
      --occ;
    }
  }
  return occ > 0 ? 0 : 1;
}

// ------------------------------------------------------ RGBA conversion

inline uint32_t pack(uint32_t r, uint32_t g, uint32_t b) {
  return r | (g << 8) | (b << 16) | 0xff000000u;
}
inline uint32_t pack4(uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
  return r | (g << 8) | (b << 16) | (a << 24);
}

// TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB (tif_color.c)
struct YCbCr {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256], y[256];

  static float code2v(int c, float rb, float rw, float cr) {
    return ((static_cast<float>(c) - rb) * cr) / ((rw - rb != 0) ? (rw - rb) : 1);
  }
  static float clampw(float v, float a, float b) { return v < a ? a : v > b ? b : v; }

  void init(const float* luma, const float* rbw) {
    constexpr int kShift = 16;
    auto fix = [](float x) {
      return static_cast<int32_t>(x * static_cast<float>(1L << kShift) + 0.5);
    };
    constexpr int32_t kHalf = 1 << (kShift - 1);
    auto clamp = [](float f, float lo, float hi) { return f < lo ? lo : f > hi ? hi : f; };
    const float f1 = 2 - 2 * luma[0];
    const int32_t d1 = fix(clamp(f1, 0.0F, 2.0F));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t d2 = -fix(clamp(f2, 0.0F, 2.0F));
    const float f3 = 2 - 2 * luma[2];
    const int32_t d3 = fix(clamp(f3, 0.0F, 2.0F));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t d4 = -fix(clamp(f4, 0.0F, 2.0F));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t cr = static_cast<int32_t>(
          clampw(code2v(x, rbw[4] - 128.0F, rbw[5] - 128.0F, 127), -128.0F * 32, 128.0F * 32));
      const int32_t cb = static_cast<int32_t>(
          clampw(code2v(x, rbw[2] - 128.0F, rbw[3] - 128.0F, 127), -128.0F * 32, 128.0F * 32));
      cr_r[i] = static_cast<int32_t>((d1 * cr + kHalf) >> kShift);
      cb_b[i] = static_cast<int32_t>((d3 * cb + kHalf) >> kShift);
      cr_g[i] = d2 * cr;
      cb_g[i] = d4 * cb + kHalf;
      y[i] = static_cast<int32_t>(
          clampw(code2v(x + 128, rbw[0], rbw[1], 255), -128.0F * 32, 128.0F * 32));
    }
  }

  uint32_t rgb(uint32_t Y, int32_t Cb, int32_t Cr) const {
    Y = Y > 255 ? 255 : Y;
    Cb = Cb < 0 ? 0 : Cb > 255 ? 255 : Cb;
    Cr = Cr < 0 ? 0 : Cr > 255 ? 255 : Cr;
    int32_t i = y[Y] + cr_r[Cr];
    const uint32_t r = i < 0 ? 0 : i > 255 ? 255 : i;
    i = y[Y] + static_cast<int>((cb_g[Cb] + cr_g[Cr]) >> 16);
    const uint32_t g = i < 0 ? 0 : i > 255 ? 255 : i;
    i = y[Y] + cb_b[Cb];
    const uint32_t b = i < 0 ? 0 : i > 255 ? 255 : i;
    return pack(r, g, b);
  }
};

// What tif_getimage.c's PickContigCase / PickSeparateCase chose.
enum Put {
  kGray1 = 1, kGray2, kGray4, kGray8, kGrayAlpha8, kGray16,                  // contig gray
  kPal1, kPal2, kPal4, kPal8,                                                // contig palette
  kRgb8, kRgbAssoc8, kRgbUnassoc8, kRgb16, kRgbAssoc16, kRgbUnassoc16,      // contig RGB
  kCmyk8,                                                                    // contig CMYK
  kYcc11, kYcc12, kYcc21, kYcc22, kYcc41, kYcc42, kYcc44,                    // contig YCbCr
  kSepRgb8, kSepRgbAssoc8, kSepRgbUnassoc8, kSepRgb16, kSepRgbAssoc16,
  kSepRgbUnassoc16, kSepCmyk8, kSepYcc11                                     // separate
};

struct Image {
  int put, bps, spp, photometric;   // photometric 0 MinIsWhite, 1 MinIsBlack, 3 palette
  uint32_t bwmap[256][8];
  uint32_t palmap[256][8];
  uint8_t ua_to_aa[256][256];
  uint8_t b16to8[65536];
  YCbCr ycc;
  int hs, vs;
  bool fixed_tables = false;
};

// setupMap + makebwmap (gray), checkcmap / cvtcmap + makecmap (palette)
void build_maps(Image* im, const uint16_t* cmap) {
  const int bps = im->bps;
  if (im->photometric == 0 || im->photometric == 1) {
    int32_t range = static_cast<int32_t>((1L << bps) - 1);
    if (bps == 16) range = 255;
    std::vector<uint8_t> map(range + 1);
    for (int32_t x = 0; x <= range; ++x)
      map[x] = static_cast<uint8_t>(im->photometric == 0 ? ((range - x) * 255) / range
                                                         : (x * 255) / range);
    for (int i = 0; i < 256; ++i) {
      uint32_t* p = im->bwmap[i];
      auto grey = [&](int x) { const uint32_t c = map[x]; *p++ = pack(c, c, c); };
      switch (bps) {
        case 1: for (int s = 7; s >= 0; --s) grey((i >> s) & 1); break;
        case 2: grey(i >> 6); grey((i >> 4) & 3); grey((i >> 2) & 3); grey(i & 3); break;
        case 4: grey(i >> 4); grey(i & 0xf); break;
        default: grey(i); break;
      }
    }
  } else if (im->photometric == 3 && bps <= 8) {
    const int n = 1 << bps;
    std::vector<uint16_t> r(cmap, cmap + n), g(cmap + n, cmap + 2 * n);
    std::vector<uint16_t> b(cmap + 2 * n, cmap + 3 * n);
    bool sixteen = false;
    for (int i = 0; i < n; ++i)
      if (r[i] >= 256 || g[i] >= 256 || b[i] >= 256) sixteen = true;
    if (sixteen)
      for (int i = 0; i < n; ++i) {
        r[i] >>= 8;
        g[i] >>= 8;
        b[i] >>= 8;
      }
    for (int i = 0; i < 256; ++i) {
      uint32_t* p = im->palmap[i];
      auto cm = [&](int c) { *p++ = pack(r[c] & 0xff, g[c] & 0xff, b[c] & 0xff); };
      switch (bps) {
        case 1: for (int s = 7; s >= 0; --s) cm((i >> s) & 1); break;
        case 2: cm(i >> 6); cm((i >> 4) & 3); cm((i >> 2) & 3); cm(i & 3); break;
        case 4: cm(i >> 4); cm(i & 0xf); break;
        default: cm(i); break;
      }
    }
  }
  if (!im->fixed_tables) {   // BuildMapUaToAa, BuildMapBitdepth16To8
    for (int a = 0; a < 256; ++a)
      for (int v = 0; v < 256; ++v) im->ua_to_aa[a][v] = static_cast<uint8_t>((v * a + 127) / 255);
    for (uint32_t n = 0; n < 65536; ++n) im->b16to8[n] = static_cast<uint8_t>((n + 128) / 257);
    im->fixed_tables = true;
  }
}

// A read of the decoded buffer that gives 0 past its end (libtiff's buffer
// is the strip's or tile's full size; the port's copy is checked instead).
struct Buf {
  const uint8_t* p;
  int64_t n;
  uint8_t at(int64_t i) const { return i >= 0 && i < n ? p[i] : 0; }
  uint16_t at16(int64_t i) const {   // native (little-endian) 16-bit sample i
    return static_cast<uint16_t>(at(2 * i) | (at(2 * i + 1) << 8));
  }
};

// The contiguous put routines. cp walks the raster from `start` with
// libtiff's toskew; pp walks the buffer from 0 with its fromskew.
void put_contig(const Image& im, uint32_t* raster, int64_t rlen, int64_t start, int w, int h,
                int32_t fromskew, int32_t toskew, const Buf& buf) {
  int64_t cp = start, pp = 0;
  auto emit = [&](int64_t at, uint32_t v) {
    if (at >= 0 && at < rlen) raster[at] = v;
  };
  const int spp = im.spp;
  switch (im.put) {
    case kGray1: case kGray2: case kGray4: case kPal1: case kPal2: case kPal4: {
      const int bps = im.bps, per = 8 / bps;
      const bool pal = im.put >= kPal1;
      fromskew /= per;
      for (; h > 0; --h) {
        int x = w;
        while (x > 0) {
          const uint32_t* m = pal ? im.palmap[buf.at(pp++)] : im.bwmap[buf.at(pp++)];
          const int k = x >= per ? per : x;
          for (int j = 0; j < k; ++j) emit(cp++, m[j]);
          x -= k;
        }
        cp += toskew;
        pp += fromskew;
      }
      break;
    }
    case kGray8: case kGrayAlpha8: case kPal8:
      for (; h > 0; --h) {
        for (int x = w; x > 0; --x) {
          uint32_t v = im.put == kPal8 ? im.palmap[buf.at(pp)][0] : im.bwmap[buf.at(pp)][0];
          if (im.put == kGrayAlpha8)
            v &= (static_cast<uint32_t>(buf.at(pp + 1)) << 24) | 0x00ffffffu;
          emit(cp++, v);
          pp += spp;
        }
        cp += toskew;
        pp += fromskew;
      }
      break;
    case kGray16:   // the high byte; pp skips fromskew bytes, not samples, as libtiff does
      for (; h > 0; --h) {
        for (int x = w; x > 0; --x) {
          emit(cp++, im.bwmap[buf.at(pp + 1)][0]);   // the high byte of the sample at pp
          pp += 2 * spp;
        }
        cp += toskew;
        pp += fromskew;
      }
      break;
    case kRgb8: case kRgbAssoc8: case kCmyk8:
      fromskew *= spp;
      for (; h > 0; --h) {
        for (int x = w; x > 0; --x) {
          if (im.put == kCmyk8) {
            const uint16_t k = static_cast<uint16_t>(255 - buf.at(pp + 3));
            const uint16_t r = static_cast<uint16_t>((k * (255 - buf.at(pp))) / 255);
            const uint16_t g = static_cast<uint16_t>((k * (255 - buf.at(pp + 1))) / 255);
            const uint16_t b = static_cast<uint16_t>((k * (255 - buf.at(pp + 2))) / 255);
            emit(cp++, pack(r, g, b));
          } else if (im.put == kRgbAssoc8) {
            emit(cp++, pack4(buf.at(pp), buf.at(pp + 1), buf.at(pp + 2), buf.at(pp + 3)));
          } else {
            emit(cp++, pack(buf.at(pp), buf.at(pp + 1), buf.at(pp + 2)));
          }
          pp += spp;
        }
        cp += toskew;
        pp += fromskew;
      }
      break;
    case kRgbUnassoc8:
      fromskew *= spp;
      for (; h > 0; --h) {
        for (int x = w; x > 0; --x) {
          const uint8_t a = buf.at(pp + 3);
          const uint8_t* m = im.ua_to_aa[a];
          emit(cp++, pack4(m[buf.at(pp)], m[buf.at(pp + 1)], m[buf.at(pp + 2)], a));
          pp += spp;
        }
        cp += toskew;
        pp += fromskew;
      }
      break;
    case kRgb16: case kRgbAssoc16: case kRgbUnassoc16: {
      fromskew *= spp;
      int64_t wp = 0;
      const uint8_t* t = im.b16to8;
      for (; h > 0; --h) {
        for (int x = w; x > 0; --x) {
          const uint8_t r = t[buf.at16(wp)], g = t[buf.at16(wp + 1)], b = t[buf.at16(wp + 2)];
          if (im.put == kRgb16) {
            emit(cp++, pack(r, g, b));
          } else if (im.put == kRgbAssoc16) {
            emit(cp++, pack4(r, g, b, t[buf.at16(wp + 3)]));
          } else {
            const uint8_t a = t[buf.at16(wp + 3)];
            const uint8_t* m = im.ua_to_aa[a];
            emit(cp++, pack4(m[r], m[g], m[b], a));
          }
          wp += spp;
        }
        cp += toskew;
        wp += fromskew;
      }
      break;
    }
    default: {   // YCbCr: blocks of hs x vs luma samples, then Cb and Cr
      const int hs = im.hs, vs = im.vs, unit = hs * vs + 2;
      fromskew = (fromskew / hs) * unit;
      const int32_t stride = w + toskew;   // raster step from one row to the next
      int rows_left = h;
      while (rows_left > 0) {
        const int bh = rows_left < vs ? rows_left : vs;
        int x = w;
        int64_t col = 0;
        while (x > 0) {
          const int bw = x < hs ? x : hs;
          const int32_t cb = buf.at(pp + hs * vs), cr = buf.at(pp + hs * vs + 1);
          for (int j = 0; j < bh; ++j)
            for (int i = 0; i < bw; ++i)
              emit(cp + col + int64_t(j) * stride + i, im.ycc.rgb(buf.at(pp + j * hs + i), cb, cr));
          col += bw;
          x -= bw;
          pp += unit;
        }
        if (rows_left <= vs) break;
        rows_left -= vs;
        cp += int64_t(vs) * stride;
        pp += fromskew;
      }
      break;
    }
  }
}

// The separate put routines: planes r, g, b (gray: one plane three times),
// a (alpha, or K for CMYK).
void put_separate(const Image& im, uint32_t* raster, int64_t rlen, int64_t start, int w, int h,
                  int32_t fromskew, int32_t toskew, const Buf* pl) {
  int64_t cp = start, pp = 0;
  const bool sixteen =
      im.put == kSepRgb16 || im.put == kSepRgbAssoc16 || im.put == kSepRgbUnassoc16;
  const uint8_t* t = im.b16to8;
  for (; h > 0; --h) {
    for (int x = w; x > 0; --x, ++pp) {
      uint32_t v;
      if (sixteen) {
        const uint8_t r = t[pl[0].at16(pp)], g = t[pl[1].at16(pp)], b = t[pl[2].at16(pp)];
        if (im.put == kSepRgb16) {
          v = pack(r, g, b);
        } else {
          const uint8_t a = t[pl[3].at16(pp)];
          if (im.put == kSepRgbAssoc16) {
            v = pack4(r, g, b, a);
          } else {
            const uint8_t* m = im.ua_to_aa[a];
            v = pack4(m[r], m[g], m[b], a);
          }
        }
      } else {
        const uint8_t r = pl[0].at(pp), g = pl[1].at(pp), b = pl[2].at(pp);
        switch (im.put) {
          case kSepRgb8: v = pack(r, g, b); break;
          case kSepRgbAssoc8: v = pack4(r, g, b, pl[3].at(pp)); break;
          case kSepRgbUnassoc8: {
            const uint8_t a = pl[3].at(pp);
            const uint8_t* m = im.ua_to_aa[a];
            v = pack4(m[r], m[g], m[b], a);
            break;
          }
          case kSepCmyk8: {
            const uint32_t k = 255 - pl[3].at(pp);
            v = pack4((k * (255 - r)) / 255, (k * (255 - g)) / 255, (k * (255 - b)) / 255, 255);
            break;
          }
          default: v = im.ycc.rgb(r, g, b); break;   // kSepYcc11
        }
      }
      if (cp >= 0 && cp < rlen) raster[cp] = v;
      ++cp;
    }
    pp += fromskew;
    cp += toskew;
  }
}

}  // namespace

extern "C" {

// Decompresses one strip or tile. method 5: LZW (compat 1 for the old
// bit-reversed codes), 32773: PackBits. `out` (occ bytes) must be zeroed by
// the caller, as libtiff zeroes its buffer. Returns 1, or 0 where libtiff's
// decoder fails (what was decoded stays).
int tiff_decompress(int method, int compat, const uint8_t* data, int64_t len, uint8_t* out,
                    int64_t occ) {
  if (method == 5) return compat ? lzw_compat(data, len, out, occ) : lzw_new(data, len, out, occ);
  // PackBitsDecode
  int64_t cc = len, pos = 0;
  uint8_t* op = out;
  while (cc > 0 && occ > 0) {
    int64_t n = static_cast<int8_t>(data[pos++]);
    --cc;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < n) n = occ;
      if (cc == 0) break;
      occ -= n;
      const uint8_t b = data[pos++];
      --cc;
      memset(op, b, static_cast<size_t>(n));
      op += n;
    } else {
      if (occ < n + 1) n = occ - 1;
      if (cc < n + 1) break;
      ++n;
      memcpy(op, data + pos, static_cast<size_t>(n));
      op += n;
      occ -= n;
      pos += n;
      cc -= n;
    }
  }
  return occ > 0 ? 0 : 1;
}

// tif_predict.c horAcc8 / horAcc16 over `rows` rows of `rowsize` bytes:
// each sample adds the one `stride` samples before it in its row.
void tiff_predictor(uint8_t* buf, int64_t rows, int64_t rowsize, int bps, int stride) {
  for (int64_t r = 0; r < rows; ++r) {
    uint8_t* row = buf + r * rowsize;
    if (bps == 8) {
      for (int64_t i = stride; i < rowsize; ++i)
        row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
    } else {
      const int64_t n = rowsize / 2;
      uint16_t* wp = reinterpret_cast<uint16_t*>(row);
      for (int64_t i = stride; i < n; ++i) {
        uint16_t a, b;
        memcpy(&a, wp + i, 2);
        memcpy(&b, wp + i - stride, 2);
        a = static_cast<uint16_t>(a + b);
        memcpy(wp + i, &a, 2);
      }
    }
  }
}

// TIFFRGBAImageGet over one strip or tile, as TIFFReadRGBAStrip /
// TIFFReadRGBATile call it: the region of w x h pixels into `raster`
// (w * h RGBA words, bottom-up as libtiff's BOTLEFT request lays it out,
// flipped as setorientation says). params: put, bps, spp, photometric,
// flip (1 vertical, 2 horizontal), fromskew, separate (0/1), hs, vs.
// planes: 1 buffer (contig) or 4 (separate; unused ones may repeat).
// cmap: 3 << bps entries (palette); luma: 3 floats, rbw: 6 floats (YCbCr).
// Returns 0.
int tiff_rgba(const int32_t* params, const uint8_t* const* planes, const int64_t* lens,
              const uint16_t* cmap, const float* luma, const float* rbw, int w, int h,
              uint32_t* raster) {
  static thread_local Image im;
  im.put = params[0];
  im.bps = params[1];
  im.spp = params[2];
  im.photometric = params[3];
  const int flip = params[4];
  const int32_t fromskew = params[5];
  const int separate = params[6];
  im.hs = params[7];
  im.vs = params[8];
  build_maps(&im, cmap);
  if ((im.put >= kYcc11 && im.put <= kYcc44) || im.put == kSepYcc11) im.ycc.init(luma, rbw);
  const int64_t rlen = int64_t(w) * h;
  int64_t start;
  int32_t toskew;
  if (flip & 1) {
    start = int64_t(h - 1) * w;
    toskew = -(w + w);
  } else {
    start = 0;
    toskew = 0;
  }
  if (separate) {
    Buf pl[4];
    for (int i = 0; i < 4; ++i) pl[i] = {planes[i], lens[i]};
    put_separate(im, raster, rlen, start, w, h, fromskew, toskew, pl);
  } else {
    put_contig(im, raster, rlen, start, w, h, fromskew, toskew, Buf{planes[0], lens[0]});
  }
  if (flip & 2) {
    for (int line = 0; line < h; ++line) {
      uint32_t* left = raster + int64_t(line) * w;
      uint32_t* right = left + w - 1;
      while (left < right) {
        const uint32_t t = *left;
        *left++ = *right;
        *right-- = t;
      }
    }
  }
  return 0;
}

}  // extern "C"
