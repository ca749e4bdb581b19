// Baseline JPEG encoder: what cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY,
// q]) writes with libjpeg(-turbo)'s defaults, byte for byte.
//
// The pipeline is libjpeg's, in integer arithmetic:
//   BGR -> YCbCr (jccolor.c rgb_ycc_convert, SCALEBITS 16)
//   -> edge replication: rows to an even count and columns to each
//      component's block width times its expansion (jcprepct.c,
//      jcsample.c expand_right_edge), the downsampled rows to a whole
//      iMCU row (expand_bottom_edge)
//   -> 4:2:0 (h2v2_downsample, bias 1, 2, 1, 2, ... along a row)
//   -> jpeg_fdct_islow on level-shifted samples (jfdctint.c)
//   -> quantisation by divisor 8 * q, rounding half away from zero
//      (jcdctmgr.c), tables jpeg_set_quality(q, force_baseline=TRUE)
//   -> dummy blocks past a component's edge inside the last MCU column and
//      row: zero AC, the DC of the block before (jccoefct.c)
//   -> Huffman coding with the standard tables of JPEG Annex K (not
//      optimised), byte stuffing, the final byte padded with 1 bits.
// Markers in libjpeg's order: SOI, APP0 JFIF 1.01 (no density unit, 1:1),
// DQT 0, DQT 1, SOF0, DHT DC0 AC0 DC1 AC1, SOS, data, EOI.
//
// Plain C interface, bound with ctypes (utils/jpeg_encode.py), built with
// g++ at first use. jpeg_std_dht writes the four standard DHT segments,
// which the video reader inserts into Motion-JPEG frames that carry none
// (libjpeg's decoder supplies the same tables).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kZigzag[64] = {   // zigzag index -> natural index
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kStdLum[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr int kStdChrom[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// JPEG Annex K.3 (jcparam.c std_huff_tables): counts of codes of length
// 1..16, then the symbols.
constexpr uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {   // code and length per symbol (jchuff.c jpeg_make_c_derived_tbl)
  uint32_t code[256];
  uint8_t len[256];
};

void make_table(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  std::memset(t->len, 0, sizeof(t->len));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i, ++k) {
      t->code[vals[k]] = code++;
      t->len[vals[k]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

class Writer {
 public:
  Writer(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}
  bool ok() const { return n_ <= cap_; }
  int64_t size() const { return n_; }

  void byte(int b) {
    if (n_ < cap_) out_[n_] = static_cast<uint8_t>(b);
    ++n_;
  }
  void word(int w) { byte(w >> 8); byte(w & 0xFF); }

  // jchuff.c emit_bits: MSB first, 0xFF followed by a stuffed 0x00
  void bits(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    nbits_ += size;
    while (nbits_ >= 8) {
      int c = static_cast<int>((acc_ >> (nbits_ - 8)) & 0xFF);
      byte(c);
      if (c == 0xFF) byte(0);
      nbits_ -= 8;
    }
  }
  void flush() { bits(0x7F, 7); nbits_ = 0; acc_ = 0; }   // pad with 1 bits

 private:
  uint8_t* out_;
  int64_t cap_;
  int64_t n_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

void quant_table(int quality, const int* base, int* out) {   // jcparam.c
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 255L) t = 255L;   // force_baseline
    out[i] = static_cast<int>(t);
  }
}

// jfdctint.c jpeg_fdct_islow: in place on 64 level-shifted samples;
// the result is the DCT scaled up by 8.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

inline int descale(int64_t x, int n) { return static_cast<int>((x + (int64_t(1) << (n - 1))) >> n); }

void fdct_islow(int* data) {
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int* d = pass == 0 ? data + 8 * i : data + i;
      const int s = pass == 0 ? 1 : 8;
      int64_t tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
      int64_t tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
      int64_t tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
      int64_t tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      int shift;
      if (pass == 0) {
        d[0] = static_cast<int>((tmp10 + tmp11) << kPass1Bits);
        d[4 * s] = static_cast<int>((tmp10 - tmp11) << kPass1Bits);
        shift = kConstBits - kPass1Bits;
      } else {
        d[0] = descale(tmp10 + tmp11, kPass1Bits);
        d[4 * s] = descale(tmp10 - tmp11, kPass1Bits);
        shift = kConstBits + kPass1Bits;
      }
      int64_t z1 = (tmp12 + tmp13) * 4433;   // FIX(0.541196100)
      d[2 * s] = descale(z1 + tmp13 * 6270, shift);
      d[6 * s] = descale(z1 - tmp12 * 15137, shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * 9633;
      tmp4 *= 2446;
      tmp5 *= 16819;
      tmp6 *= 25172;
      tmp7 *= 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      d[7 * s] = descale(tmp4 + z1 + z3, shift);
      d[5 * s] = descale(tmp5 + z2 + z4, shift);
      d[3 * s] = descale(tmp6 + z2 + z3, shift);
      d[s] = descale(tmp7 + z1 + z4, shift);
    }
  }
}

struct Component {
  int id, h, v, tq;
  int width_in_blocks, height_in_blocks;
  int plane_w, plane_h;          // padded plane (columns, rows)
  std::vector<int> plane;        // samples 0..255
};

void emit_dqt(Writer& w, int idx, const int* q) {
  w.word(0xFFDB);
  w.word(2 + 1 + 64);
  w.byte(idx);
  for (int k = 0; k < 64; ++k) w.byte(q[kZigzag[k]]);
}

void emit_dht(Writer& w, int index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  w.word(0xFFC4);
  w.word(2 + 1 + 16 + n);
  w.byte(index);
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < n; ++i) w.byte(vals[i]);
}

void emit_std_dht(Writer& w) {
  emit_dht(w, 0x00, kDcLumBits, kDcVals);
  emit_dht(w, 0x10, kAcLumBits, kAcLumVals);
  emit_dht(w, 0x01, kDcChromBits, kDcVals);
  emit_dht(w, 0x11, kAcChromBits, kAcChromVals);
}

void encode_block(Writer& w, const int* coef, int* last_dc, const HuffTable& dc,
                  const HuffTable& ac) {   // jchuff.c encode_one_block
  int temp = coef[0] - *last_dc;
  *last_dc = coef[0];
  int temp2 = temp;
  if (temp < 0) { temp = -temp; temp2--; }
  int nbits = 0;
  while (temp) { nbits++; temp >>= 1; }
  w.bits(dc.code[nbits], dc.len[nbits]);
  if (nbits) w.bits(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = coef[kZigzag[k]];
    if (temp == 0) { r++; continue; }
    while (r > 15) { w.bits(ac.code[0xF0], ac.len[0xF0]); r -= 16; }
    temp2 = temp;
    if (temp < 0) { temp = -temp; temp2--; }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    w.bits(ac.code[i], ac.len[i]);
    w.bits(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) w.bits(ac.code[0], ac.len[0]);
}

}  // namespace

extern "C" {

// Writes the four standard DHT segments into out (at least 432 bytes);
// returns their length.
int64_t jpeg_std_dht(uint8_t* out, int64_t cap) {
  Writer w(out, cap);
  emit_std_dht(w);
  return w.ok() ? w.size() : -1;
}

// Encodes an (h, w, 3) BGR u8 image (rows `stride` bytes apart) at
// `quality` into out[0:cap]; returns the stream's length, or minus the
// length it needs when cap is too small.
int64_t jpeg_encode_bgr(const uint8_t* bgr, int h, int w, int64_t stride, int quality,
                        uint8_t* out, int64_t cap) {
  const int mcus_x = (w + 15) / 16, mcus_y = (h + 15) / 16;
  Component comp[3] = {{1, 2, 2, 0, 0, 0, 0, 0, {}},
                       {2, 1, 1, 1, 0, 0, 0, 0, {}},
                       {3, 1, 1, 1, 0, 0, 0, 0, {}}};
  const int hp = h + (h & 1);   // the conversion buffer: rows to a row group
  for (Component& c : comp) {
    c.width_in_blocks = (w * c.h + 15) / 16;
    c.height_in_blocks = (h * c.v + 15) / 16;
    c.plane_w = c.width_in_blocks * 8;
    c.plane_h = mcus_y * 8 * c.v;   // a whole number of iMCU rows
    c.plane.assign(static_cast<size_t>(c.plane_w) * c.plane_h, 0);
  }
  // colour conversion with edge replication to the widest expansion the
  // downsampler reads (2 * chroma width), rows to an even count
  const int xw = comp[1].plane_w * 2;
  std::vector<int> ycc[3];
  for (auto& p : ycc) p.assign(static_cast<size_t>(xw) * hp, 0);
  constexpr int kScale = 16, kHalf = 1 << 15, kCbCrOffset = 128 << 16;
  for (int y = 0; y < hp; ++y) {
    const uint8_t* row = bgr + static_cast<int64_t>(std::min(y, h - 1)) * stride;
    for (int x = 0; x < xw; ++x) {
      const uint8_t* px = row + 3 * std::min(x, w - 1);
      int b = px[0], g = px[1], r = px[2];
      size_t o = static_cast<size_t>(y) * xw + x;
      ycc[0][o] = (19595 * r + 38470 * g + 7471 * b + kHalf) >> kScale;
      ycc[1][o] = (-11059 * r - 21709 * g + 32768 * b + kCbCrOffset + kHalf - 1) >> kScale;
      ycc[2][o] = (32768 * r - 27439 * g - 5329 * b + kCbCrOffset + kHalf - 1) >> kScale;
    }
  }
  // Y as is, Cb and Cr by h2v2; then the rows below the image repeat the last
  for (int ci = 0; ci < 3; ++ci) {
    Component& c = comp[ci];
    const int rows = ci == 0 ? hp : hp / 2;
    for (int y = 0; y < c.plane_h; ++y) {
      const int sy = std::min(y, rows - 1);
      int* dst = &c.plane[static_cast<size_t>(y) * c.plane_w];
      if (ci == 0) {
        const int* src = &ycc[0][static_cast<size_t>(sy) * xw];
        std::memcpy(dst, src, sizeof(int) * c.plane_w);
      } else {
        const int* r0 = &ycc[ci][static_cast<size_t>(2 * sy) * xw];
        const int* r1 = r0 + xw;
        int bias = 1;
        for (int x = 0; x < c.plane_w; ++x) {
          dst[x] = (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2;
          bias ^= 3;
        }
      }
    }
  }

  int qt[2][64];
  quant_table(quality, kStdLum, qt[0]);
  quant_table(quality, kStdChrom, qt[1]);
  HuffTable dc[2], ac[2];
  make_table(kDcLumBits, kDcVals, &dc[0]);
  make_table(kDcChromBits, kDcVals, &dc[1]);
  make_table(kAcLumBits, kAcLumVals, &ac[0]);
  make_table(kAcChromBits, kAcChromVals, &ac[1]);

  Writer wr(out, cap);
  wr.word(0xFFD8);
  // APP0 JFIF 1.01, density unit 0, density 1:1, no thumbnail
  const uint8_t app0[16] = {0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  wr.word(0xFFE0);
  for (int i = 0; i < 16; ++i) wr.byte(app0[i]);
  emit_dqt(wr, 0, qt[0]);
  emit_dqt(wr, 1, qt[1]);
  wr.word(0xFFC0);
  wr.word(8 + 3 * 3);
  wr.byte(8);
  wr.word(h);
  wr.word(w);
  wr.byte(3);
  for (const Component& c : comp) {
    wr.byte(c.id);
    wr.byte((c.h << 4) | c.v);
    wr.byte(c.tq);
  }
  emit_std_dht(wr);
  wr.word(0xFFDA);
  wr.word(6 + 2 * 3);
  wr.byte(3);
  for (const Component& c : comp) {
    wr.byte(c.id);
    wr.byte((c.tq << 4) | c.tq);
  }
  wr.byte(0);
  wr.byte(63);
  wr.byte(0);

  int last_dc[3] = {0, 0, 0};
  int block[64];
  int mcu[4][64];
  for (int my = 0; my < mcus_y; ++my) {
    for (int mx = 0; mx < mcus_x; ++mx) {
      for (int ci = 0; ci < 3; ++ci) {
        Component& c = comp[ci];
        const int* q = qt[c.tq];
        const int last_col_width = c.width_in_blocks % c.h ? c.width_in_blocks % c.h : c.h;
        const int last_row_height = c.height_in_blocks % c.v ? c.height_in_blocks % c.v : c.v;
        const int blockcnt = mx < mcus_x - 1 ? c.h : last_col_width;
        int blkn = 0;
        for (int yi = 0; yi < c.v; ++yi) {
          if (my < mcus_y - 1 || yi < last_row_height) {
            for (int bi = 0; bi < blockcnt; ++bi) {
              const int by = my * c.v + yi, bx = mx * c.h + bi;
              for (int r = 0; r < 8; ++r) {
                const int* src = &c.plane[static_cast<size_t>(by * 8 + r) * c.plane_w + bx * 8];
                for (int k = 0; k < 8; ++k) block[8 * r + k] = src[k] - 128;
              }
              fdct_islow(block);
              for (int k = 0; k < 64; ++k) {
                const int qv = q[k] << 3;
                int t = block[k];
                mcu[blkn + bi][k] = t < 0 ? -((-t + (qv >> 1)) / qv) : (t + (qv >> 1)) / qv;
              }
            }
            for (int bi = blockcnt; bi < c.h; ++bi) {   // dummy blocks at the right edge
              std::memset(mcu[blkn + bi], 0, sizeof(mcu[0]));
              mcu[blkn + bi][0] = mcu[blkn + bi - 1][0];
            }
          } else {                                      // a dummy row at the bottom
            for (int bi = 0; bi < c.h; ++bi) {
              std::memset(mcu[blkn + bi], 0, sizeof(mcu[0]));
              mcu[blkn + bi][0] = mcu[blkn - 1][0];
            }
          }
          blkn += c.h;
        }
        for (int b = 0; b < c.h * c.v; ++b)
          encode_block(wr, mcu[b], &last_dc[ci], dc[c.tq], ac[c.tq]);
      }
    }
  }
  wr.flush();
  wr.word(0xFFD9);
  return wr.ok() ? wr.size() : -wr.size();
}

}  // extern "C"
