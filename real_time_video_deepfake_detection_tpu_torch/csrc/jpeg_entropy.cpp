// JPEG entropy decoder: the host half of the port's JPEG decode.
//
// Parses a JPEG stream and entropy-decodes it into quantised DCT
// coefficients, nothing more; dequantisation, the inverse DCT, upsampling
// and colour conversion run in torch (ops/jpeg_decode.py), where they equal
// libjpeg-turbo 2.1.5's default decode bit for bit. Plain C interface,
// bound with ctypes (utils/jpeg_ingest.py), built with g++ at first use.
//
// Accepted as libjpeg-turbo 2.1.5 accepts them: SOF0/SOF1 (sequential) and
// SOF2 (progressive) Huffman frames and SOF9 (sequential) and SOF10
// (progressive) arithmetic-coded frames, at 8-bit precision with 1, 3 or 4
// components and sampling factors 1-4 whose ratios are whole numbers; DQT
// with 8- and 16-bit tables, DHT, DAC (the arithmetic conditioning), DRI
// with RST0-7 (a misplaced restart marker is resynchronised as jdmarker.c
// does), APPn/COM/DNL skipped (APP0 JFIF and APP14 Adobe decide the colour
// space as jdapimin.c does), byte stuffing, fill bytes, EOI; in a sequential
// Huffman frame, Huffman slots 0 and 1 that no DHT defines before the first
// scan get the standard tables, as libjpeg-turbo installs them. Lossless
// and hierarchical frames, 12-bit precision, other component counts and
// fractional sampling ratios return a negative code from the coefficient
// entries, as does every stream libjpeg stops on. A lossless (SOF3) frame
// of 8-bit samples has an entry of its own, jpeg_decode_lossless, which
// returns samples (the cv2 route decodes it; libjpeg-turbo 2.1.5 does not).
//
// A stream that ends early decodes as libjpeg's memory source decodes it:
// the data is followed by fake EOI markers (FF D9, repeated). A Huffman
// scan finishes the MCU in progress with zero bits and leaves the rest of
// the restart interval as it was (all zero in a sequential scan); a later
// restart marker found in the data resumes decoding (jdhuff.c,
// jdphuff.c). An arithmetic scan reads a marker, and the end, as zero
// bytes and goes on decoding them (jdarith.c); a bad code stops the rest of
// its restart interval. The caller learns that the end was passed
// (cv2.imdecode refuses such a stream). A progressive frame whose first AC coefficients
// are not all exact (in practice a truncated one) is block-smoothed as
// jdcoefct.c decompress_smooth_data smooths it, on the coefficients, before
// they leave this file. The bytes come from the network: every read is
// bounds checked.
//
// Layout shared with Python. info (kInfoLen int32):
//   [0] height [1] width [2] components [3] max h factor [4] max v factor
//   [5] MCUs per row [6] MCU rows [7 + 2c] h factor of component c
//   [8 + 2c] v factor of component c (c < 4) [15] colour space (kGray,
//   kYCbCr, kRGB, kCMYK, kYCCK).
// Coefficients of component c: (mcu_rows * v_c, mcus_per_row * h_c, 64)
// int16 in natural (row-major) order within each block, components one
// after another in one buffer. Quant tables: (components, 64) uint16 in
// natural order, each component's table as latched at its first scan
// (zeros for a component no scan reached). extra (kExtraLen int32): [0] 1
// when the decode read past the end of the data, [1] 1 when the frame was
// block-smoothed.
//
// For the serving tick's wire planes (ServerConfig.ingest_plane) two pooled
// entries decode eligible 4:2:0 streams straight into rows of one batch
// buffer: jpeg_wire_coefs_batch (coefficients and quant tables, "coef") and
// jpeg_wire_raw420_batch (the planes after the inverse DCT, "ycbcr420").

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kInfoLen = 24;
constexpr int kMaxComps = 4;
constexpr int kSavedCoefs = 10;                     // jdcoefct.c SAVED_COEFS
constexpr int kExtraLen = 2;
constexpr int64_t kMaxPixels = int64_t(1) << 25;   // 8K UHD fits
constexpr int kMaxDimension = 65500;                // JPEG_MAX_DIMENSION
constexpr int kMaxBlocksInMcu = 10;                 // as libjpeg (D_MAX_BLOCKS_IN_MCU)

enum Status {
  kOk = 0,
  kNotJpeg = -1,
  kTruncated = -2,
  kCorrupt = -3,
  kUnsupported = -4,
  kTooLarge = -5,
  kLossless = -7,   // a lossless (SOF3) frame, which the coefficient entries do not decode
};

enum ColorSpace { kGray = 0, kYCbCr = 1, kRGB = 2, kCMYK = 3, kYCCK = 4 };

// zigzag index -> natural (row-major) index, with libjpeg's 16 extra
// entries of 63 that catch a run past the end of a corrupt block
constexpr uint8_t kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// JPEG Annex K.3 tables, which libjpeg-turbo's sequential decoder installs
// for slots 0 and 1 that no DHT before the first scan defined (jstdhuff.c
// std_huff_tables; Motion-JPEG frames carry none)
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

struct Huff {
  bool defined = false;        // a DHT gave it
  bool valid = false;          // jpeg_make_d_derived_tbl accepts it
  bool dc_ok = false;          // every symbol <= 15 (usable as a DC table)
  bool lossless_ok = false;    // every symbol <= 16 (usable in a lossless scan)
  uint8_t look_len[256];       // 8-bit lookahead: code length, 0 = longer
  uint8_t look_sym[256];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t val[256];
};

// jdhuff.c jpeg_make_d_derived_tbl, with its table checks.
bool build_huff(const uint8_t* counts, const uint8_t* syms, int nsym, Huff* h) {
  uint8_t size[257];
  int32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) size[p++] = static_cast<uint8_t>(l);
  size[p] = 0;
  int32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (int32_t(1) << si)) return false;   // no code may be all ones
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      h->valoffset[l] = p - code_of[p];
      p += counts[l - 1];
      h->maxcode[l] = code_of[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0x7FFFFFFF;
  memset(h->look_len, 0, sizeof(h->look_len));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < counts[l - 1]; ++i, ++p) {
      const int look = code_of[p] << (8 - l);
      for (int c = 0; c < (1 << (8 - l)); ++c) {
        h->look_len[look + c] = static_cast<uint8_t>(l);
        h->look_sym[look + c] = syms[p];
      }
    }
  }
  memset(h->val, 0, sizeof(h->val));
  memcpy(h->val, syms, static_cast<size_t>(nsym));
  h->dc_ok = h->lossless_ok = true;
  for (int i = 0; i < nsym; ++i) {
    h->dc_ok = h->dc_ok && syms[i] <= 15;
    h->lossless_ok = h->lossless_ok && syms[i] <= 16;
  }
  return true;
}

// The stream as libjpeg's memory source supplies it: the data, then fake
// EOI markers (FF D9) for ever. `eof` records that a byte past the data
// was read.
struct Source {
  const uint8_t* d;
  size_t n;
  bool eof = false;
  uint8_t at(size_t i) {
    if (i < n) return d[i];
    eof = true;
    return ((i - n) & 1) ? 0xD9 : 0xFF;
  }
};

// Entropy-coded segment reader (jdhuff.c jpeg_fill_bit_buffer). Stops at a
// marker and from then on supplies zero bits, counting them: consuming one
// of them is libjpeg's "insufficient data".
struct Bits {
  Source* src;
  size_t pos;
  uint64_t buf = 0;
  int nbits = 0;
  int zeros = 0;        // zero bits appended after the data stopped
  bool stopped = false; // at a marker: pos is its first FF
  int64_t* errors = nullptr;   // counts codes libavcodec's mjpeg decoder rejects

  void fill() {
    while (nbits <= 56) {
      if (!stopped) {
        uint8_t c = src->at(pos);
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (src->at(q) == 0xFF) ++q;   // fill bytes
          if (src->at(q) == 0x00) {
            pos = q + 1;                    // stuffed 0xFF
          } else {
            stopped = true;                 // a marker
            continue;
          }
        } else {
          ++pos;
        }
        buf = (buf << 8) | c;
      } else {
        buf <<= 8;
        zeros += 8;
      }
      nbits += 8;
    }
  }
  // true when some of the consumed bits were padding
  bool overrun() const { return nbits < zeros; }
  void reset(size_t at, bool at_marker) {
    pos = at;
    buf = 0;
    nbits = 0;
    zeros = 0;
    stopped = at_marker;
  }
  uint32_t get(int k) {   // k in 1..16
    if (nbits < k) fill();
    nbits -= k;
    return static_cast<uint32_t>((buf >> nbits) & ((uint64_t(1) << k) - 1));
  }
  // jdhuff.c HUFF_DECODE / jpeg_huff_decode: a code not in the table
  // consumes 17 bits and reads as symbol 0, as libjpeg fakes it
  int decode(const Huff& h) {
    if (nbits < 17) fill();
    const int look = static_cast<int>((buf >> (nbits - 8)) & 0xFF);
    if (const int l = h.look_len[look]) {
      nbits -= l;
      return h.look_sym[look];
    }
    int l = 9;
    int32_t code = static_cast<int32_t>((buf >> (nbits - 9)) & 0x1FF);
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = static_cast<int32_t>((buf >> (nbits - l)) & ((1 << l) - 1));
    }
    if (l > 16) {
      nbits -= 17;
      if (errors) ++*errors;
      return 0;
    }
    nbits -= l;
    return h.val[(code + h.valoffset[l]) & 0xFF];
  }
};

// jaricom.c jpeg_aritab (ITU-T T.81 Table D.2): Qe << 16 | Next_Index_MPS
// << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5
// estimate of ITU-T T.851.
constexpr uint32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

constexpr int kArithTables = 16;   // NUM_ARITH_TBLS
constexpr int kDcBins = 64, kAcBins = 256;

// The arithmetic decoder's registers and input (jdarith.c arith_decode and
// get_byte). A marker met in the data, or the fake EOI after its end, is
// not consumed by the scan: from then on the decoder reads zero bytes.
struct Arith {
  Source* src;
  size_t pos;
  bool stopped = false;   // at a marker: marker_at is its last FF
  size_t marker_at = 0;
  int64_t c = 0, a = 0;
  int ct = -16;           // -16: two bytes to read; -1: a bad code stopped the segment

  // where the marker search after this segment starts
  size_t where() const { return stopped ? marker_at : pos; }
  void reset(size_t at, bool at_marker) {
    pos = marker_at = at;
    stopped = at_marker;
    c = a = 0;
    ct = -16;
  }
  int next_byte() {
    if (stopped) return 0;
    int d = src->at(pos++);
    if (d != 0xFF) return d;
    do d = src->at(pos++);
    while (d == 0xFF);
    if (d == 0) return 0xFF;   // a stuffed zero
    stopped = true;
    marker_at = pos - 2;
    return 0;
  }
  // ITU-T T.81 D.2: one binary decision with the statistics bin *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;   // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

inline int extend(uint32_t v, int s) {
  return v < (uint32_t(1) << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                      : static_cast<int>(v);
}

// LEFT_SHIFT(v, al) stored as a JCOEF (16 bits), as libjpeg stores it
inline int16_t shifted(int v, int al) {
  return static_cast<int16_t>(static_cast<uint32_t>(v) << al);
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;            // padded block grid
  int wb = 0, hb = 0;            // blocks that hold image samples
  int16_t* coef = nullptr;
  bool latched = false;
  uint16_t qt[64];               // latched at the component's first scan
  int point_transform = 0;       // lossless: the Al its scan gave
  int coef_bits[64];             // jdphuff.c coef_bits (progressive)
  int prev_bits[64];             // their values before the last scan that set them
};

struct Decoder {
  Source src;
  size_t pos = 0;
  int32_t info[kInfoLen] = {0};
  bool have_sof = false, progressive = false, arith = false, in_headers = true;
  bool multi_scan = false;
  bool accept_lossless = false;   // the lossless entry: SOF3 is decoded, other frames refused
  bool lossless = false;
  int precision = 8;
  uint8_t* lossless_out = nullptr;   // (H, W, C) samples of a lossless decode
  std::vector<int32_t> samples[kMaxComps];   // lossless: each component's sample plane
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[kMaxComps];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  uint8_t dc_L[kArithTables], dc_U[kArithTables], ac_K[kArithTables];   // DAC
  int restart_interval = 0;
  int next_rst = 0;
  int scans = 0;                 // SOS markers read (input_scan_number)
  int last_good_row = 0;         // jdcoefct.c last_good_iMCU_row
  int64_t huff_errors = 0;       // Huffman codes not in their table, runs past a block
  bool overran = false;          // a Huffman scan ran out of data (libjpeg's warning)
  bool decoding = false;         // false: a probe, which stops at the first SOS

  Decoder(const uint8_t* data, size_t len) : src{data, len} {
    memset(dc_L, 0, sizeof(dc_L));   // jdmarker.c get_soi's defaults
    memset(dc_U, 1, sizeof(dc_U));
    memset(ac_K, 5, sizeof(ac_K));
  }

  uint8_t at(size_t i) { return src.at(i); }
  int u16(size_t i) { return (at(i) << 8) | at(i + 1); }

  // jdmarker.c next_marker: skip anything up to FF xx with xx not 00/FF.
  // The fake EOI after the data always ends the search.
  int next_marker() {
    for (;;) {
      while (at(pos) != 0xFF) ++pos;
      while (at(pos) == 0xFF) ++pos;
      const int m = at(pos++);
      if (m != 0) return m;
    }
  }

  // Reads a segment's length; [pos, *end) is then its payload.
  int segment(size_t* end) {
    const int len = u16(pos);
    if (len < 2) return kCorrupt;
    *end = pos + len;
    pos += 2;
    return kOk;
  }

  int read_sof(int marker) {
    size_t end;
    if (have_sof) return kCorrupt;
    if (int s = segment(&end)) return s;
    precision = at(pos);
    const int height = u16(pos + 1), width = u16(pos + 3);
    ncomp = at(pos + 5);
    pos += 6;
    lossless = marker == 0xC3;
    if (lossless != accept_lossless) return lossless ? kLossless : kUnsupported;
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2 && marker != 0xC9 &&
        marker != 0xCA && !lossless)
      return kUnsupported;
    progressive = marker == 0xC2 || marker == 0xCA;
    arith = marker >= 0xC9;
    if (height == 0 || width == 0 || ncomp == 0) return kCorrupt;   // DNL: refused too
    if (end - pos != static_cast<size_t>(3 * ncomp)) return kCorrupt;
    // a lossless frame of 2-8 bits fits 8-bit samples (cv2 refuses 12 and 16)
    if (lossless ? precision < 2 || precision > 8 : precision != 8) return kUnsupported;
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) return kUnsupported;
    if (height > kMaxDimension || width > kMaxDimension) return kCorrupt;
    if (int64_t(height) * width > kMaxPixels) return kTooLarge;
    hmax = vmax = 1;
    const int bs = lossless ? 1 : 8;   // samples per block side (jdinput.c: 1 in lossless mode)
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      k.id = at(pos);
      k.h = at(pos + 1) >> 4;
      k.v = at(pos + 1) & 15;
      k.tq = at(pos + 2);
      pos += 3;
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) return kCorrupt;
      if (k.tq > 3) return kCorrupt;
      for (int o = 0; o < c; ++o)
        if (comp[o].id == k.id) return kCorrupt;
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = k.prev_bits[i] = -1;
    }
    // jdsample.c: only whole upsampling ratios ("Fractional sampling")
    for (int c = 0; c < ncomp; ++c)
      if (hmax % comp[c].h || vmax % comp[c].v) return kUnsupported;
    mcux = (width + bs * hmax - 1) / (bs * hmax);
    mcuy = (height + bs * vmax - 1) / (bs * vmax);
    info[0] = height;
    info[1] = width;
    info[2] = ncomp;
    info[3] = hmax;
    info[4] = vmax;
    info[5] = mcux;
    info[6] = mcuy;
    info[16] = precision;
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      info[7 + 2 * c] = k.h;
      info[8 + 2 * c] = k.v;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.wb = static_cast<int>((int64_t(width) * k.h + bs * hmax - 1) / (bs * hmax));
      k.hb = static_cast<int>((int64_t(height) * k.v + bs * vmax - 1) / (bs * vmax));
    }
    have_sof = true;
    pos = end;
    return kOk;
  }

  int read_dqt() {
    size_t end;
    if (int s = segment(&end)) return s;
    while (pos < end) {
      const int pq = at(pos) >> 4, tq = at(pos) & 15;
      ++pos;
      if (pq > 1 || tq > 3) return kCorrupt;
      const size_t need = pq ? 128 : 64;
      if (end - pos < need) return kCorrupt;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16(pos + 2 * k) : at(pos + k));
      qt_defined[tq] = true;
      pos += need;
    }
    return kOk;
  }

  int read_dht() {
    size_t end;
    if (int s = segment(&end)) return s;
    while (pos < end) {
      if (end - pos < 17) return kCorrupt;
      const int tc = at(pos) >> 4, th = at(pos) & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      uint8_t counts[16], syms[256];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = at(pos + 1 + i);
      pos += 17;
      if (total > 256 || end - pos < static_cast<size_t>(total)) return kCorrupt;
      for (int i = 0; i < total; ++i) syms[i] = at(pos + i);
      Huff* h = tc ? &ac[th] : &dc[th];
      h->defined = true;
      h->valid = build_huff(counts, syms, total, h);   // checked when a scan uses it
      pos += total;
    }
    return kOk;
  }

  // jdmarker.c get_dac: the conditioning of arithmetic tables Tb (Tc 0: DC
  // L and U, Tc 1: AC K)
  int read_dac() {
    size_t end;
    if (int s = segment(&end)) return s;
    for (; end - pos >= 2; pos += 2) {
      const int index = at(pos), val = at(pos + 1);
      if (index >= 2 * kArithTables) return kCorrupt;
      if (index >= kArithTables) {
        ac_K[index - kArithTables] = static_cast<uint8_t>(val);
      } else {
        dc_L[index] = static_cast<uint8_t>(val & 15);
        dc_U[index] = static_cast<uint8_t>(val >> 4);
        if (dc_L[index] > dc_U[index]) return kCorrupt;
      }
    }
    return pos == end ? kOk : kCorrupt;
  }

  int read_dri() {
    size_t end;
    if (int s = segment(&end)) return s;
    if (end - pos != 2) return kCorrupt;
    restart_interval = u16(pos);
    pos = end;
    return kOk;
  }

  int read_app(int marker) {
    size_t end;
    if (int s = segment(&end)) return s;
    const size_t len = end - pos;
    uint8_t b[14];
    for (size_t i = 0; i < std::min<size_t>(len, 14); ++i) b[i] = at(pos + i);
    if (marker == 0xE0 && len >= 14 && memcmp(b, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && memcmp(b, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = b[11];
    }
    pos = end;
    return kOk;
  }

  // jdapimin.c default_decompress_parms: the colour space of the data.
  int color_space() const {
    if (ncomp == 1) return kGray;
    if (ncomp == 3) {
      if (saw_jfif) return kYCbCr;
      if (saw_adobe) return adobe_transform == 0 ? kRGB : kYCbCr;
      if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return kRGB;
      return lossless ? kRGB : kYCbCr;   // libjpeg-turbo 3 takes a lossless frame as RGB
    }
    if (saw_adobe) return adobe_transform == 0 ? kCMYK : kYCCK;
    return kCMYK;
  }

  // jdcoefct.c smoothing_ok: libjpeg block-smooths a progressive frame
  // whose first AC coefficients are not all exact, when every component
  // has its quant table and some DC bits.
  bool needs_smoothing() const {
    if (!progressive) return false;
    static constexpr int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp; ++c) {
      const Comp& k = comp[c];
      if (!k.latched) return false;
      for (int q : kQ)
        if (k.qt[q] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < kSavedCoefs; ++i) useful = useful || k.coef_bits[i] != 0;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1.5) on the
  // coefficients, in place: each component block that keeps zeros among its
  // first AC coefficients gets them estimated from the DC values of its
  // 5x5 neighbourhood (and, while no AC bits are known, its DC too), rows
  // past the last complete one reading the coefficient bits of the scan
  // before. Only the blocks that hold image samples change.
  void smooth() {
    static constexpr int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      std::vector<int> dc(size_t(k.bh) * k.bw);   // the DC values before smoothing
      for (size_t i = 0; i < dc.size(); ++i) dc[i] = k.coef[i * 64];
      int cur[kSavedCoefs], prev[kSavedCoefs];
      for (int i = 0; i < kSavedCoefs; ++i) {
        cur[i] = k.coef_bits[i];
        prev[i] = scans > 1 ? k.prev_bits[i] : -1;
      }
      int64_t q[10];
      for (int i = 0; i < 10; ++i) q[i] = k.qt[kPos[i]];
      for (int r = 0; r < mcuy; ++r) {
        int block_rows = k.v;
        if (r == mcuy - 1) {
          block_rows = k.hb % k.v;
          if (block_rows == 0) block_rows = k.v;
        }
        const int* bits = r > last_good_row ? prev : cur;
        bool change_dc = true;
        for (int i = 1; i < kSavedCoefs; ++i) change_dc = change_dc && bits[i] == -1;
        const int last = mcuy - 1;
        for (int br = 0; br < block_rows; ++br) {
          // the neighbour rows as libjpeg picks them: within this iMCU row,
          // or whole iMCU rows away
          const int row = r * k.v + br;
          const int prow = br > 0 || r > 0 ? row - 1 : row;
          const int pprow = br > 1 || r > 1 ? row - 2 : prow;
          const int nrow = br < block_rows - 1 || r < last ? row + 1 : row;
          const int nnrow = br < block_rows - 2 || r + 1 < last ? row + 2 : nrow;
          const int rows5[5] = {pprow, prow, row, nrow, nnrow};
          auto dcat = [&](int rr, int col) { return dc[size_t(rr) * k.bw + col]; };
          int D[5][5];   // D[row][col]: DC01..DC25 as D[(n - 1) / 5][(n - 1) % 5]
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 5; ++j) D[i][j] = dcat(rows5[i], 0);
          const int last_col = k.wb - 1;
          for (int bx = 0; bx < k.wb; ++bx) {
            if (bx == 0 && bx < last_col)
              for (int i = 0; i < 5; ++i) D[i][3] = dcat(rows5[i], bx + 1);
            if (bx + 1 < last_col)
              for (int i = 0; i < 5; ++i) D[i][4] = dcat(rows5[i], bx + 2);
            int16_t* w = k.coef + (int64_t(row) * k.bw + bx) * 64;
            smooth_block(w, D, bits, change_dc, q);
            for (int i = 0; i < 5; ++i)
              for (int j = 0; j < 4; ++j) D[i][j] = D[i][j + 1];
          }
        }
      }
    }
  }

  static void smooth_block(int16_t* w, const int (*D)[5], const int* bits, bool change_dc,
                           const int64_t* q) {
#define DCV(n) int64_t(D[((n) - 1) / 5][((n) - 1) % 5])
    auto estimate = [&](int bit_index, int pos, int64_t qk, int64_t num) {
      const int al = bits[bit_index];
      if (al == 0 || w[pos] != 0) return;
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      w[pos] = static_cast<int16_t>(pred);
    };
    const int64_t q00 = q[0];
    estimate(1, 1, q[1], q00 * (change_dc ?
        (-DCV(1) - DCV(2) + DCV(4) + DCV(5) - 3 * DCV(6) + 13 * DCV(7) - 13 * DCV(9) +
         3 * DCV(10) - 3 * DCV(11) + 38 * DCV(12) - 38 * DCV(14) + 3 * DCV(15) -
         3 * DCV(16) + 13 * DCV(17) - 13 * DCV(19) + 3 * DCV(20) - DCV(21) - DCV(22) +
         DCV(24) + DCV(25)) :
        (-7 * DCV(11) + 50 * DCV(12) - 50 * DCV(14) + 7 * DCV(15))));
    estimate(2, 8, q[2], q00 * (change_dc ?
        (-DCV(1) - 3 * DCV(2) - 3 * DCV(3) - 3 * DCV(4) - DCV(5) - DCV(6) + 13 * DCV(7) +
         38 * DCV(8) + 13 * DCV(9) - DCV(10) + DCV(16) - 13 * DCV(17) - 38 * DCV(18) -
         13 * DCV(19) + DCV(20) + DCV(21) + 3 * DCV(22) + 3 * DCV(23) + 3 * DCV(24) +
         DCV(25)) :
        (-7 * DCV(3) + 50 * DCV(8) - 50 * DCV(18) + 7 * DCV(23))));
    estimate(3, 16, q[3], q00 * (change_dc ?
        (DCV(3) + 2 * DCV(7) + 7 * DCV(8) + 2 * DCV(9) - 5 * DCV(12) - 14 * DCV(13) -
         5 * DCV(14) + 2 * DCV(17) + 7 * DCV(18) + 2 * DCV(19) + DCV(23)) :
        (-DCV(3) + 13 * DCV(8) - 24 * DCV(13) + 13 * DCV(18) - DCV(23))));
    estimate(4, 9, q[4], q00 * (change_dc ?
        (-DCV(1) + DCV(5) + 9 * DCV(7) - 9 * DCV(9) - 9 * DCV(17) + 9 * DCV(19) + DCV(21) -
         DCV(25)) :
        (DCV(10) + DCV(16) - 10 * DCV(17) + 10 * DCV(19) - DCV(2) - DCV(20) + DCV(22) -
         DCV(24) + DCV(4) - DCV(6) + 10 * DCV(7) - 10 * DCV(9))));
    estimate(5, 2, q[5], q00 * (change_dc ?
        (2 * DCV(7) - 5 * DCV(8) + 2 * DCV(9) + DCV(11) + 7 * DCV(12) - 14 * DCV(13) +
         7 * DCV(14) + DCV(15) + 2 * DCV(17) - 5 * DCV(18) + 2 * DCV(19)) :
        (-DCV(11) + 13 * DCV(12) - 24 * DCV(13) + 13 * DCV(14) - DCV(15))));
    if (change_dc) {
      estimate(6, 3, q[6], q00 * (DCV(7) - DCV(9) + 2 * DCV(12) - 2 * DCV(14) + DCV(17) -
                                  DCV(19)));
      estimate(7, 10, q[7], q00 * (DCV(7) - 3 * DCV(8) + DCV(9) - DCV(17) + 3 * DCV(18) -
                                   DCV(19)));
      estimate(8, 17, q[8], q00 * (DCV(7) - DCV(9) - 3 * DCV(12) + 3 * DCV(14) + DCV(17) -
                                   DCV(19)));
      estimate(9, 24, q[9], q00 * (DCV(7) + 2 * DCV(8) + DCV(9) - DCV(17) - 2 * DCV(18) -
                                   DCV(19)));
      const int64_t num = q00 *
          (-2 * DCV(1) - 6 * DCV(2) - 8 * DCV(3) - 6 * DCV(4) - 2 * DCV(5) - 6 * DCV(6) +
           6 * DCV(7) + 42 * DCV(8) + 6 * DCV(9) - 6 * DCV(10) - 8 * DCV(11) + 42 * DCV(12) +
           152 * DCV(13) + 42 * DCV(14) - 8 * DCV(15) - 6 * DCV(16) + 6 * DCV(17) +
           42 * DCV(18) + 6 * DCV(19) - 6 * DCV(20) - 2 * DCV(21) - 6 * DCV(22) -
           8 * DCV(23) - 6 * DCV(24) - 2 * DCV(25));
      const int pred = num >= 0 ? static_cast<int>(((q00 << 7) + num) / (q00 << 8))
                                : -static_cast<int>(((q00 << 7) - num) / (q00 << 8));
      w[0] = static_cast<int16_t>(pred);
    }
#undef DCV
  }

  // jdmarker.c read_restart_marker with jpeg_resync_to_restart, at a
  // restart boundary, the marker search starting at `at`. Sets *resume to
  // where the next segment starts; true when the marker found there was
  // left unread (the segment then reads as empty).
  bool read_restart(size_t at, size_t* resume) {
    pos = at;
    int m = next_marker();   // the marker the reader stopped at, or the next
    bool unread = true;
    if (m == 0xD0 + next_rst) {
      unread = false;
    } else {
      for (;;) {
        int action;
        if (m < 0xC0) {
          action = 2;
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;
        } else if (m == 0xD0 + ((next_rst + 1) & 7) || m == 0xD0 + ((next_rst + 2) & 7)) {
          action = 3;
        } else if (m == 0xD0 + ((next_rst - 1) & 7) || m == 0xD0 + ((next_rst - 2) & 7)) {
          action = 2;
        } else {
          action = 1;
        }
        if (action == 1) {
          unread = false;
          break;
        }
        if (action == 3) break;
        m = next_marker();
      }
    }
    next_rst = (next_rst + 1) & 7;
    *resume = unread ? pos - 2 : pos;
    return unread;
  }

  // A Huffman scan's restart; `insufficient` is the entropy decoder's flag.
  void restart(Bits* br, bool* insufficient) {
    size_t at;
    const bool unread = read_restart(br->pos, &at);
    br->reset(at, unread);
    if (!unread) *insufficient = false;
  }

  // One sequential block (jdhuff.c decode_mcu): only nonzero AC
  // coefficients are written.
  void decode_block(Bits* br, const Huff& dct, const Huff& act, int* last_dc, int16_t* blk) {
    int s = br->decode(dct);
    int diff = 0;
    if (s) diff = extend(br->get(s), s);
    *last_dc = static_cast<int>(static_cast<uint32_t>(*last_dc) + static_cast<uint32_t>(diff));
    blk[0] = static_cast<int16_t>(*last_dc);   // JCOEF is 16 bits, as in libjpeg
    for (int k = 1; k < 64; ++k) {
      const int rs = br->decode(act);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63 && br->errors) ++*br->errors;   // a run past the block
        blk[kNatural[k]] = static_cast<int16_t>(extend(br->get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  enum ScanKind { kSeq, kDcFirst, kDcRefine, kAcFirst, kAcRefine };

  // One arithmetic-coded scan (jdarith.c): its statistics areas and DC
  // predictions start at zero and restart with each restart interval.
  int decode_arith_scan(Comp* const* sc, int ns, const int* td, const int* ta, ScanKind kind,
                        int ss, int se, int al) {
    uint8_t dc_stats[kArithTables][kDcBins], ac_stats[kArithTables][kAcBins];
    uint8_t fixed_bin = 113;
    int last_dc[kMaxComps] = {0, 0, 0, 0}, dc_ctx[kMaxComps] = {0, 0, 0, 0};
    const bool uses_dc = kind == kSeq || kind == kDcFirst;
    const bool uses_ac = kind == kSeq || kind == kAcFirst || kind == kAcRefine;
    Arith ar{&src, pos};
    auto start = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (uses_dc) {
          memset(dc_stats[td[i]], 0, kDcBins);
          last_dc[i] = dc_ctx[i] = 0;
        }
        if (uses_ac) memset(ac_stats[ta[i]], 0, kAcBins);
      }
    };
    start();
    const int p1 = 1 << al, m1 = -(1 << al);

    // Figures F.19-F.24: a DC difference of the scan's component i
    auto dc_diff = [&](int i, int* diff) {
      uint8_t* stats = dc_stats[td[i]];
      uint8_t* st = stats + dc_ctx[i];
      if (ar.decode(st) == 0) {
        dc_ctx[i] = 0;
        *diff = 0;
        return true;
      }
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = stats + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;   // JWRN_ARITH_BAD_CODE
          ++st;
        }
      }
      const int t = td[i];
      if (m < ((1 << dc_L[t]) >> 1))
        dc_ctx[i] = 0;
      else if (m > ((1 << dc_U[t]) >> 1))
        dc_ctx[i] = 12 + sign * 4;
      else
        dc_ctx[i] = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      *diff = sign ? -v : v;
      return true;
    };
    // Figure F.20: the AC coefficients k0..k1 of a block, first pass,
    // scaled by 2^shift
    auto ac_first = [&](int i, int16_t* blk, int k0, int k1, int shift) {
      uint8_t* stats = ac_stats[ta[i]];
      const int kk = ac_K[ta[i]];
      for (int k = k0; k <= k1; ++k) {
        uint8_t* st = stats + 3 * (k - 1);
        if (ar.decode(st)) break;   // EOB
        while (ar.decode(st + 1) == 0) {
          st += 3;
          if (++k > k1) return false;   // spectral overflow
        }
        const int sign = ar.decode(&fixed_bin);
        st += 2;
        int m = ar.decode(st);
        if (m && ar.decode(st)) {
          m <<= 1;
          st = stats + (k <= kk ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) return false;   // magnitude overflow
            ++st;
          }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
          if (ar.decode(st)) v |= m;
        v += 1;
        if (sign) v = -v;
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << shift);
      }
      return true;
    };
    // one block of component i; false when a bad code stops the segment
    auto decode_one = [&](int i, int16_t* blk) {
      switch (kind) {
        case kSeq:
        case kDcFirst: {
          int diff;
          if (!dc_diff(i, &diff)) return false;
          last_dc[i] = static_cast<int>(static_cast<uint32_t>(last_dc[i] + diff) & 0xFFFF);
          if (kind == kDcFirst) {
            blk[0] = shifted(last_dc[i], al);
            return true;
          }
          blk[0] = static_cast<int16_t>(last_dc[i]);
          return ac_first(i, blk, 1, 63, 0);
        }
        case kDcRefine:
          if (ar.decode(&fixed_bin)) blk[0] = static_cast<int16_t>(blk[0] | p1);
          return true;
        case kAcFirst:
          return ac_first(i, blk, ss, se, al);
        case kAcRefine: {
          uint8_t* stats = ac_stats[ta[i]];
          int kex = se;   // the previous stage's end of block
          while (kex > 0 && !blk[kNatural[kex]]) --kex;
          for (int k = ss; k <= se; ++k) {
            uint8_t* st = stats + 3 * (k - 1);
            if (k > kex && ar.decode(st)) break;   // EOB
            for (;;) {
              int16_t* c = blk + kNatural[k];
              if (*c) {
                if (ar.decode(st + 2)) *c = static_cast<int16_t>(*c < 0 ? *c + m1 : *c + p1);
                break;
              }
              if (ar.decode(st + 1)) {
                *c = static_cast<int16_t>(ar.decode(&fixed_bin) ? m1 : p1);
                break;
              }
              st += 3;
              if (++k > se) return false;   // spectral overflow
            }
          }
          return true;
        }
      }
      return true;
    };
    int64_t todo = restart_interval;
    // jdarith.c process_restart, then whether the MCU is decoded
    auto mcu_start = [&]() {
      if (restart_interval) {
        if (todo == 0) {
          size_t at;
          const bool unread = read_restart(ar.where(), &at);
          ar.reset(at, unread);
          start();
          todo = restart_interval;
        }
        --todo;
      }
      return ar.ct != -1;
    };
    if (ns == 1) {   // non-interleaved: one block per MCU, image blocks only
      Comp& k = *sc[0];
      for (int by = 0; by < k.hb; ++by) {
        for (int bx = 0; bx < k.wb; ++bx) {
          last_good_row = by / k.v;
          if (mcu_start() && !decode_one(0, k.coef + (int64_t(by) * k.bw + bx) * 64))
            ar.ct = -1;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          last_good_row = my;
          if (!mcu_start()) continue;
          for (int i = 0; i < ns && ar.ct != -1; ++i) {
            Comp& k = *sc[i];
            for (int v = 0; v < k.v && ar.ct != -1; ++v)
              for (int h = 0; h < k.h; ++h) {
                int16_t* blk = k.coef + ((int64_t(my) * k.v + v) * k.bw + int64_t(mx) * k.h + h) * 64;
                if (!decode_one(i, blk)) {
                  ar.ct = -1;
                  break;
                }
              }
          }
        }
      }
    }
    pos = ar.where();   // the marker that ended the scan, or data before it
    return kOk;
  }

  // One lossless scan (libjpeg-turbo 3: jdlhuff.c, jddiffct.c, jdlossls.c):
  // Huffman-coded differences, an MCU row at a time, each component's rows
  // undifferenced with predictor Ss; the first row of the scan, of each
  // restart interval and of each MCU row met after the data ran out
  // predicts from the left only, from 2^(P - Pt - 1) at its first sample.
  int decode_lossless_scan(Comp* const* sc, int ns, const int* td, int ss, int se, int ah,
                           int al) {
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= precision) return kCorrupt;
    for (int i = 0; i < ns; ++i)
      if (td[i] > 3 || !dc[td[i]].defined || !dc[td[i]].valid || !dc[td[i]].lossless_ok)
        return kCorrupt;
    const bool interleaved = ns > 1;
    const int mcus_per_row = interleaved ? mcux : sc[0]->wb;
    const int mcu_rows = interleaved ? mcuy : sc[0]->hb;
    if (restart_interval % mcus_per_row) return kCorrupt;   // JERR_BAD_RESTART
    const int restart_rows = restart_interval / mcus_per_row;
    std::vector<int32_t> diffs[kMaxComps];
    bool first[kMaxComps];
    int rh[kMaxComps], rw[kMaxComps];   // an MCU row's rows and samples a row, per component
    for (int i = 0; i < ns; ++i) {
      rh[i] = interleaved ? sc[i]->v : 1;
      rw[i] = interleaved ? mcux * sc[i]->h : sc[i]->wb;
      diffs[i].assign(size_t(rh[i]) * rw[i], 0);
      first[i] = true;
      sc[i]->point_transform = al;
    }
    const int init = 1 << (precision - al - 1);
    Bits br{&src, pos};
    bool insufficient = false;
    int rows_to_go = restart_rows;
    for (int my = 0; my < mcu_rows; ++my) {
      if (restart_interval) {
        if (rows_to_go == 0) {
          restart(&br, &insufficient);
          for (int i = 0; i < ns; ++i) first[i] = true;
          rows_to_go = restart_rows;
        }
        --rows_to_go;
      }
      if (insufficient) {   // zero differences from a reset predictor
        for (int i = 0; i < ns; ++i) {
          std::fill(diffs[i].begin(), diffs[i].end(), 0);
          first[i] = true;
        }
      } else {
        for (int mx = 0; mx < mcus_per_row; ++mx) {
          for (int i = 0; i < ns; ++i) {
            const int h = interleaved ? sc[i]->h : 1;
            for (int yy = 0; yy < rh[i]; ++yy) {
              for (int xx = 0; xx < h; ++xx) {
                const int t = br.decode(dc[td[i]]);
                int d = 0;
                if (t == 16) {
                  d = 32768;
                } else if (t) {
                  d = extend(br.get(t), t);
                }
                diffs[i][size_t(yy) * rw[i] + mx * h + xx] = d;
              }
            }
          }
        }
        if (br.overrun()) insufficient = true;
      }
      for (int i = 0; i < ns; ++i) {
        Comp& k = *sc[i];
        const int c = static_cast<int>(&k - comp);
        for (int yy = 0; yy < rh[i]; ++yy) {
          const int y = my * rh[i] + yy;
          undifference(&samples[c][size_t(y) * k.wb], first[i] ? nullptr
                       : &samples[c][size_t(y - 1) * k.wb], &diffs[i][size_t(yy) * rw[i]],
                       k.wb, ss, init);
          first[i] = false;
        }
      }
    }
    pos = br.pos;
    return kOk;
  }

  // jdlossls.c: one row of samples from its differences, predicted from
  // `prev` (the row above) with predictor `ps`, or from the left only
  // (from `init` at the first sample) when prev is null; modulo 2^16.
  static void undifference(int32_t* row, const int32_t* prev, const int32_t* diff, int w,
                           int ps, int init) {
    if (!prev) {
      int32_t ra = (diff[0] + init) & 0xFFFF;
      row[0] = ra;
      for (int x = 1; x < w; ++x) row[x] = ra = (diff[x] + ra) & 0xFFFF;
      return;
    }
    int32_t rb = prev[0];
    int32_t ra = (diff[0] + rb) & 0xFFFF;
    row[0] = ra;
    for (int x = 1; x < w; ++x) {
      const int32_t rc = rb;
      rb = prev[x];
      int32_t p;
      switch (ps) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      row[x] = ra = (diff[x] + p) & 0xFFFF;
    }
  }

  int read_sos() {
    size_t end;
    if (!have_sof) return kCorrupt;
    if (int s = segment(&end)) return s;
    const int ns = at(pos++);
    if (end - pos != static_cast<size_t>(2 * ns + 3) || ns < 1 || ns > kMaxComps)
      return kCorrupt;
    Comp* sc[kMaxComps];
    int td[kMaxComps], ta[kMaxComps];
    for (int i = 0; i < ns; ++i) {
      const int id = at(pos), t = at(pos + 1);
      pos += 2;
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i]) return kCorrupt;
      for (int o = 0; o < i; ++o)
        if (sc[o] == sc[i]) return kCorrupt;
      td[i] = t >> 4;
      ta[i] = t & 15;
    }
    const int ss = at(pos), se = at(pos + 1), ah = at(pos + 2) >> 4, al = at(pos + 2) & 15;
    pos = end;
    next_rst = 0;
    ++scans;
    if (in_headers) {   // jpeg_read_header ends here
      in_headers = false;
      info[15] = color_space();
      multi_scan = ns < ncomp || progressive;
      if (!decoding) return kOk;
      const uint8_t* std_tables[4][2] = {{kDcLumBits, kDcVals}, {kDcChromBits, kDcVals},
                                         {kAcLumBits, kAcLumVals}, {kAcChromBits, kAcChromVals}};
      for (int t = 0; t < 4 && !progressive && !arith; ++t) {   // jdhuff.c only
        Huff* h = t < 2 ? &dc[t] : &ac[t - 2];
        if (h->defined) continue;
        int nsym = 0;
        for (int l = 0; l < 16; ++l) nsym += std_tables[t][0][l];
        h->defined = true;
        h->valid = build_huff(std_tables[t][0], std_tables[t][1], nsym, h);
      }
    } else if (!multi_scan) {
      return kCorrupt;   // a second scan of a single-scan frame
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > kMaxBlocksInMcu) return kCorrupt;
    }
    if (lossless) return decode_lossless_scan(sc, ns, td, ss, se, ah, al);
    for (int i = 0; i < ns; ++i) {   // latch the quant tables (jdinput.c)
      Comp& k = *sc[i];
      if (k.latched) continue;
      if (!qt_defined[k.tq]) return kCorrupt;
      memcpy(k.qt, qt[k.tq], sizeof(k.qt));
      k.latched = true;
    }
    // the scan's kind and its tables (jdhuff.c / jdphuff.c / jdarith.c start_pass)
    ScanKind kind = kSeq;
    if (progressive) {
      const bool dc_band = ss == 0;
      bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) return kCorrupt;
      kind = dc_band ? (ah ? kDcRefine : kDcFirst) : (ah ? kAcRefine : kAcFirst);
      for (int i = 0; i < ns; ++i) {
        Comp& k = *sc[i];
        for (int c = std::min(ss, 1); c <= std::max(se, 9); ++c)
          k.prev_bits[c] = scans > 1 ? k.coef_bits[c] : 0;
        for (int c = ss; c <= se; ++c) k.coef_bits[c] = al;
      }
    }
    if (arith) return decode_arith_scan(sc, ns, td, ta, kind, ss, se, al);
    for (int i = 0; i < ns; ++i) {
      if (kind == kSeq || kind == kDcFirst) {
        if (td[i] > 3 || !dc[td[i]].defined || !dc[td[i]].valid || !dc[td[i]].dc_ok)
          return kCorrupt;
      }
      if (kind != kDcFirst && kind != kDcRefine) {
        if (ta[i] > 3 || !ac[ta[i]].defined || !ac[ta[i]].valid) return kCorrupt;
      }
    }

    Bits br{&src, pos};
    br.errors = &huff_errors;
    int last_dc[kMaxComps] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    bool insufficient = false, overflow = false;
    int64_t todo = restart_interval;
    const int p1 = 1 << al, m1 = -(1 << al);

    auto block_of = [](Comp& k, int64_t by, int64_t bx) {
      return k.coef + (by * k.bw + bx) * 64;
    };
    // one block of this scan into `blk` (component index i of the scan)
    auto decode_one = [&](int i, int16_t* blk) {
      switch (kind) {
        case kSeq:
          decode_block(&br, dc[td[i]], ac[ta[i]], &last_dc[i], blk);
          break;
        case kDcFirst: {
          const int s = br.decode(dc[td[i]]);
          int diff = 0;
          if (s) diff = extend(br.get(s), s);
          const int64_t v = int64_t(last_dc[i]) + diff;
          if (v > INT32_MAX || v < INT32_MIN) overflow = true;   // JERR_BAD_DCT_COEF
          last_dc[i] = static_cast<int>(v);
          blk[0] = shifted(last_dc[i], al);
          break;
        }
        case kDcRefine:
          if (br.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
          break;
        case kAcFirst: {
          if (eobrun > 0) {
            --eobrun;
            break;
          }
          const Huff& t = ac[ta[i]];
          for (int k = ss; k <= se; ++k) {
            const int rs = br.decode(t);
            int r = rs >> 4;
            const int s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = shifted(extend(br.get(s), s), al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1u << r;
              if (r) eobrun += br.get(r);
              --eobrun;
              break;
            }
          }
          break;
        }
        case kAcRefine: {
          const Huff& t = ac[ta[i]];
          int k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              const int rs = br.decode(t);
              int r = rs >> 4;
              int s = rs & 15;
              if (s) {
                s = br.get(1) ? p1 : m1;   // a size other than 1 is corrupt; libjpeg goes on
              } else if (r != 15) {
                eobrun = 1u << r;
                if (r) eobrun += br.get(r);
                break;
              }
              do {
                int16_t* c = blk + kNatural[k];
                if (*c != 0) {
                  if (br.get(1) && (*c & p1) == 0)
                    *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int16_t* c = blk + kNatural[k];
              if (*c != 0 && br.get(1) && (*c & p1) == 0)
                *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
            }
            --eobrun;
          }
          break;
        }
      }
    };
    auto mcu_start = [&]() {
      if (restart_interval) {
        if (todo == 0) {
          restart(&br, &insufficient);
          for (int& v : last_dc) v = 0;
          eobrun = 0;
          todo = restart_interval;
        }
        --todo;
      }
    };
    if (ns == 1) {   // non-interleaved: one block per MCU, image blocks only
      Comp& k = *sc[0];
      for (int by = 0; by < k.hb; ++by) {
        for (int bx = 0; bx < k.wb; ++bx) {
          if (!insufficient) last_good_row = by / k.v;
          mcu_start();
          if (insufficient) continue;
          decode_one(0, block_of(k, by, bx));
          if (br.overrun()) insufficient = overran = true;
        }
      }
    } else {
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (!insufficient) last_good_row = my;
          mcu_start();
          if (insufficient) continue;
          for (int i = 0; i < ns; ++i) {
            Comp& k = *sc[i];
            for (int v = 0; v < k.v; ++v)
              for (int h = 0; h < k.h; ++h)
                decode_one(i, block_of(k, int64_t(my) * k.v + v, int64_t(mx) * k.h + h));
          }
          if (br.overrun()) insufficient = overran = true;
        }
      }
    }
    pos = br.pos;   // the marker that ended the scan, or data before it
    return overflow ? kCorrupt : kOk;
  }

  // The lossless samples into lossless_out, (H, W, C) u8, each component
  // replicated to the frame's size (libjpeg-turbo 3 does not filter in
  // lossless mode), shifted left by its point transform.
  void write_lossless() {
    const int height = info[0], width = info[1];
    for (int c = 0; c < ncomp; ++c) {
      const Comp& k = comp[c];
      const int rx = hmax / k.h, ry = vmax / k.v;
      for (int y = 0; y < height; ++y) {
        const int32_t* row = &samples[c][size_t(y / ry) * k.wb];
        uint8_t* o = lossless_out + size_t(y) * width * ncomp + c;
        for (int x = 0; x < width; ++x)
          o[size_t(x) * ncomp] = static_cast<uint8_t>(row[x / rx] << k.point_transform);
      }
    }
  }

  // The marker loop (jdmarker.c read_markers). A probe (`decoding` false)
  // stops at the first SOS, as jpeg_read_header does; a decode lays the
  // coefficient buffers out from `want` (the probe's info) and ends at EOI.
  int run(const int32_t* want, int16_t* coefs, uint16_t* qtabs) {
    if (src.n < 2 || src.d[0] != 0xFF || src.d[1] != 0xD8) return kNotJpeg;
    decoding = coefs != nullptr || lossless_out != nullptr;
    pos = 2;
    for (;;) {
      const int m = next_marker();
      int s = kOk;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        s = read_sof(m);
        if (!s && decoding) {
          if (memcmp(info, want, 15 * sizeof(int32_t)) != 0) return kCorrupt;
          if (lossless) {
            for (int c = 0; c < ncomp; ++c)
              samples[c].assign(size_t(mcuy) * comp[c].v * comp[c].wb, 0);
            continue;
          }
          int16_t* at_c = coefs;
          for (int c = 0; c < ncomp; ++c) {
            comp[c].coef = at_c;
            at_c += int64_t(comp[c].bh) * comp[c].bw * 64;
          }
        }
      } else if (m == 0xDA) {
        s = read_sos();
        if (!s && !decoding) return kOk;
      } else if (m == 0xD9) {
        if (in_headers) return src.eof ? kTruncated : kCorrupt;   // no image
        if (!decoding) return kOk;
        if (lossless) {
          write_lossless();
          return kOk;
        }
        for (int c = 0; c < ncomp; ++c) {
          if (comp[c].latched) {
            memcpy(qtabs + 64 * c, comp[c].qt, sizeof(comp[c].qt));
          } else {
            memset(qtabs + 64 * c, 0, sizeof(comp[c].qt));
          }
        }
        return kOk;
      } else if (m == 0xDB) {
        s = read_dqt();
      } else if (m == 0xC4) {
        s = read_dht();
      } else if (m == 0xDD) {
        s = read_dri();
      } else if (m >= 0xE0 && m <= 0xEF) {
        s = read_app(m);
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        continue;   // parameterless markers
      } else if (m == 0xCC) {
        s = read_dac();
      } else if (m == 0xFE || m == 0xDC) {
        size_t end;   // COM, DNL
        s = segment(&end);
        if (!s) pos = end;
      } else if (m == 0xD8) {
        s = kCorrupt;   // a second SOI
      } else {
        s = kCorrupt;   // JPGn, DHP, EXP, reserved
      }
      if (s) return s == kCorrupt && src.eof ? kTruncated : s;
    }
  }
};

// ------------------------------------------------------ 4:2:0 wire planes
//
// The serving tick's wire planes split the decode between host and device.
// A stream is eligible when it has three YCbCr components sampled 2x2, 1x1,
// 1x1, is exactly (eh, ew) with both multiples of 16, and its Cb and Cr use
// one quant table; every other stream gets ok = 0 (the caller decodes it in
// full), as the JAX package's native/ingest.cpp check_420_header. That
// takes progressive and truncated streams too. At these sizes the padded
// block grid is the image: Y holds (eh/8)(ew/8) blocks, Cb and Cr a
// quarter of that each.

// One stream's coefficients, quant tables and extra (kExtraLen) fields.
int jpeg_decode_coefs_impl(const uint8_t* data, size_t len, const int32_t* info,
                           int16_t* coefs, uint16_t* qtabs, int32_t* extra, bool smooth) {
  Decoder dec(data, len);
  const int s = dec.run(info, coefs, qtabs);
  if (s == kOk) {
    extra[0] = dec.src.eof;
    extra[1] = dec.needs_smoothing();
    if (extra[1] && smooth) dec.smooth();
  }
  return s;
}

// Probes `data` and decodes its coefficients into `coefs` (zeroed here; Y,
// Cb, Cr blocks one after another) when the stream is eligible; qt gets the
// luma and the chroma table. `smooth`: block-smooth them where libjpeg's
// sample output would (not libjpeg's coefficient output). 0 when eligible
// and decoded.
int wire_decode_coefs(const uint8_t* data, size_t len, int eh, int ew, int16_t* coefs,
                      uint16_t* qt, bool smooth) {
  Decoder probe(data, len);
  if (probe.run(nullptr, nullptr, nullptr) != kOk) return 1;
  const int32_t* info = probe.info;
  if (eh % 16 || ew % 16 || info[0] != eh || info[1] != ew || info[2] != 3) return 1;
  if (info[15] != kYCbCr) return 1;
  if (info[7] != 2 || info[8] != 2 || info[9] != 1 || info[10] != 1 || info[11] != 1 ||
      info[12] != 1 || probe.comp[1].tq != probe.comp[2].tq)
    return 1;
  memset(coefs, 0, size_t(eh / 8) * (ew / 8) * 3 / 2 * 64 * sizeof(int16_t));
  uint16_t latched[3 * 64];
  int32_t extra[kExtraLen];
  if (jpeg_decode_coefs_impl(data, len, info, coefs, latched, extra, smooth) != kOk) return 1;
  // a DQT between the Cb and Cr scans could latch two tables on one slot
  if (memcmp(latched + 64, latched + 128, 64 * sizeof(uint16_t)) != 0) return 1;
  memcpy(qt, latched, 2 * 64 * sizeof(uint16_t));
  return 0;
}

// jpeg_idct_islow as libjpeg-turbo's x86 SIMD routines compute it
// (jidctint-avx2.asm / -sse2.asm), the C twin of
// ops/jpeg_decode.samples_islow_simd: the dequantisation and the sums
// in0 +- in4, in7 + in3, in5 + in1 wrap to 16 bits, the rotations are
// exact in 32 bits (pmaddwd), each pass's outputs saturate to 16 bits, a
// block whose coefficient rows 1-7 are zero takes the column pass's DC
// shortcut, and the samples saturate to [0, 255].
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
                  F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
                  F_1_501321110 = 12299, F_1_847759065 = 15137, F_1_961570560 = 16069,
                  F_2_053119869 = 16819, F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int32_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
// int32 arithmetic that wraps, as the vector registers' does
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
inline int32_t descale_sat16(int32_t x, int n) {
  const int32_t v = add32(x, int32_t(1) << (n - 1)) >> n;
  return v < -32768 ? -32768 : (v > 32767 ? 32767 : v);
}

void idct_1d(const int32_t* in, int stride, int32_t* out, int shift) {
  const int32_t d0 = in[0], d1 = in[stride], d2 = in[2 * stride], d3 = in[3 * stride],
                d4 = in[4 * stride], d5 = in[5 * stride], d6 = in[6 * stride],
                d7 = in[7 * stride];
  const int32_t tmp0 = static_cast<int32_t>(static_cast<uint32_t>(wrap16(d0 + d4)) << kConstBits);
  const int32_t tmp1 = static_cast<int32_t>(static_cast<uint32_t>(wrap16(d0 - d4)) << kConstBits);
  const int32_t tmp2 = d2 * F_0_541196100 + d6 * (F_0_541196100 - F_1_847759065);
  const int32_t tmp3 = d2 * (F_0_541196100 + F_0_765366865) + d6 * F_0_541196100;
  const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3);
  const int32_t tmp11 = add32(tmp1, tmp2), tmp12 = sub32(tmp1, tmp2);
  const int32_t z3 = wrap16(d7 + d3), z4 = wrap16(d5 + d1);
  const int32_t r3 = z3 * (F_1_175875602 - F_1_961570560) + z4 * F_1_175875602;
  const int32_t r4 = z3 * F_1_175875602 + z4 * (F_1_175875602 - F_0_390180644);
  const int32_t t0 = add32(d7 * (F_0_298631336 - F_0_899976223) + d1 * -F_0_899976223, r3);
  const int32_t t1 = add32(d5 * (F_2_053119869 - F_2_562915447) + d3 * -F_2_562915447, r4);
  const int32_t t2 = add32(d5 * -F_2_562915447 + d3 * (F_3_072711026 - F_2_562915447), r3);
  const int32_t t3 = add32(d7 * -F_0_899976223 + d1 * (F_1_501321110 - F_0_899976223), r4);
  out[0] = descale_sat16(add32(tmp10, t3), shift);
  out[stride] = descale_sat16(add32(tmp11, t2), shift);
  out[2 * stride] = descale_sat16(add32(tmp12, t1), shift);
  out[3 * stride] = descale_sat16(add32(tmp13, t0), shift);
  out[4 * stride] = descale_sat16(sub32(tmp13, t0), shift);
  out[5 * stride] = descale_sat16(sub32(tmp12, t1), shift);
  out[6 * stride] = descale_sat16(sub32(tmp11, t2), shift);
  out[7 * stride] = descale_sat16(sub32(tmp10, t3), shift);
}

// One block's samples into an 8x8 window of a plane with row pitch `pitch`.
void idct_block(const int16_t* coef, const uint16_t* qt, uint8_t* dst, int pitch) {
  int32_t deq[64], ws[64], sp[64];
  bool dc_only = true;
  for (int i = 0; i < 64; ++i) {
    deq[i] = wrap16(int32_t(coef[i]) * int32_t(qt[i]));
    if (i >= 8 && coef[i]) dc_only = false;
  }
  if (dc_only) {
    for (int c = 0; c < 8; ++c)
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = wrap16(deq[c] * 4);
  } else {
    for (int c = 0; c < 8; ++c) idct_1d(deq + c, 8, ws + c, kConstBits - kPass1Bits);
  }
  for (int r = 0; r < 8; ++r) idct_1d(ws + 8 * r, 1, sp + 8 * r, kConstBits + kPass1Bits + 3);
  for (int r = 0; r < 8; ++r) {
    for (int c = 0; c < 8; ++c) {
      const int32_t v = sp[8 * r + c];
      dst[r * pitch + c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// A component's (hb, wb) blocks into its (8 hb, 8 wb) plane.
void idct_plane(const int16_t* coefs, const uint16_t* qt, int hb, int wb, uint8_t* plane) {
  for (int by = 0; by < hb; ++by)
    for (int bx = 0; bx < wb; ++bx)
      idct_block(coefs + (int64_t(by) * wb + bx) * 64, qt,
                 plane + int64_t(by) * 8 * wb * 8 + bx * 8, wb * 8);
}

// Runs work(i, t) for i in [0, n) on up to n_threads threads (0: one per
// core); t is the worker's index.
template <typename Work>
void pooled(int n, int n_threads, Work work) {
  if (n <= 0) return;
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n));
  auto run = [&](int t) {
    for (int i = t; i < n; i += n_threads) work(i, t);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(run, t);
  run(0);
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

int jpeg_info_len(void) { return kInfoLen; }

// Frame header of one stream into info; 0 or a negative status.
int jpeg_probe(const uint8_t* data, size_t len, int32_t* info) {
  Decoder dec(data, len);
  const int s = dec.run(nullptr, nullptr, nullptr);
  memcpy(info, dec.info, sizeof(dec.info));
  return s;
}

int jpeg_extra_len(void) { return kExtraLen; }

// A lossless (SOF3) stream of 2- to 8-bit samples. With out null, its frame
// header into info (info[16] the precision); else its (H, W, C) u8 samples
// into out, for the info its probe gave. Any other frame returns
// kUnsupported; a stream that ends early kTruncated (cv2 refuses it). 0 or
// a negative status.
int jpeg_decode_lossless(const uint8_t* data, size_t len, int32_t* info, uint8_t* out) {
  Decoder dec(data, len);
  dec.accept_lossless = true;
  dec.lossless_out = out;
  int s = dec.run(info, nullptr, nullptr);
  if (!out) memcpy(info, dec.info, sizeof(dec.info));
  if (s == kOk && dec.src.eof) s = kTruncated;
  return s;
}

// Coefficients, quant tables and extra fields of one stream whose probe
// gave `info`. The coefficient buffer must be zeroed; 0 or a negative
// status.
int jpeg_decode_coefs(const uint8_t* data, size_t len, const int32_t* info,
                      int16_t* coefs, uint16_t* qtabs, int32_t* extra) {
  return jpeg_decode_coefs_impl(data, len, info, coefs, qtabs, extra, true);
}

// Samples of n streams' blocks as libjpeg-turbo's SIMD islow computes them
// (the C twin of ops/jpeg_decode.samples_islow_simd, which takes it for CPU
// tensors): coefs (n, nb, 64) int16 natural order, qtabs (n, 64) uint16,
// out (n, nb, 64) u8.
void jpeg_idct_islow_blocks(const int16_t* coefs, const uint16_t* qtabs, int n, int64_t nb,
                            uint8_t* out) {
  for (int i = 0; i < n; ++i)
    for (int64_t b = 0; b < nb; ++b) {
      const int64_t at = (int64_t(i) * nb + b) * 64;
      idct_block(coefs + at, qtabs + int64_t(i) * 64, out + at, 8);
    }
}

// jpeg_decode_coefs over n streams on up to n_threads threads (0: one per
// core); statuses into rcs, extra fields into extras (n, kExtraLen).
void jpeg_decode_coefs_batch(const uint8_t* const* datas, const size_t* lens,
                             const int32_t* infos, int16_t* const* coefs,
                             uint16_t* const* qtabs, int n, int n_threads,
                             int32_t* rcs, int32_t* extras) {
  pooled(n, n_threads, [&](int i, int) {
    rcs[i] = jpeg_decode_coefs_impl(datas[i], lens[i], infos + int64_t(i) * kInfoLen,
                                    coefs[i], qtabs[i], extras + int64_t(i) * kExtraLen, true);
  });
}

// The "coef" wire plane of n streams: row i of `out` (int16, (eh/8)(ew/8)
// * 3/2 + 2 blocks of 64) gets stream i's Y, Cb and Cr coefficient blocks,
// then its luma and chroma quant tables as uint16 bits (zeroed when the
// stream is not eligible; its coefficients are then left as they were).
// ok[i] = 1 when stream i is eligible and decoded.
void jpeg_wire_coefs_batch(const uint8_t* const* datas, const size_t* lens, int n, int eh,
                           int ew, int16_t* out, int n_threads, int32_t* ok) {
  const int64_t blocks = int64_t(eh / 8) * (ew / 8) * 3 / 2;
  pooled(n, n_threads, [&](int i, int) {
    int16_t* row = out + int64_t(i) * (blocks + 2) * 64;
    uint16_t* qt = reinterpret_cast<uint16_t*>(row + blocks * 64);
    // JAX's coef plane takes libjpeg's coefficients, which are not smoothed
    ok[i] = wire_decode_coefs(datas[i], lens[i], eh, ew, row, qt, false) == 0;
    if (!ok[i]) memset(qt, 0, 2 * 64 * sizeof(uint16_t));
  });
}

// The "ycbcr420" wire plane of n streams: row i of `out` (eh * ew * 3/2
// bytes) gets stream i's Y plane (eh, ew), then Cb and Cr (eh/2, ew/2),
// the samples of the inverse DCT without upsampling, as libjpeg's
// raw_data_out gives them (block-smoothed where it smooths). ok[i] as
// jpeg_wire_coefs_batch; a row of a stream that is not eligible is left as
// it was.
void jpeg_wire_raw420_batch(const uint8_t* const* datas, const size_t* lens, int n, int eh,
                            int ew, uint8_t* out, int n_threads, int32_t* ok) {
  const int hb = eh / 8, wb = ew / 8;
  const int64_t yb = int64_t(hb) * wb;
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  std::vector<std::vector<int16_t>> scratch(std::max(1, std::min(n_threads, n)));
  pooled(n, n_threads, [&](int i, int t) {
    std::vector<int16_t>& coefs = scratch[t];
    coefs.resize(yb * 3 / 2 * 64);
    uint16_t qt[2 * 64];
    ok[i] = wire_decode_coefs(datas[i], lens[i], eh, ew, coefs.data(), qt, true) == 0;
    if (!ok[i]) return;
    uint8_t* y = out + int64_t(i) * eh * ew * 3 / 2;
    idct_plane(coefs.data(), qt, hb, wb, y);
    for (int c = 0; c < 2; ++c)
      idct_plane(coefs.data() + (yb + c * yb / 4) * 64, qt + 64, hb / 2, wb / 2,
                 y + int64_t(eh) * ew + int64_t(c) * (eh / 2) * (ew / 2));
  });
}

}  // extern "C"
