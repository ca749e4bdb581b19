// MPEG-4 Part 2 (ISO/IEC 14496-2) video decoder on the host: the frames
// cv2.VideoCapture's FFmpeg backend decodes from an mp4's mp4v track whose
// stream FFmpeg's own mpeg4 encoder wrote (cv2.VideoWriter's 'mp4v',
// `ffmpeg -c:v mpeg4`), picture for picture, as libavcodec's mpeg4 decoder
// computes them.
//
// Input: the esds DecoderSpecificInfo (Visual Object Sequence, Visual
// Object, VOL and user data headers), then one mp4 sample (a VOP, with a
// GOV header in front of an I-VOP) at a time. Covered: rectangular,
// progressive 8-bit VOLs of the Simple and Advanced Simple profiles; I, P
// and B-VOPs; H.263 and MPEG quantisation (default and loaded matrices,
// the inter mismatch control); intra DC VLCs and intra_dc_vlc_thr; the
// TCOEF VLCs with the three escape modes; AC/DC prediction with the
// direction from the DC gradients and the rescaling across a quantiser
// change; dquant and dbquant; 1MV and 4MV with the median prediction and
// its video-packet edges; f_code / b_code and the vector wrap; half-pel
// motion compensation with vop_rounding_type; quarter-pel (FFmpeg's
// mirrored 8-tap filters and its chroma rule for a stream not written by
// Xvid or DivX); unrestricted vectors past the coded picture's edge; the
// 4MV chroma vector with the H.263 rounding table; not-coded macroblocks;
// forward, backward, interpolated and direct B macroblocks (1MV and 4MV
// co-located, an intra one reading as zero vectors, TRB / TRD from the VOP
// times), a B macroblock over a skipped co-located one copied forward;
// video packets (resync markers, macroblock_number, quant_scale, HEC) and
// data partitioning; not-coded VOPs (no picture out); FFmpeg's output
// order (one picture of delay when low_delay is 0, flushed at the end)
// and its drop of B-VOPs without a forward reference after a seek.
//
// Arithmetic follows libavcodec on x86-64: the IDCT is its SIMD
// simple_idct8 (rows then columns, W4 = 16383, 16-bit saturation between
// the passes, the DC-only row shortcut wrapping in 16 bits); the intra
// and MPEG inverse quantisers are its 16-bit routines; half-pel
// interpolation is as cv2's bundled FFmpeg 8 computes it: put_no_rnd x2
// and y2 of 8-pixel rows round up where a sample is 0 (the mmxext
// routines), of 16-pixel rows exactly (the system's FFmpeg 5.1
// approximates those too: `approx16`, for holding the decoder to it).
//
// Refused, with a reason naming the feature: streams written by Xvid or
// DivX (FFmpeg switches its IDCT and bug workarounds for those) or by an
// Lavc old enough for a workaround, sprites (GMC and static), interlaced
// coding, the short video header, shapes other than rectangular,
// not_8_bit, scalability, reversible VLCs, newpred, reduced-resolution
// VOPs, complexity estimation, the studio profiles and chroma other than
// 4:2:0. A damaged VOP (a bad code, a read past its end, a resync marker
// out of place, a P-VOP without a reference) stops the decoder with a
// reason that says where; FFmpeg conceals such damage, this decoder does
// not.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "simple_idct.cpp"
#include "yuv2bgr.cpp"

namespace mpeg4 {

struct Error {
  std::string what;
};

[[noreturn]] static void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// ------------------------------------------------------------- tables
// libavcodec's (h263data.c, mpeg4video.c, mpegvideodata.c, mathtables.c)

static const uint16_t kIntraVlc[103][2] = {
  {2,2},{6,3},{15,4},{13,5},{12,5},{21,6},{19,6},{18,6},
  {23,7},{31,8},{30,8},{29,8},{37,9},{36,9},{35,9},{33,9},
  {33,10},{32,10},{15,10},{14,10},{7,11},{6,11},{32,11},{33,11},
  {80,12},{81,12},{82,12},{14,4},{20,6},{22,7},{28,8},{32,9},
  {31,9},{13,10},{34,11},{83,12},{85,12},{11,5},{21,7},{30,9},
  {12,10},{86,12},{17,6},{27,8},{29,9},{11,10},{16,6},{34,9},
  {10,10},{13,6},{28,9},{8,10},{18,7},{27,9},{84,12},{20,7},
  {26,9},{87,12},{25,8},{9,10},{24,8},{35,11},{23,8},{25,9},
  {24,9},{7,10},{88,12},{7,4},{12,6},{22,8},{23,9},{6,10},
  {5,11},{4,11},{89,12},{15,6},{22,9},{5,10},{14,6},{4,10},
  {17,7},{36,11},{16,7},{37,11},{19,7},{90,12},{21,8},{91,12},
  {20,8},{19,8},{26,8},{21,9},{20,9},{19,9},{18,9},{17,9},
  {38,11},{39,11},{92,12},{93,12},{94,12},{95,12},{3,7},
};
static const int8_t kIntraRun[102] = {
  0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
  0,0,0,0,0,0,0,0,0,0,0,1,1,1,1,1,
  1,1,1,1,1,2,2,2,2,2,3,3,3,3,4,4,
  4,5,5,5,6,6,6,7,7,7,8,8,9,9,10,11,
  12,13,14,0,0,0,0,0,0,0,0,1,1,1,2,2,
  3,3,4,4,5,5,6,6,7,8,9,10,11,12,13,14,
  15,16,17,18,19,20,
};
static const int8_t kIntraLevel[102] = {
  1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,
  17,18,19,20,21,22,23,24,25,26,27,1,2,3,4,5,
  6,7,8,9,10,1,2,3,4,5,1,2,3,4,1,2,
  3,1,2,3,1,2,3,1,2,3,1,2,1,2,1,1,
  1,1,1,1,2,3,4,5,6,7,8,1,2,3,1,2,
  1,2,1,2,1,2,1,2,1,1,1,1,1,1,1,1,
  1,1,1,1,1,1,
};
static const uint16_t kInterVlc[103][2] = {
  {2,2},{15,4},{21,6},{23,7},{31,8},{37,9},{36,9},{33,10},
  {32,10},{7,11},{6,11},{32,11},{6,3},{20,6},{30,8},{15,10},
  {33,11},{80,12},{14,4},{29,8},{14,10},{81,12},{13,5},{35,9},
  {13,10},{12,5},{34,9},{82,12},{11,5},{12,10},{83,12},{19,6},
  {11,10},{84,12},{18,6},{10,10},{17,6},{9,10},{16,6},{8,10},
  {22,7},{85,12},{21,7},{20,7},{28,8},{27,8},{33,9},{32,9},
  {31,9},{30,9},{29,9},{28,9},{27,9},{26,9},{34,11},{35,11},
  {86,12},{87,12},{7,4},{25,9},{5,11},{15,6},{4,11},{14,6},
  {13,6},{12,6},{19,7},{18,7},{17,7},{16,7},{26,8},{25,8},
  {24,8},{23,8},{22,8},{21,8},{20,8},{19,8},{24,9},{23,9},
  {22,9},{21,9},{20,9},{19,9},{18,9},{17,9},{7,10},{6,10},
  {5,10},{4,10},{36,11},{37,11},{38,11},{39,11},{88,12},{89,12},
  {90,12},{91,12},{92,12},{93,12},{94,12},{95,12},{3,7},
};
static const int8_t kInterRun[102] = {
  0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1,
  1,1,2,2,2,2,3,3,3,4,4,4,5,5,5,6,
  6,6,7,7,8,8,9,9,10,10,11,12,13,14,15,16,
  17,18,19,20,21,22,23,24,25,26,0,0,0,1,1,2,
  3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,
  19,20,21,22,23,24,25,26,27,28,29,30,31,32,33,34,
  35,36,37,38,39,40,
};
static const int8_t kInterLevel[102] = {
  1,2,3,4,5,6,7,8,9,10,11,12,1,2,3,4,
  5,6,1,2,3,4,1,2,3,1,2,3,1,2,3,1,
  2,3,1,2,1,2,1,2,1,2,1,1,1,1,1,1,
  1,1,1,1,1,1,1,1,1,1,1,2,3,1,2,1,
  1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
  1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
  1,1,1,1,1,1,
};
static const uint16_t kMvTab[33][2] = {
  {1,1},{1,2},{1,3},{1,4},{3,6},{5,7},{4,7},{3,7},
  {11,9},{10,9},{9,9},{17,10},{16,10},{15,10},{14,10},{13,10},
  {12,10},{11,10},{10,10},{9,10},{8,10},{7,10},{6,10},{5,10},
  {4,10},{7,11},{6,11},{5,11},{4,11},{3,11},{2,11},{3,12},
  {2,12},
};
// symbol = cbpc | 4 intra | 8 dquant (intra: 0-7, 8 stuffing);
// inter: | 16 4MV, 20 stuffing
static const uint8_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
static const uint8_t kIntraMcbpcBits[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
static const uint8_t kInterMcbpcCode[28] = {
  1,3,2,5,3,4,3,3,3,7,6,5,4,4,3,2,
  2,5,4,5,1,0,0,0,2,12,14,15,
};
static const uint8_t kInterMcbpcBits[28] = {
  1,4,4,6,5,8,8,7,3,7,7,9,6,9,9,9,
  3,7,7,8,9,0,0,0,11,13,13,13,
};
static const uint16_t kCbpyTab[16][2] = {
  {3,4},{5,5},{4,5},{9,4},{3,5},{7,4},{2,6},{11,4},
  {2,5},{3,6},{5,4},{10,4},{4,4},{8,4},{6,4},{3,2},
};
static const uint16_t kDcLum[13][2] = {
  {3,3},{3,2},{2,2},{2,3},{1,3},{1,4},{1,5},{1,6},
  {1,7},{1,8},{1,9},{1,10},{1,11},
};
static const uint16_t kDcChrom[13][2] = {
  {3,2},{2,2},{1,2},{1,3},{1,4},{1,5},{1,6},{1,7},
  {1,8},{1,9},{1,10},{1,11},{1,12},
};
static const uint8_t kDefaultIntraMatrix[64] = {
  8,17,18,19,21,23,25,27,17,18,19,21,23,25,27,28,
  20,21,22,23,24,26,28,30,21,22,23,24,26,28,30,32,
  22,23,24,26,28,30,32,35,23,24,26,28,30,32,35,38,
  25,26,28,30,32,35,38,41,27,28,30,32,35,38,41,45,
};
static const uint8_t kDefaultInterMatrix[64] = {
  16,17,18,19,20,21,22,23,17,18,19,20,21,22,23,24,
  18,19,20,21,22,23,24,25,19,20,21,22,23,24,26,27,
  20,21,22,23,25,26,27,28,21,22,23,24,26,27,28,30,
  22,23,24,26,27,28,30,31,23,24,25,27,28,30,31,33,
};
static const uint8_t kYDcScale[32] = {
  0,8,8,8,8,10,12,14,16,17,18,19,20,21,22,23,
  24,25,26,27,28,29,30,31,32,34,36,38,40,42,44,46,
};
static const uint8_t kCDcScale[32] = {
  0,8,8,8,8,9,9,10,10,11,11,12,12,13,13,14,
  14,15,15,16,16,17,17,18,18,19,20,21,22,23,24,25,
};
static const uint8_t kZigzag[64] = {
  0,1,8,16,9,2,3,10,17,24,32,25,18,11,4,5,
  12,19,26,33,40,48,41,34,27,20,13,6,7,14,21,28,
  35,42,49,56,57,50,43,36,29,22,15,23,30,37,44,51,
  58,59,52,45,38,31,39,46,53,60,61,54,47,55,62,63,
};
static const uint8_t kAltHorizontal[64] = {
  0,1,2,3,8,9,16,17,10,11,4,5,6,7,15,14,
  13,12,19,18,24,25,32,33,26,27,20,21,22,23,28,29,
  30,31,34,35,40,41,48,49,42,43,36,37,38,39,44,45,
  46,47,50,51,56,57,58,59,52,53,54,55,60,61,62,63,
};
static const uint8_t kAltVertical[64] = {
  0,8,16,24,1,9,2,10,17,25,32,40,48,56,57,49,
  41,33,26,18,3,11,4,12,19,27,34,42,50,58,35,43,
  51,59,20,28,5,13,6,14,21,29,36,44,52,60,37,45,
  53,61,22,30,7,15,23,31,38,46,54,62,39,47,55,63,
};
static const uint8_t kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
// ff_h263_chroma_roundtab: the 4MV chroma vector's sixteenths to half-pels
static const uint8_t kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};

enum { kDcMarker = 0x6B001, kMotionMarker = 0x1F001 };

// What the decoder met, counted since it was made (mpeg4_stats)
enum Stat {
  kStIntraMb, kStInter1Mv, kStInter4Mv, kStSkipMb, kStDirect, kStDirectSkip, kStForward,
  kStBackward, kStInterpolated, kStColocatedSkip, kStDquant, kStDbquant, kStEscape1, kStEscape2,
  kStEscape3, kStAcPred, kStVideoPackets, kStNotCoded, kStBVop, kStPVop, kStIVop, kStBDropped,
  kStPartitioned, kStNoRounding, kStDirect8x8, kStQpelMb, kStIntraInP, kStAcRescaled,
  kStEdgeClip, kStCount
};
enum PicType { kI = 1, kP = 2, kB = 3, kS = 4 };
enum MbFlag { kIntra = 1, kSkip = 2, k8x8 = 4, kAcPred = 8 };

// -------------------------------------------------------------- bits

// Bits past the end of a sample read as zeros (libavcodec's zeroed input
// padding); `left()` goes negative there. The data must be followed by
// kPad zero bytes.
enum { kPad = 16 };

struct Bits {
  const uint8_t* p = nullptr;
  int64_t size = 0;  // in bits
  int64_t pos = 0;

  void init(const uint8_t* data, size_t bytes) {
    p = data;
    size = (int64_t)bytes * 8;
    pos = 0;
  }
  uint32_t show(int n) const {  // n <= 32
    if (n == 0) return 0;
    int64_t byte = pos >> 3;
    uint64_t v = 0;
    if (byte >= 0 && byte + 8 <= size / 8 + kPad) {
      for (int i = 0; i < 8; ++i) v = (v << 8) | p[byte + i];
    } else {
      for (int i = 0; i < 8; ++i) {
        int64_t b = byte + i;
        v = (v << 8) | (b >= 0 && b < size / 8 ? p[b] : 0);
      }
    }
    v <<= (pos & 7);
    return (uint32_t)(v >> (64 - n));
  }
  uint32_t get(int n) {
    uint32_t v = show(n);
    pos += n;
    return v;
  }
  int get1() { return (int)get(1); }
  void skip(int64_t n) { pos += n; }
  int64_t left() const { return size - pos; }
  void align() { pos = (pos + 7) & ~(int64_t)7; }
  int xbits(int n) {  // get_xbits: a leading 0 means negative
    uint32_t v = get(n);
    if (v >> (n - 1)) return (int)v;
    return (int)v - (int)((1u << n) - 1);
  }
  int sbits(int n) {
    int32_t v = (int32_t)(get(n) << (32 - n));
    return v >> (32 - n);
  }
};

struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;

  void build(int n, const uint16_t* code, const uint16_t* length, int stride) {
    bits = 0;
    for (int i = 0; i < n; ++i) bits = std::max(bits, (int)length[i * stride]);
    sym.assign((size_t)1 << bits, -1);
    len.assign((size_t)1 << bits, 0);
    for (int i = 0; i < n; ++i) {
      int l = length[i * stride];
      if (!l) continue;
      uint32_t c = code[i * stride];
      uint32_t lo = c << (bits - l), hi = (c + 1) << (bits - l);
      for (uint32_t k = lo; k < hi; ++k) {
        sym[k] = (int16_t)i;
        len[k] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b) const {
    uint32_t v = b.show(bits);
    int s = sym[v];
    if (s >= 0) b.skip(len[v]);
    return s;
  }
};

struct Rl {
  Vlc vlc;
  int n = 102, last = 0;
  const int8_t* run = nullptr;
  const int8_t* level = nullptr;
  int max_level[2][65] = {};
  int max_run[2][65] = {};

  void init(const uint16_t (*table)[2], const int8_t* r, const int8_t* l, int last_start) {
    uint16_t code[103], length[103];
    for (int i = 0; i < 103; ++i) {
      code[i] = table[i][0];
      length[i] = table[i][1];
    }
    vlc.build(103, code, length, 1);
    run = r;
    level = l;
    last = last_start;
    for (int i = 0; i < n; ++i) {
      int lst = i >= last;
      max_level[lst][run[i]] = std::max(max_level[lst][run[i]], (int)level[i]);
      max_run[lst][level[i]] = std::max(max_run[lst][level[i]], (int)run[i]);
    }
  }
};

struct Tables {
  Vlc dc_lum, dc_chrom, intra_mcbpc, inter_mcbpc, cbpy, mv, mb_type_b;
  Rl intra, inter;
  Tables() {
    auto pairs = [](Vlc& v, const uint16_t (*t)[2], int n) {
      std::vector<uint16_t> c(n), l(n);
      for (int i = 0; i < n; ++i) {
        c[i] = t[i][0];
        l[i] = t[i][1];
      }
      v.build(n, c.data(), l.data(), 1);
    };
    pairs(dc_lum, kDcLum, 13);
    pairs(dc_chrom, kDcChrom, 13);
    pairs(cbpy, kCbpyTab, 16);
    pairs(mv, kMvTab, 33);
    uint16_t c[28], l[28];
    for (int i = 0; i < 9; ++i) {
      c[i] = kIntraMcbpcCode[i];
      l[i] = kIntraMcbpcBits[i];
    }
    intra_mcbpc.build(9, c, l, 1);
    for (int i = 0; i < 28; ++i) {
      c[i] = kInterMcbpcCode[i];
      l[i] = kInterMcbpcBits[i];
    }
    inter_mcbpc.build(28, c, l, 1);
    // mb_type: 1 direct, 01 interpolated, 001 backward, 0001 forward
    uint16_t bc[4] = {1, 1, 1, 1}, bl[4] = {1, 2, 3, 4};
    mb_type_b.build(4, bc, bl, 1);
    intra.init(kIntraVlc, kIntraRun, kIntraLevel, 67);
    inter.init(kInterVlc, kInterRun, kInterLevel, 58);
  }
};

static const Tables& tables() {
  static const Tables t;
  return t;
}

static inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

static inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------- IDCT

using simple_idct::idct;
using simple_idct::idct_add;
using simple_idct::idct_put;
using simple_idct::sat16;

// ------------------------------------------------------ interpolation

enum Op { kPut, kPutNoRnd, kAvg };

// A block read from a plane with its coordinates clamped to the plane
// (libavcodec's emulated_edge_mc; a read inside the plane is a plain read).
struct Patch {
  uint8_t px[18 * 18];
  int stride = 18;
  void fetch(const uint8_t* plane, int pstride, int pw, int ph, int x, int y, int bw, int bh) {
    if (x >= 0 && y >= 0 && x + bw <= pw && y + bh <= ph) {
      for (int r = 0; r < bh; ++r)
        memcpy(px + r * stride, plane + (int64_t)(y + r) * pstride + x, bw);
      return;
    }
    for (int r = 0; r < bh; ++r) {
      int yy = std::min(std::max(y + r, 0), ph - 1);
      const uint8_t* row = plane + (int64_t)yy * pstride;
      for (int c = 0; c < bw; ++c) px[r * stride + c] = row[std::min(std::max(x + c, 0), pw - 1)];
    }
  }
};

struct Interp {
  // libavcodec's x86 put_no_rnd x2 / y2 of 8-pixel rows (mmxext, used
  // unless AV_CODEC_FLAG_BITEXACT): pavgb after a saturating decrement of
  // one operand (the left sample; for y2 the odd row), which rounds up where
  // that sample is 0. cv2's FFmpeg 8 rounds 16-pixel rows exactly; the
  // system's FFmpeg 5.1 approximates those too (approx16).
  bool approx16 = false;

  // hpeldsp put / put_no_rnd / avg of an n x h block at half-pel dxy
  void hpel(uint8_t* dst, int ds, const uint8_t* s, int ss, int n, int h, int dxy, Op op) const {
    const bool approx_no_rnd = n == 8 || approx16;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < n; ++x) {
        const uint8_t* p = s + y * ss + x;
        int v;
        switch (dxy) {
          case 0:
            v = p[0];
            break;
          case 1:
            if (op == kPutNoRnd)
              v = approx_no_rnd ? ((p[0] ? p[0] - 1 : 0) + p[1] + 1) >> 1 : (p[0] + p[1]) >> 1;
            else
              v = (p[0] + p[1] + 1) >> 1;
            break;
          case 2:
            if (op == kPutNoRnd) {
              if (!approx_no_rnd)
                v = (p[0] + p[ss]) >> 1;
              else if (y & 1)
                v = ((p[0] ? p[0] - 1 : 0) + p[ss] + 1) >> 1;
              else
                v = (p[0] + (p[ss] ? p[ss] - 1 : 0) + 1) >> 1;
            } else {
              v = (p[0] + p[ss] + 1) >> 1;
            }
            break;
          default:
            v = (p[0] + p[1] + p[ss] + p[ss + 1] + (op == kPutNoRnd ? 1 : 2)) >> 2;
        }
        uint8_t* d = dst + y * ds + x;
        *d = op == kAvg ? (uint8_t)((*d + v + 1) >> 1) : (uint8_t)v;
      }
  }

  // qpeldsp: the MPEG-4 8-tap lowpass, mirrored inside the n + 1 samples
  static inline int tap(const uint8_t* p, int step, int n, int k) {
    auto at = [&](int i) {
      i = i < 0 ? -1 - i : (i > n ? 2 * n + 1 - i : i);
      return (int)p[i * step];
    };
    return (at(k) + at(k + 1)) * 20 - (at(k - 1) + at(k + 2)) * 6 + (at(k - 2) + at(k + 3)) * 3 -
           (at(k - 3) + at(k + 4));
  }
  static inline uint8_t lp_out(int v, bool rnd) { return clip8((v + (rnd ? 16 : 15)) >> 5); }

  // lowpass over rows (h rows of n) or columns (n columns of h = n rows)
  static void h_lowpass(uint8_t* dst, int ds, const uint8_t* s, int ss, int n, int h, Op op) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < n; ++x) {
        uint8_t v = lp_out(tap(s + y * ss, 1, n, x), op != kPutNoRnd);
        uint8_t* d = dst + y * ds + x;
        *d = op == kAvg ? (uint8_t)((*d + v + 1) >> 1) : v;
      }
  }
  static void v_lowpass(uint8_t* dst, int ds, const uint8_t* s, int ss, int n, Op op) {
    for (int x = 0; x < n; ++x)
      for (int y = 0; y < n; ++y) {
        uint8_t v = lp_out(tap(s + x, ss, n, y), op != kPutNoRnd);
        uint8_t* d = dst + y * ds + x;
        *d = op == kAvg ? (uint8_t)((*d + v + 1) >> 1) : v;
      }
  }
  // pixels_l2: the average of two blocks (rounded, or not for put_no_rnd),
  // averaged again with dst for avg
  static void l2(uint8_t* dst, int ds, const uint8_t* a, int as, const uint8_t* b, int bs, int n,
                 int h, Op op) {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < n; ++x) {
        int v = op == kPutNoRnd ? (a[y * as + x] + b[y * bs + x]) >> 1
                                : (a[y * as + x] + b[y * bs + x] + 1) >> 1;
        uint8_t* d = dst + y * ds + x;
        *d = op == kAvg ? (uint8_t)((*d + v + 1) >> 1) : (uint8_t)v;
      }
  }

  // qpel_mc<fx><fy> of an n x n block from s (n + 1 rows and columns)
  static void qpel(uint8_t* dst, int ds, const uint8_t* s, int ss, int n, int dxy, Op op) {
    const Op mid = op == kPutNoRnd ? kPutNoRnd : kPut;  // the put##RND intermediates
    uint8_t half[17 * 17], halfhv[16 * 16];
    const int fx = dxy & 3, fy = dxy >> 2;
    if (dxy == 0) {
      for (int y = 0; y < n; ++y)
        for (int x = 0; x < n; ++x) {
          uint8_t* d = dst + y * ds + x;
          *d = op == kAvg ? (uint8_t)((*d + s[y * ss + x] + 1) >> 1) : s[y * ss + x];
        }
      return;
    }
    if (fy == 0) {  // mc10, mc20, mc30
      if (fx == 2) return h_lowpass(dst, ds, s, ss, n, n, op);
      h_lowpass(half, n, s, ss, n, n, mid);
      return l2(dst, ds, s + (fx == 3), ss, half, n, n, n, op);
    }
    if (fx == 0) {  // mc01, mc02, mc03
      if (fy == 2) return v_lowpass(dst, ds, s, ss, n, op);
      v_lowpass(half, n, s, ss, n, mid);
      return l2(dst, ds, s + (fy == 3) * ss, ss, half, n, n, n, op);
    }
    // halfH: n + 1 rows filtered horizontally, averaged with the full-pel
    // column at fx = 1 / 3
    h_lowpass(half, n, s, ss, n, n + 1, mid);
    if (fx != 2) l2(half, n, half, n, s + (fx == 3), ss, n, n + 1, mid);
    if (fy == 2) return v_lowpass(dst, ds, half, n, n, op);
    v_lowpass(halfhv, n, half, n, n, mid);
    l2(dst, ds, half + (fy == 3) * n, n, halfhv, n, n, n, op);
  }
};

// ------------------------------------------------------------ pictures

struct Picture {
  int mbw = 0, mbh = 0;
  int width = 0, height = 0;      // the VOL's size
  std::vector<uint8_t> plane[3];  // at the macroblock-aligned size
  int64_t pts = 0;
  bool discard = false;
  // the motion field a B-VOP reads from its backward reference
  std::vector<int16_t> mv;        // (b8_stride * mbh * 2 + 2) x 2, offset by one entry
  std::vector<uint8_t> mb_type;   // MbFlag per mb_stride-indexed macroblock
  std::vector<uint8_t> mbskip;
  int stride(int c) const { return c ? mbw * 8 : mbw * 16; }
  int16_t* motion(int index) { return mv.data() + 2 * (index + 1); }
  void alloc(int w, int h) {
    width = w;
    height = h;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    plane[0].assign((size_t)mbw * 16 * mbh * 16, 0);
    plane[1].assign((size_t)mbw * 8 * mbh * 8, 128);
    plane[2].assign((size_t)mbw * 8 * mbh * 8, 128);
    mv.assign((size_t)((2 * mbw + 1) * mbh * 2 + 2) * 2, 0);
    mb_type.assign((size_t)(mbw + 1) * mbh, 0);
    mbskip.assign((size_t)(mbw + 1) * mbh, 0);
  }
};

using PicPtr = std::shared_ptr<Picture>;

// ------------------------------------------------------------ decoder

struct Decoder {
  // headers
  bool have_vol = false;
  int vo_type = 0, vol_control = 0, low_delay = 1, shape = 0, width = 0, height = 0;
  int time_res = 0, time_bits = 0, progressive = 1, sprite = 0, not_8_bit = 0, quant_precision = 5;
  int mpeg_quant = 0, quarter_sample = 0, cplx = 0, data_partitioning = 0;
  int rvlc = 0, newpred = 0, reduced_res = 0, scalability = 0, chroma_format = 1, studio = 0;
  int profile = -1, matrix = 2, full_range = 0;
  int lavc_build = -1, xvid_build = -1, divx_version = -1, divx_build = -1;
  bool short_header = false;
  uint8_t intra_matrix[64], inter_matrix[64];  // natural order
  std::string user_data;

  // VOP state
  int pict_type = kI, no_rounding = 0, f_code = 1, b_code = 1, qscale = 1, intra_dc_threshold = 99;
  int64_t time_base = 0, last_time_base = 0, time = 0, last_non_b_time = 0;
  uint16_t pp_time = 0, pb_time = 0;  // 16 bits, as FFmpeg keeps them
  int picture_number = 0;

  // macroblock state
  int mbw = 0, mbh = 0, mb_num = 0, mb_stride = 0, b8_stride = 0;
  int mb_x = 0, mb_y = 0, resync_mb_x = 0, resync_mb_y = 0, first_slice_line = 1;
  int y_dc_scale = 8, c_dc_scale = 8, ac_pred = 0, mb_intra = 0, mb_skipped = 0;
  int mv_dir = 0, mv_type = 0;  // mv_dir: 1 forward, 2 backward; mv_type 0 16x16, 1 8x8
  int mv[2][4][2] = {};
  int last_mv[2][2] = {};
  int block_last_index[6] = {};
  int partitioned = 0, mb_num_left = 0;
  alignas(16) int16_t block[6][64];
  std::vector<int16_t> dc_base, ac_base;
  int16_t* dc_val[3] = {};
  int16_t* ac_val[3] = {};
  std::vector<int8_t> qscale_table;
  std::vector<uint8_t> cbp_table, pred_dir_table;
  int block_index[6] = {};

  PicPtr cur, last, next;
  std::vector<PicPtr> output;
  std::vector<PicPtr> pool;
  Interp interp;
  Bits gb;
  std::vector<uint8_t> buf;
  int64_t sample = 0;  // samples decoded since the start, for the reasons
  int64_t stats[kStCount] = {};

  Decoder() {
    memcpy(intra_matrix, kDefaultIntraMatrix, 64);
    memcpy(inter_matrix, kDefaultInterMatrix, 64);
  }

  // ----------------------------------------------------------- headers

  void decode_user_data(Bits& b) {
    char s[256];
    int i = 0;
    for (; i < 255 && b.pos < b.size; ++i) {
      if (b.show(23) == 0) break;
      s[i] = (char)b.get(8);
    }
    s[i] = 0;
    user_data = s;
    int ver = 0, build = 0, ver2 = 0, ver3 = 0, e;
    char last_c = 0;
    e = sscanf(s, "DivX%dBuild%d%c", &ver, &build, &last_c);
    if (e < 2) e = sscanf(s, "DivX%db%d%c", &ver, &build, &last_c);
    if (e >= 2) {
      divx_version = ver;
      divx_build = build;
    }
    e = sscanf(s, "FFmpe%*[^b]b%d", &build) + 3;
    if (e != 4)
      e = sscanf(s, "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver, &ver2, &ver3, &build);
    if (e != 4) {
      ver = ver2 = ver3 = 0;
      e = sscanf(s, "Lavc%d.%d.%d", &ver, &ver2, &ver3) + 1;
      if (e > 1) build = ((ver & 0xFF) << 16) + ((ver2 & 0xFF) << 8) + (ver3 & 0xFF);
    }
    if (e != 4 && strcmp(s, "ffmpeg") == 0) lavc_build = 4600;
    if (e == 4) lavc_build = build;
    if (sscanf(s, "XviD%d", &build) == 1) xvid_build = build;
  }

  void decode_vol(Bits& b) {
    b.skip(1);  // random_accessible_vol
    vo_type = (int)b.get(8);
    if (vo_type == 14 || vo_type == 15) studio = 1;  // simple / core studio
    int verid = 1;
    if (b.get1()) {
      verid = (int)b.get(4);
      b.skip(3);
    }
    if (b.get(4) == 15) b.skip(16);  // extended pixel aspect ratio
    vol_control = b.get1();
    if (vol_control) {
      chroma_format = (int)b.get(2);
      low_delay = b.get1();
      if (b.get1()) b.skip(15 + 1 + 15 + 1 + 15 + 1 + 3 + 11 + 1 + 15 + 1);  // vbv parameters
    } else if (picture_number == 0) {
      low_delay = (vo_type == 1 || vo_type == 17) ? 1 : 0;
    }
    shape = (int)b.get(2);
    if (shape == 3 && verid != 1) b.skip(4);
    b.skip(1);
    time_res = (int)b.get(16);
    if (!time_res) fail("a VOL with vop_time_increment_resolution 0");
    time_bits = 1;
    while ((1 << time_bits) < time_res) ++time_bits;  // av_log2(res - 1) + 1
    b.skip(1);
    if (b.get1()) b.skip(time_bits);  // fixed_vop_rate
    if (shape != 2) {
      if (shape == 0) {
        b.skip(1);
        int w = (int)b.get(13);
        b.skip(1);
        int h = (int)b.get(13);
        b.skip(1);
        if (w && h) {
          if (have_vol && (w != width || h != height) && picture_number)
            fail("a new VOL with another picture size (%dx%d after %dx%d)", w, h, width, height);
          width = w;
          height = h;
        }
      }
      progressive = b.get1() ^ 1;
      b.skip(1);  // obmc_disable: FFmpeg decodes as if it were set
      sprite = verid == 1 ? b.get1() : (int)b.get(2);
      if (sprite) {  // refused; the rest of the header is not read
        have_vol = true;
        return;
      }
      not_8_bit = b.get1();
      if (not_8_bit) {
        quant_precision = (int)b.get(4);
        b.skip(4);
        if (quant_precision < 3 || quant_precision > 9) quant_precision = 5;
      } else {
        quant_precision = 5;
      }
      mpeg_quant = b.get1();
      if (mpeg_quant) {
        memcpy(intra_matrix, kDefaultIntraMatrix, 64);
        memcpy(inter_matrix, kDefaultInterMatrix, 64);
        for (int m = 0; m < 2; ++m) {
          uint8_t* mat = m ? inter_matrix : intra_matrix;
          if (!b.get1()) continue;
          int last_v = 0, i = 0;
          for (; i < 64; ++i) {
            if (b.left() < 8) fail("a VOL cut inside its quantiser matrix");
            int v = (int)b.get(8);
            if (v == 0) break;
            last_v = v;
            mat[kZigzag[i]] = (uint8_t)v;
          }
          for (; i < 64; ++i) mat[kZigzag[i]] = (uint8_t)last_v;
        }
      }
      quarter_sample = verid != 1 ? b.get1() : 0;
      if (b.left() < 4) fail("a VOL header cut short");
      cplx = !b.get1();
      if (cplx) {  // refused; the rest of the header is not read
        have_vol = true;
        return;
      }
      b.skip(1);  // resync_marker_disable: FFmpeg looks for markers either way
      data_partitioning = b.get1();
      rvlc = data_partitioning ? b.get1() : 0;
      if (verid != 1) {
        newpred = b.get1();
        if (newpred) b.skip(3);
        reduced_res = b.get1();
      }
      scalability = b.get1();
    }
    have_vol = true;
  }

  void decode_vo(Bits& b) {
    if (b.get1()) b.skip(4 + 3);
    int type = (int)b.get(4);
    if (type == 1 || type == 2) {
      if (b.get1()) {  // video_signal_type
        b.skip(3);
        full_range = b.get1();
        if (b.get1()) {
          b.skip(16);  // colour_primaries, transfer_characteristics
          matrix = (int)b.get(8);
        }
      }
    }
  }

  // Headers up to a VOP start code: true when one was found (the reader
  // then stands at the VOP header), false at the end of the data.
  bool headers(Bits& b) {
    b.align();
    uint32_t code = 0xff;
    int vols = 0;
    for (;;) {
      if (b.pos >= b.size) return false;
      code = (code << 8) | b.get(8);
      if ((code & 0xFFFFFF00) != 0x100) continue;
      uint32_t sc = code & 0xFF;
      if (sc >= 0x20 && sc <= 0x2F) {
        if (vols++) continue;  // FFmpeg reads the first VOL of a sample
        decode_vol(b);
      } else if (sc == 0xB2) {
        decode_user_data(b);
      } else if (sc == 0xB3 && b.show(23)) {  // GOV (FFmpeg skips one of 23 zero bits)
        int hours = (int)b.get(5), minutes = (int)b.get(6);
        b.skip(1);
        int seconds = (int)b.get(6);
        time_base = seconds + 60 * (minutes + 60 * hours);
        b.skip(2);  // closed_gov, broken_link: FFmpeg reads neither
      } else if (sc == 0xB0) {
        profile = (int)b.get(8);
        if (profile >= 0xE1 && profile <= 0xE8) studio = 1;
      } else if (sc == 0xB5) {
        decode_vo(b);
      } else if (sc == 0xB6) {
        return true;
      }
      b.align();
      code = 0xff;
    }
  }

  // The headers of the esds config, or of a track's first sample (a VOL
  // in band; `first` also tells whether it opens with the short video
  // header).
  void config(const uint8_t* data, size_t n, bool first) {
    if (first && n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
      short_header = true;
    std::vector<uint8_t> copy(data, data + n);
    copy.resize(n + kPad, 0);
    Bits b;
    b.init(copy.data(), n);
    headers(b);
  }

  std::string check() const {
    char s[160];
    if (short_header) return "the short video header (H.263 baseline)";
    if (studio) return "the studio profile";
    if (have_vol) {
      if (shape != 0) return "a non-rectangular shape (binary or grayscale)";
      if (sprite == 1) return "static sprites";
      if (sprite == 2) return "GMC (global motion compensation sprites)";
      if (sprite) return "sprites";
      if (!progressive) return "interlaced coding";
      if (not_8_bit) return "not_8_bit (N-bit video)";
      if (chroma_format != 1) return "chroma other than 4:2:0";
      if (cplx) return "complexity estimation headers";
      if (rvlc) return "reversible VLCs (RVLC)";
      if (newpred) return "newpred";
      if (reduced_res) return "reduced-resolution VOPs";
      if (scalability) return "scalability";
    }
    if (xvid_build >= 0) {
      snprintf(s, sizeof s, "a stream written by Xvid (build %d; FFmpeg switches to the Xvid IDCT)",
               xvid_build);
      return s;
    }
    if (divx_version >= 0) {
      snprintf(s, sizeof s, "a stream written by DivX %d (build %d; FFmpeg's DivX workarounds)",
               divx_version, divx_build);
      return s;
    }
    if (lavc_build >= 0 && (unsigned)lavc_build <= 4712u) {
      snprintf(s, sizeof s,
               "a stream written by an old libavcodec (build %d; FFmpeg's workarounds)",
               lavc_build);
      return s;
    }
    if (lavc_build >= 0 && (lavc_build & 0xFF) >= 100 && lavc_build > 3621476 &&
        lavc_build < 3752552 && (lavc_build < 3752037 || lavc_build > 3752191)) {
      snprintf(s, sizeof s, "a stream written by libavcodec build %d (FFmpeg's IEDGE workaround)",
               lavc_build);
      return s;
    }
    if (!have_vol) return "no VOL header";
    return "";
  }

  // ---------------------------------------------------------- pictures

  PicPtr new_picture() {
    PicPtr p;
    for (auto& q : pool)
      if (q.use_count() == 1) {
        p = q;
        break;
      }
    if (!p) {
      p = std::make_shared<Picture>();
      pool.push_back(p);
    }
    if (p->width != width || p->height != height) p->alloc(width, height);
    return p;
  }

  void set_size() {
    int w = (width + 15) / 16, h = (height + 15) / 16;
    if (w == mbw && h == mbh && !dc_base.empty()) return;
    mbw = w;
    mbh = h;
    mb_num = mbw * mbh;
    mb_stride = mbw + 1;
    b8_stride = 2 * mbw + 1;
    int y_size = b8_stride * (2 * mbh + 1), c_size = mb_stride * (mbh + 1);
    dc_base.assign((size_t)(y_size + 2 * c_size), 1024);
    ac_base.assign((size_t)(y_size + 2 * c_size) * 16, 0);
    dc_val[0] = dc_base.data() + b8_stride + 1;
    dc_val[1] = dc_base.data() + y_size + mb_stride + 1;
    dc_val[2] = dc_val[1] + c_size;
    ac_val[0] = ac_base.data() + (b8_stride + 1) * 16;
    ac_val[1] = ac_base.data() + (y_size + mb_stride + 1) * 16;
    ac_val[2] = ac_val[1] + c_size * 16;
    qscale_table.assign((size_t)mb_stride * mbh, 0);
    cbp_table.assign((size_t)mb_stride * mbh + 2, 0);
    pred_dir_table.assign((size_t)mb_stride * mbh, 0);
  }

  void init_block_index() {
    // luma in b8 units from dc_val[0]; chroma per plane from dc_val[1/2]
    block_index[0] = b8_stride * (mb_y * 2) + mb_x * 2;
    block_index[1] = block_index[0] + 1;
    block_index[2] = block_index[0] + b8_stride;
    block_index[3] = block_index[2] + 1;
    block_index[4] = block_index[5] = mb_y * mb_stride + mb_x;
  }

  int16_t* dc_ptr(int n) { return (n < 4 ? dc_val[0] : dc_val[n - 3]) + block_index[n]; }
  int16_t* ac_ptr(int n) { return (n < 4 ? ac_val[0] : ac_val[n - 3]) + block_index[n] * 16; }
  int wrap(int n) const { return n < 4 ? b8_stride : mb_stride; }

  void set_qscale(int q) {
    q = q < 1 ? 1 : (q > 31 ? 31 : q);
    qscale = q;
    y_dc_scale = kYDcScale[q];
    c_dc_scale = kCDcScale[q];
  }

  // ------------------------------------------------------------- motion

  int decode_motion(int pred, int fcode) {
    int code = tables().mv.read(gb);
    if (code == 0) return pred;
    if (code < 0) fail("a bad motion vector code");
    int sign = gb.get1(), shift = fcode - 1, val = code;
    if (shift) {
      val = (val - 1) << shift;
      val |= (int)gb.get(shift);
      ++val;
    }
    if (sign) val = -val;
    val += pred;
    int bits = 5 + fcode;  // sign_extend(val, 5 + f_code)
    return (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
  }

  // ff_h263_pred_motion on the current picture's field; returns the entry
  int16_t* pred_motion(int blk, int* px, int* py) {
    static const int off[4] = {2, 1, 1, -1};
    int16_t* base = cur->motion(block_index[blk]);
    auto at = [&](int d) { return base + 2 * d; };
    int16_t *A = at(-1), *B, *C;
    if (first_slice_line && blk < 3) {
      if (blk == 0) {
        if (mb_x == resync_mb_x) {
          *px = *py = 0;
        } else if (mb_x + 1 == resync_mb_x) {
          C = at(off[blk] - b8_stride);
          if (mb_x == 0) {
            *px = C[0];
            *py = C[1];
          } else {
            *px = mid_pred(A[0], 0, C[0]);
            *py = mid_pred(A[1], 0, C[1]);
          }
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else if (blk == 1) {
        if (mb_x + 1 == resync_mb_x) {
          C = at(off[blk] - b8_stride);
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        } else {
          *px = A[0];
          *py = A[1];
        }
      } else {
        B = at(-b8_stride);
        C = at(off[blk] - b8_stride);
        if (mb_x == resync_mb_x) A[0] = A[1] = 0;
        *px = mid_pred(A[0], B[0], C[0]);
        *py = mid_pred(A[1], B[1], C[1]);
      }
    } else {
      B = at(-b8_stride);
      C = at(off[blk] - b8_stride);
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
    return base;
  }

  void set_mb_motion(int mx, int my) {
    int16_t* m = cur->motion(block_index[0]);
    int w = b8_stride;
    for (int d : {0, 1, w, w + 1}) {
      m[2 * d] = (int16_t)mx;
      m[2 * d + 1] = (int16_t)my;
    }
  }

  // ff_h263_update_motion_val (I- and P-VOPs)
  void update_motion_val() {
    int xy = mb_x + mb_y * mb_stride;
    cur->mbskip[xy] = (uint8_t)mb_skipped;
    if (mv_type != 1) set_mb_motion(mb_intra ? 0 : mv[0][0][0], mb_intra ? 0 : mv[0][0][1]);
  }

  // ff_mpeg4_set_direct_mv
  void set_direct_mv(int mx, int my) {
    int xy = mb_x + mb_y * mb_stride;
    auto one = [&](int i) {
      int16_t* p = next->motion(block_index[i]);
      for (int c = 0; c < 2; ++c) {
        int pm = p[c], d = c ? my : mx;
        int64_t fwd = (int64_t)pm * pb_time / pp_time + d;
        mv[0][i][c] = (int)fwd;
        mv[1][i][c] = d ? (int)(fwd - pm) : (int)((int64_t)pm * (pb_time - pp_time) / pp_time);
      }
    };
    if (next->mb_type[xy] & k8x8) {
      mv_type = 1;
      for (int i = 0; i < 4; ++i) one(i);
      return;
    }
    one(0);
    for (int i = 1; i < 4; ++i)
      for (int d = 0; d < 2; ++d)
        for (int c = 0; c < 2; ++c) mv[d][i][c] = mv[d][0][c];
    mv_type = quarter_sample ? 1 : 0;
  }

  // --------------------------------------------------------- texture

  // ff_mpeg4_pred_dc: the predicted DC (in quantiser steps) and direction
  int pred_dc(int n, int level, int* dir) {
    int scale = n < 4 ? y_dc_scale : c_dc_scale;
    int wr = wrap(n);
    int16_t* dv = dc_ptr(n);
    int a = dv[-1], b = dv[-1 - wr], c = dv[-wr];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_mb_x) b = a = 1024;
    }
    if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) {
      pred = c;
      *dir = 1;
    } else {
      pred = a;
      *dir = 0;
    }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int ret = level;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    dv[0] = (int16_t)level;
    return ret;
  }

  int decode_dc(int n, int* dir) {
    int code = (n < 4 ? tables().dc_lum : tables().dc_chrom).read(gb);
    if (code < 0 || code > 9) fail("a bad intra DC size code");
    int level = 0;
    if (code) {
      level = gb.xbits(code);
      if (code > 8) gb.skip(1);  // marker
    }
    return pred_dc(n, level, dir);
  }

  // ff_mpeg4_pred_ac: add the left column or top row of the neighbour the
  // DC came from, rescaled across a quantiser change; keep this block's
  void pred_ac(int16_t* blk, int n, int dir) {
    int16_t* av = ac_ptr(n);
    const int8_t* qt = qscale_table.data();
    if (ac_pred) {
      if (dir == 0) {
        int xy = mb_x - 1 + mb_y * mb_stride;
        int16_t* l = av - 16;
        if (mb_x == 0 || qscale == qt[xy] || n == 1 || n == 3) {
          for (int i = 1; i < 8; ++i) blk[i << 3] = (int16_t)(blk[i << 3] + l[i]);
        } else {
          ++stats[kStAcRescaled];
          for (int i = 1; i < 8; ++i) {
            int v = l[i] * qt[xy];
            int r = (v >= 0 ? v + (qscale >> 1) : v - (qscale >> 1)) / qscale;  // ROUNDED_DIV
            blk[i << 3] = (int16_t)(blk[i << 3] + r);
          }
        }
      } else {
        int xy = mb_x + mb_y * mb_stride - mb_stride;
        int16_t* t = av - 16 * wrap(n);
        if (mb_y == 0 || qscale == qt[xy] || n == 2 || n == 3) {
          for (int i = 1; i < 8; ++i) blk[i] = (int16_t)(blk[i] + t[i + 8]);
        } else {
          ++stats[kStAcRescaled];
          for (int i = 1; i < 8; ++i) {
            int v = t[i + 8] * qt[xy];
            int r = (v >= 0 ? v + (qscale >> 1) : v - (qscale >> 1)) / qscale;
            blk[i] = (int16_t)(blk[i] + r);
          }
        }
      }
    }
    for (int i = 1; i < 8; ++i) av[i] = blk[i << 3];
    for (int i = 1; i < 8; ++i) av[8 + i] = blk[i];
  }

  // mpeg4_decode_block: coefficients in natural order. Intra levels stay
  // in quantiser steps (dequantised at reconstruction); inter levels of
  // H.263 quantisation come out dequantised.
  void decode_block(int16_t* blk, int n, int coded, int intra, int use_dc_vlc) {
    int i, dir = 0;
    const Rl* rl;
    const uint8_t* scan;
    int qmul, qadd;
    if (intra) {
      if (use_dc_vlc) {
        int level;
        if (partitioned) {
          level = dc_ptr(n)[0];
          int scale = n < 4 ? y_dc_scale : c_dc_scale;
          level = (level + (scale >> 1)) / scale;
          dir = (pred_dir_table[mb_x + mb_y * mb_stride] << n) & 32;
        } else {
          level = decode_dc(n, &dir);
        }
        blk[0] = (int16_t)level;
        i = 0;
      } else {
        i = -1;
        pred_dc(n, 0, &dir);  // the direction; the DC comes with the coefficients
      }
      if (!coded) goto not_coded;
      rl = &tables().intra;
      scan = !ac_pred ? kZigzag : (dir == 0 ? kAltVertical : kAltHorizontal);
      qmul = 1;
      qadd = 0;
    } else {
      i = -1;
      if (!coded) {
        block_last_index[n] = -1;
        return;
      }
      rl = &tables().inter;
      scan = kZigzag;  // alternate_scan is interlaced-only
      if (mpeg_quant) {
        qmul = 1;
        qadd = 0;
      } else {
        qmul = qscale << 1;
        qadd = (qscale - 1) | 1;
      }
    }
    for (;;) {
      int idx = rl->vlc.read(gb);
      if (idx < 0) fail("a bad TCOEF code");
      int level, run, last;
      if (idx == rl->n) {
        if (gb.get1() == 0) {  // first escape: level offset
          ++stats[kStEscape1];
          idx = rl->vlc.read(gb);
          if (idx < 0 || idx == rl->n) fail("a bad TCOEF code after an escape");
          run = rl->run[idx];
          last = idx >= rl->last;
          level = (rl->level[idx] + rl->max_level[last][run]) * qmul + qadd;
          if (gb.get1()) level = -level;
        } else if (gb.get1() == 0) {  // second escape: run offset
          ++stats[kStEscape2];
          idx = rl->vlc.read(gb);
          if (idx < 0 || idx == rl->n) fail("a bad TCOEF code after an escape");
          last = idx >= rl->last;
          run = rl->run[idx] + rl->max_run[last][rl->level[idx]] + 1;
          level = rl->level[idx] * qmul + qadd;
          if (gb.get1()) level = -level;
        } else {  // third escape: fixed length
          ++stats[kStEscape3];
          last = gb.get1();
          run = (int)gb.get(6);
          if (!gb.get1()) fail("a missing marker in a third escape");
          level = gb.sbits(12);
          if (!gb.get1()) fail("a missing marker in a third escape");
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
        }
      } else {
        run = rl->run[idx];
        last = idx >= rl->last;
        level = rl->level[idx] * qmul + qadd;
        if (gb.get1()) level = -level;
      }
      i += run + 1;
      if (i > 63 || (!last && i > 62)) fail("coefficients past the end of a block");
      blk[scan[i]] = (int16_t)level;
      if (last) break;
    }
  not_coded:
    if (intra) {
      if (!use_dc_vlc) {
        blk[0] = (int16_t)pred_dc(n, blk[0], &dir);
        if (i < 0) i = 0;
      }
      pred_ac(blk, n, dir);
      if (ac_pred) i = 63;
    }
    block_last_index[n] = i;
  }

  // ------------------------------------------------------ resync

  int packet_prefix_length() const {
    if (pict_type == kI) return 16;
    if (pict_type == kP || pict_type == kS) return f_code + 15;
    return std::max(std::max(f_code, b_code), 2) + 15;
  }

  // mpeg4_is_resync: the macroblock number of the next video packet (or
  // mb_num at the end of the VOP) when a resync marker or the VOP's
  // stuffing follows, else 0
  int is_resync() {
    int64_t bits_count = gb.pos;
    int v = (int)gb.show(16);
    while (v <= 0xFF) {
      if (pict_type == kB || (v >> (8 - pict_type) != 1) || partitioned) break;
      gb.skip(8 + pict_type);
      bits_count += 8 + pict_type;
      v = (int)gb.show(16);
    }
    if (bits_count + 8 >= gb.size) {
      v >>= 8;
      v |= 0x7F >> (7 - (bits_count & 7));
      if (v == 0x7F) return mb_num;
    } else {
      static const uint16_t prefix[8] = {0x7F00, 0x7E00, 0x7C00, 0x7800,
                                         0x7000, 0x6000, 0x4000, 0x0000};
      if (v == prefix[bits_count & 7]) {
        int mb_bits = 1;
        while ((1 << mb_bits) < mb_num) ++mb_bits;
        Bits save = gb;
        gb.skip(1);
        gb.align();
        int len = 0;
        for (; len < 32; ++len)
          if (gb.get1()) break;
        int num = (int)gb.get(mb_bits);
        if (!num || num > mb_num || gb.pos + 6 > gb.size) num = -1;
        gb = save;
        if (len >= packet_prefix_length()) return num;
      }
    }
    return 0;
  }

  void video_packet_header() {
    int mb_bits = 1;
    while ((1 << mb_bits) < mb_num) ++mb_bits;
    if (gb.pos > gb.size - 20) fail("a video packet header past the end");
    int len = 0;
    for (; len < 32; ++len)
      if (gb.get1()) break;
    if (len != packet_prefix_length()) fail("a resync marker that does not match f_code");
    int num = (int)gb.get(mb_bits);
    if (num >= mb_num || !num) fail("a video packet at macroblock %d of %d", num, mb_num);
    mb_x = num % mbw;
    mb_y = num / mbw;
    int q = (int)gb.get(quant_precision);
    if (q) qscale = q;
    if (gb.get1()) {  // header_extension_code
      while (gb.get1()) {
      }
      gb.skip(1);
      gb.skip(time_bits);
      gb.skip(1);
      gb.skip(2);
      gb.skip(3);
      if (pict_type != kI) gb.skip(3);
      if (pict_type == kB) gb.skip(3);
    }
  }

  void clean_buffers() {  // ff_mpeg4_clean_buffers
    int l_xy = (2 * mb_y - 1) * b8_stride + mb_x * 2 - 1;
    int c_xy = (mb_y - 1) * mb_stride + mb_x - 1;
    memset(ac_val[0] + l_xy * 16, 0, (size_t)(b8_stride * 2 + 1) * 16 * sizeof(int16_t));
    memset(ac_val[1] + c_xy * 16, 0, (size_t)(mb_stride + 1) * 16 * sizeof(int16_t));
    memset(ac_val[2] + c_xy * 16, 0, (size_t)(mb_stride + 1) * 16 * sizeof(int16_t));
    last_mv[0][0] = last_mv[0][1] = last_mv[1][0] = last_mv[1][1] = 0;
  }

  // ff_clean_intra_table_entries: a non-intra macroblock's DC and AC
  void clean_intra() {
    int w = b8_stride, xy = block_index[0];
    for (int d : {0, 1, w, w + 1}) {
      dc_val[0][xy + d] = 1024;
      memset(ac_val[0] + (xy + d) * 16, 0, 16 * sizeof(int16_t));
    }
    int c = mb_x + mb_y * mb_stride;
    dc_val[1][c] = dc_val[2][c] = 1024;
    memset(ac_val[1] + c * 16, 0, 16 * sizeof(int16_t));
    memset(ac_val[2] + c * 16, 0, 16 * sizeof(int16_t));
  }

  // ------------------------------------------------------ macroblocks

  enum { kSliceOk = 0, kSliceEnd = 1, kSliceNoEnd = 2 };
  static constexpr int8_t kQuantTab[4] = {-1, -2, 1, 2};

  int decode_mb() {
    const Tables& T = tables();
    int xy = mb_x + mb_y * mb_stride, cbpc = 0, cbpy, cbp, dquant;
    if (pict_type == kP) {
      for (;;) {
        if (gb.get1()) {  // not_coded
          mb_intra = 0;
          for (int i = 0; i < 6; ++i) block_last_index[i] = -1;
          mv_dir = 1;
          mv_type = 0;
          cur->mb_type[xy] = kSkip;
          mv[0][0][0] = mv[0][0][1] = 0;
          mb_skipped = 1;
          ++stats[kStSkipMb];
          goto end;
        }
        cbpc = T.inter_mcbpc.read(gb);
        if (cbpc < 0) fail("a bad MCBPC code");
        if (cbpc != 20) break;
      }
      memset(block, 0, sizeof block);
      dquant = cbpc & 8;
      mb_intra = (cbpc & 4) != 0;
      if (mb_intra) goto intra;
      cbpy = T.cbpy.read(gb);
      if (cbpy < 0) fail("a bad CBPY code");
      cbpy ^= 0xF;
      cbp = (cbpc & 3) | (cbpy << 2);
      if (dquant) {
        set_qscale(qscale + kQuantTab[gb.get(2)]);
        ++stats[kStDquant];
      }
      mv_dir = 1;
      stats[kStQpelMb] += quarter_sample;
      if (!(cbpc & 16)) {
        ++stats[kStInter1Mv];
        cur->mb_type[xy] = 0;
        int px, py;
        pred_motion(0, &px, &py);
        int mx = decode_motion(px, f_code), my = decode_motion(py, f_code);
        mv_type = 0;
        mv[0][0][0] = mx;
        mv[0][0][1] = my;
      } else {
        ++stats[kStInter4Mv];
        cur->mb_type[xy] = k8x8;
        mv_type = 1;
        for (int i = 0; i < 4; ++i) {
          int px, py;
          int16_t* m = pred_motion(i, &px, &py);
          int mx = decode_motion(px, f_code), my = decode_motion(py, f_code);
          mv[0][i][0] = mx;
          mv[0][i][1] = my;
          m[0] = (int16_t)mx;
          m[1] = (int16_t)my;
        }
      }
    } else if (pict_type == kB) {
      mb_intra = 0;
      if (mb_x == 0) memset(last_mv, 0, sizeof last_mv);
      mb_skipped = next->mbskip[xy];
      int type;  // 0 direct, 1 interpolated, 2 backward, 3 forward
      bool direct_skip = false;
      if (mb_skipped) {
        for (int i = 0; i < 6; ++i) block_last_index[i] = -1;
        mv_dir = 1;
        mv_type = 0;
        memset(mv, 0, sizeof mv);
        ++stats[kStColocatedSkip];
        goto end;
      }
      if (gb.get1()) {  // modb: direct with no vectors or coefficients
        type = 0;
        cbp = 0;
        direct_skip = true;
      } else {
        int modb2 = gb.get1();
        type = T.mb_type_b.read(gb);
        if (type < 0) fail("a bad B macroblock type");
        if (modb2) {
          cbp = 0;
        } else {
          memset(block, 0, sizeof block);
          cbp = (int)gb.get(6);
        }
        if (type != 0 && cbp && gb.get1()) {
          set_qscale(qscale + gb.get1() * 4 - 2);
          ++stats[kStDbquant];
        }
        if (type) ++stats[type == 1 ? kStInterpolated : (type == 2 ? kStBackward : kStForward)];
        mv_dir = 0;
        if (type != 0) {
          mv_type = 0;
          if (type == 1 || type == 3) {
            mv_dir = 1;
            int mx = decode_motion(last_mv[0][0], f_code);
            int my = decode_motion(last_mv[0][1], f_code);
            last_mv[0][0] = mv[0][0][0] = mx;
            last_mv[0][1] = mv[0][0][1] = my;
          }
          if (type == 1 || type == 2) {
            mv_dir |= 2;
            int mx = decode_motion(last_mv[1][0], b_code);
            int my = decode_motion(last_mv[1][1], b_code);
            last_mv[1][0] = mv[1][0][0] = mx;
            last_mv[1][1] = mv[1][0][1] = my;
          }
        }
      }
      if (type == 0) {
        int mx = 0, my = 0;
        if (!direct_skip) {
          mx = decode_motion(0, 1);
          my = decode_motion(0, 1);
        }
        mv_dir = 3;
        set_direct_mv(mx, my);
        ++stats[direct_skip ? kStDirectSkip : kStDirect];
        stats[kStDirect8x8] += (next->mb_type[xy] & k8x8) != 0;
      }
      stats[kStQpelMb] += quarter_sample;
      for (int i = 0; i < 6; ++i) {
        decode_block(block[i], i, cbp & 32, 0, 0);
        cbp += cbp;
      }
      goto end;
    } else {  // I
      for (;;) {
        cbpc = T.intra_mcbpc.read(gb);
        if (cbpc < 0) fail("a bad intra MCBPC code");
        if (cbpc != 8) break;
      }
      dquant = cbpc & 4;
      mb_intra = 1;
    intra:
      ++stats[kStIntraMb];
      stats[kStIntraInP] += pict_type == kP;
      ac_pred = gb.get1();
      stats[kStAcPred] += ac_pred;
      cur->mb_type[xy] = (uint8_t)(kIntra | (ac_pred ? kAcPred : 0));
      cbpy = T.cbpy.read(gb);
      if (cbpy < 0) fail("a bad intra CBPY code");
      cbp = (cbpc & 3) | (cbpy << 2);
      int use_dc_vlc = qscale < intra_dc_threshold;
      if (dquant) {
        set_qscale(qscale + kQuantTab[gb.get(2)]);
        ++stats[kStDquant];
      }
      memset(block, 0, sizeof block);
      for (int i = 0; i < 6; ++i) {
        decode_block(block[i], i, cbp & 32, 1, use_dc_vlc);
        cbp += cbp;
      }
      goto end;
    }
    for (int i = 0; i < 6; ++i) {
      decode_block(block[i], i, cbp & 32, 0, 0);
      cbp += cbp;
    }
  end:
    if (gb.left() < 0) fail("a read past the end of the VOP");
    int next_mb = is_resync();
    if (next_mb) {
      if (mb_x + mb_y * mbw + 1 >= next_mb) return kSliceEnd;
      if (pict_type == kB) {
        int delta = mb_x + 1 == mbw ? 2 : 1;
        if (xy + delta < (int)next->mbskip.size() && next->mbskip[xy + delta]) return kSliceOk;
      }
      return kSliceEnd;
    }
    return kSliceOk;
  }

  // data partitioning: partition A (motion / DC) and B (CBPY / DC) of one
  // video packet; returns the macroblocks in it
  int partition_a() {
    const Tables& T = tables();
    int num = 0;
    first_slice_line = 1;
    for (; mb_y < mbh; ++mb_y) {
      for (; mb_x < mbw; ++mb_x) {
        int xy = mb_x + mb_y * mb_stride;
        init_block_index();
        ++num;
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) first_slice_line = 0;
        if (pict_type == kI) {
          int cbpc;
          do {
            if (gb.show(19) == kDcMarker) return num - 1;
            cbpc = T.intra_mcbpc.read(gb);
            if (cbpc < 0) fail("a bad intra MCBPC code");
          } while (cbpc == 8);
          cbp_table[xy] = (uint8_t)(cbpc & 3);
          cur->mb_type[xy] = kIntra;
          mb_intra = 1;
          if (cbpc & 4) set_qscale(qscale + kQuantTab[gb.get(2)]);
          qscale_table[xy] = (int8_t)qscale;
          int dir = 0;
          for (int i = 0; i < 6; ++i) {
            int d;
            decode_dc(i, &d);
            dir = (dir << 1) | (d ? 1 : 0);
          }
          pred_dir_table[xy] = (uint8_t)dir;
        } else {
          for (;;) {
            if ((int)gb.show(17) == kMotionMarker) return num - 1;
            int bits = (int)gb.show(17);
            gb.skip(1);
            if (bits & 0x10000) {
              cur->mb_type[xy] = kSkip;
              set_mb_motion(0, 0);
              clean_intra();
              break;
            }
            int cbpc = T.inter_mcbpc.read(gb);
            if (cbpc < 0) fail("a bad MCBPC code");
            if (cbpc == 20) continue;
            cbp_table[xy] = (uint8_t)(cbpc & (8 + 3));
            mb_intra = (cbpc & 4) != 0;
            if (mb_intra) {
              cur->mb_type[xy] = kIntra;
              set_mb_motion(0, 0);
            } else {
              clean_intra();
              if (!(cbpc & 16)) {
                int px, py;
                pred_motion(0, &px, &py);
                int mx = decode_motion(px, f_code), my = decode_motion(py, f_code);
                cur->mb_type[xy] = 0;
                set_mb_motion(mx, my);
              } else {
                cur->mb_type[xy] = k8x8;
                for (int i = 0; i < 4; ++i) {
                  int px, py;
                  int16_t* m = pred_motion(i, &px, &py);
                  int mx = decode_motion(px, f_code), my = decode_motion(py, f_code);
                  m[0] = (int16_t)mx;
                  m[1] = (int16_t)my;
                }
              }
            }
            break;
          }
        }
        if (gb.left() < 0) fail("a read past the end of the VOP");
      }
      mb_x = 0;
    }
    return num;
  }

  void partition_b(int count) {
    const Tables& T = tables();
    int num = 0;
    mb_x = resync_mb_x;
    first_slice_line = 1;
    for (mb_y = resync_mb_y; num < count; ++mb_y) {
      for (; num < count && mb_x < mbw; ++mb_x) {
        int xy = mb_x + mb_y * mb_stride;
        init_block_index();
        ++num;
        if (mb_x == resync_mb_x && mb_y == resync_mb_y + 1) first_slice_line = 0;
        if (pict_type == kI) {
          int acp = gb.get1();
          int cbpy = T.cbpy.read(gb);
          if (cbpy < 0) fail("a bad intra CBPY code");
          cbp_table[xy] = (uint8_t)(cbp_table[xy] | (cbpy << 2));
          if (acp) cur->mb_type[xy] |= kAcPred;
        } else if (cur->mb_type[xy] & kIntra) {
          int acp = gb.get1();
          int cbpy = T.cbpy.read(gb);
          if (cbpy < 0) fail("a bad intra CBPY code");
          if (cbp_table[xy] & 8) set_qscale(qscale + kQuantTab[gb.get(2)]);
          qscale_table[xy] = (int8_t)qscale;
          int dir = 0;
          for (int i = 0; i < 6; ++i) {
            int d;
            decode_dc(i, &d);
            dir = (dir << 1) | (d ? 1 : 0);
          }
          cbp_table[xy] = (uint8_t)((cbp_table[xy] & 3) | (cbpy << 2));
          if (acp) cur->mb_type[xy] |= kAcPred;
          pred_dir_table[xy] = (uint8_t)dir;
        } else if (cur->mb_type[xy] & kSkip) {
          qscale_table[xy] = (int8_t)qscale;
          cbp_table[xy] = 0;
        } else {
          int cbpy = T.cbpy.read(gb);
          if (cbpy < 0) fail("a bad CBPY code");
          if (cbp_table[xy] & 8) set_qscale(qscale + kQuantTab[gb.get(2)]);
          qscale_table[xy] = (int8_t)qscale;
          cbp_table[xy] = (uint8_t)((cbp_table[xy] & 3) | ((cbpy ^ 0xF) << 2));
        }
        if (gb.left() < 0) fail("a read past the end of the VOP");
      }
      if (num >= count) return;
      mb_x = 0;
    }
  }

  void decode_partitions() {
    int num = partition_a();
    if (num <= 0) fail("an empty data partition");
    if (resync_mb_x + resync_mb_y * mbw + num > mb_num) fail("a data partition past the picture");
    mb_num_left = num;
    if (pict_type == kI) {
      while (gb.show(9) == 1) gb.skip(9);
      if (gb.get(19) != kDcMarker) fail("a missing DC marker");
    } else {
      while (gb.show(10) == 1) gb.skip(10);
      if (gb.get(17) != kMotionMarker) fail("a missing motion marker");
    }
    partition_b(num);
  }

  int decode_partitioned_mb() {
    int xy = mb_x + mb_y * mb_stride;
    int type = cur->mb_type[xy], cbp = cbp_table[xy];
    int use_dc_vlc = qscale < intra_dc_threshold;
    if (qscale_table[xy] != qscale) set_qscale(qscale_table[xy]);
    if (pict_type == kP) {
      for (int i = 0; i < 4; ++i) {
        int16_t* m = cur->motion(block_index[i]);
        mv[0][i][0] = m[0];
        mv[0][i][1] = m[1];
      }
      mb_intra = (type & kIntra) != 0;
      ++stats[(type & kSkip) ? kStSkipMb
                             : (mb_intra ? kStIntraMb : ((type & k8x8) ? kStInter4Mv : kStInter1Mv))];
      stats[kStIntraInP] += mb_intra;
      if (type & kSkip) {
        for (int i = 0; i < 6; ++i) block_last_index[i] = -1;
        mv_dir = 1;
        mv_type = 0;
        mb_skipped = 1;
      } else if (mb_intra) {
        ac_pred = (type & kAcPred) != 0;
      } else {
        mv_dir = 1;
        mv_type = (type & k8x8) ? 1 : 0;
      }
    } else {
      mb_intra = 1;
      ac_pred = (type & kAcPred) != 0;
      ++stats[kStIntraMb];
    }
    stats[kStAcPred] += mb_intra && ac_pred;
    if (!(type & kSkip)) {
      memset(block, 0, sizeof block);
      for (int i = 0; i < 6; ++i) {
        decode_block(block[i], i, cbp & 32, mb_intra, use_dc_vlc);
        cbp += cbp;
      }
    }
    if (gb.left() < 0) fail("a read past the end of the VOP");
    if (--mb_num_left <= 0) return is_resync() ? kSliceEnd : kSliceNoEnd;
    if (is_resync()) {
      int delta = mb_x + 1 == mbw ? 2 : 1;
      if (cbp_table[xy + delta]) return kSliceEnd;
    }
    return kSliceOk;
  }

  // ----------------------------------------------------- reconstruction

  // H.263 intra dequantisation (libavcodec's x86 routine: 16-bit products,
  // a coefficient whose product wraps to 0 stays 0)
  void dequant_h263_intra(int16_t* b, int n) {
    int level = b[0] * (n < 4 ? y_dc_scale : c_dc_scale);
    int qmul = qscale << 1, qadd = (qscale - 1) | 1;
    for (int i = 1; i < 64; ++i) {
      int16_t x = b[i];
      uint16_t m = (uint16_t)(x * qmul);
      if (x > 0)
        b[i] = (int16_t)(uint16_t)(m + qadd);
      else if (m == 0)
        b[i] = 0;
      else
        b[i] = (int16_t)(uint16_t)(m - qadd);
    }
    b[0] = (int16_t)level;
  }

  // MPEG intra dequantisation (the x86 routine, no mismatch control)
  void dequant_mpeg_intra(int16_t* b, int n) {
    int block0 = b[0] * (n < 4 ? y_dc_scale : c_dc_scale);
    int q = qscale << 1;
    for (int i = 0; i < 64; ++i) {
      int16_t x = b[i];
      if (!x) continue;
      uint16_t qm = (uint16_t)(q * intra_matrix[i]);
      uint16_t a = (uint16_t)(x < 0 ? -x : x);
      int16_t v = (int16_t)(uint16_t)(a * qm);
      v = (int16_t)(v >> 4);
      b[i] = x < 0 ? (int16_t)(uint16_t)(-(int)v) : v;
    }
    b[0] = (int16_t)block0;
  }

  // MPEG inter dequantisation with the mismatch control (the x86 routine:
  // 16-bit products, a logical shift)
  void dequant_mpeg_inter(int16_t* b) {
    int q = qscale << 1;
    unsigned parity = 1;
    for (int i = 0; i < 64; ++i) {
      int16_t x = b[i];
      if (!x) continue;
      uint16_t qm = (uint16_t)(q * inter_matrix[i]);
      uint16_t a = (uint16_t)(x < 0 ? -x : x);
      uint16_t v = (uint16_t)((uint16_t)(a * 2 * qm) + qm) >> 5;
      int16_t r = x < 0 ? (int16_t)(uint16_t)(-(int)v) : (int16_t)v;
      b[i] = r;
      parity ^= (uint16_t)r & 1;
    }
    b[63] = (int16_t)(b[63] ^ (int16_t)(parity & 1));
  }

  uint8_t* dest(int c, int blk_x, int blk_y) {
    int s = cur->stride(c);
    return cur->plane[c].data() + (int64_t)blk_y * s + blk_x;
  }

  // luma 16x16 or 8x8 half-pel prediction at (x, y) from ref
  void hpel_block(uint8_t* dst, int ds, const Picture& ref, int c, int x, int y, int n, int dxy,
                  Op op) {
    Patch p;
    int pw = c ? mbw * 8 : mbw * 16, ph = c ? mbh * 8 : mbh * 16;
    p.fetch(ref.plane[c].data(), ref.stride(c), pw, ph, x, y, n + 1, n + 1);
    interp.hpel(dst, ds, p.px, p.stride, n, n, dxy, op);
  }

  void qpel_block(uint8_t* dst, int ds, const Picture& ref, int x, int y, int n, int dxy, Op op) {
    Patch p;
    p.fetch(ref.plane[0].data(), ref.stride(0), mbw * 16, mbh * 16, x, y, n + 1, n + 1);
    Interp::qpel(dst, ds, p.px, p.stride, n, dxy, op);
  }

  void chroma_block(const Picture& ref, int uvx, int uvy, int dxy, Op op) {
    for (int c = 1; c < 3; ++c)
      hpel_block(dest(c, mb_x * 8, mb_y * 8), cur->stride(c), ref, c, uvx, uvy, 8, dxy, op);
  }

  // ff_mpv_motion for one direction
  void motion(int dir, const Picture& ref, Op op) {
    uint8_t* dy = dest(0, mb_x * 16, mb_y * 16);
    int ls = cur->stride(0);
    if (mv_type == 0) {
      int mx = mv[dir][0][0], my = mv[dir][0][1];
      if (quarter_sample) {  // qpel_motion
        int dxy = ((my & 3) << 2) | (mx & 3);
        qpel_block(dy, ls, ref, mb_x * 16 + (mx >> 2), mb_y * 16 + (my >> 2), 16, dxy, op);
        int cx = mx / 2, cy = my / 2;
        cx = (cx >> 1) | (cx & 1);
        cy = (cy >> 1) | (cy & 1);
        int uvdxy = (cx & 1) | ((cy & 1) << 1);
        chroma_block(ref, mb_x * 8 + (cx >> 1), mb_y * 8 + (cy >> 1), uvdxy, op);
      } else {  // mpeg_motion
        int dxy = ((my & 1) << 1) | (mx & 1);
        int x = mb_x * 16 + (mx >> 1), y = mb_y * 16 + (my >> 1);
        hpel_block(dy, ls, ref, 0, x, y, 16, dxy, op);
        // H.263's chroma vector: half-pel wherever the luma one is fractional
        int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
        chroma_block(ref, x >> 1, y >> 1, uvdxy, op);
      }
      return;
    }
    // apply_8x8
    int sx = 0, sy = 0;
    for (int i = 0; i < 4; ++i) {
      int mx = mv[dir][i][0], my = mv[dir][i][1];
      uint8_t* d = dy + (i & 1) * 8 + (i >> 1) * 8 * ls;
      if (quarter_sample) {
        int dxy = ((my & 3) << 2) | (mx & 3);
        int x = mb_x * 16 + (mx >> 2) + (i & 1) * 8, y = mb_y * 16 + (my >> 2) + (i >> 1) * 8;
        x = std::min(std::max(x, -16), width);
        if (x == width) dxy &= ~3;
        y = std::min(std::max(y, -16), height);
        if (y == height) dxy &= ~12;
        stats[kStEdgeClip] += x == width || y == height;
        qpel_block(d, ls, ref, x, y, 8, dxy, op);
        sx += mx / 2;
        sy += my / 2;
      } else {
        int x = mb_x * 16 + (i & 1) * 8 + (mx >> 1), y = mb_y * 16 + (i >> 1) * 8 + (my >> 1);
        int dxy = 0;
        x = std::min(std::max(x, -16), width);
        if (x != width) dxy |= mx & 1;
        y = std::min(std::max(y, -16), height);
        if (y != height) dxy |= (my & 1) << 1;
        stats[kStEdgeClip] += x == width || y == height;
        hpel_block(d, ls, ref, 0, x, y, 8, dxy, op);
        sx += mx;
        sy += my;
      }
    }
    // chroma_4mv_motion
    int cx = kChromaRound[sx & 0xf] + ((sx >> 3) & ~1);
    int cy = kChromaRound[sy & 0xf] + ((sy >> 3) & ~1);
    int dxy = ((cy & 1) << 1) | (cx & 1);
    cx >>= 1;
    cy >>= 1;
    int x = mb_x * 8 + cx, y = mb_y * 8 + cy;
    x = std::min(std::max(x, -8), width >> 1);
    if (x == (width >> 1)) dxy &= ~1;
    y = std::min(std::max(y, -8), height >> 1);
    if (y == (height >> 1)) dxy &= ~2;
    chroma_block(ref, x, y, dxy, op);
  }

  void reconstruct() {
    if (mb_intra) {
      for (int i = 0; i < 6; ++i) {
        if (mpeg_quant)
          dequant_mpeg_intra(block[i], i);
        else
          dequant_h263_intra(block[i], i);
        int c = i < 4 ? 0 : i - 3;
        uint8_t* d = c ? dest(c, mb_x * 8, mb_y * 8)
                       : dest(0, mb_x * 16 + (i & 1) * 8, mb_y * 16 + (i >> 1) * 8);
        idct_put(d, cur->stride(c), block[i]);
      }
      return;
    }
    clean_intra();
    Op op = (pict_type != kB && no_rounding) ? kPutNoRnd : kPut;
    if (mv_dir & 1) {
      motion(0, *last, op);
      op = kAvg;
    }
    if (mv_dir & 2) motion(1, *next, op);
    for (int i = 0; i < 6; ++i) {
      if (block_last_index[i] < 0) continue;
      if (mpeg_quant) dequant_mpeg_inter(block[i]);
      int c = i < 4 ? 0 : i - 3;
      uint8_t* d = c ? dest(c, mb_x * 8, mb_y * 8)
                     : dest(0, mb_x * 16 + (i & 1) * 8, mb_y * 16 + (i >> 1) * 8);
      idct_add(d, cur->stride(c), block[i]);
    }
  }

  // ------------------------------------------------------------ slices

  void decode_slice() {
    first_slice_line = 1;
    resync_mb_x = mb_x;
    resync_mb_y = mb_y;
    set_qscale(qscale);
    if (partitioned) {
      int q = qscale;
      decode_partitions();
      first_slice_line = 1;
      mb_x = resync_mb_x;
      mb_y = resync_mb_y;
      set_qscale(q);
    }
    for (; mb_y < mbh; ++mb_y) {
      for (; mb_x < mbw; ++mb_x) {
        init_block_index();
        if (resync_mb_x == mb_x && resync_mb_y + 1 == mb_y) first_slice_line = 0;
        mv_dir = 1;
        mv_type = 0;
        mb_skipped = 0;
        int ret;
        try {
          ret = partitioned ? decode_partitioned_mb() : decode_mb();
        } catch (Error& e) {
          fail("sample %lld, macroblock %d: %s", (long long)sample, mb_x + mb_y * mbw,
               e.what.c_str());
        }
        if (pict_type != kB) update_motion_val();
        if (ret == kSliceNoEnd)
          fail("sample %lld, macroblock %d: a data partition that does not end at a resync marker",
               (long long)sample, mb_x + mb_y * mbw);
        qscale_table[mb_x + mb_y * mb_stride] = (int8_t)qscale;
        reconstruct();
        if (ret == kSliceEnd) {
          if (++mb_x >= mbw) {
            mb_x = 0;
            ++mb_y;
          }
          return;
        }
      }
      mb_x = 0;
    }
    fail("sample %lld: the VOP's macroblocks end before its data", (long long)sample);
  }

  void decode_picture() {
    mb_x = mb_y = 0;
    decode_slice();
    while (mb_y < mbh) {
      int64_t prev = (int64_t)mb_y * mbw + mb_x;
      gb.skip(1);
      gb.align();
      if (gb.show(16) != 0)
        fail("sample %lld: no resync marker after macroblock %lld", (long long)sample,
             (long long)prev - 1);
      try {
        video_packet_header();
      } catch (Error& e) {
        fail("sample %lld, after macroblock %lld: %s", (long long)sample, (long long)prev - 1,
             e.what.c_str());
      }
      if ((int64_t)mb_y * mbw + mb_x != prev)
        fail("sample %lld: a video packet at macroblock %d after macroblock %lld",
             (long long)sample, mb_x + mb_y * mbw, (long long)prev - 1);
      clean_buffers();
      ++stats[kStVideoPackets];
      decode_slice();
    }
  }

  // -------------------------------------------------------------- VOPs

  // the VOP header after its start code; false for a VOP that gives no
  // picture (not coded, or a B-VOP FFmpeg skips by its times)
  bool vop_header() {
    pict_type = (int)gb.get(2) + 1;
    if (pict_type == kB && low_delay && vol_control == 0) low_delay = 0;
    partitioned = data_partitioning && pict_type != kB;
    int time_incr = 0;
    while (gb.get1()) ++time_incr;
    gb.skip(1);
    if (!(gb.show(time_bits + 1) & 1))
      fail("sample %lld: a VOP time increment without its marker", (long long)sample);
    int inc = (int)gb.get(time_bits);
    if (pict_type != kB) {
      last_time_base = time_base;
      time_base += time_incr;
      time = time_base * time_res + inc;
      pp_time = (uint16_t)(time - last_non_b_time);
      last_non_b_time = time;
    } else {
      time = (last_time_base + time_incr) * time_res + inc;
      pb_time = (uint16_t)(pp_time - (last_non_b_time - time));
      if (pp_time <= pb_time || pp_time <= pp_time - pb_time || pp_time <= 0) return false;
    }
    gb.skip(1);
    if (!gb.get1()) {  // vop_coded = 0
      ++stats[kStNotCoded];
      return false;
    }
    if (pict_type == kS) fail("sample %lld: an S-VOP", (long long)sample);
    no_rounding = pict_type == kP ? gb.get1() : 0;
    if (gb.left() < 3) fail("sample %lld: a VOP header cut short", (long long)sample);
    intra_dc_threshold = kDcThreshold[gb.get(3)];
    int q = (int)gb.get(quant_precision);
    if (q == 0) fail("sample %lld: a VOP with quantiser 0", (long long)sample);
    qscale = q;
    f_code = 1;
    b_code = 1;
    if (pict_type != kI) {
      f_code = (int)gb.get(3);
      if (!f_code) fail("sample %lld: a VOP with f_code 0", (long long)sample);
    }
    if (pict_type == kB) {
      b_code = (int)gb.get(3);
      if (!b_code) fail("sample %lld: a VOP with b_code 0", (long long)sample);
    }
    ++picture_number;
    stats[kStNoRounding] += no_rounding;
    stats[kStPartitioned] += partitioned;
    return true;
  }

  void decode_sample(const uint8_t* data, size_t n, int64_t pts, bool discard) {
    buf.assign(data, data + n);
    buf.resize(n + kPad, 0);
    gb.init(buf.data(), n);
    if (!headers(gb)) fail("sample %lld: no VOP in the sample", (long long)sample);
    std::string why = check();
    if (!why.empty()) fail("sample %lld: %s", (long long)sample, why.c_str());
    set_size();
    if (!vop_header()) return;
    if (!last && pict_type == kB) {  // no forward reference (after a seek)
      ++stats[kStBDropped];
      return;
    }
    ++stats[pict_type == kB ? kStBVop : (pict_type == kP ? kStPVop : kStIVop)];
    if (pict_type == kP && !next)
      fail("sample %lld: a P-VOP without a reference", (long long)sample);
    cur = new_picture();
    cur->pts = pts;
    cur->discard = discard;
    std::fill(cur->mbskip.begin(), cur->mbskip.end(), 0);
    if (pict_type != kB) {
      last = next;
      next = cur;
    }
    decode_picture();
    PicPtr out;
    if (pict_type == kB || low_delay)
      out = cur;
    else
      out = last;
    if (out && !out->discard) output.push_back(out);
    cur.reset();
  }

  void drain() {
    if (!low_delay && next) {
      if (!next->discard) output.push_back(next);
      next.reset();
    }
  }

  void flush() {
    output.clear();
    cur.reset();
    last.reset();
    next.reset();
    mb_x = mb_y = 0;
    pp_time = 0;
  }

  int decode(const uint8_t* data, size_t n, int64_t pts, bool discard) {
    try {
      decode_sample(data, n, pts, discard);
    } catch (...) {
      ++sample;
      throw;
    }
    ++sample;
    return (int)output.size();
  }
};

constexpr int8_t Decoder::kQuantTab[4];

struct Handle {
  Decoder dec;
  std::string error;
};

template <class F>
static int guarded(Handle* h, F f) {
  if (!h->error.empty()) return -1;
  try {
    return f();
  } catch (const Error& e) {
    h->error = e.what;
    h->dec.flush();
    return -1;
  } catch (const std::bad_alloc&) {
    h->error = "out of memory";
    h->dec.flush();
    return -1;
  }
}

}  // namespace mpeg4

extern "C" {

// A decoder; approx16 selects the system FFmpeg 5.1's x86 put_no_rnd x2 /
// y2 rounding of 16-pixel rows in place of cv2's FFmpeg 8's exact one.
void* mpeg4_new(int approx16) {
  mpeg4::Handle* h = new mpeg4::Handle();
  h->dec.interp.approx16 = approx16 != 0;
  return h;
}

void mpeg4_free(void* h) { delete (mpeg4::Handle*)h; }

// The esds DecoderSpecificInfo, then (optionally) the first sample's
// headers. 0, or -1 with mpeg4_error set.
int mpeg4_config(void* hp, const uint8_t* config, int64_t size, const uint8_t* first,
                 int64_t first_size) {
  mpeg4::Handle* h = (mpeg4::Handle*)hp;
  return mpeg4::guarded(h, [&] {
    h->dec.config(config, (size_t)size, false);
    if (first) h->dec.config(first, (size_t)first_size, true);
    return 0;
  });
}

// The feature of the headers seen so far that the decoder refuses, or "".
const char* mpeg4_check(void* hp) {
  static thread_local std::string r;
  r = ((mpeg4::Handle*)hp)->dec.check();
  return r.c_str();
}

// The user data string of the headers ("Lavc62.28.101"...).
const char* mpeg4_user_data(void* hp) { return ((mpeg4::Handle*)hp)->dec.user_data.c_str(); }

// Decode one sample. discard: decode it as a reference but never output
// its picture. Returns the pictures ready, or -1 with mpeg4_error set.
int mpeg4_decode(void* hp, const uint8_t* data, int64_t size, int64_t pts, int discard) {
  mpeg4::Handle* h = (mpeg4::Handle*)hp;
  return mpeg4::guarded(h, [&] { return h->dec.decode(data, (size_t)size, pts, discard != 0); });
}

// The end of the stream: the picture held back becomes ready.
int mpeg4_drain(void* hp) {
  mpeg4::Handle* h = (mpeg4::Handle*)hp;
  return mpeg4::guarded(h, [&] {
    h->dec.drain();
    return (int)h->dec.output.size();
  });
}

// A seek: drop every picture and reference. Clears an error.
void mpeg4_flush(void* hp) {
  mpeg4::Handle* h = (mpeg4::Handle*)hp;
  h->dec.flush();
  h->error.clear();
}

// The next ready picture's size, pts, matrix_coefficients and range; 0
// when none is ready.
int mpeg4_peek(void* hp, int* width, int* height, int64_t* pts, int* matrix, int* full_range) {
  mpeg4::Handle* h = (mpeg4::Handle*)hp;
  if (h->dec.output.empty()) return 0;
  const mpeg4::Picture* p = h->dec.output.front().get();
  *width = p->width;
  *height = p->height;
  *pts = p->pts;
  *matrix = h->dec.matrix;
  *full_range = h->dec.full_range;
  return 1;
}

// Pop the next ready picture: its Y, U, V planes (width x height, and
// ((width+1)/2) x ((height+1)/2)) and its BGR24 conversion, each where the
// pointer is not null. 0, or -1 when no picture is ready.
int mpeg4_take(void* hp, uint8_t* y, uint8_t* u, uint8_t* v, uint8_t* bgr) {
  mpeg4::Handle* h = (mpeg4::Handle*)hp;
  if (h->dec.output.empty()) return -1;
  mpeg4::PicPtr p = h->dec.output.front();
  h->dec.output.erase(h->dec.output.begin());
  int w = p->width, hh = p->height, cw = (w + 1) / 2, ch = (hh + 1) / 2;
  int ls = p->stride(0), cs = p->stride(1);
  if (y)
    for (int r = 0; r < hh; ++r) memcpy(y + (size_t)r * w, p->plane[0].data() + (size_t)r * ls, w);
  for (int c = 0; c < 2; ++c) {
    uint8_t* out = c ? v : u;
    if (out)
      for (int r = 0; r < ch; ++r)
        memcpy(out + (size_t)r * cw, p->plane[1 + c].data() + (size_t)r * cs, cw);
  }
  if (bgr)
    yuv420_to_bgr(p->plane[0].data(), ls, p->plane[1].data(), p->plane[2].data(), cs, w, hh, bgr,
                  w * 3, h->dec.matrix, h->dec.full_range);
  return 0;
}

const char* mpeg4_error(void* hp) { return ((mpeg4::Handle*)hp)->error.c_str(); }

// The decoder's counts of what it met (mpeg4::Stat order), up to n of
// them; returns how many there are.
int mpeg4_stats(void* hp, int64_t* out, int n) {
  const mpeg4::Decoder& d = ((mpeg4::Handle*)hp)->dec;
  for (int i = 0; i < n && i < mpeg4::kStCount; ++i) out[i] = d.stats[i];
  return mpeg4::kStCount;
}

// The decoder's IDCT on n natural-order blocks: out gets what idct_put
// would store before clipping, saturated to 16 bits (libavcodec's `idct`).
void mpeg4_idct(const int16_t* in, int16_t* out, int64_t n) {
  for (int64_t k = 0; k < n; ++k) {
    int32_t r[64];
    mpeg4::idct(in + 64 * k, r);
    for (int i = 0; i < 64; ++i) out[64 * k + i] = mpeg4::sat16(r[i]);
  }
}

}  // extern "C"
