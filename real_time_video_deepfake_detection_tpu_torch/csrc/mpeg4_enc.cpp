// MPEG-4 Part 2 (mp4v) video encoder on the host: the bitstream
// cv2.VideoWriter(path, fourcc 'mp4v', fps, size) writes through its FFmpeg
// backend, which opens libavcodec's native mpeg4 encoder with bit_rate
// and bit_rate_tolerance about 2 * fps * width * height (the caller's:
// utils/video._cv2_bit_rate), gop_size 12, qmin 3 and everything else at
// libavcodec's defaults; the same bytes, VOP for VOP.
//
// What that configuration runs, and so what this file does:
// - headers: Visual Object Sequence (Simple Profile L1), Visual Object and
//   VOL (H.263 quantisation, resync markers off, not fixed-rate,
//   vop_time_increment_resolution = the reduced time base's denominator)
//   with the "Lavc62.28.101" user data, either once as the global header
//   (the mp4 / mov / m4v esds) or in front of every I-VOP (AVI); a GOV
//   header before every I-VOP;
// - I- and P-VOPs only (no B-VOPs), an I-VOP every 12 pictures or at a
//   scene change, rounding_type alternating on P-VOPs;
// - motion estimation as libavcodec's ff_estimate_p_frame_motion with its
//   defaults (EPZS with the median, neighbour and previous-vector
//   predictors, the small diamond, SAD compares, the score map and its
//   generations, then the half-pel SAD search of sad_hpel_motion_search,
//   the x86 approximate xy2 average included), the simple intra / inter
//   decision by variance, the scene-change score, ff_get_best_fcode and
//   the long-vector fix; an intra macroblock's vector is zeroed for the
//   next picture's search;
// - rate control as ratecontrol.c's first pass (rc_eq "tex^qComp", the
//   size predictors, qblur, i_quant_factor -0.8, max_qdiff, the lambda to
//   qscale rule), in the same float and double arithmetic;
// - the transform and quantiser of libavcodec's x86 build: ff_fdct_sse2,
//   the SSSE3 dct_quantize (16-bit reciprocals, the inter rounding bias of
//   -1/4), the intra DC through the DC scaler, the pre-quantisation skip
//   of inter blocks;
// - the MB, DC and TCOEF coding of mpeg4videoenc.c (the uni tables that
//   pick the shortest of the VLC and the three escapes).
// Each coded VOP is decoded by csrc/mpeg4.cpp's decoder (which equals
// libavcodec's decoder) to give the reference of the next one, as the
// encoder's own reconstruction does.
//
// The frames come in as BGR24, converted as cv2 converts them
// (csrc/bgr2yuv.cpp).

#include "mpeg4.cpp"
#include "bgr2yuv.cpp"

#include <cmath>

namespace mpeg4 {
namespace enc {

enum { kMaxFcode = 7, kMaxMv = 4096, kMaxDmv = 2 * kMaxMv, kLambdaShift = 7, kQp2Lambda = 118 };
enum { kMapSize = 64, kMapShift = 3, kMapMvBits = 11 };
enum { kCandIntra = 1, kCandInter = 2 };

// ------------------------------------------------------------ bit writer

struct Put {
  std::vector<uint8_t> out;
  uint64_t acc = 0;
  int n = 0;
  void bits(int len, uint32_t v) {
    if (len <= 0) return;
    acc = (acc << len) | (v & (uint32_t)((1ull << len) - 1));
    n += len;
    while (n >= 8) {
      n -= 8;
      out.push_back((uint8_t)(acc >> n));
    }
    acc &= (1ull << n) - 1;
  }
  int64_t count() const { return (int64_t)out.size() * 8 + n; }
  void flush() {  // flush_put_bits: zeros to the byte
    if (n) out.push_back((uint8_t)(acc << (8 - n)));
    acc = 0;
    n = 0;
  }
  void stuffing() {  // ff_mpeg4_stuffing: a 0, then 1s to the byte
    bits(1, 0);
    int len = (int)((-count()) & 7);
    if (len) bits(len, (1u << len) - 1);
  }
  void string(const char* s) {
    for (; *s; ++s) bits(8, (uint8_t)*s);
  }
};

// ---------------------------------------------------------------- tables

static inline int uni_index(int last, int run, int level) {  // level + 64
  return (last * 64 + run) * 128 + level;
}

struct EncTables {
  uint32_t rl_bits[2][2 * 64 * 128];  // [intra, inter]
  uint8_t rl_len[2][2 * 64 * 128];
  uint32_t dc_bits[2][512];
  uint8_t dc_len[2][512];
  uint8_t mv_penalty[kMaxFcode + 1][2 * kMaxDmv + 1];
  uint8_t fcode_tab[2 * kMaxMv + 1];
  int inv_zigzag[64];  // natural index -> zigzag position + 1

  static int rl_index(const Rl& rl, int last, int run, int level) {
    for (int i = last ? rl.last : 0; i < (last ? rl.n : rl.last); ++i)
      if (rl.run[i] == run && rl.level[i] == level) return i;
    return rl.n;
  }

  // init_uni_mpeg4_rl_tab: the shortest of ESC0 (the VLC), ESC1 (level
  // offset), ESC2 (run offset) and ESC3 (fixed length), the first on ties
  void init_rl(int which, const Rl& rl, const uint16_t (*vlc)[2]) {
    for (int slevel = -64; slevel < 64; ++slevel) {
      if (!slevel) continue;
      for (int run = 0; run < 64; ++run)
        for (int last = 0; last <= 1; ++last) {
          const int index = uni_index(last, run, slevel + 64);
          int level = slevel < 0 ? -slevel : slevel, sign = slevel < 0;
          uint32_t& best_bits = rl_bits[which][index];
          uint8_t& best_len = rl_len[which][index];
          best_len = 100;
          int code = rl_index(rl, last, run, level);
          uint32_t bits = vlc[code][0] * 2 + sign;
          int len = vlc[code][1] + 1;
          if (code != rl.n && len < best_len) {
            best_bits = bits;
            best_len = (uint8_t)len;
          }
          // ESC1
          bits = vlc[rl.n][0] * 2;
          len = vlc[rl.n][1] + 1;
          int level1 = level - rl.max_level[last][run];
          if (level1 > 0) {
            code = rl_index(rl, last, run, level1);
            bits <<= vlc[code][1];
            len += vlc[code][1];
            bits += vlc[code][0];
            bits = bits * 2 + sign;
            len++;
            if (code != rl.n && len < best_len) {
              best_bits = bits;
              best_len = (uint8_t)len;
            }
          }
          // ESC2
          bits = vlc[rl.n][0] * 4 + 2;
          len = vlc[rl.n][1] + 2;
          int run1 = run - rl.max_run[last][level] - 1;
          if (run1 >= 0) {
            code = rl_index(rl, last, run1, level);
            bits <<= vlc[code][1];
            len += vlc[code][1];
            bits += vlc[code][0];
            bits = bits * 2 + sign;
            len++;
            if (code != rl.n && len < best_len) {
              best_bits = bits;
              best_len = (uint8_t)len;
            }
          }
          // ESC3
          bits = vlc[rl.n][0] * 4 + 3;
          len = vlc[rl.n][1] + 2;
          bits = bits * 2 + last;
          len++;
          bits = bits * 64 + run;
          len += 6;
          bits = bits * 2 + 1;
          len++;
          bits = bits * 4096 + (slevel & 0xfff);
          len += 12;
          bits = bits * 2 + 1;
          len++;
          if (len < best_len) {
            best_bits = bits;
            best_len = (uint8_t)len;
          }
        }
    }
  }

  EncTables() {
    const Tables& T = tables();
    memset(rl_bits, 0, sizeof rl_bits);
    memset(rl_len, 0, sizeof rl_len);
    init_rl(0, T.intra, kIntraVlc);
    init_rl(1, T.inter, kInterVlc);
    // init_uni_dc_tab
    for (int level = -256; level < 256; ++level) {
      int size = 0, v = std::abs(level);
      while (v) {
        v >>= 1;
        size++;
      }
      int l = level < 0 ? (-level) ^ ((1 << size) - 1) : level;
      for (int c = 0; c < 2; ++c) {
        const uint16_t(*tab)[2] = c ? kDcChrom : kDcLum;
        uint32_t code = tab[size][0];
        int len = tab[size][1];
        if (size > 0) {
          code = (code << size) | (uint32_t)l;
          len += size;
          if (size > 8) {
            code = (code << 1) | 1;
            len++;
          }
        }
        dc_bits[c][level + 256] = code;
        dc_len[c][level + 256] = (uint8_t)len;
      }
    }
    // init_mv_penalty_and_fcode
    memset(mv_penalty, 0, sizeof mv_penalty);
    for (int f = 1; f <= kMaxFcode; ++f)
      for (int mv = -kMaxDmv; mv <= kMaxDmv; ++mv) {
        int len;
        if (mv == 0) {
          len = 1;
        } else {
          int bit_size = f - 1, val = std::abs(mv) - 1;
          int code = (val >> bit_size) + 1;
          if (code < 33)
            len = kMvTab[code][1] + 1 + bit_size;
          else
            len = kMvTab[32][1] + (31 - __builtin_clz((unsigned)(code >> 5))) + 2 + bit_size;
        }
        mv_penalty[f][mv + kMaxDmv] = (uint8_t)len;
      }
    for (int f = kMaxFcode; f > 0; --f)
      for (int mv = -(16 << f); mv < (16 << f); ++mv) fcode_tab[mv + kMaxMv] = (uint8_t)f;
    for (int i = 0; i < 64; ++i) inv_zigzag[kZigzag[i]] = i + 1;
  }
};

static const EncTables& enc_tables() {
  static const EncTables t;
  return t;
}

// ----------------------------------------------------- transform, quant

static inline int16_t s16(int v) { return (int16_t)(v > 32767 ? 32767 : (v < -32768 ? -32768 : v)); }
static inline int16_t mulhi(int16_t a, int16_t b) { return (int16_t)(((int32_t)a * b) >> 16); }
static inline int16_t shl(int16_t a, int n) { return (int16_t)(uint16_t)((uint16_t)a << n); }

// libavcodec's ff_fdct_sse2 (x86/fdct.c): the AP-922 column pass in 16-bit
// saturating arithmetic (tangents and cos(pi/4) as pmulhw constants, the
// 'one_corr' rounding ORs), then the row pass with pmaddwd over the four
// scaled cosine tables, rounded by 1 << 16 and shifted by 17. Natural order
// in and out; the result is 8x the orthonormal DCT.
static void fdct(int16_t* blk) {
  static const int16_t kTg1 = 13036, kTg2 = 27146, kTg3 = -21746, kCos4 = 23170;
  static const int16_t kRowCos[4][7] = {  // c4 c1 c2 c3 c5 c6 c7 of rows 0/4, 1/7, 2/6, 3/5
      {16384, 22725, 21407, 19266, 12873, 8867, 4520},
      {22725, 31521, 29692, 26722, 17855, 12299, 6270},
      {21407, 29692, 27969, 25172, 16819, 11585, 5906},
      {19266, 26722, 25172, 22654, 15137, 10426, 5315}};
  int16_t t[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* x = blk + c;
    int16_t* o = t + c;
    auto X = [&](int k) { return (int)x[8 * k]; };
    int16_t t1 = shl(s16(X(1) + X(6)), 3), t2 = shl(s16(X(2) + X(5)), 3);
    int16_t t0 = shl(s16(X(0) + X(7)), 3), t3 = shl(s16(X(3) + X(4)), 3);
    int16_t d16 = shl(s16(X(1) - X(6)), 4), d25 = shl(s16(X(2) - X(5)), 4);
    int16_t tm12 = s16(t1 - t2), tp12 = s16(t1 + t2), tm03 = s16(t0 - t3), tp03 = s16(t0 + t3);
    o[16] = (int16_t)(s16(tm03 + mulhi(tm12, kTg2)) | 1);
    o[32] = s16(tp03 - tp12);
    o[0] = s16(tp03 + tp12);
    o[48] = (int16_t)(s16(mulhi(tm03, kTg2) - tm12) | 1);
    int16_t a = (int16_t)(mulhi(s16(d16 + d25), kCos4) | 1);
    int16_t b = mulhi(s16(d16 - d25), kCos4);
    int16_t t7 = shl(s16(X(3) - X(4)), 3), t4 = shl(s16(X(0) - X(7)), 3);
    int16_t m1 = s16(t7 + b), m4 = s16(t7 - b), m7 = s16(t4 - a), m3 = s16(t4 + a);
    o[8] = (int16_t)(s16(m3 + mulhi(m1, kTg1)) | 1);
    int16_t m6 = s16(mulhi(m4, kTg3) + m4), m5 = s16(mulhi(m7, kTg3) + m7);
    o[24] = s16(m7 - m6);
    o[40] = s16(m5 + m4);
    o[56] = s16(mulhi(m3, kTg1) - m1);
  }
  for (int r = 0; r < 8; ++r) {
    const int16_t* x = t + 8 * r;
    const int16_t* C = kRowCos[r < 4 ? (r == 0 ? 0 : r) : (r == 4 ? 0 : 8 - r)];
    int s0 = s16(x[0] + x[7]), s1 = s16(x[1] + x[6]), s2 = s16(x[2] + x[5]), s3 = s16(x[3] + x[4]);
    int d0 = s16(x[0] - x[7]), d1 = s16(x[1] - x[6]), d2 = s16(x[2] - x[5]), d3 = s16(x[3] - x[4]);
    int c4 = C[0], c1 = C[1], c2 = C[2], c3 = C[3], c5 = C[4], c6 = C[5], c7 = C[6];
    int y[8];
    y[0] = c4 * (s0 + s1 + s2 + s3);
    y[4] = c4 * (s0 - s1 - s2 + s3);
    y[2] = c2 * (s0 - s3) + c6 * (s1 - s2);
    y[6] = c6 * (s0 - s3) - c2 * (s1 - s2);
    y[1] = c1 * d0 + c3 * d1 + c5 * d2 + c7 * d3;
    y[3] = c3 * d0 - c7 * d1 - c1 * d2 - c5 * d3;
    y[5] = c5 * d0 - c1 * d1 + c7 * d2 + c3 * d3;
    y[7] = c7 * d0 - c5 * d1 + c3 * d2 - c1 * d3;
    for (int k = 0; k < 8; ++k) blk[8 * r + k] = s16((y[k] + 65536) >> 17);
  }
}


// ------------------------------------------------------------ SAD, SSE

static inline int sad16(const uint8_t* a, int as, const uint8_t* b, int bs) {
  int s = 0;
  for (int y = 0; y < 16; ++y, a += as, b += bs)
    for (int x = 0; x < 16; ++x) s += std::abs(a[x] - b[x]);
  return s;
}
static inline int sad8(const uint8_t* a, int as, const uint8_t* b, int bs) {
  int s = 0;
  for (int y = 0; y < 8; ++y, a += as, b += bs)
    for (int x = 0; x < 8; ++x) s += std::abs(a[x] - b[x]);
  return s;
}
static inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
static inline unsigned isqrt(unsigned a) {  // ff_sqrt: floor(sqrt(a))
  unsigned r = (unsigned)std::sqrt((double)a);
  while ((uint64_t)r * r > a) --r;
  while ((uint64_t)(r + 1) * (r + 1) <= a) ++r;
  return r;
}

// ----------------------------------------------------------- encoder

struct Predictor {
  double coeff, count, decay;
};

struct Encoder {
  // configuration
  int width = 0, height = 0, mbw = 0, mbh = 0, mb_num = 0, mb_stride = 0, b8_stride = 0;
  int tb_num = 1, tb_den = 25, time_bits = 1;
  int64_t bit_rate = 0;
  int bit_rate_tolerance = 0;
  bool global_header = false;
  const char* ident = "Lavc62.28.101";
  int gop_size = 12, qmin = 3, qmax = 31, lmin = 2 * kQp2Lambda, lmax = 31 * kQp2Lambda;
  int max_qdiff = 3;
  float qcompress = 0.5f, qblur = 0.5f, i_quant_factor = -0.8f, i_quant_offset = 0.0f;

  // pictures
  int ls = 0, cs = 0;               // source strides (macroblock-aligned)
  std::vector<uint8_t> src[3];      // the input, edges replicated to the macroblocks
  enum { kRefPad = 48 };
  int rs = 0;                       // padded reference luma stride
  std::vector<uint8_t> ref_luma;    // the reference's luma, edges replicated
  const uint8_t* ref0 = nullptr;    // its (0, 0)
  Decoder dec;                      // reconstructs each VOP
  Interp interp;

  // picture state
  int pict_type = kI, no_rounding = 0, qscale = 3, lambda = 0, lambda2 = 0, f_code = 1;
  int64_t picture_number = 0, picture_in_gop = 0;
  int last_pict_type = kI, last_non_b_pict_type = kI;
  int last_lambda_for[5] = {0, 0, 0, 0, 0};
  int y_dc_scale = 8, c_dc_scale = 8;
  int64_t time = 0, last_time_base = 0;

  // motion estimation
  uint32_t map[kMapSize] = {}, score_map[kMapSize] = {};
  uint32_t map_generation = 0;
  std::vector<int16_t> motion_val;  // b8 grid, offset by one entry
  std::vector<int16_t> p_mv;        // (x, y) per macroblock, kept across pictures
  std::vector<uint8_t> mb_type;
  std::vector<int> mb_var, mc_mb_var;
  int64_t mb_var_sum = 0, mc_mb_var_sum = 0;
  int scene_change_score = 0;
  int penalty = 0;
  int pred_x = 0, pred_y = 0, xmin = 0, xmax = 0, ymin = 0, ymax = 0;
  bool skip = false;
  const uint8_t* cur_penalty = nullptr;

  // rate control
  Predictor pred[5];
  double short_term_qsum = 0.001, short_term_qcount = 0.001;
  double pass1_rc_eq_output_sum = 0.001, pass1_wanted_bits = 0.001;
  double last_qscale_for[5];
  int rc_last_non_b = 0;
  double rc_last_qscale = 0;
  int64_t rc_last_mb_var_sum = 0, rc_last_mc_mb_var_sum = 0;
  int64_t total_bits = 0, frame_bits = 0;

  // macroblock coding
  std::vector<int16_t> dc_base;
  int16_t* dc_val[3] = {};
  int mb_x = 0, mb_y = 0, first_slice_line = 1;
  int block_index[6] = {};
  alignas(16) int16_t block[6][64];
  int block_last_index[6] = {};

  Put pb;
  std::vector<uint8_t> header;  // VOS, VO, VOL and user data
  std::vector<uint8_t> packet;
  int key = 0;

  int16_t* motion(int index) { return motion_val.data() + 2 * (index + 1); }
  int16_t* pmv(int xy) { return p_mv.data() + 2 * (xy + mb_stride + 1); }

  void init(int w, int h, int num, int den, int64_t rate, bool global) {
    width = w;
    height = h;
    mbw = (w + 15) / 16;
    mbh = (h + 15) / 16;
    mb_num = mbw * mbh;
    mb_stride = mbw + 1;
    b8_stride = 2 * mbw + 1;
    // "removing common factors from framerate"
    int64_t g = std::__gcd((int64_t)num, (int64_t)den);
    tb_num = (int)(num / g);
    tb_den = (int)(den / g);
    if (tb_den > 65535) throw Error{"a time base denominator over 65535 (MPEG-4's limit)"};
    time_bits = tb_den > 1 ? 32 - __builtin_clz((unsigned)(tb_den - 1)) : 1;
    bit_rate = rate;
    bit_rate_tolerance = (int)std::min<int64_t>(rate, INT32_MAX);  // cv2 sets it to the bit rate
    global_header = global;
    // bitrate tolerance too small for the bit rate: 5 frames' worth
    if (bit_rate * (int64_t)tb_num > (int64_t)bit_rate_tolerance * tb_den)
      bit_rate_tolerance = (int)(5LL * bit_rate * ((double)tb_num / tb_den));
    ls = mbw * 16;
    cs = mbw * 8;
    src[0].assign((size_t)ls * mbh * 16, 0);
    src[1].assign((size_t)cs * mbh * 8, 0);
    src[2].assign((size_t)cs * mbh * 8, 0);
    rs = ls + 2 * kRefPad;
    ref_luma.assign((size_t)rs * (mbh * 16 + 2 * kRefPad), 0);
    ref0 = ref_luma.data() + (size_t)kRefPad * rs + kRefPad;
    motion_val.assign((size_t)(b8_stride * mbh * 2 + 2) * 2, 0);
    p_mv.assign((size_t)((mbh + 2) * mb_stride + 1) * 2, 0);
    mb_type.assign((size_t)mb_stride * mbh, 0);
    mb_var.assign((size_t)mb_stride * mbh, 0);
    mc_mb_var.assign((size_t)mb_stride * mbh, 0);
    int y_size = b8_stride * (2 * mbh + 1), c_size = mb_stride * (mbh + 1);
    dc_base.assign((size_t)(y_size + 2 * c_size), 1024);
    dc_val[0] = dc_base.data() + b8_stride + 1;
    dc_val[1] = dc_base.data() + y_size + mb_stride + 1;
    dc_val[2] = dc_val[1] + c_size;
    for (int i = 0; i < 5; ++i) {
      pred[i] = {kQp2Lambda * 7.0, 1.0, 0.4};
      last_qscale_for[i] = kQp2Lambda * 5;
    }
    f_code = 1;
    // the headers: once as the global header, or before every I-VOP
    Put hp;
    write_vos(hp);
    write_vol(hp);
    hp.flush();
    header = hp.out;
    dec.config(header.data(), header.size(), false);
  }

  // ----------------------------------------------------------- headers

  void write_vos(Put& p) {
    p.bits(16, 0);
    p.bits(16, 0x1B0);
    p.bits(8, 0x01);  // simple profile, level 1
    p.bits(16, 0);
    p.bits(16, 0x1B5);
    p.bits(1, 1);
    p.bits(4, 1);  // visual object verid
    p.bits(3, 1);  // priority
    p.bits(4, 1);  // video object
    p.bits(1, 0);  // no video signal type
    p.stuffing();
  }

  void write_vol(Put& p) {
    p.bits(16, 0);
    p.bits(16, 0x100);
    p.bits(16, 0);
    p.bits(16, 0x120);
    p.bits(1, 0);  // random access
    p.bits(8, 1);  // simple object type
    p.bits(1, 1);  // is_object_layer_identifier
    p.bits(4, 1);  // verid
    p.bits(3, 1);  // priority
    p.bits(4, 1);  // aspect ratio 1:1
    p.bits(1, 1);  // vol control parameters
    p.bits(2, 1);  // 4:2:0
    p.bits(1, 1);  // low delay
    p.bits(1, 0);  // no vbv parameters
    p.bits(2, 0);  // rectangular
    p.bits(1, 1);
    p.bits(16, (uint32_t)tb_den);
    p.bits(1, 1);
    p.bits(1, 0);  // not fixed-rate
    p.bits(1, 1);
    p.bits(13, (uint32_t)width);
    p.bits(1, 1);
    p.bits(13, (uint32_t)height);
    p.bits(1, 1);
    p.bits(1, 0);  // progressive
    p.bits(1, 1);  // obmc disable
    p.bits(1, 0);  // no sprite
    p.bits(1, 0);  // 8 bit
    p.bits(1, 0);  // H.263 quantisation
    p.bits(1, 1);  // complexity estimation disable
    p.bits(1, 1);  // resync marker disable
    p.bits(1, 0);  // no data partitioning
    p.bits(1, 0);  // no scalability
    p.stuffing();
    p.bits(16, 0);
    p.bits(16, 0x1B2);
    p.string(ident);
  }

  void write_gov(Put& p) {
    p.bits(16, 0);
    p.bits(16, 0x1B3);
    int64_t t = time;
    last_time_base = t / tb_den;
    int64_t seconds = t / tb_den, minutes = seconds / 60, hours = minutes / 60;
    seconds %= 60;
    minutes %= 60;
    hours %= 24;
    p.bits(5, (uint32_t)hours);
    p.bits(6, (uint32_t)minutes);
    p.bits(1, 1);
    p.bits(6, (uint32_t)seconds);
    p.bits(1, 0);  // closed_gov
    p.bits(1, 0);  // broken_link
    p.stuffing();
  }

  void write_vop_header(Put& p) {
    if (pict_type == kI) {
      if (!global_header) {
        write_vos(p);
        write_vol(p);
      }
      write_gov(p);
    }
    p.bits(16, 0);
    p.bits(16, 0x1B6);
    p.bits(2, (uint32_t)(pict_type - 1));
    int64_t time_div = time / tb_den, time_mod = time % tb_den;
    int64_t incr = time_div - last_time_base;
    if (incr < 0 || incr > 3600 * 24) throw Error{"a VOP time increment out of range"};
    while (incr--) p.bits(1, 1);
    p.bits(1, 0);
    p.bits(1, 1);
    p.bits(time_bits, (uint32_t)time_mod);
    p.bits(1, 1);
    p.bits(1, 1);  // vop coded
    if (pict_type == kP) p.bits(1, (uint32_t)no_rounding);
    p.bits(3, 0);  // intra_dc_vlc_thr
    p.bits(5, (uint32_t)qscale);
    if (pict_type != kI) p.bits(3, (uint32_t)f_code);
  }

  // ------------------------------------------------------------- input

  void load(const uint8_t* const planes[3], const int64_t strides[3]) {
    for (int c = 0; c < 3; ++c) {
      int w = c ? width / 2 : width, h = c ? height / 2 : height;
      int pw = c ? cs : ls, ph = c ? mbh * 8 : mbh * 16;
      uint8_t* d = src[c].data();
      for (int y = 0; y < ph; ++y) {
        const uint8_t* row = planes[c] + (int64_t)std::min(y, h - 1) * strides[c];
        uint8_t* o = d + (int64_t)y * pw;
        memcpy(o, row, w);
        memset(o + w, row[w - 1], pw - w);
      }
    }
  }

  void load_reference() {
    const Picture& r = *dec.next;
    const int pw = ls, ph = mbh * 16;
    const uint8_t* p = r.plane[0].data();
    for (int y = -kRefPad; y < ph + kRefPad; ++y) {
      const uint8_t* row = p + (int64_t)std::min(std::max(y, 0), ph - 1) * pw;
      uint8_t* o = ref_luma.data() + (int64_t)(y + kRefPad) * rs;
      memset(o, row[0], kRefPad);
      memcpy(o + kRefPad, row, pw);
      memset(o + kRefPad + pw, row[pw - 1], kRefPad);
    }
  }

  // ------------------------------------------------------------ motion

  static int pix_sum(const uint8_t* p, int stride) {
    int s = 0;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) s += p[y * stride + x];
    return s;
  }
  static int pix_norm1(const uint8_t* p, int stride) {
    int s = 0;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x) s += p[y * stride + x] * p[y * stride + x];
    return s;
  }

  int cmp_full(const uint8_t* srcp, int x, int y) const {
    return sad16(srcp, ls, ref0 + (int64_t)(mb_y * 16 + y) * rs + mb_x * 16 + x, rs);
  }

  // CHECK_MV: a full-pel candidate through the score map
  void check_mv(const uint8_t* s, int x, int y, int& dmin, int* best, int* dir = nullptr,
                int new_dir = -1) {
    const uint32_t key = ((uint32_t)y << kMapMvBits) + (uint32_t)x + map_generation;
    const int index = (int)((((uint32_t)y << kMapShift) + (uint32_t)x) & (kMapSize - 1));
    if (map[index] == key) return;
    int d = cmp_full(s, x, y);
    map[index] = key;
    score_map[index] = (uint32_t)d;
    d += (cur_penalty[x * 2 - pred_x] + cur_penalty[y * 2 - pred_y]) * penalty;
    if (d < dmin) {
      best[0] = x;
      best[1] = y;
      dmin = d;
      if (dir) *dir = new_dir;
    }
  }
  void check_clipped(const uint8_t* s, int x, int y, int& dmin, int* best) {
    check_mv(s, std::max(xmin, std::min(x, xmax)), std::max(ymin, std::min(y, ymax)), dmin, best);
  }

  // ff_estimate_p_frame_motion with the default (simple) mb decision
  void estimate_mb() {
    const int xy = mb_x + mb_y * mb_stride;
    const uint8_t* pix = src[0].data() + (int64_t)mb_y * 16 * ls + mb_x * 16;
    const int x = 16 * mb_x, y = 16 * mb_y;
    xmin = std::max(-x - 16, -2048);
    ymin = std::max(-y - 16, -2048);
    xmax = std::min(-x + width, 2048);
    ymax = std::min(-y + height, 2048);
    skip = false;
    int sum = pix_sum(pix, ls);
    int varc = pix_norm1(pix, ls) - (int)(((unsigned)sum * sum) >> 8) + 500;
    mb_var[xy] = (varc + 128) >> 8;
    mb_var_sum += (varc + 128) >> 8;

    const int mot_xy = b8_stride * (mb_y * 2) + mb_x * 2;
    int P_LEFT[2], P_TOP[2] = {0, 0}, P_TR[2] = {0, 0}, P_MED[2] = {0, 0};
    P_LEFT[0] = motion(mot_xy - 1)[0];
    P_LEFT[1] = motion(mot_xy - 1)[1];
    if (P_LEFT[0] > (xmax << 1)) P_LEFT[0] = xmax << 1;
    if (!first_slice_line) {
      P_TOP[0] = motion(mot_xy - b8_stride)[0];
      P_TOP[1] = motion(mot_xy - b8_stride)[1];
      P_TR[0] = motion(mot_xy - b8_stride + 2)[0];
      P_TR[1] = motion(mot_xy - b8_stride + 2)[1];
      if (P_TOP[1] > (ymax << 1)) P_TOP[1] = ymax << 1;
      if (P_TR[0] < (xmin * 2)) P_TR[0] = xmin * 2;
      if (P_TR[1] > (ymax * 2)) P_TR[1] = ymax * 2;
      P_MED[0] = mid_pred(P_LEFT[0], P_TOP[0], P_TR[0]);
      P_MED[1] = mid_pred(P_LEFT[1], P_TOP[1], P_TR[1]);
      pred_x = P_MED[0];
      pred_y = P_MED[1];
    } else {
      pred_x = P_LEFT[0];
      pred_y = P_LEFT[1];
    }

    // epzs_motion_search_internal
    int best[2] = {0, 0}, mx = 0, my = 0;
    map_generation += 1u << (kMapMvBits * 2);
    if (map_generation == 0) {
      map_generation = 1u << (kMapMvBits * 2);
      memset(map, 0, sizeof map);
    }
    int dmin = cmp_full(pix, 0, 0);
    map[0] = map_generation;
    score_map[0] = (uint32_t)dmin;
    auto last_mv = [&](int d, int c) { return (pmv(xy + d)[c] * 32768 + (1 << 15)) >> 16; };
    bool early = false;
    if (first_slice_line) {
      check_mv(pix, P_LEFT[0] >> 1, P_LEFT[1] >> 1, dmin, best);
      check_clipped(pix, last_mv(0, 0), last_mv(0, 1), dmin, best);
    } else {
      if (dmin < ((16 * 16 * 256) >> 8) &&
          (P_LEFT[0] | P_LEFT[1] | P_TOP[0] | P_TOP[1] | P_TR[0] | P_TR[1]) == 0) {
        skip = true;
        early = true;
      } else {
        check_mv(pix, P_MED[0] >> 1, P_MED[1] >> 1, dmin, best);
        check_clipped(pix, P_MED[0] >> 1, (P_MED[1] >> 1) - 1, dmin, best);
        check_clipped(pix, P_MED[0] >> 1, (P_MED[1] >> 1) + 1, dmin, best);
        check_clipped(pix, (P_MED[0] >> 1) - 1, P_MED[1] >> 1, dmin, best);
        check_clipped(pix, (P_MED[0] >> 1) + 1, P_MED[1] >> 1, dmin, best);
        check_clipped(pix, last_mv(0, 0), last_mv(0, 1), dmin, best);
        check_mv(pix, P_LEFT[0] >> 1, P_LEFT[1] >> 1, dmin, best);
        check_mv(pix, P_TOP[0] >> 1, P_TOP[1] >> 1, dmin, best);
        check_mv(pix, P_TR[0] >> 1, P_TR[1] >> 1, dmin, best);
      }
    }
    if (!early) {
      if (dmin > 16 * 16 * 4) {
        check_clipped(pix, last_mv(1, 0), last_mv(1, 1), dmin, best);
        if (mb_y + 1 < mbh) check_clipped(pix, last_mv(mb_stride, 0), last_mv(mb_stride, 1), dmin, best);
      }
      // small_diamond_search
      {
        const uint32_t key = ((uint32_t)best[1] << kMapMvBits) + (uint32_t)best[0] + map_generation;
        const int index = (int)((((uint32_t)best[1] << kMapShift) + (uint32_t)best[0]) & (kMapSize - 1));
        if (map[index] != key) {
          score_map[index] = (uint32_t)cmp_full(pix, best[0], best[1]);
          map[index] = key;
        }
      }
      int next_dir = -1;
      for (;;) {
        const int dir = next_dir, bx = best[0], by = best[1];
        next_dir = -1;
        if (dir != 2 && bx > xmin) check_mv(pix, bx - 1, by, dmin, best, &next_dir, 0);
        if (dir != 3 && by > ymin) check_mv(pix, bx, by - 1, dmin, best, &next_dir, 1);
        if (dir != 0 && bx < xmax) check_mv(pix, bx + 1, by, dmin, best, &next_dir, 2);
        if (dir != 1 && by < ymax) check_mv(pix, bx, by + 1, dmin, best, &next_dir, 3);
        if (next_dir == -1) break;
      }
      mx = best[0];
      my = best[1];
    }

    const uint8_t* ppix = ref0 + (int64_t)(y + my) * rs + x + mx;
    int vard = 0;
    for (int r = 0; r < 16; ++r)
      for (int c = 0; c < 16; ++c) {
        int d = pix[r * ls + c] - ppix[r * rs + c];
        vard += d * d;
      }
    mc_mb_var[xy] = (vard + 128) >> 8;
    mc_mb_var_sum += (vard + 128) >> 8;

    // sad_hpel_motion_search
    if (!skip) {
      const uint8_t* ptr = ppix;
      int dminh = dmin;
      if (mx > xmin && mx < xmax && my > ymin && my < ymax) {
        int dx = 0, dy = 0;
        const int index = my * (1 << kMapShift) + mx;
        const int t = (int)score_map[(index - (1 << kMapShift)) & (kMapSize - 1)];
        const int l = (int)score_map[(index - 1) & (kMapSize - 1)];
        const int r = (int)score_map[(index + 1) & (kMapSize - 1)];
        const int b = (int)score_map[(index + (1 << kMapShift)) & (kMapSize - 1)];
        mx += mx;
        my += my;
        // libavcodec's sad_hpel_motion_search indexes the penalty at the
        // vector plus the prediction (not less it)
        const int pen_x = pred_x + mx, pen_y = pred_y + my;
        auto half = [&](int hx, int hy) {
          int dxy = (hx ? 1 : 0) + (hy ? 2 : 0);
          int d = sad_hpel_at(pix, ptr + (hx >> 1), dxy);
          d += (cur_penalty[pen_x + hx] + cur_penalty[pen_y + hy]) * penalty;
          if (d < dminh) {
            dminh = d;
            dx = hx;
            dy = hy;
          }
        };
        ptr -= rs;
        if (t <= b) {
          half(0, -1);
          if (l <= r) {
            half(-1, -1);
            if (t + r <= b + l) {
              half(+1, -1);
              ptr += rs;
            } else {
              ptr += rs;
              half(-1, +1);
            }
            half(-1, 0);
          } else {
            half(+1, -1);
            if (t + l <= b + r) {
              half(-1, -1);
              ptr += rs;
            } else {
              ptr += rs;
              half(+1, +1);
            }
            half(+1, 0);
          }
        } else {
          if (l <= r) {
            if (t + l <= b + r) {
              half(-1, -1);
              ptr += rs;
            } else {
              ptr += rs;
              half(+1, +1);
            }
            half(-1, 0);
            half(-1, +1);
          } else {
            if (t + r <= b + l) {
              half(+1, -1);
              ptr += rs;
            } else {
              ptr += rs;
              half(-1, +1);
            }
            half(+1, 0);
            half(+1, +1);
          }
          half(0, +1);
        }
        mx += dx;
        my += dy;
      } else {
        mx += mx;
        my += my;
      }
      dmin = dminh;
    }

    // set_p_mv_tables
    pmv(xy)[0] = (int16_t)mx;
    pmv(xy)[1] = (int16_t)my;
    for (int d : {0, 1, b8_stride, b8_stride + 1}) {
      motion(mot_xy + d)[0] = (int16_t)mx;
      motion(mot_xy + d)[1] = (int16_t)my;
    }

    // intra luma score: SAD against the mean
    unsigned mean = (unsigned)(sum + 128) >> 8;
    int intra_score = 0;
    for (int r = 0; r < 16; ++r)
      for (int c = 0; c < 16; ++c) intra_score += std::abs((int)pix[r * ls + c] - (int)mean);
    intra_score += penalty * 16;
    mb_type[xy] = intra_score < dmin ? kCandIntra : kCandInter;

    int p_score = std::min(vard, varc - 500 + (lambda2 >> kLambdaShift) * 100);
    int i_score = varc - 500 + (lambda2 >> kLambdaShift) * 20;
    scene_change_score += (int)isqrt((unsigned)p_score) - (int)isqrt((unsigned)i_score);
  }

  // pix_abs[0][dxy]: the SAD of the source macroblock against a half-pel
  // average of the reference at p (x2 and y2 as pavgb; xy2 as libavcodec's
  // non-bitexact ff_sad16_approx_xy2_sse2, read from the bundled library's
  // code: the pavgb horizontal averages of two reference rows, the one of
  // odd index from the block's top less one (psubusb, saturating at 0),
  // averaged again with pavgb; the writer case "xy2" of
  // tests/torch_mpeg4_scenes.py fails with the even row or the lower row
  // decremented instead)
  int sad_hpel_at(const uint8_t* pix, const uint8_t* p, int dxy) const {
    int s = 0;
    if (dxy == 1 || dxy == 2) {
      const int step = dxy == 1 ? 1 : rs;
      for (int yy = 0; yy < 16; ++yy, pix += ls, p += rs)
        for (int xx = 0; xx < 16; ++xx) s += std::abs(pix[xx] - avg2(p[xx], p[xx + step]));
      return s;
    }
    for (int yy = 0; yy < 16; ++yy, pix += ls, p += rs) {
      const uint8_t* q = p + rs;
      for (int xx = 0; xx < 16; ++xx) {
        int h0 = avg2(p[xx], p[xx + 1]), h1 = avg2(q[xx], q[xx + 1]);
        if (yy & 1)
          h0 = h0 ? h0 - 1 : 0;
        else
          h1 = h1 ? h1 - 1 : 0;
        s += std::abs(pix[xx] - avg2(h0, h1));
      }
    }
    return s;
  }

  void mb_var_pass() {  // mb_var_thread (I-VOPs)
    for (mb_y = 0; mb_y < mbh; ++mb_y)
      for (mb_x = 0; mb_x < mbw; ++mb_x) {
        const uint8_t* pix = src[0].data() + (int64_t)mb_y * 16 * ls + mb_x * 16;
        int sum = pix_sum(pix, ls);
        int varc = (pix_norm1(pix, ls) - (int)(((unsigned)sum * sum) >> 8) + 500 + 128) >> 8;
        mb_var[mb_x + mb_y * mb_stride] = varc;
        mb_var_sum += varc;
      }
  }

  int best_fcode() {  // ff_get_best_fcode
    const EncTables& T = enc_tables();
    int score[8];
    for (int i = 0; i < 8; ++i) score[i] = mb_num * (8 - i);
    for (int y = 0; y < mbh; ++y)
      for (int x = 0; x < mbw; ++x) {
        int xy = x + y * mb_stride;
        if (!(mb_type[xy] & kCandInter)) continue;
        int mx = pmv(xy)[0], my = pmv(xy)[1];
        int fc = std::max(T.fcode_tab[mx + kMaxMv], T.fcode_tab[my + kMaxMv]);
        for (int j = 0; j < fc && j < 8; ++j)
          if (mc_mb_var[xy] < mb_var[xy]) score[j] -= 170;
      }
    int best = -1, best_score = -10000000;
    for (int i = 1; i < 8; ++i)
      if (score[i] > best_score) {
        best_score = score[i];
        best = i;
      }
    return best;
  }

  void fix_long_mvs() {  // ff_fix_long_mvs on the 16x16 vectors: out of range -> intra
    const int range = 16 << f_code;
    for (int y = 0; y < mbh; ++y)
      for (int x = 0; x < mbw; ++x) {
        int xy = x + y * mb_stride;
        if (!(mb_type[xy] & kCandInter)) continue;
        int16_t* v = pmv(xy);
        if (v[0] >= range || v[0] < -range || v[1] >= range || v[1] < -range) {
          mb_type[xy] = (uint8_t)((mb_type[xy] & ~kCandInter) | kCandIntra);
          v[0] = v[1] = 0;
        }
      }
  }

  // --------------------------------------------------------- rate control

  double fps() const { return 1.0 / ((double)tb_num / tb_den); }

  void qminmax(int type, int* qmn, int* qmx) const {
    int a = lmin, b = lmax;
    if (type == kI) {
      a = (int)(a * std::fabs(i_quant_factor) + i_quant_offset + 0.5);
      b = (int)(b * std::fabs(i_quant_factor) + i_quant_offset + 0.5);
    }
    a = std::min(std::max(a, 1), 256 * 128 - 1);
    b = std::min(std::max(b, 1), 256 * 128 - 1);
    if (b < a) b = a;
    *qmn = a;
    *qmx = b;
  }

  static double predict_size(const Predictor& p, double q, double var) {
    return p.coeff * var / (q * p.count);
  }
  static void update_predictor(Predictor& p, double q, double var, double size) {
    double new_coeff = size * q / (var + 1);
    if (var < 10) return;
    p.count *= p.decay;
    p.coeff *= p.decay;
    p.count++;
    p.coeff += new_coeff;
  }

  int estimate_qscale(int64_t pts) {  // ff_rate_estimate_qscale (first pass)
    int qmn, qmx;
    qminmax(pict_type, &qmn, &qmx);
    const double fps_ = fps();
    if (picture_number > 2) {
      const int64_t last_var = last_pict_type == kI ? rc_last_mb_var_sum : rc_last_mc_mb_var_sum;
      update_predictor(pred[last_pict_type], rc_last_qscale, std::sqrt((double)last_var),
                       (double)frame_bits);
    }
    int64_t wanted_bits = (int64_t)(uint64_t)(bit_rate * (double)pts / fps_);
    double diff = (double)(total_bits - wanted_bits);
    float br_compensation = (float)((bit_rate_tolerance - diff) / bit_rate_tolerance);
    if (br_compensation <= 0.0) br_compensation = 0.001f;
    const int64_t var = pict_type == kI ? mb_var_sum : mc_mb_var_sum;
    const float rce_qscale = kQp2Lambda * 2;
    double bits = predict_size(pred[pict_type], rce_qscale, std::sqrt((double)var));
    int i_tex = 0, p_tex = 0;
    if (pict_type == kI)
      i_tex = (int)bits;
    else
      p_tex = (int)(bits * 0.9);
    double rate_factor = pass1_wanted_bits / pass1_rc_eq_output_sum * br_compensation;

    // get_qscale
    double tex = (i_tex + p_tex) * (double)rce_qscale;
    double eq = std::pow(tex, (double)qcompress);
    pass1_rc_eq_output_sum += eq;
    eq *= rate_factor;
    if (eq < 0.0) eq = 0.0;
    eq += 1.0;
    double qd = rce_qscale * (double)(i_tex + p_tex + 1) / eq;
    if (pict_type == kI && i_quant_factor < 0.0) qd = -qd * i_quant_factor + i_quant_offset;
    if (qd < 1) qd = 1;
    float q = (float)qd;

    // get_diff_limited_q
    {
      double qq = q;
      const double last_p_q = last_qscale_for[kP];
      if (pict_type == kI && (i_quant_factor > 0.0 || rc_last_non_b == kP))
        qq = last_p_q * std::fabs(i_quant_factor) + i_quant_offset;
      if (qq < 1) qq = 1;
      if (rc_last_non_b == pict_type || pict_type != kI) {
        double last_q = last_qscale_for[pict_type];
        const int maxdiff = kQp2Lambda * max_qdiff;
        if (qq > last_q + maxdiff)
          qq = last_q + maxdiff;
        else if (qq < last_q - maxdiff)
          qq = last_q - maxdiff;
      }
      last_qscale_for[pict_type] = qq;
      rc_last_non_b = pict_type;
      q = (float)qq;
    }
    if (pict_type == kP) {
      short_term_qsum *= qblur;
      short_term_qcount *= qblur;
      short_term_qsum += q;
      short_term_qcount++;
      q = (float)(short_term_qsum / short_term_qcount);
    }
    // modify_qscale: no buffer, no squish
    {
      double qq = q;
      if (qq < qmn)
        qq = qmn;
      else if (qq > qmx)
        qq = qmx;
      q = (float)qq;
    }
    pass1_wanted_bits += bit_rate / fps_;
    if (q < qmn)
      q = (float)qmn;
    else if (q > qmx)
      q = (float)qmx;
    q = (float)(int)(q + 0.5);
    rc_last_qscale = q;
    rc_last_mc_mb_var_sum = mc_mb_var_sum;
    rc_last_mb_var_sum = mb_var_sum;
    return (int)q;
  }

  void update_qscale() {
    qscale = (lambda * 139 + 128 * 64) >> (kLambdaShift + 7);
    qscale = std::min(std::max(qscale, qmin), qmax);
    lambda2 = (lambda * lambda + 64) >> kLambdaShift;
  }

  // ------------------------------------------------------------ coding

  void init_block_index() {
    block_index[0] = b8_stride * (mb_y * 2) + mb_x * 2;
    block_index[1] = block_index[0] + 1;
    block_index[2] = block_index[0] + b8_stride;
    block_index[3] = block_index[2] + 1;
    block_index[4] = block_index[5] = mb_y * mb_stride + mb_x;
  }
  int16_t* dc_ptr(int n) { return (n < 4 ? dc_val[0] : dc_val[n - 3]) + block_index[n]; }

  // ff_mpeg4_pred_dc (encoding): the DC level less its prediction
  int pred_dc(int n, int level) {
    int scale = n < 4 ? y_dc_scale : c_dc_scale;
    int wr = n < 4 ? b8_stride : mb_stride;
    int16_t* dv = dc_ptr(n);
    int a = dv[-1], b = dv[-1 - wr], c = dv[-wr];
    if (first_slice_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == 0) b = a = 1024;
    }
    if (mb_x == 0 && mb_y == 1) {
      if (n == 0 || n == 4 || n == 5) b = 1024;
    }
    int p = std::abs(a - b) < std::abs(b - c) ? c : a;
    p = (p + (scale >> 1)) / scale;
    int ret = level - p;
    level *= scale;
    if (level & ~2047) level = level < 0 ? 0 : 2047;
    dv[0] = (int16_t)level;
    return ret;
  }

  void clean_intra() {
    int w = b8_stride, xy = block_index[0];
    for (int d : {0, 1, w, w + 1}) dc_val[0][xy + d] = 1024;
    int c = mb_x + mb_y * mb_stride;
    dc_val[1][c] = dc_val[2][c] = 1024;
  }

  // the x86 dct_quantize (H.263 quantisation): returns the last index
  int quantize(int16_t* blk, int n, bool intra) {
    const int* inv_zigzag = enc_tables().inv_zigzag;
    fdct(blk);
    const int qmat = std::min((2 << 16) / (2 * qscale * 16), 128 * 256 - 1);  // qscale2 = 2q
    int bias = 0, last = 0;
    if (intra) {
      int q = n < 4 ? y_dc_scale : c_dc_scale;
      int level = ((blk[0] >> 2) + q) / (2 * q);
      blk[0] = 0;
      last = 1;
      for (int i = 1; i < 64; ++i) {
        int v = blk[i];
        int a = std::abs(v);
        int l = (a * qmat) >> 16;
        blk[i] = (int16_t)(v < 0 ? -l : l);
        if (l) last = std::max(last, inv_zigzag[i]);
      }
      blk[0] = (int16_t)level;
      return last - 1;
    }
    {
      int b = -(1 << (8 - 2));  // inter_quant_bias
      int num = b * (1 << (16 - 8));
      bias = num >= 0 ? (num + (qmat >> 1)) / qmat : (num - (qmat >> 1)) / qmat;
    }
    const int sub = (-bias) & 0xFFFF;
    for (int i = 0; i < 64; ++i) {
      int v = blk[i];
      int a = std::abs(v);
      a = a > sub ? a - sub : 0;
      int l = (a * qmat) >> 16;
      blk[i] = (int16_t)(v < 0 ? -l : l);
      if (l) last = std::max(last, inv_zigzag[i]);
    }
    return last - 1;
  }

  void get_blocks(int16_t (*blk)[64]) {
    for (int i = 0; i < 6; ++i) {
      int c = i < 4 ? 0 : i - 3;
      const uint8_t* p;
      int st;
      if (c) {
        st = cs;
        p = src[c].data() + (int64_t)mb_y * 8 * cs + mb_x * 8;
      } else {
        st = ls;
        p = src[0].data() + (int64_t)(mb_y * 16 + (i >> 1) * 8) * ls + mb_x * 16 + (i & 1) * 8;
      }
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) blk[i][8 * y + x] = p[y * st + x];
    }
  }

  void encode_block(const int16_t* blk, int n, int dc_diff, bool intra) {
    const EncTables& T = enc_tables();
    const int last_index = block_last_index[n];
    int i;
    const uint32_t* bits_tab;
    const uint8_t* len_tab;
    if (intra) {
      int c = n < 4 ? 0 : 1;
      pb.bits(T.dc_len[c][dc_diff + 256], T.dc_bits[c][dc_diff + 256]);
      if (last_index < 1) return;
      i = 1;
      bits_tab = T.rl_bits[0];
      len_tab = T.rl_len[0];
    } else {
      if (last_index < 0) return;
      i = 0;
      bits_tab = T.rl_bits[1];
      len_tab = T.rl_len[1];
    }
    int last_non_zero = i - 1;
    for (; i < last_index; ++i) {
      int level = blk[kZigzag[i]];
      if (level) {
        int run = i - last_non_zero - 1;
        level += 64;
        if ((level & ~127) == 0) {
          const int index = uni_index(0, run, level);
          pb.bits(len_tab[index], bits_tab[index]);
        } else {
          pb.bits(30, (3u << 23) + (3u << 21) + (0u << 20) + ((uint32_t)run << 14) + (1u << 13) +
                          ((uint32_t)((level - 64) & 0xfff) << 1) + 1);
        }
        last_non_zero = i;
      }
    }
    int level = blk[kZigzag[i]];
    int run = i - last_non_zero - 1;
    level += 64;
    if ((level & ~127) == 0) {
      const int index = uni_index(1, run, level);
      pb.bits(len_tab[index], bits_tab[index]);
    } else {
      pb.bits(30, (3u << 23) + (3u << 21) + (1u << 20) + ((uint32_t)run << 14) + (1u << 13) +
                      ((uint32_t)((level - 64) & 0xfff) << 1) + 1);
    }
  }

  // ff_h263_pred_motion for block 0 on one slice
  void pred_motion(int* px, int* py) {
    const int xy = block_index[0];
    int16_t* A = motion(xy - 1);
    if (first_slice_line) {
      if (mb_x == 0) {
        *px = *py = 0;
      } else {
        *px = A[0];
        *py = A[1];
      }
      return;
    }
    int16_t* B = motion(xy - b8_stride);
    int16_t* C = motion(xy + 2 - b8_stride);
    *px = mid_pred(A[0], B[0], C[0]);
    *py = mid_pred(A[1], B[1], C[1]);
  }

  void encode_motion(int val) {  // ff_h263_encode_motion
    if (val == 0) {
      pb.bits(1, 1);
      return;
    }
    int bit_size = f_code - 1, range = 1 << bit_size;
    int bits = 6 + bit_size;
    val = (int)((uint32_t)val << (32 - bits)) >> (32 - bits);
    int sign = val < 0;
    val = std::abs(val);
    val--;
    int code = (val >> bit_size) + 1;
    int b = val & (range - 1);
    pb.bits(kMvTab[code][1] + 1, (uint32_t)((kMvTab[code][0] << 1) | sign));
    if (bit_size > 0) pb.bits(bit_size, (uint32_t)b);
  }

  void set_motion(int mx, int my) {
    const int xy = block_index[0];
    for (int d : {0, 1, b8_stride, b8_stride + 1}) {
      motion(xy + d)[0] = (int16_t)mx;
      motion(xy + d)[1] = (int16_t)my;
    }
  }

  void encode_intra_mb() {
    get_blocks(block);
    int dc_diff[6];
    for (int i = 0; i < 6; ++i) block_last_index[i] = quantize(block[i], i, true);
    for (int i = 0; i < 6; ++i) dc_diff[i] = pred_dc(i, block[i][0]);
    int cbp = 0;
    for (int i = 0; i < 6; ++i)
      if (block_last_index[i] >= 1) cbp |= 1 << (5 - i);
    int cbpc = cbp & 3;
    if (pict_type == kI) {
      pb.bits(kIntraMcbpcBits[cbpc], kIntraMcbpcCode[cbpc]);
    } else {
      pb.bits(1, 0);
      pb.bits(kInterMcbpcBits[cbpc + 4], kInterMcbpcCode[cbpc + 4]);
    }
    pb.bits(1, 0);  // ac_pred
    int cbpy = cbp >> 2;
    pb.bits(kCbpyTab[cbpy][1], kCbpyTab[cbpy][0]);
    for (int i = 0; i < 6; ++i) encode_block(block[i], i, dc_diff[i], true);
    set_motion(0, 0);
  }

  void encode_inter_mb(int mx, int my) {
    // the prediction, as ff_mpv_motion writes it
    uint8_t pred[3][256];
    const Picture& ref = *dec.next;
    const Op op = no_rounding ? kPutNoRnd : kPut;
    {
      int dxy = ((my & 1) << 1) | (mx & 1);
      int x = mb_x * 16 + (mx >> 1), y = mb_y * 16 + (my >> 1);
      Patch p;
      p.fetch(ref.plane[0].data(), ref.stride(0), mbw * 16, mbh * 16, x, y, 17, 17);
      interp.hpel(pred[0], 16, p.px, p.stride, 16, 16, dxy, op);
      int uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      for (int c = 1; c < 3; ++c) {
        Patch q;
        q.fetch(ref.plane[c].data(), ref.stride(c), mbw * 8, mbh * 8, x >> 1, y >> 1, 9, 9);
        interp.hpel(pred[c], 8, q.px, q.stride, 8, 8, uvdxy, op);
      }
    }
    bool skip_dct[6] = {};
    const int xy = mb_x + mb_y * mb_stride;
    const uint8_t* sy = src[0].data() + (int64_t)mb_y * 16 * ls + mb_x * 16;
    const uint8_t* sc[2] = {src[1].data() + (int64_t)mb_y * 8 * cs + mb_x * 8,
                            src[2].data() + (int64_t)mb_y * 8 * cs + mb_x * 8};
    if (mc_mb_var[xy] < 2 * qscale * qscale) {
      for (int i = 0; i < 4; ++i) {
        int off = (i >> 1) * 8, offx = (i & 1) * 8;
        skip_dct[i] = sad8(sy + off * ls + offx, ls, pred[0] + off * 16 + offx, 16) < 20 * qscale;
      }
      skip_dct[4] = sad8(sc[0], cs, pred[1], 8) < 20 * qscale;
      skip_dct[5] = sad8(sc[1], cs, pred[2], 8) < 20 * qscale;
    }
    for (int i = 0; i < 6; ++i) {
      if (i < 4) {
        int off = (i >> 1) * 8, offx = (i & 1) * 8;
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            block[i][8 * y + x] =
                (int16_t)(sy[(off + y) * ls + offx + x] - pred[0][(off + y) * 16 + offx + x]);
      } else {
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x)
            block[i][8 * y + x] = (int16_t)(sc[i - 4][y * cs + x] - pred[i - 3][y * 8 + x]);
      }
      block_last_index[i] = skip_dct[i] ? -1 : quantize(block[i], i, false);
    }
    int cbp = 0;
    for (int i = 0; i < 6; ++i)
      if (block_last_index[i] >= 0) cbp |= 1 << (5 - i);
    if ((cbp | mx | my) == 0) {
      pb.bits(1, 1);  // not coded
      set_motion(0, 0);
      return;
    }
    pb.bits(1, 0);
    int cbpc = cbp & 3, cbpy = (cbp >> 2) ^ 0xf;
    pb.bits(kInterMcbpcBits[cbpc], kInterMcbpcCode[cbpc]);
    pb.bits(kCbpyTab[cbpy][1], kCbpyTab[cbpy][0]);
    int px, py;
    pred_motion(&px, &py);
    encode_motion(mx - px);
    encode_motion(my - py);
    for (int i = 0; i < 6; ++i) encode_block(block[i], i, 0, false);
    set_motion(mx, my);
  }

  // --------------------------------------------------------- a picture

  void encode_picture(int64_t pts) {
    time = pts * tb_num;
    mb_var_sum = mc_mb_var_sum = 0;
    scene_change_score = 0;
    // picture type: an I-VOP first and every gop_size pictures
    pict_type = (picture_number == 0 || picture_in_gop >= gop_size) ? kI : kP;
    if (pict_type == kI)
      no_rounding = 0;
    else
      no_rounding ^= 1;
    if (pict_type == kP) {
      lambda = last_lambda_for[last_non_b_pict_type];
      update_qscale();
      load_reference();
      penalty = lambda >> kLambdaShift;
      cur_penalty = enc_tables().mv_penalty[f_code] + kMaxDmv;
      first_slice_line = 1;
      for (mb_y = 0; mb_y < mbh; ++mb_y) {
        for (mb_x = 0; mb_x < mbw; ++mb_x) estimate_mb();
        first_slice_line = 0;
      }
      if (scene_change_score > 0) {
        pict_type = kI;
        for (auto& t : mb_type) t = kCandIntra;
      }
    } else {
      mb_var_pass();
    }
    if (pict_type == kP) {
      f_code = best_fcode();
      fix_long_mvs();
    }
    lambda = estimate_qscale(pts);
    update_qscale();
    if (pict_type == kI) picture_in_gop = 0;
    y_dc_scale = kYDcScale[qscale];
    c_dc_scale = kCDcScale[qscale];

    pb = Put();
    write_vop_header(pb);
    last_time_base = time / tb_den;
    first_slice_line = 1;
    for (mb_y = 0; mb_y < mbh; ++mb_y) {
      for (mb_x = 0; mb_x < mbw; ++mb_x) {
        init_block_index();
        if (mb_x == 0 && mb_y == 1) first_slice_line = 0;
        const int xy = mb_x + mb_y * mb_stride;
        if (pict_type == kI || (mb_type[xy] & kCandIntra)) {
          // an intra macroblock leaves no vector for the next picture's search
          pmv(xy)[0] = pmv(xy)[1] = 0;
          encode_intra_mb();
        } else {
          encode_inter_mb(pmv(xy)[0], pmv(xy)[1]);
          clean_intra();
        }
      }
    }
    pb.stuffing();
    pb.flush();
    packet = pb.out;
    key = pict_type == kI;
    frame_bits = (int64_t)packet.size() * 8;
    total_bits += frame_bits;
    last_pict_type = pict_type;
    last_lambda_for[pict_type] = lambda;
    last_non_b_pict_type = pict_type;
    ++picture_in_gop;
    ++picture_number;
    // the reconstruction: the decoder's picture
    std::vector<uint8_t> vop = packet;
    dec.decode(vop.data(), vop.size(), pts, false);
    dec.output.clear();
  }
};

struct Handle {
  Encoder enc;
  std::string error;
};

}  // namespace enc
}  // namespace mpeg4

extern "C" {

// An encoder of width x height (even) pictures at the time base num/den
// (seconds per tick) and bit_rate; global_header puts the VOS / VOL headers
// in mpeg4enc_header (mp4, mov, m4v) instead of in every I-VOP (AVI).
void* mpeg4enc_new(int width, int height, int num, int den, int64_t bit_rate, int global_header) {
  auto* h = new mpeg4::enc::Handle();
  try {
    h->enc.init(width, height, num, den, bit_rate, global_header != 0);
  } catch (const mpeg4::Error& e) {
    h->error = e.what;
  }
  return h;
}

void mpeg4enc_free(void* h) { delete (mpeg4::enc::Handle*)h; }

const char* mpeg4enc_error(void* h) { return ((mpeg4::enc::Handle*)h)->error.c_str(); }

// The VOS, VO, VOL and user data headers (the esds decoder config).
int64_t mpeg4enc_header(void* hp, uint8_t* out, int64_t cap) {
  auto& e = ((mpeg4::enc::Handle*)hp)->enc;
  if (out) memcpy(out, e.header.data(), std::min<int64_t>(cap, (int64_t)e.header.size()));
  return (int64_t)e.header.size();
}

// Encode one BGR24 frame (at least width x height, rows of `stride`
// bytes; an odd last column or row is not read) at pts (in time base
// ticks). Returns the packet's size, or -1 with mpeg4enc_error set.
int64_t mpeg4enc_encode_bgr(void* hp, const uint8_t* bgr, int64_t stride, int64_t pts) {
  auto* h = (mpeg4::enc::Handle*)hp;
  auto& e = h->enc;
  if (!h->error.empty()) return -1;
  try {
    std::vector<uint8_t> y((size_t)e.width * e.height), u((size_t)e.width * e.height / 4),
        v((size_t)e.width * e.height / 4);
    bgr2yuv::convert(bgr, stride, e.width, e.height, y.data(), e.width, u.data(), v.data(),
                     e.width / 2);
    const uint8_t* planes[3] = {y.data(), u.data(), v.data()};
    const int64_t strides[3] = {e.width, e.width / 2, e.width / 2};
    e.load(planes, strides);
    e.encode_picture(pts);
  } catch (const mpeg4::Error& err) {
    h->error = err.what;
    return -1;
  } catch (const std::bad_alloc&) {
    h->error = "out of memory";
    return -1;
  }
  return (int64_t)e.packet.size();
}

// The last packet: its bytes into out, and whether it is a keyframe.
int mpeg4enc_packet(void* hp, uint8_t* out) {
  auto& e = ((mpeg4::enc::Handle*)hp)->enc;
  memcpy(out, e.packet.data(), e.packet.size());
  return e.key;
}

// The last picture as its reconstruction (what a decoder of the stream
// gives) in BGR24 converted as cv2 converts a decoded frame: width x height
// rows of 3 * width bytes. 0, or -1 before the first picture.
int mpeg4enc_reconstruction(void* hp, uint8_t* bgr) {
  auto& e = ((mpeg4::enc::Handle*)hp)->enc;
  if (!e.dec.next) return -1;
  const mpeg4::Picture& p = *e.dec.next;
  yuv420_to_bgr(p.plane[0].data(), p.stride(0), p.plane[1].data(), p.plane[2].data(),
                p.stride(1), p.width, p.height, bgr, p.width * 3, e.dec.matrix,
                e.dec.full_range);
  return 0;
}

// cv2's BGR24 -> yuv420p conversion of a w x h (even) frame.
void mpeg4enc_bgr_to_yuv(const uint8_t* bgr, int64_t stride, int w, int h, uint8_t* y,
                         uint8_t* u, uint8_t* v) {
  bgr2yuv::convert(bgr, stride, w, h, y, w, u, v, w / 2);
}

// ff_fdct_sse2 over n blocks in natural order, in place.
void mpeg4enc_fdct(int16_t* blocks, int64_t n) {
  for (int64_t i = 0; i < n; ++i) mpeg4::enc::fdct(blocks + 64 * i);
}

}  // extern "C"
