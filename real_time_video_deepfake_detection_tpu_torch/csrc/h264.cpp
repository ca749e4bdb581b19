// H.264 Constrained Baseline decoder on the host (ITU-T H.264, CAVLC, I and
// P slices, frames only, 4:2:0, 8 bits): the frames cv2.VideoCapture's
// FFmpeg backend decodes from an mp4's avc1/avc3 track, sample by sample.
//
// Input: one mp4 sample (an access unit of NAL units, each behind a
// big-endian length of nal_length_size bytes) at a time, after the avcC's
// parameter sets. Covered: emulation-prevention bytes; SPS/PPS in the
// avcC or in band; SEI (the recovery point; the rest is skipped), AUD and
// filler skipped; frame cropping; POC types 0, 1 and 2; several slices a
// picture, each with its QP and deblocking control; the default P list and
// its modification commands; the sliding window, MMCO 1-6 and IDR
// long_term_reference_flag; mb_skip_run, I_NxN, I_16x16, I_PCM, P 16x16,
// 16x8, 8x16, 8x8 and 8x8ref0 with 8x8 / 8x4 / 4x8 / 4x4 sub-partitions;
// CAVLC; intra 4x4 / 16x16 / chroma prediction with constrained_intra_pred;
// motion vector prediction and P_Skip; quarter-pel luma and eighth-pel
// chroma interpolation with references clamped at the coded picture's edge;
// flat dequantisation, the Intra16x16 DC Hadamard, chroma DC and the 4x4
// inverse transform; the deblocking filter (bS 0-4, the slice's offsets,
// disable_deblocking_filter_idc 0/1/2). Pictures come out in POC order
// behind the VUI's max_num_reorder_frames (0 without one), as FFmpeg's
// decoder emits them; a picture decoded after a flush from a non-IDR
// keyframe is held back until FFmpeg would call it recovered (the SEI
// recovery point), and references missing there read as mid-grey.
//
// Refused, with a reason naming the feature: CABAC, B / SP / SI slices,
// transform_8x8_mode, weighted prediction, slice groups (FMO), field or
// MBAFF coding, chroma other than 4:2:0, bit depth above 8, scaling
// matrices, redundant pictures, data partitioning and gaps in frame_num. A
// damaged slice (a bad code, a read past its end, macroblocks missing or
// overlapping, a reference that is not there) stops the decoder with a
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

#include "yuv2bgr.cpp"

namespace h264 {

struct Error {
  std::string what;
};

[[noreturn]] static void fail(const char* fmt, ...) {
  char buf[512];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Error{buf};
}

// ---------------------------------------------------------------- tables

static const uint8_t kCoeffTokenLen[4][4 * 17] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10, 9,  8,  6,
     11, 10, 9,  7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13, 13, 10, 14, 14, 13, 11,
     14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15, 16, 16, 16, 15,
     16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,  6,  6,  4,
     8,  7,  7,  5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11, 11, 7,  12, 11, 11, 9,
     12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13, 13, 14, 13, 13,
     14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0,  6,  4,  0,  0,  6,  5,  4,  0,  6,  5,  5,  4,  7,  5,  5,  4,
     7,  5,  5,  4,  7,  6,  6,  4,  7,  6,  6,  4,  8,  7,  7,  5,  8,  8,  7,  6,
     9,  8,  8,  7,  9,  9,  8,  8,  9,  9,  9,  8,  10, 9,  9,  9,  10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6}};

static const uint8_t kCoeffTokenBits[4][4 * 17] = {
    {1,  0,  0,  0,  5,  1,  0,  0,  7,  4,  1,  0,  7,  6,  5,  3,  7,  6,  5,  3,
     7,  6,  5,  4,  15, 6,  5,  4,  11, 14, 5,  4,  8,  10, 13, 4,  15, 14, 9,  4,
     11, 10, 13, 12, 15, 14, 9,  12, 11, 10, 13, 8,  15, 1,  9,  12, 11, 14, 13, 8,
     7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9,  5,  7,  6,  5,  4,
     4,  6,  5,  6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14, 13, 4,  15, 10, 9,  4,
     11, 14, 13, 12, 8,  10, 9,  8,  15, 14, 13, 12, 11, 10, 9,  12, 7,  11, 6,  8,
     9,  8,  10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15, 10, 11, 11,
     11, 8,  9,  10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14, 13, 13, 11, 14, 10, 12,
     15, 10, 13, 12, 11, 14, 9,  12, 8,  10, 13, 8,  13, 7,  9,  12, 9,  12, 11, 10,
     5,  8,  7,  6,  1,  4,  3,  2},
    {3,  0,  0,  0,  0,  1,  0,  0,  4,  5,  6,  0,  8,  9,  10, 11, 12, 13, 14, 15,
     16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
     36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55,
     56, 57, 58, 59, 60, 61, 62, 63}};

static const uint8_t kChromaDcTokenLen[4 * 5] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6,
                                                 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
static const uint8_t kChromaDcTokenBits[4 * 5] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6,
                                                  1, 0, 3, 3, 2, 5, 2, 3, 2, 0};

static const uint8_t kTotalZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},       {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},             {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},                   {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},                         {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},                               {4, 4, 2, 1, 3},
    {3, 3, 1, 2},                                     {2, 2, 1},
    {1, 1}};
static const uint8_t kTotalZerosBits[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},       {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},             {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},                   {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},                         {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},                               {0, 1, 1, 1, 1},
    {0, 1, 1, 1},                                     {0, 1, 1},
    {0, 1}};
static const uint8_t kChromaDcTotalZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2, 0}, {1, 1, 0, 0}};
static const uint8_t kChromaDcTotalZerosBits[3][4] = {{1, 1, 1, 0}, {1, 1, 0, 0}, {1, 0, 0, 0}};
static const uint8_t kRunLen[7][16] = {{1, 1},          {1, 2, 2},          {2, 2, 2, 2},
                                       {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
                                       {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
static const uint8_t kRunBits[7][16] = {{1, 0},          {1, 1, 0},          {3, 2, 1, 0},
                                        {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
                                        {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};

static const uint8_t kIntraCbp[48] = {
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41};
static const uint8_t kInterCbp[48] = {
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
// luma4x4BlkIdx -> (x, y) of the 4x4 block in 4x4 units
static const uint8_t kBlkX[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
static const uint8_t kBlkY[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

static const uint8_t kDequant[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                                       {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};

static const uint8_t kChromaQp[52] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12,
                                      13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
                                      26, 27, 28, 29, 29, 30, 31, 32, 32, 33, 34, 34, 35,
                                      35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

static const uint8_t kAlpha[52] = {0,  0,  0,  0,  0,  0,  0,   0,   0,   0,   0,   0,   0,
                                   0,  0,  0,  4,  4,  5,  6,   7,   8,   9,   10,  12,  13,
                                   15, 17, 20, 22, 25, 28, 32,  36,  40,  45,  50,  56,  63,
                                   71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
static const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,  2,  2,
                                  2, 3, 3, 3, 3, 4, 4, 4, 6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
                                  11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
static const uint8_t kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},    {0, 0, 0},   {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 1},    {0, 0, 1},    {0, 0, 1},   {0, 0, 1},
    {0, 1, 1},   {0, 1, 1},   {1, 1, 1},   {1, 1, 1},    {1, 1, 1},    {1, 1, 1},   {1, 1, 2},
    {1, 1, 2},   {1, 1, 2},   {1, 1, 2},   {1, 2, 3},    {1, 2, 3},    {2, 2, 3},   {2, 2, 4},
    {2, 3, 4},   {2, 3, 4},   {3, 3, 5},   {3, 4, 6},    {3, 4, 6},    {4, 5, 7},   {4, 5, 8},
    {4, 6, 9},   {5, 7, 10},  {6, 8, 11},  {6, 8, 13},   {7, 10, 14},  {8, 11, 16}, {9, 12, 18},
    {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// ------------------------------------------------------------------ VLCs

struct Vlc {
  int maxlen = 0;
  std::vector<uint8_t> len;   // by the next maxlen bits; 0: no code
  std::vector<uint8_t> sym;
  void build(int n, const uint8_t* lens, const uint8_t* bits, const uint8_t* syms) {
    maxlen = 0;
    for (int i = 0; i < n; ++i) maxlen = std::max(maxlen, (int)lens[i]);
    len.assign(1u << maxlen, 0);
    sym.assign(1u << maxlen, 0);
    for (int i = 0; i < n; ++i) {
      if (!lens[i]) continue;
      int shift = maxlen - lens[i];
      uint32_t first = (uint32_t)bits[i] << shift;
      for (uint32_t k = 0; k < (1u << shift); ++k) {
        len[first + k] = lens[i];
        sym[first + k] = syms[i];
      }
    }
  }
};

struct Tables {
  Vlc coeff_token[4], chroma_dc_token, total_zeros[15], chroma_dc_total_zeros[3], run[7];
  Tables() {
    uint8_t syms[68];
    for (int i = 0; i < 68; ++i) syms[i] = (uint8_t)i;  // total_coeff * 4 + trailing_ones
    for (int t = 0; t < 4; ++t) {
      uint8_t lens[68];
      memcpy(lens, kCoeffTokenLen[t], 68);
      if (t == 3) lens[4] = 6;  // 0000 00: total 1, trailing 0 (bits 0)
      coeff_token[t].build(68, lens, kCoeffTokenBits[t], syms);
    }
    chroma_dc_token.build(20, kChromaDcTokenLen, kChromaDcTokenBits, syms);
    for (int t = 0; t < 15; ++t) total_zeros[t].build(16 - t, kTotalZerosLen[t],
        kTotalZerosBits[t], syms);
    for (int t = 0; t < 3; ++t)
      chroma_dc_total_zeros[t].build(4 - t, kChromaDcTotalZerosLen[t], kChromaDcTotalZerosBits[t],
          syms);
    for (int t = 0; t < 7; ++t) run[t].build(t < 6 ? t + 2 : 15, kRunLen[t], kRunBits[t], syms);
  }
};

static const Tables& tables() {
  static const Tables t;
  return t;
}

// ------------------------------------------------------------ bit reader

struct Bits {
  const uint8_t* d = nullptr;
  size_t nbits = 0, pos = 0, stop = 0;   // stop: the rbsp_stop_one_bit's position
  const char* where = "";
  void init(const uint8_t* data, size_t n, const char* w) {
    d = data;
    nbits = n * 8;
    pos = 0;
    where = w;
    stop = 0;
    for (size_t i = n; i-- > 0;) {
      if (d[i]) {
        int b = 0;
        while (!((d[i] >> b) & 1)) ++b;
        stop = i * 8 + (7 - b);
        break;
      }
    }
  }
  uint32_t peek(int k) const {  // k <= 25
    uint32_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 4; ++i) v = (v << 8) | (byte + i < nbits / 8 ? d[byte + i] : 0);
    return (v << (pos & 7)) >> (32 - k);
  }
  void skip(int k) {
    pos += k;
    if (pos > nbits) fail("%s: read past the end of the NAL unit", where);
  }
  uint32_t u(int k) {
    if (!k) return 0;
    if (k > 24) {
      uint32_t hi = u(k - 16);
      return (hi << 16) | u(16);
    }
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  bool flag() { return u(1) != 0; }
  uint32_t ue() {
    int zeros = 0;
    while (!u(1)) {  // at most 2^31 - 2: every ue(v) value fits an int
      if (++zeros > 30) fail("%s: an Exp-Golomb code longer than 31 bits", where);
    }
    if (!zeros) return 0;
    return (uint32_t)((((uint64_t)1 << zeros) - 1) + u(zeros));
  }
  int32_t se() {
    uint32_t k = ue();
    return (k & 1) ? (int32_t)((k + 1) / 2) : -(int32_t)(k / 2);
  }
  int vlc(const Vlc& t, const char* what) {
    uint32_t v = peek(t.maxlen);
    int l = t.len[v];
    if (!l) fail("%s: no %s code matches", where, what);
    skip(l);
    return t.sym[v];
  }
  bool more_rbsp_data() const { return pos < stop; }
  bool byte_aligned() const { return (pos & 7) == 0; }
};

static void unescape(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  out.clear();
  out.reserve(n);
  int zeros = 0;
  for (size_t i = 0; i < n; ++i) {
    uint8_t b = src[i];
    if (zeros >= 2 && b == 3) {
      zeros = 0;
      continue;
    }
    zeros = b ? 0 : zeros + 1;
    out.push_back(b);
  }
}

// ------------------------------------------------------- parameter sets

static const char* profile_name(int p) {
  switch (p) {
    case 66: return "Baseline";
    case 77: return "Main";
    case 88: return "Extended";
    case 100: return "High";
    case 110: return "High 10";
    case 122: return "High 4:2:2";
    case 244: return "High 4:4:4 Predictive";
    case 44: return "CAVLC 4:4:4 Intra";
    default: return "an unknown profile";
  }
}

struct Sps {
  bool valid = false;
  int profile_idc = 0, constraints = 0, level_idc = 0;
  int chroma_format_idc = 1, bit_depth_luma = 8, bit_depth_chroma = 8;
  bool scaling_matrix = false, transform_bypass = false, separate_colour_plane = false;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  bool delta_pic_order_always_zero = false;
  int offset_for_non_ref_pic = 0, offset_for_top_to_bottom_field = 0;
  std::vector<int> offset_for_ref_frame;
  int num_ref_frames = 0;
  bool gaps_allowed = false, frame_mbs_only = true;
  int mb_width = 0, mb_height = 0;
  int crop_left = 0, crop_right = 0, crop_top = 0, crop_bottom = 0;
  int matrix = 2, full_range = 0, num_reorder_frames = 0;
};

struct Pps {
  bool valid = false;
  int sps_id = 0;
  bool cabac = false, bottom_field_pic_order = false;
  int num_slice_groups = 1, num_ref_idx_default = 1;
  bool weighted_pred = false;
  int weighted_bipred_idc = 0, pic_init_qp = 26, chroma_qp_offset[2] = {0, 0};
  bool deblocking_control = false, constrained_intra_pred = false, redundant_pic_cnt = false;
  bool transform_8x8 = false, scaling_matrix = false;
};

static void skip_scaling_list(Bits& b, int size) {
  int last = 8, next = 8;
  for (int j = 0; j < size; ++j) {
    if (next) {
      int delta = b.se();
      next = (last + delta + 256) % 256;
    }
    last = next ? next : last;
  }
}

static void skip_hrd(Bits& b) {
  int cpb_cnt = (int)b.ue() + 1;
  b.u(4);
  b.u(4);
  for (int i = 0; i < cpb_cnt && i < 32; ++i) {
    b.ue();
    b.ue();
    b.u(1);
  }
  b.u(20);
}

static void parse_vui(Bits& b, Sps& s) {
  if (b.flag()) {  // aspect_ratio_info
    if (b.u(8) == 255) b.u(32);
  }
  if (b.flag()) b.u(1);  // overscan
  if (b.flag()) {        // video_signal_type
    b.u(3);
    s.full_range = (int)b.u(1);
    if (b.flag()) {
      b.u(8);
      b.u(8);
      s.matrix = (int)b.u(8);
    }
  }
  if (b.flag()) {  // chroma_loc_info
    b.ue();
    b.ue();
  }
  if (b.flag()) b.u(32), b.u(32), b.u(1);  // timing_info
  bool nal = b.flag();
  if (nal) skip_hrd(b);
  bool vcl = b.flag();
  if (vcl) skip_hrd(b);
  if (nal || vcl) b.u(1);
  b.u(1);          // pic_struct_present
  if (b.flag()) {  // bitstream_restriction
    b.u(1);
    b.ue();
    b.ue();
    b.ue();
    b.ue();
    s.num_reorder_frames = (int)std::min(b.ue(), 16u);
    b.ue();
  }
}

static int parse_sps(Bits& b, Sps* table) {
  Sps s;
  s.profile_idc = (int)b.u(8);
  s.constraints = (int)b.u(8);
  s.level_idc = (int)b.u(8);
  uint32_t id = b.ue();
  if (id > 31) fail("SPS: seq_parameter_set_id %u", id);
  static const int high[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};
  if (std::find(std::begin(high), std::end(high), s.profile_idc) != std::end(high)) {
    s.chroma_format_idc = (int)b.ue();
    if (s.chroma_format_idc == 3) s.separate_colour_plane = b.flag();
    s.bit_depth_luma = (int)b.ue() + 8;
    s.bit_depth_chroma = (int)b.ue() + 8;
    s.transform_bypass = b.flag();
    if (b.flag()) {
      s.scaling_matrix = true;
      for (int i = 0; i < (s.chroma_format_idc == 3 ? 12 : 8); ++i)
        if (b.flag()) skip_scaling_list(b, i < 6 ? 16 : 64);
    }
  }
  s.log2_max_frame_num = (int)b.ue() + 4;
  if (s.log2_max_frame_num > 16) fail("SPS: log2_max_frame_num %d", s.log2_max_frame_num);
  s.poc_type = (int)b.ue();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = (int)b.ue() + 4;
    if (s.log2_max_poc_lsb > 16) fail("SPS: log2_max_pic_order_cnt_lsb %d", s.log2_max_poc_lsb);
  } else if (s.poc_type == 1) {
    s.delta_pic_order_always_zero = b.flag();
    s.offset_for_non_ref_pic = b.se();
    s.offset_for_top_to_bottom_field = b.se();
    uint32_t n = b.ue();
    if (n > 255) fail("SPS: num_ref_frames_in_pic_order_cnt_cycle %u", n);
    for (uint32_t i = 0; i < n; ++i) s.offset_for_ref_frame.push_back(b.se());
  } else if (s.poc_type != 2) {
    fail("SPS: pic_order_cnt_type %d", s.poc_type);
  }
  s.num_ref_frames = (int)b.ue();
  if (s.num_ref_frames > 16) fail("SPS: max_num_ref_frames %d", s.num_ref_frames);
  s.gaps_allowed = b.flag();
  s.mb_width = (int)b.ue() + 1;
  s.mb_height = (int)b.ue() + 1;
  s.frame_mbs_only = b.flag();
  if (!s.frame_mbs_only) b.u(1);
  b.u(1);  // direct_8x8_inference
  if (b.flag()) {
    s.crop_left = (int)std::min(b.ue(), 1u << 16);
    s.crop_right = (int)std::min(b.ue(), 1u << 16);
    s.crop_top = (int)std::min(b.ue(), 1u << 16);
    s.crop_bottom = (int)std::min(b.ue(), 1u << 16);
  }
  // level 6.2's largest frame: 139,264 macroblocks
  if (s.mb_width > 1024 || s.mb_height > 1024 || s.mb_width * s.mb_height > 139264)
    fail("SPS: a %dx%d macroblock picture", s.mb_width, s.mb_height);
  if (2 * (s.crop_left + s.crop_right) >= 16 * s.mb_width ||
      2 * (s.crop_top + s.crop_bottom) >= 16 * s.mb_height)
    fail("SPS: the cropping window is empty");
  if (b.flag()) {
    try {
      parse_vui(b, s);
    } catch (const Error&) {  // a cut VUI: FFmpeg keeps the SPS too
    }
  }
  s.valid = true;
  table[id] = s;
  return (int)id;
}

static void parse_pps(Bits& b, Pps* table) {
  Pps p;
  uint32_t id = b.ue();
  if (id > 255) fail("PPS: pic_parameter_set_id %u", id);
  p.sps_id = (int)b.ue();
  if (p.sps_id > 31) fail("PPS: seq_parameter_set_id %d", p.sps_id);
  p.cabac = b.flag();
  p.bottom_field_pic_order = b.flag();
  p.num_slice_groups = (int)b.ue() + 1;
  if (p.num_slice_groups > 1) {  // the rest is not read: the PPS is refused at its use
    p.valid = true;
    table[id] = p;
    return;
  }
  p.num_ref_idx_default = (int)b.ue() + 1;
  b.ue();
  if (p.num_ref_idx_default > 32) fail("PPS: num_ref_idx_l0_default_active %d",
      p.num_ref_idx_default);
  p.weighted_pred = b.flag();
  p.weighted_bipred_idc = (int)b.u(2);
  p.pic_init_qp = 26 + b.se();
  b.se();
  p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
  p.deblocking_control = b.flag();
  p.constrained_intra_pred = b.flag();
  p.redundant_pic_cnt = b.flag();
  if (b.more_rbsp_data()) {
    p.transform_8x8 = b.flag();
    if (b.flag()) {
      p.scaling_matrix = true;
      for (int i = 0; i < 6 + 2 * p.transform_8x8; ++i)
        if (b.flag()) skip_scaling_list(b, i < 6 ? 16 : 64);
    }
    p.chroma_qp_offset[1] = b.se();
  }
  if (p.pic_init_qp < 0 || p.pic_init_qp > 51) fail("PPS: pic_init_qp %d", p.pic_init_qp);
  if (abs(p.chroma_qp_offset[0]) > 12 || abs(p.chroma_qp_offset[1]) > 12)
    fail("PPS: a chroma_qp_index_offset out of range");
  p.valid = true;
  table[id] = p;
}

// The feature of an SPS / PPS pair this decoder refuses, or "".
static std::string unsupported(const Sps& s, const Pps* p) {
  char buf[256];
  const char* what = nullptr;
  if (s.chroma_format_idc != 1) what = "chroma other than 4:2:0";
  else if (s.bit_depth_luma != 8 || s.bit_depth_chroma != 8) what = "a bit depth above 8";
  else if (s.transform_bypass) what = "lossless transform bypass";
  else if (s.scaling_matrix) what = "scaling matrices";
  else if (!s.frame_mbs_only) what = "field or MBAFF coding (frame_mbs_only_flag = 0)";
  else if (s.gaps_allowed) what = "gaps in frame_num";
  else if (p && p->cabac) what = "CABAC (entropy_coding_mode_flag = 1)";
  else if (p && p->num_slice_groups > 1) what = "slice groups (FMO)";
  else if (p && p->transform_8x8) what = "transform_8x8_mode";
  else if (p && p->scaling_matrix) what = "scaling matrices";
  else if (p && p->weighted_pred) what = "weighted prediction";
  else if (p && p->redundant_pic_cnt) what = "redundant pictures";
  if (!what) return "";
  snprintf(buf, sizeof buf, "%s profile (profile_idc %d) with %s is not decoded",
           profile_name(s.profile_idc), s.profile_idc, what);
  return buf;
}

// -------------------------------------------------------------- pictures

struct Picture {
  int id = 0;
  int width = 0, height = 0;  // coded, in samples
  std::vector<uint8_t> plane[3];
  int frame_num = 0, frame_num_wrap = 0, long_term_idx = 0, poc = 0;
  bool short_ref = false, long_ref = false, wait_output = false, recovered = false;
  bool discard = false;
  int64_t pts = 0;
  int crop[4] = {0, 0, 0, 0};  // left, right, top, bottom in samples
  int matrix = 2, full_range = 0;
  bool is_ref() const { return short_ref || long_ref; }
};

struct Mv {
  int16_t x = 0, y = 0;
};

enum MbKind : uint8_t { MB_NONE, MB_I4, MB_I16, MB_PCM, MB_P, MB_SKIP };

struct SliceParams {
  int disable_deblock = 0, alpha_offset = 0, beta_offset = 0;
  int chroma_qp_offset[2] = {0, 0};
};

struct Neighbor {
  bool avail = false;
  int ref = -1;
  Mv mv;
};

class Decoder {
 public:
  Sps sps_table[32];
  Pps pps_table[256];
  int nal_length_size = 4;
  std::string error;

  // output
  std::vector<Picture*> output;  // ready, in order

  ~Decoder() = default;

  void decode_sample(const uint8_t* data, size_t size, int64_t pts, bool discard);
  void parameter_set(const uint8_t* nal, size_t size);
  void flush_output() { bump(true); }
  void flush();  // a seek: drop every picture, start again at the next keyframe
  std::string check() const;
  void release(Picture* p) { p->wait_output = false; }

 private:
  // DPB
  std::vector<std::unique_ptr<Picture>> pool;
  std::vector<Picture*> refs;     // short and long-term references
  std::vector<Picture*> waiting;  // decoded, not yet output
  int next_id = 1;
  std::unique_ptr<Picture> grey;  // stands for references missing after a flush

  // stream state
  int cur_sps_id = -1;
  int prev_ref_frame_num = 0, prev_frame_num = 0, prev_frame_num_offset = 0;
  int prev_poc_msb = 0, prev_poc_lsb = 0;
  bool prev_mmco5 = false;
  int max_long_term_idx = -1;  // "no long-term frame indices"
  bool frame_recovered = false, after_flush = true;
  int recovery_frame = -1, sei_recovery_cnt = -1;
  int64_t sample_index = -1;
  bool valid_recovery_point = false;
  int64_t cur_pts_ = 0;
  bool cur_discard_ = false;
  int poc_msb_ = 0, poc_lsb_ = 0, poc_top_ = 0;
  int i4_modes_[16];

  // the picture being decoded
  Picture* cur = nullptr;
  Sps active_sps;  // a copy: an in-band SPS may rewrite its table entry
  const Sps* sps = nullptr;
  const Pps* pps = nullptr;
  int mbw = 0, mbh = 0, w4 = 0;
  int cur_frame_num = 0, cur_nal_ref_idc = 0, cur_idr = 0, frame_num_offset = 0;
  bool cur_mmco5 = false, cur_all_intra = true;
  std::vector<int> mb_slice;
  std::vector<uint8_t> mb_kind;
  std::vector<int8_t> mb_qp;        // QP_Y (0 for I_PCM: what the deblocking filter reads)
  std::vector<uint8_t> nz;          // luma total_coeff by 4x4 block
  std::vector<uint8_t> nzc[2];      // chroma AC total_coeff by chroma 4x4 block
  std::vector<int8_t> i4mode;       // Intra4x4PredMode by 4x4 block (-1: not I_NxN)
  std::vector<int8_t> refidx;       // by 4x4 block, -1 intra
  std::vector<int> refpic;          // picture id by 4x4 block, 0 intra
  std::vector<Mv> mv;
  std::vector<SliceParams> slices;

  // the slice being decoded
  int slice_num = 0, slice_type = 0, qp = 0, num_ref_active = 0;
  std::vector<Picture*> ref_list;
  struct Mmco {
    int op, a, b;
  };
  std::vector<Mmco> mmcos;
  bool adaptive_marking = false, long_term_reference_flag = false;
  Bits bits;
  char where[160];

  // macroblock scratch
  int mbx = 0, mby = 0, mb_addr = 0;
  int16_t coef[16][16];     // luma blocks, raster order within the block
  int16_t ccoef[2][4][16];  // chroma AC (and DC at [0])
  int16_t dc_luma[16], dc_chroma[2][4];
  bool written[16];          // 4x4 blocks of the current MB whose motion is set

  Picture* new_picture();
  void bump(bool all);
  void start_picture(int nal_type, int nal_ref_idc, int frame_num, int pps_id, Bits& hdr_rest);
  void finish_picture();
  void slice(const uint8_t* rbsp, size_t n, int nal_type, int nal_ref_idc);
  void sei(const uint8_t* rbsp, size_t n);
  void compute_poc(int nal_type, int nal_ref_idc, int poc_lsb, int delta_bottom, const int* delta);
  void build_ref_list(Bits& b);
  void mark_references();
  void start_mb() {
    mbx = mb_addr % mbw;
    mby = mb_addr / mbw;
    snprintf(where, sizeof where, "sample %lld, macroblock %d (%d, %d)", (long long)sample_index,
        mb_addr, mbx, mby);
    bits.where = where;
    if (mb_slice[mb_addr] >= 0) fail("%s: decoded twice", where);
  }
  bool mb_available(int x, int y) const {
    return x >= 0 && y >= 0 && x < mbw && y < mbh && mb_slice[y * mbw + x] == slice_num;
  }
  bool intra_ok(int x, int y) const;  // available for intra prediction
  void macroblock(bool skip);
  void residual_luma(int cbp, bool i16);
  void residual_chroma(int cbp_chroma);
  int block(int nC, int max_coeff, int16_t* out, int start, const char* what);
  int luma_nc(int bx, int by) const;
  int chroma_nc(int c, int bx, int by) const;
  void intra4x4(int blk, int mode);
  void intra16x16(int mode);
  void intra_chroma(int mode);
  void add_luma_residual(int bx, int by, int16_t* c, bool has_dc);
  void dequant_luma(int qp);
  void recon_chroma(int cbp_chroma);
  Neighbor neighbor(int x, int y) const;
  Mv predict_mv(int x, int y, int w, int ref, int shape) const;
  void set_motion(int x, int y, int w, int h, int ref, Mv m);
  void motion_compensate(int x, int y, int w, int h, int ref, Mv m);
  Picture* reference(int idx);
  void deblock();
  void deblock_mb(int x, int y);
};

Picture* Decoder::new_picture() {
  for (auto& p : pool)
    if (!p->is_ref() && !p->wait_output && p.get() != cur) {
      p->id = next_id++;
      return p.get();
    }
  pool.emplace_back(new Picture());
  pool.back()->id = next_id++;
  return pool.back().get();
}

void Decoder::bump(bool all) {
  int reorder = sps ? sps->num_reorder_frames : 0;
  while (!waiting.empty() && (all || (int)waiting.size() > reorder)) {
    auto it = std::min_element(waiting.begin(), waiting.end(),
                               [](Picture* a, Picture* b) { return a->poc < b->poc; });
    Picture* p = *it;
    waiting.erase(it);
    if (p->recovered) frame_recovered = true;
    if (p->recovered && !p->discard) output.push_back(p);
    else p->wait_output = false;
  }
}

void Decoder::flush() {
  for (Picture* p : refs) p->short_ref = p->long_ref = false;
  refs.clear();
  for (Picture* p : waiting) p->wait_output = false;
  waiting.clear();
  for (Picture* p : output) p->wait_output = false;
  output.clear();
  cur = nullptr;
  prev_ref_frame_num = prev_frame_num = prev_frame_num_offset = 0;
  prev_poc_msb = prev_poc_lsb = 0;
  prev_mmco5 = false;
  max_long_term_idx = -1;
  frame_recovered = false;
  after_flush = true;
  recovery_frame = -1;
  sei_recovery_cnt = -1;
  error.clear();
}

std::string Decoder::check() const {
  for (int i = 0; i < 256; ++i) {
    const Pps& p = pps_table[i];
    if (!p.valid) continue;
    const Sps& s = sps_table[p.sps_id];
    if (!s.valid) continue;
    std::string r = unsupported(s, &p);
    if (!r.empty()) return r;
  }
  for (int i = 0; i < 32; ++i)
    if (sps_table[i].valid) {
      std::string r = unsupported(sps_table[i], nullptr);
      if (!r.empty()) return r;
    }
  return "";
}

void Decoder::parameter_set(const uint8_t* nal, size_t size) {
  if (!size) return;
  std::vector<uint8_t> rbsp;
  unescape(nal + 1, size - 1, rbsp);
  Bits b;
  int type = nal[0] & 31;
  if (type == 7) {
    b.init(rbsp.data(), rbsp.size(), "SPS");
    parse_sps(b, sps_table);
  } else if (type == 8) {
    b.init(rbsp.data(), rbsp.size(), "PPS");
    parse_pps(b, pps_table);
  }
}

void Decoder::sei(const uint8_t* rbsp, size_t n) {
  size_t i = 0;
  while (i + 2 <= n && rbsp[i] != 0x80) {
    int type = 0, size = 0;
    while (i < n && rbsp[i] == 0xFF) type += 255, ++i;
    if (i >= n) return;
    type += rbsp[i++];
    while (i < n && rbsp[i] == 0xFF) size += 255, ++i;
    if (i >= n) return;
    size += rbsp[i++];
    if (i + size > n) return;
    if (type == 6) {  // recovery point
      Bits b;
      b.init(rbsp + i, size, "SEI");
      try {
        sei_recovery_cnt = (int)b.ue();
      } catch (const Error&) {
      }
    }
    i += size;
  }
}

void Decoder::decode_sample(const uint8_t* data, size_t size, int64_t pts, bool discard) {
  ++sample_index;
  std::vector<uint8_t> rbsp;
  size_t pos = 0;
  sei_recovery_cnt = -1;
  while (pos < size) {
    if (pos + nal_length_size > size) fail("sample %lld: a NAL length runs past the sample",
        (long long)sample_index);
    size_t len = 0;
    for (int i = 0; i < nal_length_size; ++i) len = (len << 8) | data[pos + i];
    pos += nal_length_size;
    if (len > size - pos) fail("sample %lld: a NAL unit runs past the sample",
        (long long)sample_index);
    const uint8_t* nal = data + pos;
    pos += len;
    if (!len) continue;
    if (nal[0] & 0x80) fail("sample %lld: forbidden_zero_bit set", (long long)sample_index);
    int type = nal[0] & 31, ref_idc = (nal[0] >> 5) & 3;
    switch (type) {
      case 1:
      case 5:
        unescape(nal + 1, len - 1, rbsp);
        if (!cur) {
          cur_pts_ = pts;
          cur_discard_ = discard;
        }
        slice(rbsp.data(), rbsp.size(), type, ref_idc);
        break;
      case 2:
      case 3:
      case 4:
        fail("data partitioning (Extended profile) is not decoded");
      case 6:
        unescape(nal + 1, len - 1, rbsp);
        sei(rbsp.data(), rbsp.size());
        break;
      case 7:
      case 8:
        if (cur) finish_picture();
        parameter_set(nal, len);
        break;
      default:  // AUD, end of sequence / stream, filler, extensions
        break;
    }
  }
  if (cur) finish_picture();
}

// ------------------------------------------------------------ slices

void Decoder::slice(const uint8_t* rbsp, size_t n, int nal_type, int nal_ref_idc) {
  snprintf(where, sizeof where, "sample %lld, slice header", (long long)sample_index);
  Bits& b = bits;
  b.init(rbsp, n, where);
  int first_mb = (int)b.ue();
  int type = (int)b.ue();
  if (type > 9) fail("%s: slice_type %d", where, type);
  type %= 5;
  int pps_id = (int)b.ue();
  if (pps_id > 255 || !pps_table[pps_id].valid) fail("%s: no PPS %d", where, pps_id);
  const Pps& p = pps_table[pps_id];
  const Sps& s = sps_table[p.sps_id];
  if (!s.valid) fail("%s: no SPS %d", where, p.sps_id);
  std::string bad = unsupported(s, &p);
  if (!bad.empty()) fail("%s", bad.c_str());
  if (type == 1) fail("%s profile (profile_idc %d) with B slices is not decoded",
      profile_name(s.profile_idc), s.profile_idc);
  if (type == 3 || type == 4) fail("SP / SI slices (Extended profile) are not decoded");
  if (nal_type == 5 && type != 2) fail("%s: a P slice in an IDR picture", where);
  int frame_num = (int)b.u(s.log2_max_frame_num);
  bool new_pic = !cur;
  if (cur && (p.sps_id != cur_sps_id || frame_num != cur_frame_num)) {
    finish_picture();
    new_pic = true;
  }
  if (new_pic) {
    start_picture(nal_type, nal_ref_idc, frame_num, pps_id, b);
  } else {
    // the rest of the header of a later slice of the same picture
    if (nal_type == 5) b.ue();
    if (s.poc_type == 0) {
      b.u(s.log2_max_poc_lsb);
      if (p.bottom_field_pic_order) b.se();
    } else if (s.poc_type == 1 && !s.delta_pic_order_always_zero) {
      b.se();
      if (p.bottom_field_pic_order) b.se();
    }
  }
  if (first_mb >= mbw * mbh) fail("%s: first_mb_in_slice %d past the picture", where, first_mb);
  pps = &p;  // each slice may name another PPS of the same SPS
  slice_type = type;
  if (type != 2) cur_all_intra = false;
  // num_ref_idx / list modification / weights / marking
  num_ref_active = p.num_ref_idx_default;
  if (type == 0) {
    if (b.flag()) num_ref_active = (int)b.ue() + 1;
    if (num_ref_active > 16) fail("%s: num_ref_idx_l0_active %d", where, num_ref_active);
    build_ref_list(b);
  }
  if (nal_ref_idc) {
    if (nal_type == 5) {
      b.u(1);  // no_output_of_prior_pics: FFmpeg outputs them all the same
      long_term_reference_flag = b.flag();
    } else if (b.flag()) {
      std::vector<Mmco> ops;
      for (;;) {
        int op = (int)b.ue();
        if (op == 0) break;
        if (op > 6) fail("%s: memory_management_control_operation %d", where, op);
        Mmco m{op, 0, 0};
        if (op == 1 || op == 3) m.a = (int)b.ue();
        if (op == 2) m.a = (int)b.ue();
        if (op == 3 || op == 6) m.b = (int)b.ue();
        if (op == 4) m.a = (int)b.ue();
        ops.push_back(m);
        if (ops.size() > 66) fail("%s: too many memory_management_control_operations", where);
      }
      if (new_pic || !adaptive_marking) {
        mmcos = ops;
        adaptive_marking = true;
      }
    }
  }
  int qp_delta = b.se();
  qp = p.pic_init_qp + qp_delta;
  if (qp < 0 || qp > 51) fail("%s: slice QP %d", where, qp);
  SliceParams sp;
  sp.chroma_qp_offset[0] = p.chroma_qp_offset[0];
  sp.chroma_qp_offset[1] = p.chroma_qp_offset[1];
  if (p.deblocking_control) {
    sp.disable_deblock = (int)b.ue();
    if (sp.disable_deblock > 2) fail("%s: disable_deblocking_filter_idc %d", where,
        sp.disable_deblock);
    if (sp.disable_deblock != 1) {
      sp.alpha_offset = b.se() * 2;
      sp.beta_offset = b.se() * 2;
      if (abs(sp.alpha_offset) > 12 ||
          abs(sp.beta_offset) > 12) fail("%s: a deblocking offset out of range", where);
    }
  }
  slices.push_back(sp);
  slice_num = (int)slices.size() - 1;
  if (new_pic) {
    // FFmpeg's recovery: an IDR, the picture a recovery point SEI names, and
    // every picture after one that was output recovered
    int maxfn = 1 << sps->log2_max_frame_num;
    if (sei_recovery_cnt >= 0) {
      if (frame_num != sei_recovery_cnt || type != 2) valid_recovery_point = true;
      if (recovery_frame < 0 || ((recovery_frame - frame_num) & (maxfn - 1)) > sei_recovery_cnt) {
        recovery_frame = (frame_num + sei_recovery_cnt) & (maxfn - 1);
        if (!valid_recovery_point) recovery_frame = frame_num;
      }
    }
    if (nal_type == 5 || (recovery_frame == frame_num && nal_ref_idc)) {
      recovery_frame = -1;
      cur->recovered = true;
    }
    if (nal_type == 5) frame_recovered = true;
    cur->recovered = cur->recovered || frame_recovered;
  }
  // slice data
  mb_addr = first_mb;
  int total = mbw * mbh;
  bool more = true;
  while (more) {
    if (slice_type != 2) {
      int run = (int)b.ue();
      if (run > total - mb_addr) fail("%s: mb_skip_run %d past the picture", where, run);
      for (int i = 0; i < run; ++i, ++mb_addr) {
        start_mb();
        macroblock(true);
      }
      if (run > 0) more = b.more_rbsp_data();
    }
    if (more) {
      if (mb_addr >= total) fail("%s: macroblocks past the end of the picture", where);
      start_mb();
      macroblock(false);
      ++mb_addr;
      more = b.more_rbsp_data();
    }
  }
  if (b.pos != b.stop) fail("%s: the slice data does not end at its stop bit", where);
}

void Decoder::start_picture(int nal_type, int nal_ref_idc, int frame_num, int pps_id, Bits& b) {
  pps = &pps_table[pps_id];
  const Sps& s = sps_table[pps->sps_id];
  bool new_sps = cur_sps_id != pps->sps_id || !sps || sps->mb_width != s.mb_width ||
                 sps->mb_height != s.mb_height;
  if (new_sps && cur_sps_id >= 0 && nal_type != 5) fail("%s: a new SPS on a non-IDR picture",
      where);
  if (new_sps && !refs.empty()) {
    bump(true);
    for (Picture* r : refs) r->short_ref = r->long_ref = false;
    refs.clear();
  }
  cur_sps_id = pps->sps_id;
  active_sps = s;
  sps = &active_sps;
  mbw = sps->mb_width;
  mbh = sps->mb_height;
  w4 = mbw * 4;
  int maxfn = 1 << sps->log2_max_frame_num;
  // frame_num gaps: only after a flush (decoding from a recovery point)
  if (nal_type != 5 && frame_num != prev_ref_frame_num &&
      frame_num != (prev_ref_frame_num + 1) % maxfn) {
    if (!after_flush) fail("%s: a gap in frame_num (%d after %d): a lost picture", where,
        frame_num, prev_ref_frame_num);
  }
  if (nal_type == 5) after_flush = false;
  cur = new_picture();
  Picture& P = *cur;
  P.width = mbw * 16;
  P.height = mbh * 16;
  for (int c = 0; c < 3; ++c)
    P.plane[c].assign((size_t)(c ? P.width * P.height / 4 : P.width * P.height), 0);
  P.crop[0] = 2 * sps->crop_left;
  P.crop[1] = 2 * sps->crop_right;
  P.crop[2] = 2 * sps->crop_top;
  P.crop[3] = 2 * sps->crop_bottom;
  P.matrix = sps->matrix;
  P.full_range = sps->full_range;
  P.frame_num = frame_num;
  P.short_ref = P.long_ref = false;
  P.wait_output = false;
  P.recovered = false;
  P.pts = cur_pts_;
  P.discard = cur_discard_;
  cur_frame_num = frame_num;
  cur_nal_ref_idc = nal_ref_idc;
  cur_idr = nal_type == 5;
  cur_mmco5 = false;
  cur_all_intra = true;
  adaptive_marking = false;
  long_term_reference_flag = false;
  mmcos.clear();
  int n = mbw * mbh;
  mb_slice.assign(n, -1);
  mb_kind.assign(n, MB_NONE);
  mb_qp.assign(n, 0);
  nz.assign((size_t)n * 16, 0);
  nzc[0].assign((size_t)n * 4, 0);
  nzc[1].assign((size_t)n * 4, 0);
  i4mode.assign((size_t)n * 16, -1);
  refidx.assign((size_t)n * 16, -1);
  refpic.assign((size_t)n * 16, 0);
  mv.assign((size_t)n * 16, Mv());
  slices.clear();
  // the rest of the first slice's header: idr_pic_id and the POC fields
  if (nal_type == 5) b.ue();
  int poc_lsb = 0, delta_bottom = 0, delta[2] = {0, 0};
  if (sps->poc_type == 0) {
    poc_lsb = (int)b.u(sps->log2_max_poc_lsb);
    if (pps->bottom_field_pic_order) delta_bottom = b.se();
  } else if (sps->poc_type == 1 && !sps->delta_pic_order_always_zero) {
    delta[0] = b.se();
    if (pps->bottom_field_pic_order) delta[1] = b.se();
  }
  compute_poc(nal_type, nal_ref_idc, poc_lsb, delta_bottom, delta);
  // short-term FrameNumWrap for the lists
  for (Picture* r : refs)
    if (r->short_ref)
      r->frame_num_wrap = r->frame_num > frame_num ? r->frame_num - maxfn : r->frame_num;
}

void Decoder::compute_poc(int nal_type, int nal_ref_idc, int poc_lsb, int delta_bottom,
    const int* delta) {
  const Sps& s = *sps;
  int maxfn = 1 << s.log2_max_frame_num;
  int fn = cur_frame_num;
  int poc = 0;
  if (s.poc_type == 0) {
    if (nal_type == 5) prev_poc_msb = prev_poc_lsb = 0;
    int max_lsb = 1 << s.log2_max_poc_lsb, msb;
    if (poc_lsb < prev_poc_lsb &&
        prev_poc_lsb - poc_lsb >= max_lsb / 2) msb = prev_poc_msb + max_lsb;
    else if (poc_lsb > prev_poc_lsb &&
        poc_lsb - prev_poc_lsb > max_lsb / 2) msb = prev_poc_msb - max_lsb;
    else msb = prev_poc_msb;
    int top = msb + poc_lsb;
    poc = std::min(top, top + delta_bottom);
    if (nal_ref_idc) {
      poc_msb_ = msb;
      poc_lsb_ = poc_lsb;
      poc_top_ = top;
    }
  } else {
    if (nal_type == 5) frame_num_offset = 0;
    else if (prev_frame_num > fn)
      frame_num_offset = (prev_mmco5 ? 0 : prev_frame_num_offset) + maxfn;
    else frame_num_offset = prev_mmco5 ? 0 : prev_frame_num_offset;
    if (s.poc_type == 1) {
      int cycle = (int)s.offset_for_ref_frame.size();
      int abs_fn = cycle ? frame_num_offset + fn : 0;
      if (!nal_ref_idc && abs_fn > 0) --abs_fn;
      int expected = 0;
      if (abs_fn > 0) {
        int delta_cycle = 0;
        for (int v : s.offset_for_ref_frame) delta_cycle += v;
        int cnt = (abs_fn - 1) / cycle, in_cycle = (abs_fn - 1) % cycle;
        expected = cnt * delta_cycle;
        for (int i = 0; i <= in_cycle; ++i) expected += s.offset_for_ref_frame[i];
      }
      if (!nal_ref_idc) expected += s.offset_for_non_ref_pic;
      int top = expected + delta[0];
      int bottom = top + s.offset_for_top_to_bottom_field + delta[1];
      poc = std::min(top, bottom);
    } else {
      int abs_fn = frame_num_offset + fn;
      poc = nal_type == 5 ? 0 : (nal_ref_idc ? 2 * abs_fn : 2 * abs_fn - 1);
    }
  }
  cur->poc = poc;
}

void Decoder::build_ref_list(Bits& b) {
  int maxfn = 1 << sps->log2_max_frame_num;
  std::vector<Picture*> shorts, longs;
  for (Picture* r : refs) {
    if (r->short_ref) shorts.push_back(r);
    else if (r->long_ref) longs.push_back(r);
  }
  std::sort(shorts.begin(), shorts.end(),
      [](Picture* a, Picture* c) { return a->frame_num_wrap > c->frame_num_wrap; });
  std::sort(longs.begin(), longs.end(),
      [](Picture* a, Picture* c) { return a->long_term_idx < c->long_term_idx; });
  std::vector<Picture*> init = shorts;
  init.insert(init.end(), longs.begin(), longs.end());
  ref_list.assign(num_ref_active + 1, nullptr);
  for (int i = 0; i < num_ref_active && i < (int)init.size(); ++i) ref_list[i] = init[i];
  if (b.flag()) {  // ref_pic_list_modification_flag_l0
    int pred = cur_frame_num, idx = 0;
    for (;;) {
      int op = (int)b.ue();
      if (op == 3) break;
      if (op > 3) fail("%s: modification_of_pic_nums_idc %d", where, op);
      if (idx >= num_ref_active) fail("%s: more list modifications than references", where);
      Picture* pic = nullptr;
      int pic_num = 0, lt = 0;
      if (op < 2) {
        int diff = (int)b.ue() + 1;
        if (diff > maxfn) fail("%s: abs_diff_pic_num %d", where, diff);
        int no_wrap = op == 0 ? pred - diff : pred + diff;
        if (no_wrap < 0) no_wrap += maxfn;
        if (no_wrap >= maxfn) no_wrap -= maxfn;
        pred = no_wrap;
        pic_num = no_wrap > cur_frame_num ? no_wrap - maxfn : no_wrap;
        for (Picture* r : refs)
          if (r->short_ref && r->frame_num_wrap == pic_num) pic = r;
      } else {
        lt = (int)b.ue();
        for (Picture* r : refs)
          if (r->long_ref && r->long_term_idx == lt) pic = r;
      }
      if (!pic && !after_flush) fail("%s: the list names a picture that is not a reference", where);
      auto same = [&](Picture* q) {
        return q && pic && (op < 2 ? (q->short_ref && q->frame_num_wrap == pic_num)
                                   : (q->long_ref && q->long_term_idx == lt));
      };
      for (int c = num_ref_active; c > idx; --c) ref_list[c] = ref_list[c - 1];
      ref_list[idx++] = pic;
      int k = idx;
      for (int c = idx; c <= num_ref_active; ++c)
        if (!same(ref_list[c])) ref_list[k++] = ref_list[c];
    }
  }
  ref_list.resize(num_ref_active);
}

Picture* Decoder::reference(int idx) {
  Picture* p = idx < (int)ref_list.size() ? ref_list[idx] : nullptr;
  if (p && (p->width != cur->width || p->height != cur->height))
    fail("%s: ref_idx %d names a %dx%d picture in a %dx%d one", where, idx, p->width, p->height,
         cur->width, cur->height);
  if (p) return p;
  if (!after_flush) fail("%s: ref_idx %d names no reference picture", where, idx);
  if (!grey || grey->width != mbw * 16 || grey->height != mbh * 16) {
    grey.reset(new Picture());
    grey->id = -1;
    grey->width = mbw * 16;
    grey->height = mbh * 16;
    grey->plane[0].assign((size_t)grey->width * grey->height, 128);
    grey->plane[1].assign((size_t)grey->width * grey->height / 4, 128);
    grey->plane[2].assign((size_t)grey->width * grey->height / 4, 128);
  }
  return grey.get();
}

void Decoder::mark_references() {
  Picture* P = cur;
  if (!cur_nal_ref_idc) return;
  if (cur_idr) {
    for (Picture* r : refs) r->short_ref = r->long_ref = false;
    refs.clear();
    if (long_term_reference_flag) {
      P->long_ref = true;
      P->long_term_idx = 0;
      max_long_term_idx = 0;
    } else {
      P->short_ref = true;
      max_long_term_idx = -1;
    }
    refs.push_back(P);
    return;
  }
  bool to_long = false;
  if (adaptive_marking) {
    for (const Mmco& m : mmcos) {
      int pic_num = cur_frame_num - (m.a + 1);
      switch (m.op) {
        case 1:
          for (Picture* r : refs)
            if (r->short_ref && r->frame_num_wrap == pic_num) r->short_ref = false;
          break;
        case 2:
          for (Picture* r : refs)
            if (r->long_ref && r->long_term_idx == m.a) r->long_ref = false;
          break;
        case 3:
          for (Picture* r : refs)
            if (r->long_ref && r->long_term_idx == m.b) r->long_ref = false;
          for (Picture* r : refs)
            if (r->short_ref && r->frame_num_wrap == pic_num) {
              r->short_ref = false;
              r->long_ref = true;
              r->long_term_idx = m.b;
            }
          break;
        case 4:
          max_long_term_idx = m.a - 1;
          for (Picture* r : refs)
            if (r->long_ref && r->long_term_idx > max_long_term_idx) r->long_ref = false;
          break;
        case 5:
          for (Picture* r : refs) r->short_ref = r->long_ref = false;
          max_long_term_idx = -1;
          cur_mmco5 = true;
          break;
        case 6:
          for (Picture* r : refs)
            if (r->long_ref && r->long_term_idx == m.b && r != P) r->long_ref = false;
          to_long = true;
          P->long_term_idx = m.b;
          break;
      }
      refs.erase(std::remove_if(refs.begin(), refs.end(), [](Picture* r) { return !r->is_ref(); }),
          refs.end());
    }
  } else {
    int n_short = 0, n_long = 0;
    for (Picture* r : refs) n_short += r->short_ref, n_long += r->long_ref;
    if (n_short + n_long >= std::max(sps->num_ref_frames, 1) && n_short > 0) {
      Picture* oldest = nullptr;
      for (Picture* r : refs)
        if (r->short_ref && (!oldest || r->frame_num_wrap < oldest->frame_num_wrap)) oldest = r;
      oldest->short_ref = false;
      refs.erase(std::find(refs.begin(), refs.end(), oldest));
    }
  }
  if (to_long) P->long_ref = true;
  else P->short_ref = true;
  refs.push_back(P);
}

void Decoder::finish_picture() {
  Picture* P = cur;
  for (int i = 0; i < mbw * mbh; ++i)
    if (mb_slice[i] < 0) {
      snprintf(where, sizeof where, "sample %lld", (long long)sample_index);
      cur = nullptr;
      fail("%s: macroblock %d (%d, %d) is missing from the picture", where, i, i % mbw, i / mbw);
    }
  deblock();
  mark_references();
  // FFmpeg: an I picture with no long-term and at most one default
  // reference recovers
  int n_long = 0;
  for (Picture* r : refs) n_long += r->long_ref;
  if (cur_all_intra && !n_long && pps->num_ref_idx_default <= 1) {
    P->recovered = true;
    recovery_frame = -1;
  }
  if (cur_mmco5) P->frame_num = 0;
  if (cur_mmco5) {
    int temp = P->poc;
    P->poc -= temp;
    poc_top_ -= temp;
    bump(true);
  }
  if (cur_idr) bump(true);
  // the previous-picture state of the POC derivation
  if (cur_nal_ref_idc) {
    prev_ref_frame_num = cur_mmco5 ? 0 : cur_frame_num;
    if (sps->poc_type == 0) {
      prev_poc_msb = cur_mmco5 ? 0 : poc_msb_;
      prev_poc_lsb = cur_mmco5 ? poc_top_ : poc_lsb_;
    }
  }
  prev_frame_num = cur_mmco5 ? 0 : cur_frame_num;
  prev_frame_num_offset = frame_num_offset;
  prev_mmco5 = cur_mmco5;
  P->wait_output = true;
  waiting.push_back(P);
  cur = nullptr;
  bump(false);
}

// ------------------------------------------------------------- CAVLC

int Decoder::luma_nc(int bx, int by) const {
  // bx, by: 4x4 block coordinates in the picture
  int ax = bx - 1, ay = by, tx = bx, ty = by - 1;
  bool a = mb_available(ax >> 2, ay >> 2) || (ax >= 0 && (ax >> 2) == mbx && (ay >> 2) == mby);
  bool t = mb_available(tx >> 2, ty >> 2) || (ty >= 0 && (tx >> 2) == mbx && (ty >> 2) == mby);
  int na = a ? nz[ay * w4 + ax] : 0, nt = t ? nz[ty * w4 + tx] : 0;
  if (a && t) return (na + nt + 1) >> 1;
  if (a) return na;
  if (t) return nt;
  return 0;
}

int Decoder::chroma_nc(int c, int bx, int by) const {
  int w2 = mbw * 2;
  int ax = bx - 1, ay = by, tx = bx, ty = by - 1;
  bool a = mb_available(ax >> 1, ay >> 1) || (ax >= 0 && (ax >> 1) == mbx && (ay >> 1) == mby);
  bool t = mb_available(tx >> 1, ty >> 1) || (ty >= 0 && (tx >> 1) == mbx && (ty >> 1) == mby);
  int na = a ? nzc[c][ay * w2 + ax] : 0, nt = t ? nzc[c][ty * w2 + tx] : 0;
  if (a && t) return (na + nt + 1) >> 1;
  if (a) return na;
  if (t) return nt;
  return 0;
}

// One residual block: its levels in scan order into out[start .. start +
// max_coeff - 1]; returns TotalCoeff. nC = -1: chroma DC.
int Decoder::block(int nC, int max_coeff, int16_t* out, int start, const char* what) {
  const Tables& T = tables();
  Bits& b = bits;
  int tok;
  if (nC == -1) tok = b.vlc(T.chroma_dc_token, "chroma DC coeff_token");
  else if (nC < 2) tok = b.vlc(T.coeff_token[0], "coeff_token");
  else if (nC < 4) tok = b.vlc(T.coeff_token[1], "coeff_token");
  else if (nC < 8) tok = b.vlc(T.coeff_token[2], "coeff_token");
  else tok = b.vlc(T.coeff_token[3], "coeff_token");
  int total = tok >> 2, trailing = tok & 3;
  if (nC >= 8 && tok == 3) total = 0, trailing = 0;  // 0000 11
  if (total > max_coeff) fail("%s: %d coefficients in a %s block of %d", where, total, what,
      max_coeff);
  if (!total) return 0;
  int level[16], run[16];
  int suffix_len = (total > 10 && trailing < 3) ? 1 : 0;
  for (int i = 0; i < total; ++i) {
    if (i < trailing) {
      level[i] = b.u(1) ? -1 : 1;
      continue;
    }
    int prefix = 0;
    while (!b.u(1)) {
      if (++prefix > 31) fail("%s: a level_prefix past 31", where);
    }
    int code = std::min(15, prefix) << suffix_len;
    if (suffix_len > 0 || prefix >= 14) {
      int size = (prefix == 14 && suffix_len == 0) ? 4 : (prefix >= 15 ? prefix - 3 : suffix_len);
      if (size > 0) code += (int)b.u(size);
    }
    if (prefix >= 15 && suffix_len == 0) code += 15;
    if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
    if (i == trailing && trailing < 3) code += 2;
    level[i] = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
    if (suffix_len == 0) suffix_len = 1;
    if (abs(level[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
  }
  int zeros = 0;
  if (total < max_coeff) {
    if (nC == -1) zeros = b.vlc(T.chroma_dc_total_zeros[total - 1], "total_zeros");
    else zeros = b.vlc(T.total_zeros[total - 1], "total_zeros");
  }
  if (zeros + total > max_coeff) fail("%s: total_zeros %d past the %s block", where, zeros, what);
  int left = zeros;
  for (int i = 0; i < total - 1; ++i) {
    if (left > 0) {
      run[i] = b.vlc(T.run[std::min(left, 7) - 1], "run_before");
      if (run[i] > left) fail("%s: run_before past zerosLeft", where);
      left -= run[i];
    } else {
      run[i] = 0;
    }
  }
  run[total - 1] = left;
  int pos = -1;
  for (int i = total - 1; i >= 0; --i) {
    pos += run[i] + 1;
    out[start + pos] = (int16_t)level[i];
  }
  return total;
}

// ------------------------------------------------------- macroblocks

bool Decoder::intra_ok(int x, int y) const {
  if (!mb_available(x, y)) return false;
  if (pps->constrained_intra_pred) {
    uint8_t k = mb_kind[y * mbw + x];
    if (k == MB_P || k == MB_SKIP) return false;
  }
  return true;
}

static inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

static void idct4x4_add(const int16_t* c, uint8_t* dst, int stride) {
  int t[16];
  for (int i = 0; i < 4; ++i) {  // rows
    const int16_t* d = c + 4 * i;
    int e0 = d[0] + d[2], e1 = d[0] - d[2], e2 = (d[1] >> 1) - d[3], e3 = d[1] + (d[3] >> 1);
    t[4 * i] = e0 + e3;
    t[4 * i + 1] = e1 + e2;
    t[4 * i + 2] = e1 - e2;
    t[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {  // columns
    int f0 = t[j], f1 = t[4 + j], f2 = t[8 + j], f3 = t[12 + j];
    int g0 = f0 + f2, g1 = f0 - f2, g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
    int h[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
    for (int i = 0; i < 4; ++i) {
      uint8_t* p = dst + i * stride + j;
      *p = clip1(*p + ((h[i] + 32) >> 6));
    }
  }
}

void Decoder::add_luma_residual(int bx, int by, int16_t* c, bool has_dc) {
  bool any = has_dc;
  for (int k = 0; k < 16 && !any; ++k) any = c[k] != 0;
  if (!any) return;
  int stride = cur->width;
  idct4x4_add(c, cur->plane[0].data() + (by * 4) * stride + bx * 4, stride);
}

void Decoder::intra4x4(int blk, int mode) {
  int stride = cur->width;
  int bx = mbx * 4 + kBlkX[blk], by = mby * 4 + kBlkY[blk];
  int x0 = bx * 4, y0 = by * 4;
  uint8_t* dst = cur->plane[0].data() + y0 * stride + x0;
  int lx = kBlkX[blk], ly = kBlkY[blk];
  // availability of the left, top, top-right and top-left samples
  bool left = lx > 0 || intra_ok(mbx - 1, mby);
  bool top = ly > 0 || intra_ok(mbx, mby - 1);
  bool topleft = (lx > 0 && ly > 0) || (lx == 0 && ly > 0 && intra_ok(mbx - 1, mby)) ||
                 (ly == 0 && lx > 0 && intra_ok(mbx, mby - 1)) ||
                 (lx == 0 && ly == 0 && intra_ok(mbx - 1, mby - 1));
  bool topright;
  if (ly == 0) topright = lx < 3 ? intra_ok(mbx, mby - 1) : intra_ok(mbx + 1, mby - 1);
  else topright = !(blk == 3 || blk == 7 || blk == 11 || blk == 13 || blk == 15);
  int T[8], L[4], Q = 0;
  if (top) {
    for (int i = 0; i < 4; ++i) T[i] = dst[-stride + i];
    if (topright) for (int i = 4; i < 8; ++i) T[i] = dst[-stride + i];
    else for (int i = 4; i < 8; ++i) T[i] = T[3];
  }
  if (left) for (int i = 0; i < 4; ++i) L[i] = dst[i * stride - 1];
  if (topleft) Q = dst[-stride - 1];
  int pred[4][4];
  auto need = [&](bool ok) {
    if (!ok) fail("%s: Intra4x4 mode %d needs samples that are not available", where, mode);
  };
  switch (mode) {
    case 0:
      need(top);
      for (int y = 0; y < 4; ++y) for (int x = 0; x < 4; ++x) pred[y][x] = T[x];
      break;
    case 1:
      need(left);
      for (int y = 0; y < 4; ++y) for (int x = 0; x < 4; ++x) pred[y][x] = L[y];
      break;
    case 2: {
      int v;
      if (top && left) v = (T[0] + T[1] + T[2] + T[3] + L[0] + L[1] + L[2] + L[3] + 4) >> 3;
      else if (left) v = (L[0] + L[1] + L[2] + L[3] + 2) >> 2;
      else if (top) v = (T[0] + T[1] + T[2] + T[3] + 2) >> 2;
      else v = 128;
      for (int y = 0; y < 4; ++y) for (int x = 0; x < 4; ++x) pred[y][x] = v;
      break;
    }
    case 3:
      need(top);
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x)
          pred[y][x] = (x == 3 && y == 3) ? (T[6] + 3 * T[7] + 2) >> 2
                                          : (T[x + y] + 2 * T[x + y + 1] + T[x + y + 2] + 2) >> 2;
      break;
    default: {
      if (mode == 7) need(top);
      else if (mode == 8) need(left);
      else need(top && left && topleft);
      // p[-1..3, -1] and p[-1, -1..3] through one accessor
      auto P = [&](int x, int y) -> int {
        if (y == -1) return x == -1 ? Q : T[x];
        return L[y];
      };
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          int v = 0;
          if (mode == 4) {
            if (x > y) v = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1) + P(x - y, -1) + 2) >> 2;
            else if (x < y) v = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1) + P(-1, y - x) + 2) >> 2;
            else v = (P(0, -1) + 2 * P(-1, -1) + P(-1, 0) + 2) >> 2;
          } else if (mode == 5) {
            int z = 2 * x - y;
            if (z >= 0 && !(z & 1)) v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1;
            else if (z >= 0)
              v = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) +
                   2) >> 2;
            else if (z == -1) v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
            else v = (P(-1, y - 1) + 2 * P(-1, y - 2) + P(-1, y - 3) + 2) >> 2;
          } else if (mode == 6) {
            int z = 2 * y - x;
            if (z >= 0 && !(z & 1)) v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1;
            else if (z >= 0)
              v = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) +
                   2) >> 2;
            else if (z == -1) v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
            else v = (P(x - 1, -1) + 2 * P(x - 2, -1) + P(x - 3, -1) + 2) >> 2;
          } else if (mode == 7) {
            if (!(y & 1)) v = (T[x + (y >> 1)] + T[x + (y >> 1) + 1] + 1) >> 1;
            else v = (T[x + (y >> 1)] + 2 * T[x + (y >> 1) + 1] + T[x + (y >> 1) + 2] + 2) >> 2;
          } else {  // 8: horizontal up
            int z = x + 2 * y;
            if (z < 5 && !(z & 1)) v = (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1;
            else if (z < 5)
              v = (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1] + L[y + (x >> 1) + 2] + 2) >> 2;
            else if (z == 5) v = (L[2] + 3 * L[3] + 2) >> 2;
            else v = L[3];
          }
          pred[y][x] = v;
        }
    }
  }
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) dst[y * stride + x] = (uint8_t)pred[y][x];
}

void Decoder::intra16x16(int mode) {
  int stride = cur->width;
  uint8_t* dst = cur->plane[0].data() + mby * 16 * stride + mbx * 16;
  bool left = intra_ok(mbx - 1, mby), top = intra_ok(mbx, mby - 1), tl = intra_ok(mbx - 1, mby - 1);
  switch (mode) {
    case 0:
      if (!top) fail("%s: Intra16x16 vertical without the top samples", where);
      for (int y = 0; y < 16; ++y) memcpy(dst + y * stride, dst - stride, 16);
      break;
    case 1:
      if (!left) fail("%s: Intra16x16 horizontal without the left samples", where);
      for (int y = 0; y < 16; ++y) memset(dst + y * stride, dst[y * stride - 1], 16);
      break;
    case 2: {
      int s = 0, v;
      if (top && left) {
        for (int i = 0; i < 16; ++i) s += dst[-stride + i] + dst[i * stride - 1];
        v = (s + 16) >> 5;
      } else if (left) {
        for (int i = 0; i < 16; ++i) s += dst[i * stride - 1];
        v = (s + 8) >> 4;
      } else if (top) {
        for (int i = 0; i < 16; ++i) s += dst[-stride + i];
        v = (s + 8) >> 4;
      } else {
        v = 128;
      }
      for (int y = 0; y < 16; ++y) memset(dst + y * stride, v, 16);
      break;
    }
    default: {
      if (!(top && left && tl)) fail("%s: Intra16x16 plane without its neighbours", where);
      auto T = [&](int x) { return (int)dst[-stride + x]; };  // x = -1 is the corner
      auto L = [&](int y) { return (int)dst[y * stride - 1]; };
      int H = 0, V = 0;
      for (int i = 0; i < 8; ++i) {
        H += (i + 1) * (T(8 + i) - T(6 - i));
        V += (i + 1) * (L(8 + i) - (6 - i >= 0 ? L(6 - i) : T(-1)));
      }
      int a = 16 * (L(15) + T(15)), b = (5 * H + 32) >> 6, c = (5 * V + 32) >> 6;
      uint8_t out[16][16];
      for (int y = 0; y < 16; ++y)
        for (int x = 0; x < 16; ++x) out[y][x] = clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5);
      for (int y = 0; y < 16; ++y) memcpy(dst + y * stride, out[y], 16);
    }
  }
}

void Decoder::intra_chroma(int mode) {
  int stride = cur->width / 2;
  bool left = intra_ok(mbx - 1, mby), top = intra_ok(mbx, mby - 1), tl = intra_ok(mbx - 1, mby - 1);
  for (int c = 1; c <= 2; ++c) {
    uint8_t* dst = cur->plane[c].data() + mby * 8 * stride + mbx * 8;
    switch (mode) {
      case 0:  // DC, per 4x4 block
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            int st = 0, sl = 0;
            for (int i = 0; i < 4; ++i) {
              if (top) st += dst[-stride + bx * 4 + i];
              if (left) sl += dst[(by * 4 + i) * stride - 1];
            }
            int v;
            if (bx == by) {
              if (top && left) v = (st + sl + 4) >> 3;
              else if (left) v = (sl + 2) >> 2;
              else if (top) v = (st + 2) >> 2;
              else v = 128;
            } else if (bx == 1) {  // top-right block: the top first
              if (top) v = (st + 2) >> 2;
              else if (left) v = (sl + 2) >> 2;
              else v = 128;
            } else {  // bottom-left block: the left first
              if (left) v = (sl + 2) >> 2;
              else if (top) v = (st + 2) >> 2;
              else v = 128;
            }
            for (int y = 0; y < 4; ++y) memset(dst + (by * 4 + y) * stride + bx * 4, v, 4);
          }
        break;
      case 1:
        if (!left) fail("%s: chroma horizontal without the left samples", where);
        for (int y = 0; y < 8; ++y) memset(dst + y * stride, dst[y * stride - 1], 8);
        break;
      case 2:
        if (!top) fail("%s: chroma vertical without the top samples", where);
        for (int y = 0; y < 8; ++y) memcpy(dst + y * stride, dst - stride, 8);
        break;
      default: {
        if (!(top && left && tl)) fail("%s: chroma plane without its neighbours", where);
        auto T = [&](int x) { return (int)dst[-stride + x]; };
        auto L = [&](int y) { return y < 0 ? (int)dst[-stride - 1] : (int)dst[y * stride - 1]; };
        int H = 0, V = 0;
        for (int i = 0; i < 4; ++i) {
          H += (i + 1) * (T(4 + i) - T(2 - i));
          V += (i + 1) * (L(4 + i) - L(2 - i));
        }
        int a = 16 * (L(7) + T(7)), b = (34 * H + 32) >> 6, cc = (34 * V + 32) >> 6;
        uint8_t out[8][8];
        for (int y = 0; y < 8; ++y)
          for (int x = 0; x < 8; ++x) out[y][x] = clip1((a + b * (x - 3) + cc * (y - 3) + 16) >> 5);
        for (int y = 0; y < 8; ++y) memcpy(dst + y * stride, out[y], 8);
      }
    }
  }
}

// Motion: the neighbour at sample (x, y) relative to the macroblock.
Neighbor Decoder::neighbor(int x, int y) const {
  Neighbor n;
  int nx = mbx, ny = mby;
  if (y < 0) {
    ny = mby - 1;
    if (x < 0) nx = mbx - 1;
    else if (x >= 16) nx = mbx + 1;
  } else if (x < 0) {
    nx = mbx - 1;
  } else if (x >= 16) {
    return n;
  }
  int bx = (x + 16) % 16 / 4, by = (y + 16) % 16 / 4;
  if (nx == mbx && ny == mby) {
    if (!written[by * 4 + bx]) return n;
  } else if (!mb_available(nx, ny)) {
    return n;
  }
  n.avail = true;
  size_t i = (size_t)(ny * 4 + by) * w4 + nx * 4 + bx;
  n.ref = refidx[i];
  if (n.ref >= 0) n.mv = mv[i];
  return n;
}

static inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// shape: 0 any, 1 16x8, 2 8x16
Mv Decoder::predict_mv(int x, int y, int w, int ref, int shape) const {
  Neighbor A = neighbor(x - 1, y), B = neighbor(x, y - 1), C = neighbor(x + w, y - 1);
  if (!C.avail) C = neighbor(x - 1, y - 1);
  if (shape == 1) {
    if (y == 0 && B.ref == ref) return B.mv;
    if (y != 0 && A.ref == ref) return A.mv;
  } else if (shape == 2) {
    if (x == 0 && A.ref == ref) return A.mv;
    if (x != 0 && C.ref == ref) return C.mv;
  }
  if (!B.avail && !C.avail && A.avail) B = C = A;
  int match = (A.ref == ref) + (B.ref == ref) + (C.ref == ref);
  if (match == 1) {
    if (A.ref == ref) return A.mv;
    if (B.ref == ref) return B.mv;
    return C.mv;
  }
  Mv m;
  m.x = (int16_t)median3(A.mv.x, B.mv.x, C.mv.x);
  m.y = (int16_t)median3(A.mv.y, B.mv.y, C.mv.y);
  return m;
}

void Decoder::set_motion(int x, int y, int w, int h, int ref, Mv m) {
  int pid = reference(ref)->id;
  for (int by = y / 4; by < (y + h) / 4; ++by)
    for (int bx = x / 4; bx < (x + w) / 4; ++bx) {
      size_t i = (size_t)(mby * 4 + by) * w4 + mbx * 4 + bx;
      refidx[i] = (int8_t)ref;
      refpic[i] = pid;
      mv[i] = m;
      written[by * 4 + bx] = true;
    }
}

void Decoder::motion_compensate(int x, int y, int w, int h, int ref, Mv m) {
  const Picture* R = reference(ref);
  int W = cur->width, H = cur->height;
  // luma
  int xi = mbx * 16 + x + (m.x >> 2), yi = mby * 16 + y + (m.y >> 2), fx = m.x & 3, fy = m.y & 3;
  int win[21][21];
  const uint8_t* src = R->plane[0].data();
  bool inside = xi - 2 >= 0 && xi + w + 3 <= W && yi - 2 >= 0 && yi + h + 3 <= H;
  for (int r = 0; r < h + 5; ++r) {
    int yy = std::min(std::max(yi - 2 + r, 0), H - 1);
    const uint8_t* row = src + (size_t)yy * W;
    if (inside)
      for (int c = 0; c < w + 5; ++c) win[r][c] = row[xi - 2 + c];
    else
      for (int c = 0; c < w + 5; ++c) win[r][c] = row[std::min(std::max(xi - 2 + c, 0), W - 1)];
  }
  uint8_t* dst = cur->plane[0].data() + (mby * 16 + y) * W + mbx * 16 + x;
  auto tap = [](const int* p, int step) {
    return p[0] - 5 * p[step] + 20 * p[2 * step] + 20 * p[3 * step] - 5 * p[4 * step] + p[5 * step];
  };
  if (!fx && !fy) {
    for (int py = 0; py < h; ++py)
      for (int px = 0; px < w; ++px) dst[py * W + px] = (uint8_t)win[py + 2][px + 2];
  } else {
    // the half samples once each: b1 on every window row (j filters them
    // vertically), h on columns 0..w (m is h one column right)
    int B1[21][16], Bc[21][16], Hc[16][17], J[16][16];
    int c_ = fy * 4 + fx;
    bool need_j = c_ == 6 || c_ == 9 || c_ == 10 || c_ == 11 || c_ == 14;
    bool need_h = fx == 0 || fx == 3 || c_ == 5 || c_ == 9 || c_ == 13;
    bool need_b = fx != 0 || need_j;
    // rows of b: 2..h+1, and h+2 where s (b one row down) is read; all with j
    int r0 = need_j ? 0 : 2, r1 = need_j ? h + 5 : (fy == 3 ? h + 3 : h + 2);
    if (need_b)
      for (int r = r0; r < r1; ++r)
        for (int c = 0; c < w; ++c) {
          B1[r][c] = tap(&win[r][c], 1);
          Bc[r][c] = clip1((B1[r][c] + 16) >> 5);
        }
    if (need_h)
      for (int r = 0; r < h; ++r)
        for (int c = 0; c <= w; ++c) Hc[r][c] = clip1((tap(&win[r][c + 2], 21) + 16) >> 5);
    if (need_j)
      for (int r = 0; r < h; ++r)
        for (int c = 0; c < w; ++c) {
          int col[6];
          for (int k = 0; k < 6; ++k) col[k] = B1[r + k][c];
          J[r][c] = clip1((tap(col, 1) + 512) >> 10);
        }
    // the sample of each position (8.4.2.2.1), one loop per position
#define MC_CASE(k, expr)                                                   \
  case k:                                                                  \
    for (int py = 0; py < h; ++py)                                         \
      for (int px = 0; px < w; ++px) dst[py * W + px] = (uint8_t)(expr);   \
    break;
#define G_ win[py + 2][px + 2]
#define B_ Bc[py + 2][px]
#define H_ Hc[py][px]
#define J_ J[py][px]
#define M_ Hc[py][px + 1]
#define S_ Bc[py + 3][px]
    switch (c_) {
      MC_CASE(1, (G_ + B_ + 1) >> 1)
      MC_CASE(2, B_)
      MC_CASE(3, (B_ + win[py + 2][px + 3] + 1) >> 1)
      MC_CASE(4, (G_ + H_ + 1) >> 1)
      MC_CASE(5, (B_ + H_ + 1) >> 1)
      MC_CASE(6, (B_ + J_ + 1) >> 1)
      MC_CASE(7, (B_ + M_ + 1) >> 1)
      MC_CASE(8, H_)
      MC_CASE(9, (H_ + J_ + 1) >> 1)
      MC_CASE(10, J_)
      MC_CASE(11, (J_ + M_ + 1) >> 1)
      MC_CASE(12, (win[py + 3][px + 2] + H_ + 1) >> 1)
      MC_CASE(13, (H_ + S_ + 1) >> 1)
      MC_CASE(14, (J_ + S_ + 1) >> 1)
      MC_CASE(15, (M_ + S_ + 1) >> 1)
    }
#undef MC_CASE
#undef G_
#undef B_
#undef H_
#undef J_
#undef M_
#undef S_
  }
  // chroma
  int CW = W / 2, CH = H / 2, cw = w / 2, ch = h / 2;
  int cxi = (mbx * 16 + x) / 2 + (m.x >> 3), cyi = (mby * 16 + y) / 2 + (m.y >> 3);
  int cfx = m.x & 7, cfy = m.y & 7;
  for (int c = 1; c <= 2; ++c) {
    const uint8_t* s = R->plane[c].data();
    uint8_t* d = cur->plane[c].data() + ((mby * 16 + y) / 2) * CW + (mbx * 16 + x) / 2;
    for (int py = 0; py < ch; ++py) {
      int y0 = std::min(std::max(cyi + py, 0), CH - 1),
          y1 = std::min(std::max(cyi + py + 1, 0), CH - 1);
      for (int px = 0; px < cw; ++px) {
        int x0 = std::min(std::max(cxi + px, 0), CW - 1),
            x1 = std::min(std::max(cxi + px + 1, 0), CW - 1);
        int A = s[y0 * CW + x0], B = s[y0 * CW + x1], C = s[y1 * CW + x0], D = s[y1 * CW + x1];
        d[py * CW + px] = (uint8_t)(((8 - cfx) * (8 - cfy) * A + cfx * (8 - cfy) * B +
                                     (8 - cfx) * cfy * C + cfx * cfy * D + 32) >> 6);
      }
    }
  }
}

void Decoder::macroblock(bool skip) {
  Bits& b = bits;
  int addr = mb_addr;
  mb_slice[addr] = slice_num;
  for (int i = 0; i < 16; ++i) written[i] = false;
  if (skip) {
    mb_kind[addr] = MB_SKIP;
    mb_qp[addr] = (int8_t)qp;
    Neighbor A = neighbor(-1, 0), B = neighbor(0, -1);
    Mv m;
    if (!(!mb_available(mbx - 1, mby) || !mb_available(mbx, mby - 1) ||
          (A.ref == 0 && A.mv.x == 0 && A.mv.y == 0) || (B.ref == 0 && B.mv.x == 0 && B.mv.y == 0)))
      m = predict_mv(0, 0, 16, 0, 0);
    set_motion(0, 0, 16, 16, 0, m);
    motion_compensate(0, 0, 16, 16, 0, m);
    return;
  }
  int mb_type = (int)b.ue();
  bool intra = true;
  if (slice_type == 0) {
    if (mb_type < 5) intra = false;
    else mb_type -= 5;
  }
  if (intra && mb_type > 25) fail("%s: mb_type %d", where, mb_type);
  memset(coef, 0, sizeof coef);
  memset(ccoef, 0, sizeof ccoef);
  memset(dc_luma, 0, sizeof dc_luma);
  memset(dc_chroma, 0, sizeof dc_chroma);
  size_t base4 = (size_t)(mby * 4) * w4 + mbx * 4;
  if (intra && mb_type == 25) {  // I_PCM
    mb_kind[addr] = MB_PCM;
    b.pos = (b.pos + 7) & ~(size_t)7;
    int stride = cur->width;
    for (int y = 0; y < 16; ++y)
      for (int x = 0; x < 16; ++x)
        cur->plane[0][(mby * 16 + y) * stride + mbx * 16 + x] = (uint8_t)b.u(8);
    for (int c = 1; c <= 2; ++c)
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x)
          cur->plane[c][(mby * 8 + y) * (stride / 2) + mbx * 8 + x] = (uint8_t)b.u(8);
    mb_qp[addr] = 0;
    for (int by = 0; by < 4; ++by)
      for (int bx = 0; bx < 4; ++bx) nz[base4 + by * w4 + bx] = 16;
    for (int c = 0; c < 2; ++c)
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx) nzc[c][(mby * 2 + by) * mbw * 2 + mbx * 2 + bx] = 16;
    return;  // QP_Y stays QP_Y,PRED; the filter reads 0 for I_PCM
  }
  int cbp = 0, i16_mode = 0, chroma_mode = 0;
  bool i16 = false;
  if (intra) {
    if (mb_type == 0) {
      mb_kind[addr] = MB_I4;
      for (int blk = 0; blk < 16; ++blk) {
        bool prev = b.flag();
        int rem = prev ? 0 : (int)b.u(3);
        int bx = mbx * 4 + kBlkX[blk], by = mby * 4 + kBlkY[blk];
        // predicted mode from the left and top 4x4 blocks
        int lx = kBlkX[blk], ly = kBlkY[blk];
        bool a_ok = lx > 0 || mb_available(mbx - 1, mby),
            t_ok = ly > 0 || mb_available(mbx, mby - 1);
        int pred = 2;
        if (a_ok && t_ok) {
          // -1: an inter neighbour under constrained_intra_pred (DC predicted)
          auto mode_of = [&](int x4, int y4) -> int {
            int mx = x4 >> 2, my = y4 >> 2;
            if (mx != mbx || my != mby) {
              uint8_t k = mb_kind[my * mbw + mx];
              if ((k == MB_P || k == MB_SKIP) && pps->constrained_intra_pred) return -1;
              if (k != MB_I4) return 2;
            }
            return i4mode[(size_t)y4 * w4 + x4];
          };
          int ma = mode_of(bx - 1, by), mt = mode_of(bx, by - 1);
          if (ma >= 0 && mt >= 0) pred = std::min(ma, mt);
        }
        int mode = prev ? pred : (rem < pred ? rem : rem + 1);
        i4mode[(size_t)by * w4 + bx] = (int8_t)mode;
        i4_modes_[blk] = mode;
      }
      chroma_mode = (int)b.ue();
    } else {
      mb_kind[addr] = MB_I16;
      i16 = true;
      i16_mode = (mb_type - 1) % 4;
      cbp = (((mb_type - 1) / 4) % 3) << 4;
      if (mb_type >= 13) cbp |= 15;
      chroma_mode = (int)b.ue();
    }
    if (chroma_mode > 3) fail("%s: intra_chroma_pred_mode %d", where, chroma_mode);
    for (int i = 0; i < 16; ++i) refidx[base4 + (i / 4) * w4 + i % 4] = -1;
  } else {
    mb_kind[addr] = MB_P;
    int refs_[4] = {0, 0, 0, 0};
    Mv mvd[4][4];
    int sub[4] = {0, 0, 0, 0};
    int nparts = mb_type == 0 ? 1 : (mb_type < 3 ? 2 : 4);
    auto read_ref = [&]() -> int {
      if (num_ref_active <= 1) return 0;
      int r = num_ref_active == 2 ? !b.u(1) : (int)b.ue();
      if (r >= num_ref_active) fail("%s: ref_idx %d of %d", where, r, num_ref_active);
      return r;
    };
    if (nparts == 4) {
      for (int i = 0; i < 4; ++i) {
        sub[i] = (int)b.ue();
        if (sub[i] > 3) fail("%s: sub_mb_type %d", where, sub[i]);
      }
      for (int i = 0; i < 4; ++i) refs_[i] = mb_type == 4 ? 0 : read_ref();
      for (int i = 0; i < 4; ++i) {
        int n = sub[i] == 0 ? 1 : (sub[i] == 3 ? 4 : 2);
        for (int j = 0; j < n; ++j) {
          mvd[i][j].x = (int16_t)b.se();
          mvd[i][j].y = (int16_t)b.se();
        }
      }
    } else {
      for (int i = 0; i < nparts; ++i) refs_[i] = read_ref();
      for (int i = 0; i < nparts; ++i) {
        mvd[i][0].x = (int16_t)b.se();
        mvd[i][0].y = (int16_t)b.se();
      }
    }
    for (int i = 0; i < nparts; ++i) {
      if (nparts == 4) {
        int x0 = (i & 1) * 8, y0 = (i >> 1) * 8;
        int sw = sub[i] == 0 || sub[i] == 1 ? 8 : 4, sh = sub[i] == 0 || sub[i] == 2 ? 8 : 4;
        int n = sub[i] == 0 ? 1 : (sub[i] == 3 ? 4 : 2);
        for (int j = 0; j < n; ++j) {
          int x = x0 + (sw == 4 ? (j & 1) * 4 : 0),
              y = y0 + (sh == 4 ? (sw == 4 ? (j >> 1) : j) * 4 : 0);
          Mv p = predict_mv(x, y, sw, refs_[i], 0);
          Mv m;
          m.x = (int16_t)(p.x + mvd[i][j].x);
          m.y = (int16_t)(p.y + mvd[i][j].y);
          set_motion(x, y, sw, sh, refs_[i], m);
          motion_compensate(x, y, sw, sh, refs_[i], m);
        }
      } else {
        int x = 0, y = 0, w = 16, h = 16, shape = 0;
        if (mb_type == 1) h = 8, y = 8 * i, shape = 1;
        if (mb_type == 2) w = 8, x = 8 * i, shape = 2;
        Mv p = predict_mv(x, y, w, refs_[i], shape);
        Mv m;
        m.x = (int16_t)(p.x + mvd[i][0].x);
        m.y = (int16_t)(p.y + mvd[i][0].y);
        set_motion(x, y, w, h, refs_[i], m);
        motion_compensate(x, y, w, h, refs_[i], m);
      }
    }
  }
  if (!i16) {
    int code = (int)b.ue();
    if (code > 47) fail("%s: coded_block_pattern %d", where, code);
    cbp = intra ? kIntraCbp[code] : kInterCbp[code];
  }
  if ((cbp & 15) || (cbp >> 4) || i16) {
    int d = b.se();
    if (d < -26 || d > 25) fail("%s: mb_qp_delta %d", where, d);
    qp = (qp + d + 52) % 52;
  }
  mb_qp[addr] = (int8_t)qp;
  // residual
  residual_luma(cbp, i16);
  residual_chroma(cbp >> 4);
  // reconstruction
  if (intra) {
    if (i16) {
      intra16x16(i16_mode);
      dequant_luma(qp);
      for (int blk = 0; blk < 16; ++blk)
        add_luma_residual(mbx * 4 + kBlkX[blk], mby * 4 + kBlkY[blk], coef[blk], true);
    } else {
      dequant_luma(qp);
      for (int blk = 0; blk < 16; ++blk) {
        intra4x4(blk, i4_modes_[blk]);
        add_luma_residual(mbx * 4 + kBlkX[blk], mby * 4 + kBlkY[blk], coef[blk], false);
      }
    }
    intra_chroma(chroma_mode);
  } else {
    dequant_luma(qp);
    for (int blk = 0; blk < 16; ++blk)
      add_luma_residual(mbx * 4 + kBlkX[blk], mby * 4 + kBlkY[blk], coef[blk], false);
  }
  recon_chroma(cbp >> 4);
}

void Decoder::residual_luma(int cbp, bool i16) {
  size_t base4 = (size_t)(mby * 4) * w4 + mbx * 4;
  int16_t scan[16];
  if (i16) {
    memset(scan, 0, sizeof scan);
    block(luma_nc(mbx * 4, mby * 4), 16, scan, 0, "Intra16x16 DC");
    for (int k = 0; k < 16; ++k) dc_luma[kZigzag[k]] = scan[k];
  }
  for (int blk = 0; blk < 16; ++blk) {
    int bx = mbx * 4 + kBlkX[blk], by = mby * 4 + kBlkY[blk];
    int total = 0;
    if (cbp & (1 << (blk / 4))) {
      memset(scan, 0, sizeof scan);
      int nc = luma_nc(bx, by);
      if (i16) total = block(nc, 15, scan, 1, "Intra16x16 AC");
      else total = block(nc, 16, scan, 0, "luma 4x4");
      for (int k = 0; k < 16; ++k) coef[blk][kZigzag[k]] = scan[k];
    }
    nz[base4 + (size_t)kBlkY[blk] * w4 + kBlkX[blk]] = (uint8_t)total;
  }
}

void Decoder::residual_chroma(int cbp_chroma) {
  int w2 = mbw * 2;
  int16_t scan[16];
  if (cbp_chroma & 3) {
    for (int c = 0; c < 2; ++c) {
      memset(scan, 0, sizeof scan);
      block(-1, 4, scan, 0, "chroma DC");
      for (int k = 0; k < 4; ++k) dc_chroma[c][k] = scan[k];
    }
  }
  for (int c = 0; c < 2; ++c)
    for (int blk = 0; blk < 4; ++blk) {
      int bx = mbx * 2 + (blk & 1), by = mby * 2 + (blk >> 1);
      int total = 0;
      if (cbp_chroma & 2) {
        memset(scan, 0, sizeof scan);
        total = block(chroma_nc(c, bx, by), 15, scan, 1, "chroma AC");
        for (int k = 1; k < 16; ++k) ccoef[c][blk][kZigzag[k]] = scan[k];
      }
      nzc[c][by * w2 + bx] = (uint8_t)total;
    }
}

static inline int level_scale(int m, int pos) {
  int i = pos >> 2, j = pos & 3;
  if (!(i & 1) && !(j & 1)) return kDequant[m][0];
  if ((i & 1) && (j & 1)) return kDequant[m][1];
  return kDequant[m][2];
}

void Decoder::dequant_luma(int q) {
  int q6 = q / 6, m = q % 6;
  bool i16 = mb_kind[mb_addr] == MB_I16;
  for (int blk = 0; blk < 16; ++blk)
    for (int k = i16 ? 1 : 0; k < 16; ++k)
      if (coef[blk][k]) coef[blk][k] = (int16_t)(coef[blk][k] * level_scale(m, k) * (1 << q6));
  if (i16) {
    int c[16], f[16], t[16];
    for (int k = 0; k < 16; ++k) c[k] = dc_luma[k];
    for (int i = 0; i < 4; ++i) {  // rows
      int a = c[4 * i], b = c[4 * i + 1], cc = c[4 * i + 2], d = c[4 * i + 3];
      t[4 * i] = a + b + cc + d;
      t[4 * i + 1] = a + b - cc - d;
      t[4 * i + 2] = a - b - cc + d;
      t[4 * i + 3] = a - b + cc - d;
    }
    for (int j = 0; j < 4; ++j) {
      int a = t[j], b = t[4 + j], cc = t[8 + j], d = t[12 + j];
      f[j] = a + b + cc + d;
      f[4 + j] = a + b - cc - d;
      f[8 + j] = a - b - cc + d;
      f[12 + j] = a - b + cc - d;
    }
    int ls = 16 * kDequant[m][0];
    for (int k = 0; k < 16; ++k) {
      int64_t fk = f[k];
      int v = (int)(q >= 36 ? fk * ls * (1 << (q6 - 6)) : (fk * ls + (1 << (5 - q6))) >> (6 - q6));
      // the DC of the 4x4 block at (x, y) = (k & 3, k >> 2)
      int blk = 0;
      for (int bb = 0; bb < 16; ++bb)
        if (kBlkX[bb] == (k & 3) && kBlkY[bb] == (k >> 2)) blk = bb;
      coef[blk][0] = (int16_t)v;
    }
  }
}

void Decoder::recon_chroma(int cbp_chroma) {
  int stride = cur->width / 2;
  for (int c = 0; c < 2; ++c) {
    int qpc = kChromaQp[std::min(std::max(qp + pps->chroma_qp_offset[c], 0), 51)];
    int q6 = qpc / 6, m = qpc % 6;
    if (cbp_chroma) {
      int c0 = dc_chroma[c][0], c1 = dc_chroma[c][1], c2 = dc_chroma[c][2], c3 = dc_chroma[c][3];
      int f[4] = {c0 + c1 + c2 + c3, c0 - c1 + c2 - c3, c0 + c1 - c2 - c3, c0 - c1 - c2 + c3};
      int ls = 16 * kDequant[m][0];
      for (int k = 0; k < 4; ++k) {
        for (int p = 1; p < 16; ++p)
          if (ccoef[c][k][p])
            ccoef[c][k][p] = (int16_t)(ccoef[c][k][p] * level_scale(m, p) * (1 << q6));
        ccoef[c][k][0] = (int16_t)(((int64_t)f[k] * ls * (1 << q6)) >> 5);
      }
      for (int k = 0; k < 4; ++k) {
        bool any = false;
        for (int p = 0; p < 16 && !any; ++p) any = ccoef[c][k][p] != 0;
        if (!any) continue;
        uint8_t* dst = cur->plane[c + 1].data() + (mby * 8 + (k >> 1) * 4) * stride + mbx * 8 +
                       (k & 1) * 4;
        idct4x4_add(ccoef[c][k], dst, stride);
      }
    }
  }
}

// --------------------------------------------------------- deblocking

void Decoder::deblock() {
  for (int y = 0; y < mbh; ++y)
    for (int x = 0; x < mbw; ++x) deblock_mb(x, y);
}

static void filter_line(uint8_t* p, int step, int bS, int alpha, int beta, int tc0, bool chroma) {
  int p0 = p[-step], p1 = p[-2 * step], q0 = p[0], q1 = p[step];
  if (!(abs(p0 - q0) < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) return;
  if (bS < 4) {
    if (chroma) {
      int tc = tc0 + 1;
      int delta = std::min(std::max((((q0 - p0) * 4 + (p1 - q1) + 4) >> 3), -tc), tc);
      p[-step] = clip1(p0 + delta);
      p[0] = clip1(q0 - delta);
      return;
    }
    int p2 = p[-3 * step], q2 = p[2 * step];
    int ap = abs(p2 - p0), aq = abs(q2 - q0);
    int tc = tc0 + (ap < beta) + (aq < beta);
    int delta = std::min(std::max((((q0 - p0) * 4 + (p1 - q1) + 4) >> 3), -tc), tc);
    p[-step] = clip1(p0 + delta);
    p[0] = clip1(q0 - delta);
    auto clip_tc0 = [tc0](int v) { return std::min(std::max(v, -tc0), tc0); };
    int avg = (p0 + q0 + 1) >> 1;
    if (ap < beta) p[-2 * step] = (uint8_t)(p1 + clip_tc0((p2 + avg - (p1 << 1)) >> 1));
    if (aq < beta) p[step] = (uint8_t)(q1 + clip_tc0((q2 + avg - (q1 << 1)) >> 1));
    return;
  }
  if (chroma) {
    p[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    p[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    return;
  }
  int p2 = p[-3 * step], q2 = p[2 * step], p3 = p[-4 * step], q3 = p[3 * step];
  int ap = abs(p2 - p0), aq = abs(q2 - q0);
  bool strong = abs(p0 - q0) < ((alpha >> 2) + 2);
  if (ap < beta && strong) {
    p[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    p[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    p[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    p[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (aq < beta && strong) {
    p[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
    p[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
    p[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    p[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

void Decoder::deblock_mb(int x, int y) {
  int addr = y * mbw + x;
  const SliceParams& sp = slices[mb_slice[addr]];
  if (sp.disable_deblock == 1) return;
  auto intra = [&](int a) {
    uint8_t k = mb_kind[a];
    return k == MB_I4 || k == MB_I16 || k == MB_PCM;
  };
  int W = cur->width, CW = W / 2;
  for (int dir = 0; dir < 2; ++dir) {  // 0: vertical edges, 1: horizontal edges
    for (int e = 0; e < 4; ++e) {
      int naddr = addr;
      if (e == 0) {
        int nx = dir == 0 ? x - 1 : x, ny = dir == 0 ? y : y - 1;
        if (nx < 0 || ny < 0) continue;
        naddr = ny * mbw + nx;
        if (sp.disable_deblock == 2 && mb_slice[naddr] != mb_slice[addr]) continue;
      }
      int bS[4];
      for (int k = 0; k < 4; ++k) {
        // q block (bx, by) in 4x4 units of the picture, p its neighbour across the edge
        int qbx = x * 4 + (dir == 0 ? e : k), qby = y * 4 + (dir == 0 ? k : e);
        int pbx = dir == 0 ? qbx - 1 : qbx, pby = dir == 0 ? qby : qby - 1;
        size_t qi = (size_t)qby * w4 + qbx, pi = (size_t)pby * w4 + pbx;
        if (intra(addr) || intra(naddr)) bS[k] = e == 0 ? 4 : 3;
        else if (nz[qi] || nz[pi]) bS[k] = 2;
        else if (refpic[qi] != refpic[pi] || abs(mv[qi].x - mv[pi].x) >= 4 ||
            abs(mv[qi].y - mv[pi].y) >= 4) bS[k] = 1;
        else bS[k] = 0;
      }
      if (!bS[0] && !bS[1] && !bS[2] && !bS[3]) continue;
      // luma
      {
        int qpav = (mb_qp[addr] + mb_qp[naddr] + 1) >> 1;
        int ia = std::min(std::max(qpav + sp.alpha_offset, 0), 51),
            ib = std::min(std::max(qpav + sp.beta_offset, 0), 51);
        int alpha = kAlpha[ia], beta = kBeta[ib];
        for (int i = 0; i < 16; ++i) {
          int s = bS[i >> 2];
          if (!s) continue;
          uint8_t* p = dir == 0 ? cur->plane[0].data() + (y * 16 + i) * W + x * 16 + e * 4
                                : cur->plane[0].data() + (y * 16 + e * 4) * W + x * 16 + i;
          filter_line(p, dir == 0 ? 1 : W, s, alpha, beta, s < 4 ? kTc0[ia][s - 1] : 0, false);
        }
      }
      // chroma: luma edges 0 and 2 are chroma edges 0 and 1
      if (e & 1) continue;
      for (int c = 0; c < 2; ++c) {
        auto cqp = [&](int a) {
          return (int)kChromaQp[std::min(std::max(mb_qp[a] + sp.chroma_qp_offset[c], 0), 51)];
        };
        int qpav = (cqp(addr) + cqp(naddr) + 1) >> 1;
        int ia = std::min(std::max(qpav + sp.alpha_offset, 0), 51),
            ib = std::min(std::max(qpav + sp.beta_offset, 0), 51);
        int alpha = kAlpha[ia], beta = kBeta[ib];
        for (int i = 0; i < 8; ++i) {
          int s = bS[i >> 1];
          if (!s) continue;
          uint8_t* p = dir == 0 ? cur->plane[c + 1].data() + (y * 8 + i) * CW + x * 8 + e * 2
                                : cur->plane[c + 1].data() + (y * 8 + e * 2) * CW + x * 8 + i;
          filter_line(p, dir == 0 ? 1 : CW, s, alpha, beta, s < 4 ? kTc0[ia][s - 1] : 0, true);
        }
      }
    }
  }
}

}  // namespace h264

// ------------------------------------------------------------- C API

namespace {

struct Handle {
  h264::Decoder dec;
  std::string error;
};

template <class F>
int guarded(Handle* h, F f) {
  if (!h->error.empty()) return -1;
  try {
    return f();
  } catch (const h264::Error& e) {
    h->error = e.what;
    h->dec.flush();
    return -1;
  } catch (const std::bad_alloc&) {
    h->error = "out of memory";
    h->dec.flush();
    return -1;
  }
}

}  // namespace

extern "C" {

// A decoder for a track whose samples carry NAL units behind
// nal_length_size-byte lengths (the avcC's lengthSizeMinusOne + 1).
void* h264_new(int nal_length_size) {
  Handle* h = new Handle();
  h->dec.nal_length_size = nal_length_size;
  return h;
}

void h264_free(void* h) { delete (Handle*)h; }

// An SPS or PPS NAL unit (from the avcC). 0, or -1 with h264_error set.
int h264_parameter_set(void* hp, const uint8_t* nal, int64_t size) {
  Handle* h = (Handle*)hp;
  return guarded(h, [&] {
    h->dec.parameter_set(nal, (size_t)size);
    return 0;
  });
}

// The coding feature of the parameter sets seen so far that the decoder
// refuses, naming the profile; "" when it decodes them.
const char* h264_check(void* hp) {
  Handle* h = (Handle*)hp;
  static thread_local std::string r;
  r = h->dec.check();
  return r.c_str();
}

// Decode one sample (an access unit). discard: decode it as a reference
// but never output its picture. Returns the pictures ready for output, or
// -1 with h264_error set.
int h264_decode(void* hp, const uint8_t* data, int64_t size, int64_t pts, int discard) {
  Handle* h = (Handle*)hp;
  return guarded(h, [&] {
    h->dec.decode_sample(data, (size_t)size, pts, discard != 0);
    return (int)h->dec.output.size();
  });
}

// The end of the stream: every picture still held back becomes ready.
int h264_drain(void* hp) {
  Handle* h = (Handle*)hp;
  return guarded(h, [&] {
    h->dec.flush_output();
    return (int)h->dec.output.size();
  });
}

// A seek: drop every picture and reference; decoding starts again at the
// next sample (a keyframe). Clears an error.
void h264_flush(void* hp) {
  Handle* h = (Handle*)hp;
  h->dec.flush();
  h->error.clear();
}

// The next ready picture's cropped size, pts, matrix_coefficients and
// full-range flag; 0 when none is ready.
int h264_peek(void* hp, int* width, int* height, int64_t* pts, int* matrix, int* full_range) {
  Handle* h = (Handle*)hp;
  if (h->dec.output.empty()) return 0;
  const h264::Picture* p = h->dec.output.front();
  *width = p->width - p->crop[0] - p->crop[1];
  *height = p->height - p->crop[2] - p->crop[3];
  *pts = p->pts;
  *matrix = p->matrix;
  *full_range = p->full_range;
  return 1;
}

// Pop the next ready picture: its cropped Y, U, V planes (width x height,
// (width/2) x (height/2)) and its BGR24 conversion, each where the pointer
// is not null. 0, or -1 when no picture is ready.
int h264_take(void* hp, uint8_t* y, uint8_t* u, uint8_t* v, uint8_t* bgr) {
  Handle* h = (Handle*)hp;
  if (h->dec.output.empty()) return -1;
  h264::Picture* p = h->dec.output.front();
  h->dec.output.erase(h->dec.output.begin());
  int W = p->width, w = W - p->crop[0] - p->crop[1], hh = p->height - p->crop[2] - p->crop[3];
  const uint8_t* py = p->plane[0].data() + p->crop[2] * W + p->crop[0];
  const uint8_t* pu = p->plane[1].data() + (p->crop[2] / 2) * (W / 2) + p->crop[0] / 2;
  const uint8_t* pv = p->plane[2].data() + (p->crop[2] / 2) * (W / 2) + p->crop[0] / 2;
  if (y)
    for (int r = 0; r < hh; ++r) memcpy(y + (size_t)r * w, py + (size_t)r * W, w);
  for (int c = 0; c < 2; ++c) {
    uint8_t* out = c ? v : u;
    const uint8_t* src = c ? pv : pu;
    if (out)
      for (int r = 0; r < hh / 2; ++r) memcpy(out + (size_t)r * (w / 2), src + (size_t)r * (W / 2),
          w / 2);
  }
  if (bgr) yuv420_to_bgr(py, W, pu, pv, W / 2, w, hh, bgr, w * 3, p->matrix, p->full_range);
  h->dec.release(p);
  return 0;
}

const char* h264_error(void* hp) { return ((Handle*)hp)->error.c_str(); }

}  // extern "C"
