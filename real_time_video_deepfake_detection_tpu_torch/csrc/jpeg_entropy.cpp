// Baseline JPEG entropy decoder: the host half of the port's JPEG decode.
//
// Parses a JFIF/baseline stream and Huffman-decodes it into quantised DCT
// coefficients, nothing more; dequantisation, the inverse DCT, upsampling
// and colour conversion run in torch (ops/jpeg_decode.py), where they equal
// libjpeg's default decode bit for bit. Plain C interface, bound with ctypes
// (utils/jpeg_ingest.py), built with g++ at first use.
//
// Accepted: SOI, APPn/COM (skipped; APP0 JFIF and APP14 Adobe are read for
// the colour space), DQT with 8- and 16-bit tables, DHT, SOF0/SOF1 at 8-bit
// precision with 1 or 3 components and sampling factors 1-2, DRI with
// RST0-7, SOS (interleaved and non-interleaved sequential scans), byte
// stuffing, fill bytes, EOI. Everything else returns a negative code:
// progressive, lossless and arithmetic-coded frames, 12-bit precision, 2 or
// 4 components, RGB-coded 3-component frames, DNL, and every truncated or
// corrupt stream. The bytes come from the network: every read is bounds
// checked, and a stream that runs out of entropy-coded data inside a scan is
// an error (libjpeg would pad it with zero bits and warn).
//
// Layout shared with Python. info (kInfoLen int32):
//   [0] height [1] width [2] components [3] max h factor [4] max v factor
//   [5] MCUs per row [6] MCU rows [7 + 2c] h factor of component c
//   [8 + 2c] v factor of component c.
// Coefficients of component c: (mcu_rows * v_c, mcus_per_row * h_c, 64)
// int16 in natural (row-major) order within each block, components one
// after another in one buffer. Quant tables: (components, 64) uint16 in
// natural order, each component's table as latched at its first scan.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kInfoLen = 16;
constexpr int64_t kMaxPixels = int64_t(1) << 25;   // 8K UHD fits
constexpr int kMaxBlocksInMcu = 10;                 // as libjpeg (D_MAX_BLOCKS_IN_MCU)

enum Status {
  kOk = 0,
  kNotJpeg = -1,
  kTruncated = -2,
  kCorrupt = -3,
  kUnsupported = -4,
  kTooLarge = -5,
};

// zigzag index -> natural (row-major) index
constexpr uint8_t kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Huff {
  bool defined = false;
  bool dc_ok = false;          // every symbol <= 15 (usable as a DC table)
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
  memcpy(h->val, syms, static_cast<size_t>(nsym));
  h->dc_ok = true;
  for (int i = 0; i < nsym; ++i) h->dc_ok = h->dc_ok && syms[i] <= 15;
  h->defined = true;
  return true;
}

// Entropy-coded segment reader. Stops at a marker (or the end of the data)
// and from then on supplies zero bits, counting them: consuming one of them
// means the scan ran past its data.
struct Bits {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int nbits = 0;
  int zeros = 0;        // zero bits appended after the data stopped
  bool stopped = false;

  void fill() {
    while (nbits <= 56) {
      if (!stopped) {
        if (pos >= n) {
          stopped = true;
          continue;
        }
        uint8_t c = d[pos];
        if (c == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;   // fill bytes
          if (q < n && d[q] == 0x00) {
            pos = q + 1;                      // stuffed 0xFF
          } else {
            stopped = true;                   // a marker (or the end)
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
  uint32_t get(int k) {   // k in 1..16
    if (nbits < k) fill();
    nbits -= k;
    return static_cast<uint32_t>((buf >> nbits) & ((uint64_t(1) << k) - 1));
  }
  // returns the symbol, or -1 for a code not in the table
  int decode(const Huff& h) {
    if (nbits < 16) fill();
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
    if (l > 16) return -1;
    nbits -= l;
    return h.val[(code + h.valoffset[l]) & 0xFF];
  }
};

inline int extend(uint32_t v, int s) {
  return v < (uint32_t(1) << (s - 1)) ? static_cast<int>(v) - (1 << s) + 1
                                      : static_cast<int>(v);
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;            // padded block grid
  int wb = 0, hb = 0;            // blocks that hold image samples
  int16_t* coef = nullptr;
  bool scanned = false;
  uint16_t qt[64];               // latched at the component's first scan
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int32_t info[kInfoLen] = {0};
  bool have_sof = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool ycbcr_checked = false;
  int ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[3];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u16(size_t at) const { return (d[at] << 8) | d[at + 1]; }

  // jdmarker.c next_marker: skip anything up to FF xx with xx not 00/FF.
  int next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) return -1;
      const int m = d[pos++];
      if (m != 0) return m;
    }
  }

  // Reads a segment's length; on success [pos, *end) is its payload.
  int segment(size_t* end) {
    if (pos + 2 > n) return kTruncated;
    const int len = u16(pos);
    if (len < 2) return kCorrupt;
    if (pos + len > n) return kTruncated;
    *end = pos + len;
    pos += 2;
    return kOk;
  }

  int read_sof(int marker) {
    size_t end;
    if (int s = segment(&end)) return s;
    if (have_sof) return kCorrupt;
    if (end - pos < 6) return kCorrupt;
    const int precision = d[pos];
    const int height = u16(pos + 1), width = u16(pos + 3);
    ncomp = d[pos + 5];
    pos += 6;
    if (marker != 0xC0 && marker != 0xC1) return kUnsupported;
    if (precision != 8) return kUnsupported;
    if (height == 0 || width == 0) return kUnsupported;   // DNL not supported
    if (ncomp != 1 && ncomp != 3) return kUnsupported;
    if (end - pos != static_cast<size_t>(3 * ncomp)) return kCorrupt;
    if (int64_t(height) * width > kMaxPixels) return kTooLarge;
    hmax = vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      k.id = d[pos];
      k.h = d[pos + 1] >> 4;
      k.v = d[pos + 1] & 15;
      k.tq = d[pos + 2];
      pos += 3;
      if (k.h < 1 || k.h > 2 || k.v < 1 || k.v > 2) return kUnsupported;
      if (k.tq > 3) return kCorrupt;
      for (int o = 0; o < c; ++o)
        if (comp[o].id == k.id) return kCorrupt;
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    info[0] = height;
    info[1] = width;
    info[2] = ncomp;
    info[3] = hmax;
    info[4] = vmax;
    info[5] = mcux;
    info[6] = mcuy;
    for (int c = 0; c < ncomp; ++c) {
      Comp& k = comp[c];
      info[7 + 2 * c] = k.h;
      info[8 + 2 * c] = k.v;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.wb = static_cast<int>((int64_t(width) * k.h + 8 * hmax - 1) / (8 * hmax));
      k.hb = static_cast<int>((int64_t(height) * k.v + 8 * vmax - 1) / (8 * vmax));
    }
    have_sof = true;
    return kOk;
  }

  int read_dqt() {
    size_t end;
    if (int s = segment(&end)) return s;
    while (pos < end) {
      const int pq = d[pos] >> 4, tq = d[pos] & 15;
      ++pos;
      if (pq > 1 || tq > 3) return kCorrupt;
      const size_t need = pq ? 128 : 64;
      if (end - pos < need) return kCorrupt;
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16(pos + 2 * k) : d[pos + k]);
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
      const int tc = d[pos] >> 4, th = d[pos] & 15;
      if (tc > 1 || th > 3) return kCorrupt;
      const uint8_t* counts = d + pos + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      pos += 17;
      if (total > 256 || end - pos < static_cast<size_t>(total)) return kCorrupt;
      if (!build_huff(counts, d + pos, total, tc ? &ac[th] : &dc[th])) return kCorrupt;
      pos += total;
    }
    return kOk;
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
    if (marker == 0xE0 && len >= 14 && memcmp(d + pos, "JFIF\0", 5) == 0) saw_jfif = true;
    if (marker == 0xEE && len >= 12 && memcmp(d + pos, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
    return kOk;
  }

  // libjpeg's colour-space guess (jdapimin.c default_decompress_parms): only
  // YCbCr is accepted for 3 components.
  bool is_ycbcr() const {
    if (saw_jfif) return true;
    if (saw_adobe) return adobe_transform != 0;
    return !(comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66);
  }

  // Reads the marker expected at a restart boundary.
  int restart(Bits* br, int* next_rst) {
    pos = br->pos;
    const int m = next_marker();
    if (m < 0) return kTruncated;
    if (m != 0xD0 + *next_rst) return kCorrupt;
    *next_rst = (*next_rst + 1) & 7;
    br->pos = pos;
    br->buf = 0;
    br->nbits = 0;
    br->zeros = 0;
    br->stopped = false;
    return kOk;
  }

  int decode_block(Bits* br, const Huff& dct, const Huff& act, int* last_dc, int16_t* blk) {
    int s = br->decode(dct);
    if (s < 0) return kCorrupt;
    int diff = 0;
    if (s) diff = extend(br->get(s), s);
    const int64_t dcv = int64_t(*last_dc) + diff;
    if (dcv > INT32_MAX || dcv < INT32_MIN) return kCorrupt;
    *last_dc = static_cast<int>(dcv);
    blk[0] = static_cast<int16_t>(dcv);   // JCOEF is 16 bits, as in libjpeg
    for (int k = 1; k < 64; ++k) {
      const int rs = br->decode(act);
      if (rs < 0) return kCorrupt;
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) return kCorrupt;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br->get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return kOk;
  }

  int read_sos() {
    size_t end;
    if (int s = segment(&end)) return s;
    if (!have_sof) return kCorrupt;
    if (end - pos < 1) return kCorrupt;
    const int ns = d[pos++];
    if (ns < 1 || ns > ncomp || end - pos != static_cast<size_t>(2 * ns + 3)) return kCorrupt;
    Comp* sc[3];
    int td[3], ta[3];
    for (int i = 0; i < ns; ++i) {
      const int id = d[pos], t = d[pos + 1];
      pos += 2;
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == id) sc[i] = &comp[c];
      if (!sc[i] || sc[i]->scanned) return kCorrupt;
      for (int o = 0; o < i; ++o)
        if (sc[o] == sc[i]) return kCorrupt;
      td[i] = t >> 4;
      ta[i] = t & 15;
      if (td[i] > 3 || ta[i] > 3) return kCorrupt;
      if (!dc[td[i]].defined || !dc[td[i]].dc_ok || !ac[ta[i]].defined) return kCorrupt;
    }
    const int ss = d[pos], se = d[pos + 1], ahal = d[pos + 2];
    pos = end;
    if (ss != 0 || se != 63 || ahal != 0) return kCorrupt;
    if (ncomp == 3 && !ycbcr_checked) {   // decided once, as jpeg_read_header does
      if (!is_ycbcr()) return kUnsupported;
      ycbcr_checked = true;
    }
    for (int i = 0; i < ns; ++i) {   // latch the quant tables (jdinput.c)
      Comp& k = *sc[i];
      if (!qt_defined[k.tq]) return kCorrupt;
      memcpy(k.qt, qt[k.tq], sizeof(k.qt));
      k.scanned = true;
    }
    Bits br{d, n, pos};
    int last_dc[3] = {0, 0, 0};
    int next_rst = 0;
    int64_t todo = restart_interval;
    auto mcu_start = [&]() -> int {
      if (restart_interval) {
        if (todo == 0) {
          if (int s = restart(&br, &next_rst)) return s;
          last_dc[0] = last_dc[1] = last_dc[2] = 0;
          todo = restart_interval;
        }
        --todo;
      }
      return kOk;
    };
    if (ns == 1) {   // non-interleaved: one block per MCU, image blocks only
      Comp& k = *sc[0];
      for (int by = 0; by < k.hb; ++by) {
        for (int bx = 0; bx < k.wb; ++bx) {
          if (int s = mcu_start()) return s;
          int16_t* blk = k.coef + (int64_t(by) * k.bw + bx) * 64;
          if (int s = decode_block(&br, dc[td[0]], ac[ta[0]], &last_dc[0], blk)) return s;
          if (br.overrun()) return kTruncated;
        }
      }
    } else {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > kMaxBlocksInMcu) return kCorrupt;
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (int s = mcu_start()) return s;
          for (int i = 0; i < ns; ++i) {
            Comp& k = *sc[i];
            for (int v = 0; v < k.v; ++v) {
              for (int h = 0; h < k.h; ++h) {
                const int64_t by = int64_t(my) * k.v + v, bx = int64_t(mx) * k.h + h;
                int16_t* blk = k.coef + (by * k.bw + bx) * 64;
                if (int s = decode_block(&br, dc[td[i]], ac[ta[i]], &last_dc[i], blk)) return s;
              }
            }
          }
          if (br.overrun()) return kTruncated;
        }
      }
    }
    pos = br.pos;   // the marker that ended the scan, or data before it
    return kOk;
  }

  // The marker loop. With `coefs` null it stops after the frame header
  // (a probe); otherwise it decodes every scan into buffers laid out from
  // `want` (the probe's info) and ends at EOI.
  int run(const int32_t* want, int16_t* coefs, uint16_t* qtabs) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kNotJpeg;
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0) return kTruncated;
      int s = kOk;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        s = read_sof(m);
        if (s || !coefs) return s;
        if (memcmp(info, want, sizeof(info)) != 0) return kCorrupt;
        int16_t* at = coefs;
        for (int c = 0; c < ncomp; ++c) {
          comp[c].coef = at;
          at += int64_t(comp[c].bh) * comp[c].bw * 64;
        }
      } else if (m == 0xDA) {
        s = read_sos();
      } else if (m == 0xD9) {
        if (!have_sof) return kCorrupt;
        for (int c = 0; c < ncomp; ++c)
          if (!comp[c].scanned) return kCorrupt;
        for (int c = 0; c < ncomp; ++c) memcpy(qtabs + 64 * c, comp[c].qt, sizeof(comp[c].qt));
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
        continue;   // standalone markers
      } else if (m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
        size_t end;   // COM, JPGn
        s = segment(&end);
        if (!s) pos = end;
      } else if (m == 0xCC) {
        s = kUnsupported;   // arithmetic coding
      } else {
        s = kCorrupt;   // JPG, DNL, DHP, EXP, a second SOI, reserved
      }
      if (s) return s;
    }
  }
};

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

// Coefficients and quant tables of one stream whose probe gave `info`. The
// coefficient buffer must be zeroed; 0 or a negative status.
int jpeg_decode_coefs(const uint8_t* data, size_t len, const int32_t* info,
                      int16_t* coefs, uint16_t* qtabs) {
  Decoder dec(data, len);
  return dec.run(info, coefs, qtabs);
}

// jpeg_decode_coefs over n streams on up to n_threads threads (0: one per
// core); statuses into rcs.
void jpeg_decode_coefs_batch(const uint8_t* const* datas, const size_t* lens,
                             const int32_t* infos, int16_t* const* coefs,
                             uint16_t* const* qtabs, int n, int n_threads,
                             int32_t* rcs) {
  if (n <= 0) return;
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min(n_threads, n));
  auto work = [&](int t) {
    for (int i = t; i < n; i += n_threads)
      rcs[i] = jpeg_decode_coefs(datas[i], lens[i], infos + int64_t(i) * kInfoLen,
                                 coefs[i], qtabs[i]);
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < n_threads; ++t) pool.emplace_back(work, t);
  work(0);
  for (auto& th : pool) th.join();
}

}  // extern "C"
