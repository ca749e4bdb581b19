// Viola-Jones Haar cascade evaluator on the host: the `haar_native` rung of
// the face-detector ladder (pipeline/faces.py).
//
// The port's own copy of the JAX package's native evaluator
// (native/haar.cpp). The Python side (models/haar_cascade.py) parses the
// OpenCV cascade XML and hands the packed stump arrays to haar_create;
// haar_detect_raw returns the raw windows of every pyramid level before
// grouping, so the grouping is the numpy one for both evaluators.
//
// Semantics are those of models/haar_cascade.py, which follows OpenCV's
// CascadeClassifierImpl::detectMultiScale: an image pyramid made with cv2's
// INTER_LINEAR fixed-point resize, the 22x22 normrect variance normalisation
// with the setWindow gate (window std must exceed ~10), stump votes
// accumulated in double in corner order, and a stage-0 rejection skipping
// the next x position (a setWindow rejection does not).
//
// One difference from the JAX package's copy: the resize tables keep the
// residual of each source position in float, as cv2's resize.cpp does
// (`fx = (float)((dx+0.5)*scale - 0.5); sx = cvFloor(fx); fx -= sx;`). The
// JAX copy keeps it in double and rounds it late, which moves a Q11
// coefficient by one on some columns; its numpy evaluator resizes through
// the cv2-exact tables. Here both evaluators resize with the same tables,
// so every level of the pyramid is the same bytes (haar_resize_gray exposes
// the resize for the tests).
//
// Plain C interface, bound with ctypes (utils/native_haar.py); built with
// g++ -O3 -march=native -shared -fPIC -std=c++17.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// --- cv2 INTER_LINEAR u8 resize, one channel ------------------------------

struct LinTab {
  std::vector<int> s0, s1;
  std::vector<int32_t> a0, a1;  // coefficients scaled by 2048
};

LinTab make_tab(int src, int dst) {
  LinTab t;
  t.s0.resize(dst);
  t.s1.resize(dst);
  t.a0.resize(dst);
  t.a1.resize(dst);
  const double scale = static_cast<double>(src) / dst;
  for (int x = 0; x < dst; ++x) {
    float f = static_cast<float>((x + 0.5) * scale - 0.5);
    int sx = static_cast<int>(std::floor(f));
    f -= static_cast<float>(sx);
    if (sx < 0) { sx = 0; f = 0.0f; }
    if (sx >= src - 1) { sx = src - 1; f = 0.0f; }
    t.s0[x] = sx;
    t.s1[x] = sx + 1 < src ? sx + 1 : src - 1;
    // cvRound is round-half-to-even, as nearbyintf in the default mode
    t.a1[x] = static_cast<int32_t>(std::nearbyintf(f * 2048.0f));
    t.a0[x] = static_cast<int32_t>(std::nearbyintf((1.0f - f) * 2048.0f));
  }
  return t;
}

void resize_gray_cv2(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  if (sh == dh && sw == dw) {
    memcpy(dst, src, static_cast<size_t>(sh) * sw);
    return;
  }
  if (sh == 2 * dh && sw == 2 * dw) {
    // OpenCV rewrites an exact 2x INTER_LINEAR downscale to its area path
    for (int y = 0; y < dh; ++y) {
      const uint8_t* r0 = src + static_cast<size_t>(2 * y) * sw;
      const uint8_t* r1 = r0 + sw;
      uint8_t* d = dst + static_cast<size_t>(y) * dw;
      for (int x = 0; x < dw; ++x) {
        const int i = 2 * x;
        d[x] = static_cast<uint8_t>((r0[i] + r0[i + 1] + r1[i] + r1[i + 1] + 2) >> 2);
      }
    }
    return;
  }
  const LinTab tx = make_tab(sw, dw);
  const LinTab ty = make_tab(sh, dh);
  std::vector<int32_t> hbuf(static_cast<size_t>(sh) * dw);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * sw;
    int32_t* hrow = hbuf.data() + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      hrow[x] = srow[tx.s0[x]] * tx.a0[x] + srow[tx.s1[x]] * tx.a1[x];
    }
  }
  for (int y = 0; y < dh; ++y) {
    const int32_t* r0 = hbuf.data() + static_cast<size_t>(ty.s0[y]) * dw;
    const int32_t* r1 = hbuf.data() + static_cast<size_t>(ty.s1[y]) * dw;
    const int32_t b0 = ty.a0[y], b1 = ty.a1[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) {
      int32_t v = ((b0 * (r0[x] >> 4)) >> 16) + ((b1 * (r1[x] >> 4)) >> 16);
      v = (v + 2) >> 2;
      drow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// ------------------------------------------------------------- cascade

struct Stage {
  int ntrees;
  float threshold;
  std::vector<float> node_thresh, leaf0, leaf1;
  std::vector<int32_t> rects;  // ntrees*3*4 (x,y,w,h) in the 24x24 window
  std::vector<float> weights;  // ntrees*3
};

struct Cascade {
  int win_w, win_h;
  std::vector<Stage> stages;
};

// Per-stump corner offsets and signed weights for one integral-image stride,
// in the corner order {tl,tr,bl,br} x 3 rects (the numpy reduction's order).
// Built per haar_detect_raw call, so the shared Cascade stays immutable and
// concurrent detections from the server's request threads are safe.
struct ScaleTables {
  std::vector<std::vector<int64_t>> offs;
  std::vector<std::vector<double>> sw;

  void build(const Cascade& c, int64_t stride) {
    static const double sign[4] = {1.0, -1.0, -1.0, 1.0};
    offs.resize(c.stages.size());
    sw.resize(c.stages.size());
    for (size_t s = 0; s < c.stages.size(); ++s) {
      const Stage& st = c.stages[s];
      offs[s].assign(static_cast<size_t>(st.ntrees) * 12, 0);
      sw[s].assign(static_cast<size_t>(st.ntrees) * 12, 0.0);
      for (int t = 0; t < st.ntrees; ++t) {
        for (int r = 0; r < 3; ++r) {
          const int32_t* q = &st.rects[(static_cast<size_t>(t) * 3 + r) * 4];
          const int64_t x = q[0], y = q[1], w = q[2], h = q[3];
          const double wt = st.weights[static_cast<size_t>(t) * 3 + r];
          const int64_t cor[4] = {y * stride + x, y * stride + x + w,
                                  (y + h) * stride + x,
                                  (y + h) * stride + x + w};
          for (int k = 0; k < 4; ++k) {
            offs[s][(static_cast<size_t>(t) * 12) + r * 4 + k] = cor[k];
            sw[s][(static_cast<size_t>(t) * 12) + r * 4 + k] = wt * sign[k];
          }
        }
      }
    }
  }
};

inline int64_t rect_sum(const int64_t* ii, int64_t stride, int64_t y,
                        int64_t x, int64_t w, int64_t h) {
  return ii[(y + h) * stride + x + w] - ii[(y + h) * stride + x]
       - ii[y * stride + x + w] + ii[y * stride + x];
}

int cv_round(double v) { return static_cast<int>(std::nearbyint(v)); }

}  // namespace

extern "C" {

// Version of the exported signatures; utils/native_haar.py checks it.
int haar_abi_version(void) { return 1; }

// cv2.resize(src, (dw, dh), INTER_LINEAR) of a u8 plane, as the pyramid
// takes it.
void haar_resize_gray(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                      int dw) {
  resize_gray_cv2(src, sh, sw, dst, dh, dw);
}

void* haar_create(int win_w, int win_h, int n_stages, const int* ntrees,
                  const float* stage_thresh, const int* rects,
                  const float* weights, const float* node_thresh,
                  const float* leaf0, const float* leaf1) {
  Cascade* c = new Cascade;
  c->win_w = win_w;
  c->win_h = win_h;
  size_t t0 = 0;
  for (int s = 0; s < n_stages; ++s) {
    Stage st;
    st.ntrees = ntrees[s];
    st.threshold = stage_thresh[s];
    st.rects.assign(rects + t0 * 12, rects + (t0 + st.ntrees) * 12);
    st.weights.assign(weights + t0 * 3, weights + (t0 + st.ntrees) * 3);
    st.node_thresh.assign(node_thresh + t0, node_thresh + t0 + st.ntrees);
    st.leaf0.assign(leaf0 + t0, leaf0 + t0 + st.ntrees);
    st.leaf1.assign(leaf1 + t0, leaf1 + t0 + st.ntrees);
    t0 += st.ntrees;
    c->stages.push_back(std::move(st));
  }
  return c;
}

void haar_destroy(void* h) { delete static_cast<Cascade*>(h); }

// Writes raw (x, y, w, h) windows in the input image's coordinates for every
// pyramid level. Returns the TOTAL number of passing windows, which may
// exceed cap/4: only the first cap/4 are written, and the caller retries
// with a larger buffer when the return value is bigger.
int haar_detect_raw(void* hptr, const uint8_t* gray, int H, int W,
                    double scale_factor, int min_w, int min_h, int max_w,
                    int max_h, int* out, int cap) {
  const Cascade& c = *static_cast<const Cascade*>(hptr);
  int n_out = 0;
  const int cap_boxes = cap / 4;

  std::vector<uint8_t> scaled;
  std::vector<int64_t> ii, ii2;
  ScaleTables tables;

  for (double factor = 1.0;; factor *= scale_factor) {
    const int win_w = cv_round(c.win_w * factor);
    const int win_h = cv_round(c.win_h * factor);
    const int sw = cv_round(W / factor);
    const int sh = cv_round(H / factor);
    if (sw - c.win_w <= 0 || sh - c.win_h <= 0) break;
    if (win_w > max_w || win_h > max_h) break;
    if (win_w < min_w || win_h < min_h) continue;

    scaled.resize(static_cast<size_t>(sh) * sw);
    resize_gray_cv2(gray, H, W, scaled.data(), sh, sw);

    const int64_t stride = sw + 1;
    ii.assign(static_cast<size_t>(sh + 1) * stride, 0);
    ii2.assign(static_cast<size_t>(sh + 1) * stride, 0);
    for (int y = 0; y < sh; ++y) {
      int64_t rs = 0, rs2 = 0;
      const uint8_t* row = scaled.data() + static_cast<size_t>(y) * sw;
      int64_t* i0 = ii.data() + static_cast<size_t>(y + 1) * stride;
      int64_t* i1 = ii.data() + static_cast<size_t>(y) * stride;
      int64_t* q0 = ii2.data() + static_cast<size_t>(y + 1) * stride;
      int64_t* q1 = ii2.data() + static_cast<size_t>(y) * stride;
      for (int x = 0; x < sw; ++x) {
        const int64_t v = row[x];
        rs += v;
        rs2 += v * v;
        i0[x + 1] = i1[x + 1] + rs;
        q0[x + 1] = q1[x + 1] + rs2;
      }
    }

    tables.build(c, stride);
    const int ystep = factor > 2.0 ? 1 : 2;
    const int nx = sw - c.win_w;   // exclusive bound (processingRectSize)
    const int ny = sh - c.win_h;
    const int nr_w = c.win_w - 2, nr_h = c.win_h - 2;
    const double area = static_cast<double>(nr_w) * nr_h;

    for (int y = 0; y < ny; y += ystep) {
      for (int x = 0; x < nx; x += ystep) {
        const double s =
            static_cast<double>(rect_sum(ii.data(), stride, y + 1, x + 1, nr_w, nr_h));
        const double sq =
            static_cast<double>(rect_sum(ii2.data(), stride, y + 1, x + 1, nr_w, nr_h));
        // setWindow: zero- and low-variance windows (area/nf >= 0.1, pixel
        // std <= ~10) are rejected with result -1, without the extra x skip
        const double nf2 = area * sq - s * s;
        if (nf2 <= 0.0) continue;
        const double nf = std::sqrt(nf2);
        if (area >= 0.1 * nf) continue;
        const double inv_nf = 1.0 / nf;
        const int64_t base = static_cast<int64_t>(y) * stride + x;

        bool pass = true;
        for (size_t si = 0; si < c.stages.size(); ++si) {
          const Stage& st = c.stages[si];
          double vote_sum = 0.0;
          const int64_t* offs = tables.offs[si].data();
          const double* swt = tables.sw[si].data();
          for (int t = 0; t < st.ntrees; ++t) {
            double v = 0.0;
            const int64_t* o = offs + static_cast<size_t>(t) * 12;
            const double* w = swt + static_cast<size_t>(t) * 12;
            for (int k = 0; k < 12; ++k)
              v += w[k] * static_cast<double>(ii[base + o[k]]);
            const double feat = v * inv_nf;
            vote_sum += feat < static_cast<double>(st.node_thresh[t])
                            ? st.leaf0[t] : st.leaf1[t];
          }
          if (vote_sum < static_cast<double>(st.threshold)) {
            if (si == 0) x += ystep;  // stage-0 rejection: extra skip
            pass = false;
            break;
          }
        }
        if (pass) {
          if (n_out < cap_boxes) {
            out[n_out * 4 + 0] = cv_round(x * factor);
            out[n_out * 4 + 1] = cv_round(y * factor);
            out[n_out * 4 + 2] = win_w;
            out[n_out * 4 + 3] = win_h;
          }
          ++n_out;  // counts past the cap so an overflow is seen
        }
      }
    }
  }
  return n_out;
}

}  // extern "C"
