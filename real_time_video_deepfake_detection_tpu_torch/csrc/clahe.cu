// CLAHE (contrast-limited adaptive histogram equalization) of a batch of u8
// planes on a tiles x tiles grid, the function of the port's
// ops/clahe.clahe_u8_batch (bit-exact with clahe_u8_numpy, OpenCV's
// algorithm), in two kernels:
//
//   clahe_luts   (B, H, W) u8 -> (B, tiles^2, 256) f32 LUTs
//   clahe_apply  (B, H, W) u8 + LUTs -> (B, H, W) u8
//
// Replaces the TPU kernels of real_time_video_deepfake_detection_tpu/kernels/
// clahe.py: clahe_luts_pallas (_hist_lut_kernel: a 256-bin compare-reduce
// histogram and a triangular-matmul CDF per tile) and clahe_apply_pallas
// (_apply_kernel: per tile quadrant, a one-hot(img) @ 4 LUT rows matmul on
// the MXU and static bilinear weight planes). Neither form is copied: the
// TPU kernels round the LUT in f32 and blend with per-quadrant weight
// products, both approximations of the oracle. These kernels compute the
// oracle's arithmetic instead:
//   - the LUT entry is rint(cdf * fl64(255/area)) with the f64 product
//     rounded as numpy rounds it (__dmul_rn, rint: half to even);
//   - each pixel's fractions are v * f32(1/t) - 0.5 minus its floor, and the
//     blend is the nested two-step f32 lerp, every operation rounded on its
//     own (__fmul_rn/__fadd_rn/__fsub_rn: nvcc would otherwise contract
//     a*b + c into a fused multiply-add, which rounds once and breaks
//     equality with the oracle).
//
// What bounds them on an H100: bytes, and below them launch overhead. At a
// full tick (64 faces of 160x160, 20x20 tiles) clahe_luts reads 1.6 MB and
// writes 4.2 MB of LUTs, clahe_apply reads both and writes 1.6 MB: 1.7 and
// 2.2 us at 3.35 TB/s.
//
// clahe_luts first ran one block of 256 threads per (face, tile), 4,096
// blocks for 400 one-byte pixels each: shared atomics piled onto the few
// bins of a smooth face tile, and the block scan cost 16 barriers (8.7x the
// bound). It now runs one warp per (face, tile), 8 tiles per block, and no
// block barrier at all:
//   - each warp counts into its own 1 KB histogram in shared memory with
//     shared atomics, reading the tile as 32-bit words when the tile width,
//     W and the base allow it (20-pixel tile rows do), byte by byte
//     otherwise, each lane with four loads in flight before it counts.
//     Merging equal lanes with __match_any_sync first was slower: 14.2
//     against 5.0 us on half random, half smooth planes and 6.2 against 5.0
//     on constant ones, at 64x160x160 on an H100 80GB HBM3 at 700 W: the
//     warp's shared atomics to one bin cost less than the match;
//   - lane l then owns bins 8l..8l+7 in registers: the clip (excess summed
//     by __reduce_add_sync), OpenCV's batch redistribution and residual
//     steps, an 8-bin serial prefix and a 5-step shuffle scan, the LUT entry
//     rint(cdf * scale) in float64, and two float4 stores.
//
// clahe_apply first ran one thread per output pixel: two 64-bit divisions
// and modulos for (b, y, x), its tile pair and fractions recomputed per
// pixel, a byte loaded and stored, and four scattered 4-byte LUT reads
// from L2, a 32-byte sector each (12.2 us, 5.5x the bound). It now runs one
// block per (band of rows, face), b and the band from the grid, no
// division:
//   - each thread owns a column of 4 pixels (one 32-bit load and store, a
//     byte path for a base that is not 4-byte aligned) and up to
//     kRowsPerThread rows of the band; it finds its columns' tile offsets
//     and fractions once, issues its image loads first, and reads each
//     row's (y1, y2, ya), which the block computes once, from shared memory;
//   - the block stages the band's tile rows of LUTs in shared memory with
//     float4 loads, one LUT every kTileStride = 260 floats: equal pixel
//     values in neighbouring tile columns then fall in different banks;
//   - the four lookups are shared-memory reads, still gathers by pixel value
//     (2-4-way bank conflicts on random planes); the lerp keeps every
//     operation rounded on its own, and the clamped result is rounded half
//     to even by adding 2^23, not by rint and a conversion (both on the
//     quarter-rate conversion unit).
// Bands are two tile heights (4 bands of a 160-row face: 256 blocks of 400
// threads, 2 per SM, at most 4 tile rows = 33 KB staged). Device time at
// 64 x 160 x 160 (half random, half smooth planes), mean of 20 calls under
// torch.profiler on an H100 80GB HBM3 at 700 W, by band rows / threads (a
// variant harness kept outside the repository; PERF.md lists the runs):
// 40/512 6.35-6.41 us (this file); 80/1024 6.27-6.40; 20/256 6.61-6.73;
// 20/128 7.19; cell-aligned 20 (first band 10) 7.70; 16/256 8.32 and 8/256
// 8.17-8.48 (more blocks than fit an SM at once with 64 registers a
// thread); no bank skew 6.57; skipping repeated lookups at the borders 6.67.
// Taken apart at 40/512: 2.07 us is the floor of a kernel that copies the
// 1.6 MB (an empty one of 512 blocks takes 1.11), the arithmetic adds 1.36,
// the LUT staging (7.2 MB from L2 for the tick) 1.3, the lookups 1.7; they
// barely overlap. The bound is 2.23 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBins = 256;
constexpr int kWarps = 8;   // clahe_luts: tiles (warps) per block
constexpr int kChunk = 4;   // clahe_luts: loads each lane has in flight
constexpr int kApplyThreads = 512;   // clahe_apply: most threads a block
constexpr int kMaxBand = 64;         // clahe_apply: most rows a band
constexpr int kRowsPerThread = 4;    // clahe_apply: most rows of a band a thread takes
constexpr int kTileStride = kBins + 4;   // clahe_apply: floats between staged LUTs

__global__ void __launch_bounds__(kWarps * 32)
clahe_luts_kernel(const uint8_t* __restrict__ img, float* __restrict__ luts, int B, int H,
                  int W, int tiles, int th, int tw, int clip, double scale, int words) {
  __shared__ __align__(16) int hists[kWarps][kBins];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = tiles * tiles;
  const int gw = blockIdx.x * kWarps + warp;   // one warp per (face, tile)
  if (gw >= B * n_tiles) return;
  const int b = gw / n_tiles, tile = gw - b * n_tiles;
  const int ty = tile / tiles, tx = tile - ty * tiles;
  int* hist = hists[warp];
  reinterpret_cast<int4*>(hist)[2 * lane] = make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(hist)[2 * lane + 1] = make_int4(0, 0, 0, 0);
  __syncwarp();

  // the histogram: each lane issues kChunk loads, then counts what they
  // brought with shared atomics
  const uint8_t* base = img + ((size_t)b * H + (size_t)ty * th) * W + (size_t)tx * tw;
  const int per_row = words ? tw >> 2 : tw;   // 32-bit words or bytes per tile row
  const int n = th * per_row;
  for (int p0 = 0; p0 < n; p0 += 32 * kChunk) {
    uint32_t q[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int p = p0 + i * 32 + lane;
      if (p < n) {
        const int r = p / per_row;
        const uint8_t* row = base + (size_t)r * W;
        q[i] = words ? __ldg(reinterpret_cast<const uint32_t*>(row) + (p - r * per_row))
                     : __ldg(row + (p - r * per_row));
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (p0 + i * 32 + lane < n) {
        if (words) {
#pragma unroll
          for (int k = 0; k < 4; ++k) atomicAdd(hist + ((q[i] >> (8 * k)) & 0xff), 1);
        } else {
          atomicAdd(hist + q[i], 1);
        }
      }
    }
  }
  __syncwarp();

  // lane l owns bins 8l .. 8l+7
  int h[8];
  const int4 lo = reinterpret_cast<const int4*>(hist)[2 * lane];
  const int4 hi = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
  h[0] = lo.x; h[1] = lo.y; h[2] = lo.z; h[3] = lo.w;
  h[4] = hi.x; h[5] = hi.y; h[6] = hi.z; h[7] = hi.w;
  if (clip > 0) {   // OpenCV's clip, batch redistribution and residual steps
    int over = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int o = h[k] > clip ? h[k] - clip : 0;
      h[k] -= o;
      over += o;
    }
    const int excess = __reduce_add_sync(0xffffffffu, over);
    const int redist = excess / kBins;
    const int residual = excess - redist * kBins;
    // the residual goes one count each to bins 0, step, 2*step, ... below
    // residual*step; rem walks t % step from the lane's first bin
    const int step = residual > 0 ? max(kBins / residual, 1) : kBins;
    const int end = residual * step;
    int rem = (8 * lane) % step;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      h[k] += redist + (rem == 0 && 8 * lane + k < end ? 1 : 0);
      rem = rem + 1 == step ? 0 : rem + 1;
    }
  }

  // inclusive scan: 8 bins in the lane, then across the warp
#pragma unroll
  for (int k = 1; k < 8; ++k) h[k] += h[k - 1];
  int run = h[7];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, run, o);
    if (lane >= o) run += up;
  }
  const int before = run - h[7];
  float q[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const double v = rint(__dmul_rn((double)(before + h[k]), scale));
    q[k] = (float)fmin(fmax(v, 0.0), 255.0);
  }
  float4* dst = reinterpret_cast<float4*>(luts + ((size_t)b * n_tiles + tile) * kBins + 8 * lane);
  dst[0] = make_float4(q[0], q[1], q[2], q[3]);
  dst[1] = make_float4(q[4], q[5], q[6], q[7]);
}

// The tile coordinate of pixel row or column v: v * f32(1/t) - 0.5, each
// operation rounded on its own, as the oracle computes it.
__device__ __forceinline__ float tile_coord(int v, float inv_t) {
  return __fsub_rn(__fmul_rn((float)v, inv_t), 0.5f);
}

__device__ __forceinline__ int clamp_tile(int t, int last) { return min(max(t, 0), last); }

// Four pixels of a row as one 32-bit word: one load and one store where
// the base allows (words), four bytes otherwise.
__device__ __forceinline__ uint32_t load_word(const uint8_t* p, int words) {
  if (words) return __ldg(reinterpret_cast<const uint32_t*>(p));
  return (uint32_t)__ldg(p) | (uint32_t)__ldg(p + 1) << 8 | (uint32_t)__ldg(p + 2) << 16 |
         (uint32_t)__ldg(p + 3) << 24;
}
__device__ __forceinline__ void store_word(uint8_t* p, uint32_t w, int words) {
  if (words) {
    *reinterpret_cast<uint32_t*>(p) = w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = (uint8_t)(w >> (8 * j));
  }
}

// A 4-pixel column's tile columns (as offsets into a staged tile row) and
// fractions.
struct Columns {
  int xo1[4], xo2[4];
  float xa[4], ixa[4];
};

__device__ __forceinline__ Columns columns(int qx, float inv_tw, int last) {
  Columns c;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float txf = tile_coord(4 * qx + j, inv_tw);
    const float fx = floorf(txf);
    c.xa[j] = __fsub_rn(txf, fx);
    c.ixa[j] = __fsub_rn(1.0f, c.xa[j]);
    c.xo1[j] = clamp_tile((int)fx, last) * kTileStride;
    c.xo2[j] = clamp_tile((int)fx + 1, last) * kTileStride;
  }
  return c;
}

// The blend of four pixels (the word q) of a row whose tile rows sit at l1
// and l2 in shared memory: the oracle's nested two-step f32 lerp, every
// operation rounded on its own.
__device__ __forceinline__ uint32_t blend4(const float* l1, const float* l2, float ya,
                                           const Columns& c, uint32_t q) {
  const float iya = __fsub_rn(1.0f, ya);
  uint32_t px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = (q >> (8 * j)) & 0xFF;
    const float tl = l1[c.xo1[j] + v], tr = l1[c.xo2[j] + v];
    const float bl = l2[c.xo1[j] + v], br = l2[c.xo2[j] + v];
    const float top = __fadd_rn(__fmul_rn(tl, c.ixa[j]), __fmul_rn(tr, c.xa[j]));
    const float bot = __fadd_rn(__fmul_rn(bl, c.ixa[j]), __fmul_rn(br, c.xa[j]));
    const float p = __fadd_rn(__fmul_rn(top, iya), __fmul_rn(bot, ya));
    // clamp, then round half to even by adding 2^23: the integer lands in
    // the low mantissa bits (rint and the float-to-int conversion would both
    // take the quarter-rate conversion unit)
    px[j] = __float_as_uint(__fadd_rn(fminf(fmaxf(p, 0.0f), 255.0f), 8388608.0f));
  }
  return __byte_perm(__byte_perm(px[0], px[1], 0x0040), __byte_perm(px[2], px[3], 0x0040),
                     0x5410);
}

// One block per (band of rows, face): grid (bands, B), block (tx, ty).
// Band k holds rows [k * band, (k + 1) * band) clipped to H. Thread (x, y)
// owns 4-pixel columns x, x+tx, ... and band rows y, y+ty, ... (at most
// kRowsPerThread).
__global__ void __launch_bounds__(kApplyThreads)
clahe_apply_kernel(const uint8_t* __restrict__ img, const float* __restrict__ luts,
                   uint8_t* __restrict__ out, int H, int W, int tiles, int band,
                   float inv_th, float inv_tw, int words, int lut4) {
  extern __shared__ __align__(16) float slut[];   // the band's tile rows of LUTs
  __shared__ int srow[kMaxBand][2];               // per band row: y1, y2 offsets in slut
  __shared__ float sya[kMaxBand];
  const int b = blockIdx.y, k = blockIdx.x;
  const int y0 = k * band;
  const int rows = min(H, y0 + band) - y0;
  const int wq = W >> 2, qx0 = threadIdx.x, ty = blockDim.y;
  const size_t base = ((size_t)b * H + y0) * W;
  const uint8_t* src_img = img + base;
  uint8_t* dst_img = out + base;

  // the thread's words of its first column, in flight while the LUTs are staged
  uint32_t q[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.y + i * ty;
    if (qx0 < wq && r < rows) q[i] = load_word(src_img + r * W + 4 * qx0, words);
  }

  // The band's tile rows come from the pixels' own f32 expression at its
  // first and last row: its floor is monotone in y, so they bound every row's
  // (y1, y2). Integer arithmetic can disagree at a boundary for odd tile
  // heights.
  const int last = tiles - 1, row_floats = tiles * kTileStride;
  const int ty_lo = clamp_tile((int)floorf(tile_coord(y0, inv_th)), last);
  const int ty_hi = clamp_tile((int)floorf(tile_coord(y0 + rows - 1, inv_th)) + 1, last);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x, nthr = blockDim.x * ty;

  // stage tile rows ty_lo..ty_hi (one contiguous run of the face's LUTs),
  // one LUT every kTileStride floats
  const float* src = luts + ((size_t)b * tiles + ty_lo) * tiles * kBins;
  const int n = (ty_hi - ty_lo + 1) * tiles * kBins;
  if (lut4) {
    for (int g = tid; g < n / 4; g += nthr)
      reinterpret_cast<float4*>(slut + (g >> 6) * kTileStride)[g & 63] =
          __ldg(reinterpret_cast<const float4*>(src) + g);
  } else {
    for (int i = tid; i < n; i += nthr) slut[(i >> 8) * kTileStride + (i & 255)] = __ldg(src + i);
  }
  for (int r = tid; r < rows; r += nthr) {
    const float tyf = tile_coord(y0 + r, inv_th);
    const float fy = floorf(tyf);
    srow[r][0] = (clamp_tile((int)fy, last) - ty_lo) * row_floats;
    srow[r][1] = (clamp_tile((int)fy + 1, last) - ty_lo) * row_floats;
    sya[r] = __fsub_rn(tyf, fy);
  }
  __syncthreads();

  for (int qx = qx0; qx < wq; qx += blockDim.x) {
    const Columns c = columns(qx, inv_tw, last);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = threadIdx.y + i * ty;
      if (r >= rows) break;
      const int off = r * W + 4 * qx;
      const uint32_t w = qx == qx0 ? q[i] : load_word(src_img + off, words);   // W > 4 * tx only
      store_word(dst_img + off, blend4(slut + srow[r][0], slut + srow[r][1], sya[r], c, w), words);
    }
  }
}

}  // namespace

extern "C" int clahe_luts(const void* img, void* luts, int B, int H, int W, int tiles,
                          int clip, double scale, void* stream) {
  if (B == 0) return 0;
  const int th = H / tiles, tw = W / tiles;
  const int words = tw % 4 == 0 && W % 4 == 0 && (uintptr_t)img % 4 == 0;
  const long long warps = (long long)B * tiles * tiles;
  const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
  clahe_luts_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (float*)luts, B, H, W, tiles, th, tw, clip, scale, words);
  return (int)cudaGetLastError();
}

extern "C" int clahe_apply(const void* img, const void* luts, void* out, int B, int H,
                           int W, int tiles, float inv_th, float inv_tw, void* stream) {
  if ((size_t)B * H * W == 0) return 0;
  if (W % 4 != 0 || H < tiles || B > 65535) return (int)cudaErrorInvalidValue;
  // bands of two tile heights, 4-pixel columns across x and the band's rows
  // spread evenly over y, at most kRowsPerThread a thread
  const int tx = std::min(W / 4, kApplyThreads);
  const int fit = kApplyThreads / tx;   // rows of threads that fit
  const int band = std::min({2 * (H / tiles), kMaxBand, kRowsPerThread * fit});
  const int per = (band + fit - 1) / fit;
  const int ty = (band + per - 1) / per;
  // A band's f32 tile coordinates span (band - 1) / th, so their floors take
  // at most floor((band - 1) / th) + 2 values, each with the tile row below.
  const int trows = std::min(tiles, (band - 1) / (H / tiles) + 3);
  const size_t smem = (size_t)trows * tiles * kTileStride * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;   // more than 11 tiles
  const int words = (uintptr_t)img % 4 == 0 && (uintptr_t)out % 4 == 0;
  const int lut4 = (uintptr_t)luts % 16 == 0;
  clahe_apply_kernel<<<dim3((H + band - 1) / band, B), dim3(tx, ty), smem,
                       (cudaStream_t)stream>>>((const uint8_t*)img, (const float*)luts,
                                               (uint8_t*)out, H, W, tiles, band, inv_th,
                                               inv_tw, words, lut4);
  return (int)cudaGetLastError();
}
