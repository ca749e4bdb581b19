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
// clahe_apply runs one thread per output pixel and reads its four corner
// LUT entries (which stay in L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kWarps = 8;   // clahe_luts: tiles (warps) per block
constexpr int kChunk = 4;   // clahe_luts: loads each lane has in flight

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

__global__ void clahe_apply_kernel(const uint8_t* __restrict__ img,
                                   const float* __restrict__ luts,
                                   uint8_t* __restrict__ out, int B, int H, int W,
                                   int tiles, float inv_th, float inv_tw) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * H * W) return;
  const int x = (int)(i % W);
  const size_t row = i / W;
  const int y = (int)(row % H);
  const int b = (int)(row / H);

  const float tyf = __fsub_rn(__fmul_rn((float)y, inv_th), 0.5f);
  const float txf = __fsub_rn(__fmul_rn((float)x, inv_tw), 0.5f);
  const float fy = floorf(tyf), fx = floorf(txf);
  const float ya = __fsub_rn(tyf, fy), xa = __fsub_rn(txf, fx);
  const int last = tiles - 1;
  const int y1 = min(max((int)fy, 0), last), y2 = min(max((int)fy + 1, 0), last);
  const int x1 = min(max((int)fx, 0), last), x2 = min(max((int)fx + 1, 0), last);

  const float* lut = luts + (size_t)b * tiles * tiles * kBins + img[i];
  const float tl = __ldg(lut + (y1 * tiles + x1) * kBins);
  const float tr = __ldg(lut + (y1 * tiles + x2) * kBins);
  const float bl = __ldg(lut + (y2 * tiles + x1) * kBins);
  const float br = __ldg(lut + (y2 * tiles + x2) * kBins);
  const float ixa = __fsub_rn(1.0f, xa), iya = __fsub_rn(1.0f, ya);
  const float top = __fadd_rn(__fmul_rn(tl, ixa), __fmul_rn(tr, xa));
  const float bot = __fadd_rn(__fmul_rn(bl, ixa), __fmul_rn(br, xa));
  const float r = rintf(__fadd_rn(__fmul_rn(top, iya), __fmul_rn(bot, ya)));
  out[i] = (uint8_t)fminf(fmaxf(r, 0.0f), 255.0f);
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
  const size_t n = (size_t)B * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  clahe_apply_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (const float*)luts, (uint8_t*)out, B, H, W, tiles, inv_th,
      inv_tw);
  return (int)cudaGetLastError();
}
