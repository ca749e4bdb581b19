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
// 2.2 us at 3.35 TB/s. clahe_luts runs one block of 256 threads per (face,
// tile), 4,096 blocks: the tile's histogram in shared memory with shared
// atomicAdd, the clip excess summed with warp shuffles, an in-block scan,
// one LUT entry per thread. clahe_apply runs one thread per output pixel
// and reads its four corner LUT entries (which stay in L2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;

__global__ void __launch_bounds__(kBins)
clahe_luts_kernel(const uint8_t* __restrict__ img, float* __restrict__ luts, int H,
                  int W, int tiles, int th, int tw, int clip, double scale) {
  __shared__ int hist[kBins];
  __shared__ int scan[kBins];
  __shared__ int excess;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int ty = tile / tiles, tx = tile - (tile / tiles) * tiles;
  hist[t] = 0;
  if (t == 0) excess = 0;
  __syncthreads();

  const uint8_t* base = img + ((size_t)b * H + (size_t)ty * th) * W + (size_t)tx * tw;
  const int area = th * tw;
  for (int p = t; p < area; p += kBins) {
    const int r = p / tw;
    atomicAdd(&hist[base[(size_t)r * W + (p - r * tw)]], 1);
  }
  __syncthreads();

  int h = hist[t];
  if (clip > 0) {   // uniform over the block
    int over = h > clip ? h - clip : 0;
    h -= over;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(0xffffffffu, over, o);
    if ((t & 31) == 0 && over) atomicAdd(&excess, over);
    __syncthreads();
    const int redist = excess / kBins;
    const int residual = excess - redist * kBins;
    h += redist;
    // the residual goes one count each to bins 0, step, 2*step, ...
    if (residual > 0) {
      const int step = max(kBins / residual, 1);
      if (t % step == 0 && t / step < residual) h += 1;
    }
  }

  // inclusive scan over the 256 bins
  scan[t] = h;
  __syncthreads();
  for (int o = 1; o < kBins; o <<= 1) {
    const int add = t >= o ? scan[t - o] : 0;
    __syncthreads();
    scan[t] += add;
    __syncthreads();
  }
  const double q = rint(__dmul_rn((double)scan[t], scale));
  luts[((size_t)b * tiles * tiles + tile) * kBins + t] = (float)fmin(fmax(q, 0.0), 255.0);
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
  const dim3 grid(tiles * tiles, B);
  clahe_luts_kernel<<<grid, kBins, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)img, (float*)luts, H, W, tiles, H / tiles, W / tiles, clip, scale);
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
