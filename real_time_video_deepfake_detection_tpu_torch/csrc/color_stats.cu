// Number of distinct hue values (bins 0..180) in each frame of a (B, H*W)
// u8 hue batch, returned as f32 (an exact integer).
//
// Replaces the TPU kernel real_time_video_deepfake_detection_tpu/kernels/
// color_stats.py: unique_hue_count_pallas (_kernel), which compares chunks
// of pixels against all 256 bins on the VPU, one grid step per frame.
//
// What bounds it on an H100: bytes, and below them launch overhead. At batch
// 64 of 256x256 frames it reads 4.2 MB (about 1.3 us at 3.35 TB/s) and does a
// few integer operations per pixel, so one launch of a few microseconds is
// the floor in practice. The design reads each pixel once, 16 bytes per
// load, and keeps the presence set in eight 32-bit registers per thread
// (bit h&31 of word h>>5, selected with constant indices so the set never
// leaves registers); a warp OR-reduction and one shared-memory atomicOr per
// warp merge the block's sets, and __popc counts the bins below 181. One
// block per frame: no second pass and no global atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ void mark(unsigned (&m)[8], unsigned h) {
  const unsigned bit = 1u << (h & 31u);
  const unsigned word = h >> 5;
#pragma unroll
  for (int q = 0; q < 8; ++q) m[q] |= (word == (unsigned)q) ? bit : 0u;
}

__global__ void unique_hue_count_kernel(const uint8_t* __restrict__ hue,
                                        float* __restrict__ out, int hw) {
  const uint8_t* frame = hue + (size_t)blockIdx.x * hw;
  unsigned m[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};

  const bool vec = (hw % 16 == 0) && (((uintptr_t)frame & 15u) == 0);
  const int nvec = vec ? hw / 16 : 0;
  const uint4* frame4 = reinterpret_cast<const uint4*>(frame);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    const uint4 v = __ldg(frame4 + i);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mark(m, (w[k] >> (8 * j)) & 0xFFu);
    }
  }
  for (int i = nvec * 16 + threadIdx.x; i < hw; i += kThreads)
    mark(m, __ldg(frame + i));

  __shared__ unsigned s[8];
  if (threadIdx.x < 8) s[threadIdx.x] = 0u;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const unsigned r = __reduce_or_sync(0xffffffffu, m[q]);
    if ((threadIdx.x & 31) == 0) atomicOr(&s[q], r);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // bins 0..159 are words 0..4; 160..180 are bits 0..20 of word 5
    const int n = __popc(s[0]) + __popc(s[1]) + __popc(s[2]) + __popc(s[3]) +
                  __popc(s[4]) + __popc(s[5] & 0x1FFFFFu);
    out[blockIdx.x] = (float)n;
  }
}

}  // namespace

extern "C" int unique_hue_count(const void* hue, void* out, int B, int hw,
                                void* stream) {
  if (B == 0) return 0;
  unique_hue_count_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hue, (float*)out, hw);
  return (int)cudaGetLastError();
}
