// Number of distinct hue values (bins 0..180) in each frame of a (B, H*W)
// u8 hue batch, returned as f32 (an exact integer).
//
// Replaces the TPU kernel real_time_video_deepfake_detection_tpu/kernels/
// color_stats.py: unique_hue_count_pallas (_kernel), which compares chunks
// of pixels against all 256 bins on the VPU, one grid step per frame.
//
// What bounds it on an H100: the bytes are few (4.2 MB at batch 64 of
// 256x256 frames, 1.25 us at 3.35 TB/s), so the issue rate decides. The
// first design ran one block of 512 threads per frame (64 blocks: 68 of the
// 132 SMs idle) and kept the presence set in eight registers per thread,
// marking each pixel with a byte extract and eight constant-indexed
// compare/select/OR steps (~28 integer instructions a pixel): 13.8 us of
// device time at (64, 256, 256) on an H100 80GB HBM3 at 700 W, 11x the bound.
//
// This design:
//   - splits each frame over a thread-block cluster of kSplit blocks (128
//     blocks at batch 64, one per SM). Each block marks its share of the
//     frame, then its warp 0 writes the block's 181-bin set (six 32-bit
//     words) into the leader block's shared memory through distributed
//     shared memory; after a cluster barrier the leader ORs the kSplit sets
//     and popcounts them. One launch: no global scratch, no memset, no
//     second pass, and no fallback (the cluster launch is the only path);
//   - marks a pixel with one byte extract and one byte store, flags[h] = 1,
//     into one 256-byte flag array per block. A store of 1 is idempotent,
//     so warps need no copy of their own, and 256 bytes span 64 words over
//     32 banks: a warp's stores conflict at most 2-way. Lane l of warp 0
//     then reads flags[32q + l], and __ballot_sync gives word q of the set;
//   - reads the frame's 16-byte-aligned body with 16-byte loads, kChunk in
//     flight per thread (issued before the first cluster barrier), split
//     evenly over the cluster. A base at any byte offset is taken, not
//     rejected: the frame's unaligned head and its tail (hw not a multiple
//     of 16) go byte by byte to the leader block.
// Device time at (64, 256, 256), mean of 20 calls under torch.profiler, on
// an H100 80GB HBM3 at 700 W, by cluster size x threads (a variant harness
// kept outside the repository; PERF.md lists the runs): 3.94 us for 2 x 256
// with 8 loads each (this file); 4.16 for 2 x 512 with 4 loads; 4.30-4.48
// for 8 x 128; 4.71 for 4 x 256; 5.27-5.32 for 1 x 512, no split. The bound
// is 1.25 us, and an empty kernel of 128 blocks takes 0.87 us on that card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 2;      // blocks (one cluster) per frame
constexpr int kThreads = 256;
constexpr int kChunk = 8;      // 16-byte loads each thread has in flight
constexpr int kWords = 6;      // words 0..5 hold bins 0..191; 181..191 are masked

__device__ __forceinline__ void mark4(uint8_t* flags, unsigned w) {
  flags[w & 0xFFu] = 1;
  flags[(w >> 8) & 0xFFu] = 1;
  flags[(w >> 16) & 0xFFu] = 1;
  flags[w >> 24] = 1;
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
unique_hue_count_kernel(const uint8_t* __restrict__ hue, float* __restrict__ out, int hw) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kSplit;
  __shared__ __align__(16) uint8_t flags[256];
  __shared__ unsigned parts[kSplit][kWords];   // used in the leader block only

  const uint8_t* frame = hue + (size_t)b * hw;
  const int head = min(hw, (int)((16u - ((uintptr_t)frame & 15u)) & 15u));
  const int nvec = (hw - head) >> 4;
  const int per = (nvec + kSplit - 1) / kSplit;
  const int lo = min(nvec, rank * per), hi = min(nvec, lo + per);
  const uint4* body = reinterpret_cast<const uint4*>(frame + head);
  uint4 v[kChunk];
  auto load = [&](int i0) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int i = i0 + k * kThreads;
      v[k] = __ldg(body + (i < hi ? i : i0));   // past the end: pixel i0 again
    }
  };
  int i0 = lo + (int)threadIdx.x;
  if (i0 < hi) load(i0);   // the first loads fly while the cluster meets

  if (threadIdx.x < 64) reinterpret_cast<unsigned*>(flags)[threadIdx.x] = 0u;
  // flags zeroed; and every block of the cluster has started before any
  // writes into the leader's shared memory
  cluster.sync();

  while (i0 < hi) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      mark4(flags, v[k].x);
      mark4(flags, v[k].y);
      mark4(flags, v[k].z);
      mark4(flags, v[k].w);
    }
    i0 += kThreads * kChunk;
    if (i0 < hi) load(i0);
  }
  if (rank == 0) {
    for (int i = threadIdx.x; i < head; i += kThreads) flags[__ldg(frame + i)] = 1;
    for (int i = head + 16 * nvec + threadIdx.x; i < hw; i += kThreads)
      flags[__ldg(frame + i)] = 1;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    unsigned mine = 0u;
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      const unsigned w = __ballot_sync(0xffffffffu, flags[32 * q + lane] != 0);
      if (lane == q) mine = w;
    }
    if (lane < kWords) cluster.map_shared_rank(&parts[0][0], 0)[rank * kWords + lane] = mine;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < 32) {
    unsigned w = 0u;
    if (lane < kWords) {
#pragma unroll
      for (int r = 0; r < kSplit; ++r) w |= parts[r][lane];
    }
    if (lane == 5) w &= 0x1FFFFFu;   // bins 160..180 are bits 0..20 of word 5
    const int n = __reduce_add_sync(0xffffffffu, __popc(w));
    if (lane == 0) out[b] = (float)n;
  }
}

}  // namespace

extern "C" int unique_hue_count(const void* hue, void* out, int B, int hw,
                                void* stream) {
  if (B == 0) return 0;
  unique_hue_count_kernel<<<B * kSplit, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)hue, (float*)out, hw);
  return (int)cudaGetLastError();
}
