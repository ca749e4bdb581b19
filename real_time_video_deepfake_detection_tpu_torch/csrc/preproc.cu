// Fused face preprocessing for the classifier: bilinear resize (half-pixel
// centers, edge clamped) of raw-RGB faces, then x/255 and the ImageNet
// mean/std normalization, NHWC in and NHWC out.
//
// Replaces the TPU kernel real_time_video_deepfake_detection_tpu/kernels/
// preproc.py: preprocess_faces_pallas (_kernel), which runs the resize as
// two banded interpolation matmuls Ry @ IMG_c @ Rx^T on the MXU at HIGHEST
// precision over a (batch, channel) grid of channel-major images.
//
// What bounds it on an H100: bytes, the output stream above all. At batch
// 64 (160x160 -> 224x224) the call must read 4.9 MB of u8 faces (19.7 MB as
// f32) and write 38.5 MB of f32, against ~0.1 GFLOP: 13 us at 3.35 TB/s.
// No channel-major transpose and no dense Ry/Rx (each of their rows has two
// nonzeros): two taps per axis, read straight from NHWC. Arithmetic is plain
// fp32 (no TF32, no bf16: the TPU kernel needs HIGHEST precision for the
// same reason, a single bf16 pass drifts the resample by ~1%).
//
// The first version ran one thread per output float: a chain of 64-bit
// divisions by 3 and by O to find (b, y, x, c), eight table loads and four
// one-byte tap loads per 4-byte store, so integer work, not the store
// stream, set its time (5.8x the bound). This design gives that work to
// the block and the thread once and keeps the stores wide:
//   - one block per (face, group of up to kRows output rows): b and the
//     rows come from blockIdx, with no division;
//   - the two source rows of each output row are staged in shared memory
//     with 16-byte loads where the row's bytes allow it (element loads
//     otherwise; source rows too wide for shared memory are read in place);
//     the copy is small against the output and later rows need nothing
//     from it in flight, so cp.async would buy no overlap;
//   - thread t owns output floats 4t..4t+3 of every row of the group, so
//     its four (x, c) columns, their source columns, x weights and mean/std
//     are found once and kept in registers across the rows (the "x tables
//     once per block"); the y weights are uniform across the block;
//   - each thread writes its four floats as one float4 when the output row
//     (O*3 floats) keeps 16-byte alignment, which O = 224 does.
// Measured on an H100 80GB HBM3 at 700 W: 25.0 us at (64,160,160,3) u8,
// against 12.5 us for a fill of the same 38.5 MB and the first version's
// 75; 4 rows per block took 27.7 us, 16 rows 24.8, so 8 it is. What is left
// above the store stream is instruction issue: per output, four taps,
// their conversion, two lerps and an IEEE division.
// The arithmetic and its order are the first version's: top and bottom
// lerps in x, the lerp in y, then (v * (1/255) - mean) / std. u8 input is
// converted in-register (exactly: every u8 is an f32), which computes the
// same values as converting first.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kRows = 8;               // output rows per block
constexpr int kStageBytes = 48 * 1024; // the static shared-memory limit

// A tap as f32. For u8, 2^23 + v holds v in its low mantissa bits, so
// float(v) is one OR and one subtraction, both at full rate; the conversion
// instruction (I2F) runs at a quarter of it on Hopper, and a float4 takes
// sixteen taps.
__device__ __forceinline__ float to_f32(uint8_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// Per-call tables, from kernels/preproc.py: int32 [sy | sy1 | sx | sx1] and
// float32 [wy0 | wy1 | wx0 | wx1 | mean(3) | std(3)], each axis O entries.
template <typename T, bool kStaged, bool kVec4>
__global__ void preprocess_faces_kernel(const T* __restrict__ in, float* __restrict__ out,
                                        int H, int W, int O, const int* __restrict__ itab,
                                        const float* __restrict__ ftab, int vec_copy) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  const T* stage = reinterpret_cast<const T*>(stage_raw);
  const int b = blockIdx.x;
  const int y_begin = blockIdx.y * kRows;
  const int rows = min(kRows, O - y_begin);
  const int row_elems = W * 3;
  const int n_out = O * 3;
  const int *sy = itab, *sy1 = itab + O, *sx = itab + 2 * O, *sx1 = itab + 3 * O;
  const float *wy0 = ftab, *wy1 = ftab + O, *wx0 = ftab + 2 * O, *wx1 = ftab + 3 * O;
  const float* norm = ftab + 4 * O;
  const T* face = in + (size_t)b * H * row_elems;

  if constexpr (kStaged) {
    // stage rows 2j and 2j+1: source rows sy[y] and sy1[y] of y = y_begin + j
    const int row_bytes = row_elems * (int)sizeof(T);
    unsigned char* dst = stage_raw;
    if (vec_copy) {
      const int nv = row_bytes / 16;
      for (int i = threadIdx.x; i < 2 * rows * nv; i += blockDim.x) {
        const int s = i / nv, k = i - s * nv;
        const int y = y_begin + (s >> 1);
        const int src = (s & 1) ? __ldg(sy1 + y) : __ldg(sy + y);
        const uint4* g = reinterpret_cast<const uint4*>(face + (size_t)src * row_elems);
        reinterpret_cast<uint4*>(dst + (size_t)s * row_bytes)[k] = __ldg(g + k);
      }
    } else {
      T* d = reinterpret_cast<T*>(dst);
      for (int i = threadIdx.x; i < 2 * rows * row_elems; i += blockDim.x) {
        const int s = i / row_elems, k = i - s * row_elems;
        const int y = y_begin + (s >> 1);
        const int src = (s & 1) ? __ldg(sy1 + y) : __ldg(sy + y);
        d[i] = __ldg(face + (size_t)src * row_elems + k);
      }
    }
    __syncthreads();
  }

  float* out_rows = out + ((size_t)b * O + y_begin) * n_out;
  for (int v = threadIdx.x; 4 * v < n_out; v += blockDim.x) {
    int col0[4], col1[4];
    float ax0[4], ax1[4], mean[4], stdv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int f = min(4 * v + k, n_out - 1);   // the tail of a non-float4 row repeats
      const int x = f / 3, c = f - 3 * (f / 3);
      col0[k] = __ldg(sx + x) * 3 + c;
      col1[k] = __ldg(sx1 + x) * 3 + c;
      ax0[k] = __ldg(wx0 + x);
      ax1[k] = __ldg(wx1 + x);
      mean[k] = __ldg(norm + c);
      stdv[k] = __ldg(norm + 3 + c);
    }
    for (int j = 0; j < rows; ++j) {
      const int y = y_begin + j;
      const float ay0 = __ldg(wy0 + y), ay1 = __ldg(wy1 + y);
      const T* r0 = kStaged ? stage + (size_t)(2 * j) * row_elems
                            : face + (size_t)__ldg(sy + y) * row_elems;
      const T* r1 = kStaged ? stage + (size_t)(2 * j + 1) * row_elems
                            : face + (size_t)__ldg(sy1 + y) * row_elems;
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float p00 = to_f32(r0[col0[k]]), p01 = to_f32(r0[col1[k]]);
        const float p10 = to_f32(r1[col0[k]]), p11 = to_f32(r1[col1[k]]);
        const float top = p00 * ax0[k] + p01 * ax1[k];
        const float bot = p10 * ax0[k] + p11 * ax1[k];
        const float val = top * ay0 + bot * ay1;
        o[k] = (val * (1.0f / 255.0f) - mean[k]) / stdv[k];
      }
      float* dst = out_rows + (size_t)j * n_out + 4 * v;
      if constexpr (kVec4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * v + k < n_out) dst[k] = o[k];
      }
    }
  }
}

template <typename T, bool kStaged, bool kVec4>
int launch_as(const void* in, void* out, int B, int H, int W, int O, const void* itab,
              const void* ftab, int vec_copy, void* stream) {
  const int n_vec = (O * 3 + 3) / 4;
  const int threads = std::min(1024, (n_vec + 31) / 32 * 32);
  const dim3 grid(B, (O + kRows - 1) / kRows);
  const size_t smem = kStaged ? (size_t)2 * kRows * W * 3 * sizeof(T) : 0;
  preprocess_faces_kernel<T, kStaged, kVec4><<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const T*)in, (float*)out, H, W, O, (const int*)itab, (const float*)ftab, vec_copy);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* in, void* out, int B, int H, int W, int O, const void* itab,
           const void* ftab, void* stream) {
  if (B == 0 || O == 0) return 0;
  if (O > 65535 * kRows) return (int)cudaErrorInvalidValue;
  const size_t row_bytes = (size_t)W * 3 * sizeof(T);
  const bool staged = 2 * kRows * row_bytes <= (size_t)kStageBytes;
  const bool vec4 = (O * 3) % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int vec_copy = (uintptr_t)in % 16 == 0 && row_bytes % 16 == 0;
  if (staged)
    return vec4 ? launch_as<T, true, true>(in, out, B, H, W, O, itab, ftab, vec_copy, stream)
                : launch_as<T, true, false>(in, out, B, H, W, O, itab, ftab, vec_copy, stream);
  return vec4 ? launch_as<T, false, true>(in, out, B, H, W, O, itab, ftab, 0, stream)
              : launch_as<T, false, false>(in, out, B, H, W, O, itab, ftab, 0, stream);
}

}  // namespace

extern "C" int preprocess_faces_f32(const void* in, void* out, int B, int H, int W, int O,
                                    const void* itab, const void* ftab, void* stream) {
  return launch<float>(in, out, B, H, W, O, itab, ftab, stream);
}

extern "C" int preprocess_faces_u8(const void* in, void* out, int B, int H, int W, int O,
                                   const void* itab, const void* ftab, void* stream) {
  return launch<uint8_t>(in, out, B, H, W, O, itab, ftab, stream);
}
