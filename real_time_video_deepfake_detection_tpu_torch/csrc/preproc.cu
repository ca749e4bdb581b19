// Fused face preprocessing for the classifier: bilinear resize (half-pixel
// centers, edge clamped) of raw-RGB faces, then x/255 and the ImageNet
// mean/std normalization, NHWC in and NHWC out.
//
// Replaces the TPU kernel real_time_video_deepfake_detection_tpu/kernels/
// preproc.py: preprocess_faces_pallas (_kernel), which runs the resize as
// two banded interpolation matmuls Ry @ IMG_c @ Rx^T on the MXU at HIGHEST
// precision over a (batch, channel) grid of channel-major images.
//
// What bounds it on an H100: bytes. Each output element needs 4 input taps
// and ~10 flops; at batch 64 (160x160 -> 224x224) the call must read 19.7 MB
// of f32 faces (4.9 MB as u8) and write 38.5 MB, against ~0.06 GFLOP. The
// design therefore moves only those bytes: no channel-major transpose and no
// dense Ry/Rx matrices (each row of them has two nonzeros), one thread per
// output element reading its four taps straight from the NHWC input (the
// reads of neighbouring threads fall on neighbouring addresses and stay in
// L1/L2), writes fully coalesced, weights and indices from four small
// per-axis tables built on the host by the same numpy builder as the JAX
// kernel's matrices. Arithmetic is plain fp32 (no TF32, no bf16: the TPU
// kernel needs HIGHEST precision for the same reason — a single bf16 pass
// drifts the resample by ~1%). u8 input is converted in-register, which
// computes the same values as converting first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void preprocess_faces_kernel(
    const T* __restrict__ in, float* __restrict__ out,
    int B, int H, int W, int O,
    const int* __restrict__ sy, const int* __restrict__ sy1,
    const float* __restrict__ wy0, const float* __restrict__ wy1,
    const int* __restrict__ sx, const int* __restrict__ sx1,
    const float* __restrict__ wx0, const float* __restrict__ wx1,
    float m0, float m1, float m2, float s0, float s1, float s2) {
  const long long total = (long long)B * O * O * 3;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % 3);
  long long r = idx / 3;
  const int x = (int)(r % O);
  r /= O;
  const int y = (int)(r % O);
  const int b = (int)(r / O);

  const T* img = in + (long long)b * H * W * 3 + c;
  const long long row0 = (long long)__ldg(sy + y) * W * 3;
  const long long row1 = (long long)__ldg(sy1 + y) * W * 3;
  const int col0 = __ldg(sx + x) * 3;
  const int col1 = __ldg(sx1 + x) * 3;
  const float ax0 = __ldg(wx0 + x), ax1 = __ldg(wx1 + x);
  const float p00 = (float)__ldg(img + row0 + col0);
  const float p01 = (float)__ldg(img + row0 + col1);
  const float p10 = (float)__ldg(img + row1 + col0);
  const float p11 = (float)__ldg(img + row1 + col1);
  const float top = p00 * ax0 + p01 * ax1;
  const float bot = p10 * ax0 + p11 * ax1;
  const float v = top * __ldg(wy0 + y) + bot * __ldg(wy1 + y);
  const float mean = c == 0 ? m0 : (c == 1 ? m1 : m2);
  const float stdv = c == 0 ? s0 : (c == 1 ? s1 : s2);
  out[idx] = (v * (1.0f / 255.0f) - mean) / stdv;
}

template <typename T>
int launch(const void* in, void* out, int B, int H, int W, int O,
           const void* sy, const void* sy1, const void* wy0, const void* wy1,
           const void* sx, const void* sx1, const void* wx0, const void* wx1,
           float m0, float m1, float m2, float s0, float s1, float s2,
           void* stream) {
  const long long total = (long long)B * O * O * 3;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  preprocess_faces_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)in, (float*)out, B, H, W, O,
      (const int*)sy, (const int*)sy1, (const float*)wy0, (const float*)wy1,
      (const int*)sx, (const int*)sx1, (const float*)wx0, (const float*)wx1,
      m0, m1, m2, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int preprocess_faces_f32(
    const void* in, void* out, int B, int H, int W, int O,
    const void* sy, const void* sy1, const void* wy0, const void* wy1,
    const void* sx, const void* sx1, const void* wx0, const void* wx1,
    float m0, float m1, float m2, float s0, float s1, float s2, void* stream) {
  return launch<float>(in, out, B, H, W, O, sy, sy1, wy0, wy1, sx, sx1, wx0,
                       wx1, m0, m1, m2, s0, s1, s2, stream);
}

extern "C" int preprocess_faces_u8(
    const void* in, void* out, int B, int H, int W, int O,
    const void* sy, const void* sy1, const void* wy0, const void* wy1,
    const void* sx, const void* sx1, const void* wx0, const void* wx1,
    float m0, float m1, float m2, float s0, float s1, float s2, void* stream) {
  return launch<uint8_t>(in, out, B, H, W, O, sy, sy1, wy0, wy1, sx, sx1, wx0,
                         wx1, m0, m1, m2, s0, s1, s2, stream);
}
