// K3 (forward): fused LayerNorm over the last dim + exact-erf GELU.
//
// Replaces applecider_tpu/ops/ln_gelu.py:_fwd_kernel (Pallas, TPU).
//
// x: (N, C) contiguous, f32 or bf16; scale, bias: (C,) f32; y like x.
// y = gelu(((x - mean) * rsqrt(var + eps)) * scale + bias), with the
// statistics and the GELU in f32 and one rounding to the output dtype at
// the end. GELU uses CUDA's erff (the TPU kernel carried its own rational
// erf only because Mosaic had none).
//
// Bound on the H100: bytes. The SpectraNet epilogue reads each activation
// once and writes it once with ~20 flops an element; at the stage-0 shape
// of the main path (N = 193 * 3481 rows, C = 192, f32) that is 1.03 GB of
// traffic, about 0.31 ms at 3.35 TB/s, against well under 0.1 ms of
// arithmetic at the f32 rate.
//
// Design: one warp per row, eight rows a block. The warp makes three
// passes over its row: the sum for the mean, the sum of squared
// deviations for the variance (two passes, as the reference computes
// it), and the normalise + GELU + store. Lanes touch consecutive columns,
// so every pass is a coalesced read; the second and third passes re-read a
// row of at most 12 KB that is still in L1/L2, so device memory sees close
// to one read and one write per element.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) ln_gelu_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ y, int64_t N, int C, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= N) return;
  const T* xr = x + row * C;
  T* yr = y + row * C;

  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += ac::to_f32(xr[c]);
  const float mean = ac::warp_sum(s) / static_cast<float>(C);

  float ss = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dlt = ac::to_f32(xr[c]) - mean;
    ss += dlt * dlt;
  }
  const float var = ac::warp_sum(ss) / static_cast<float>(C);
  const float inv = rsqrtf(var + eps);

  for (int c = lane; c < C; c += 32) {
    const float z = (ac::to_f32(xr[c]) - mean) * inv * scale[c] + bias[c];
    const float g = 0.5f * z * (1.f + erff(z / 1.41421356237309515f));
    yr[c] = ac::from_f32<T>(g);
  }
}

}  // namespace

extern "C" int ac_ln_gelu_fwd(const void* x, const void* scale, const void* bias, void* y,
                              int64_t N, int C, float eps, int dtype, void* stream) {
  if (N == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks = static_cast<unsigned int>((N + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == AC_F32) {
    ln_gelu_fwd_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(y), N, C, eps);
  } else if (dtype == AC_BF16) {
    ln_gelu_fwd_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), N, C, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
