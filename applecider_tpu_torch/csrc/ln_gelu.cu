// K3: fused LayerNorm over the last dim + exact-erf GELU, forward (K3f)
// and backward (K3b).
//
// Replaces applecider_tpu/ops/ln_gelu.py:_fwd_kernel and :_bwd_kernel
// (Pallas, TPU).
//
// Forward. x: (N, C) contiguous, f32 or bf16; scale, bias: (C,) f32; y like
// x. y = gelu(((x - mean) * rsqrt(var + eps)) * scale + bias), with the
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
//
// Backward. x, g, dx: (N, C), f32 or bf16 (g and dx in x's dtype); ds_part,
// db_part: (ceil(N / 64), C) f32, one partial row of dscale = sum dz * xhat
// and dbias = sum dz per block, summed by the wrapper as the JAX package
// sums its per-block partials. Everything is recomputed from x in f32:
// xhat, z = xhat * scale + bias, dgelu = Phi(z) + z * phi(z) (erff, expf),
// dz = g * dgelu, and dx = inv * (dz * scale - mean(dz * scale)
// - xhat * mean(dz * scale * xhat)).
//
// Bound on the H100 at the train shape's stage 0 (N = 256 * 3481, C = 192,
// f32): bytes, x and g read once and dx written once, 2.05 GB, about
// 0.61 ms at 3.35 TB/s; ~40 flops an element are ~0.1 ms at the f32 rate.
//
// Design: a block takes 64 rows. Phase 1, a warp per row (three passes
// over the row, as the forward): mean, inv and the two row means of the dx
// formula, kept in shared memory. Phase 2, a thread per column, looping
// over the block's rows in order: dx is written, coalesced across the
// threads, and the column's dscale and dbias sums stay in registers, so
// the partial row comes out in a fixed order, with no atomics. The 64-row
// tile (48 KB of x and g at C = 192) is still in L1/L2 when phase 2
// re-reads it.
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

constexpr int kBwdRows = 64;
constexpr float kSqrt2 = 1.41421356237309515f;
constexpr float kInvSqrt2Pi = 0.398942280401432678f;

__device__ __forceinline__ float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z / kSqrt2)) + z * kInvSqrt2Pi * expf(-0.5f * z * z);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) ln_gelu_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ ds_part,
    float* __restrict__ db_part, int64_t N, int C, float eps) {
  __shared__ float s_mean[kBwdRows], s_inv[kBwdRows], s_m1[kBwdRows], s_m2[kBwdRows];
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBwdRows;
  const int rows = static_cast<int>(N - row0 < kBwdRows ? N - row0 : kBwdRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r = warp; r < rows; r += kWarps) {
    const T* xr = x + (row0 + r) * C;
    const T* gr = g + (row0 + r) * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += ac::to_f32(xr[c]);
    const float mean = ac::warp_sum(s) / static_cast<float>(C);
    float ss = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float dlt = ac::to_f32(xr[c]) - mean;
      ss += dlt * dlt;
    }
    const float inv = rsqrtf(ac::warp_sum(ss) / static_cast<float>(C) + eps);
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = (ac::to_f32(xr[c]) - mean) * inv;
      const float dxhat = ac::to_f32(gr[c]) * gelu_grad(xhat * scale[c] + bias[c]) * scale[c];
      m1 += dxhat;
      m2 += dxhat * xhat;
    }
    m1 = ac::warp_sum(m1);
    m2 = ac::warp_sum(m2);
    if (lane == 0) {
      s_mean[r] = mean;
      s_inv[r] = inv;
      s_m1[r] = m1 / static_cast<float>(C);
      s_m2[r] = m2 / static_cast<float>(C);
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float sc = scale[c], bc = bias[c];
    float dsum = 0.f, dbsum = 0.f;
    for (int r = 0; r < rows; ++r) {
      const int64_t off = (row0 + r) * C + c;
      const float xhat = (ac::to_f32(x[off]) - s_mean[r]) * s_inv[r];
      const float dz = ac::to_f32(g[off]) * gelu_grad(xhat * sc + bc);
      const float dxhat = dz * sc;
      dx[off] = ac::from_f32<T>(s_inv[r] * (dxhat - s_m1[r] - xhat * s_m2[r]));
      dsum = fmaf(dz, xhat, dsum);
      dbsum += dz;
    }
    ds_part[static_cast<int64_t>(blockIdx.x) * C + c] = dsum;
    db_part[static_cast<int64_t>(blockIdx.x) * C + c] = dbsum;
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

// ds_part, db_part: (ceil(N / 64), C) f32 partial rows, summed by the caller.
extern "C" int ac_ln_gelu_bwd(const void* x, const void* scale, const void* bias, const void* g,
                              void* dx, void* ds_part, void* db_part, int64_t N, int C, float eps,
                              int dtype, void* stream) {
  if (N == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int blocks = static_cast<unsigned int>((N + kBwdRows - 1) / kBwdRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == AC_F32) {
    ln_gelu_bwd_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(g), static_cast<float*>(dx), static_cast<float*>(ds_part),
        static_cast<float*>(db_part), N, C, eps);
  } else if (dtype == AC_BF16) {
    ln_gelu_bwd_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ds_part), static_cast<float*>(db_part),
        N, C, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
