// Helpers shared by the port's hand-written kernels.
//
// Every kernel library exports plain C entry points that take device
// pointers, sizes and a cudaStream_t, launch on that stream without
// synchronising, and return cudaGetLastError() so that the Python wrapper
// can raise on a refused launch (applecider_tpu_torch/ops/kernel.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ac {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an f32 value to T and back: what `x.astype(T)` does to a value
// that is then consumed in f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

}  // namespace ac

// dtype codes shared with the Python wrappers
enum AcDtype : int { AC_F32 = 0, AC_BF16 = 1 };

extern "C" const char* ac_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
