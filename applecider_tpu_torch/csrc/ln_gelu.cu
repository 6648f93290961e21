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
// db_part: (blocks, C) f32, one partial row of dscale = sum dz * xhat and
// dbias = sum dz per block, summed by the wrapper as the JAX package sums
// its per-block partials. Everything is recomputed from x in f32: xhat,
// z = xhat * scale + bias, dgelu = Phi(z) + z * phi(z) (erff, expf),
// dz = g * dgelu, and dx = inv * (dz * scale - mean(dz * scale)
// - xhat * mean(dz * scale * xhat)).
//
// Bound on the H100 at the train shape's stage 0 (N = 256 * 3481, C = 192,
// f32): bytes, x and g read once and dx written once, 12 bytes an element,
// 2.05 GB, about 0.61 ms at 3.35 TB/s (1.19 ms over SpectraNet's five
// stages). The arithmetic, ~45 instructions an element with one erff and
// one expf, takes 0.2-0.3 ms of issue on 132 SMs at stage 0, so it has to
// overlap the loads rather than add to them.
//
// Design: one trip to device memory. A row group of `warps` warps (the
// wrapper's `ln_gelu.bwd_geometry` picks it: a warp for C = 192, 16 warps
// for C = 3072, 6 elements a thread at every SpectraNet width) loads its
// row of x and g once, in vectors of V elements (8 bytes in f32), and
// keeps it in registers: thread t of the group holds the K chunks that
// start at columns (k * G + t) * V, G = 32 * warps. Over those registers
// it takes the mean, the variance (two passes), gelu_grad once an element,
// the two row means of the dx formula, and writes dx; nothing is read
// twice. A row sum goes through a warp butterfly and, for a group wider
// than a warp, through shared memory and the group's named barrier, summed
// in warp order, so every thread of the group gets the same bits. The
// thread's columns never change, so it accumulates dz * xhat and dz for
// them in registers over all the rows its group takes; rows go to groups
// by a fixed grid stride (group i of the grid takes rows i, i + groups in
// the grid, ...). At the end the block adds its groups' sums in group
// order through shared memory into its one partial row. The grid is
// min(ceil(N / groups a block), 132 SMs * the blocks an SM holds): a
// function of (N, C) only, so with no atomics two launches on the same
// inputs give the same bits, and the partial rows are at most 264.
// Enough bytes are in flight from occupancy: 1,024 threads an SM at the
// SpectraNet widths, each with its row's loads issued before its first
// reduction (48 KB an SM).
//
// Rows wider than a group's registers hold (C > 8,192, or > 4,096 when C
// is odd or a row is off alignment; no SpectraNet width) take
// ln_gelu_bwd_wide_kernel: a block is one row group that streams its row
// from device memory in four passes (mean, variance, the two row means,
// dx), so it reads x four times and g twice and evaluates gelu_grad twice
// an element. Thread t owns columns t, t + 512, ... of its block's
// partial rows and adds into them in place, row after row, so the sums
// keep a fixed order without atomics.
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

constexpr float kInvSqrt2 = 0.707106781186547524f;
constexpr float kInvSqrt2Pi = 0.398942280401432678f;
constexpr int kBwdThreads = 512;  // a block of the backward: 16 warps, 1 to 16 row groups
constexpr int kBwdWarps = kBwdThreads / 32;

__device__ __forceinline__ float gelu_grad(float z) {
  return 0.5f * (1.f + erff(z * kInvSqrt2)) + z * kInvSqrt2Pi * expf(-0.5f * z * z);
}

// V consecutive elements of a row, read or written as one access
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

// Sums of v[0..n) over the row group, the same bits in every thread of the
// group: a warp butterfly, then (groups wider than a warp) the warps' sums
// from shared memory in warp order. slot[i] holds one float per warp of the
// block; each of the row's sums has its own slots, so one barrier a call
// suffices.
template <int n>
__device__ __forceinline__ void group_sum(float (&v)[n], float (*slot)[kBwdWarps], int warps,
                                          int first_warp, int group) {
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = ac::warp_sum(v[i]);
  if (warps == 1) return;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int i = 0; i < n; ++i) slot[i][threadIdx.x / 32] = v[i];
  }
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(warps * 32) : "memory");
#pragma unroll
  for (int i = 0; i < n; ++i) {
    v[i] = 0.f;
    for (int w = 0; w < warps; ++w) v[i] += slot[i][first_warp + w];
  }
}

// Registers a thread holds: K chunks of V columns of one row (x, then xhat;
// g, then dz * scale), and the dz * xhat and dz sums of those columns.
// ptxas must fit the SpectraNet instantiations (K = 3) in 64 registers so
// that two blocks share an SM.
template <typename T, int V, int K>
__global__ void __launch_bounds__(kBwdThreads, K == 3 ? 2 : 1) ln_gelu_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ ds_part,
    float* __restrict__ db_part, int64_t N, int C, float eps, int warps) {
  __shared__ float s_sum[4][kBwdWarps];         // a row's mean, variance, m1, m2 per warp
  __shared__ float s_col[kBwdThreads * V * K];  // the groups' column sums, (groups, C)
  const int G = warps * 32;
  const int groups = kBwdThreads / G;
  const int group = threadIdx.x / G, t = threadIdx.x % G;
  const int first_warp = group * warps;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * groups;
  const float inv_c = 1.f / static_cast<float>(C);

  float ds[K][V], db[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) ds[k][v] = db[k][v] = 0.f;

  for (int64_t row = static_cast<int64_t>(blockIdx.x) * groups + group; row < N; row += stride) {
    const T* xr = x + row * C;
    const T* gr = g + row * C;
    float xv[K][V], gv[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * G + t) * V;
      if (c < C) {
        load_vec<V>(xr + c, xv[k]);
        load_vec<V>(gr + c, gv[k]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) xv[k][v] = gv[k][v] = 0.f;
      }
    }
    float s[1] = {0.f};
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) s[0] += xv[k][v];
    group_sum(s, &s_sum[0], warps, first_warp, group);
    const float mean = s[0] * inv_c;
    float ss[1] = {0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((k * G + t) * V < C) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          xv[k][v] -= mean;
          ss[0] = fmaf(xv[k][v], xv[k][v], ss[0]);
        }
      }
    }
    group_sum(ss, &s_sum[1], warps, first_warp, group);
    const float inv = rsqrtf(ss[0] * inv_c + eps);
    float m[2] = {0.f, 0.f};  // sums of dxhat and dxhat * xhat
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * G + t) * V;
      if (c < C) {
        float sc[V], bc[V];
        load_vec<V>(scale + c, sc);
        load_vec<V>(bias + c, bc);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xhat = xv[k][v] * inv;
          const float dz = gv[k][v] * gelu_grad(fmaf(xhat, sc[v], bc[v]));
          ds[k][v] = fmaf(dz, xhat, ds[k][v]);
          db[k][v] += dz;
          const float dxhat = dz * sc[v];
          m[0] += dxhat;
          m[1] = fmaf(dxhat, xhat, m[1]);
          xv[k][v] = xhat;
          gv[k][v] = dxhat;
        }
      }
    }
    group_sum(m, &s_sum[2], warps, first_warp, group);
    const float m1 = m[0] * inv_c, m2 = m[1] * inv_c;
    T* dxr = dx + row * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * G + t) * V;
      if (c < C) {
        float out[V];
#pragma unroll
        for (int v = 0; v < V; ++v) out[v] = inv * (gv[k][v] - m1 - xv[k][v] * m2);
        store_vec<V>(dxr + c, out);
      }
    }
  }

  // the block's partial rows: its groups' column sums added in group order
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * G + t) * V;
      if (c < C) {
#pragma unroll
        for (int v = 0; v < V; ++v) s_col[group * C + c + v] = pass == 0 ? ds[k][v] : db[k][v];
      }
    }
    __syncthreads();
    float* part = (pass == 0 ? ds_part : db_part) + static_cast<int64_t>(blockIdx.x) * C;
    for (int c = threadIdx.x; c < C; c += kBwdThreads) {
      float s = 0.f;
      for (int j = 0; j < groups; ++j) s += s_col[j * C + c];
      part[c] = s;
    }
    __syncthreads();
  }
}

// Rows too wide for ln_gelu_bwd_kernel's registers: one row group a
// block, four passes over the row in device memory (see the header).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) ln_gelu_bwd_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
    const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ ds_part,
    float* __restrict__ db_part, int64_t N, int C, float eps) {
  __shared__ float s_sum[4][kBwdWarps];  // a row's mean, variance, m1, m2 per warp
  const int t = threadIdx.x;
  const float inv_c = 1.f / static_cast<float>(C);
  float* dsp = ds_part + static_cast<int64_t>(blockIdx.x) * C;
  float* dbp = db_part + static_cast<int64_t>(blockIdx.x) * C;
  for (int c = t; c < C; c += kBwdThreads) dsp[c] = dbp[c] = 0.f;

  for (int64_t row = blockIdx.x; row < N; row += gridDim.x) {
    const T* xr = x + row * C;
    const T* gr = g + row * C;
    float s[1] = {0.f};
    for (int c = t; c < C; c += kBwdThreads) s[0] += ac::to_f32(xr[c]);
    group_sum(s, &s_sum[0], kBwdWarps, 0, 0);
    const float mean = s[0] * inv_c;
    float ss[1] = {0.f};
    for (int c = t; c < C; c += kBwdThreads) {
      const float d = ac::to_f32(xr[c]) - mean;
      ss[0] = fmaf(d, d, ss[0]);
    }
    group_sum(ss, &s_sum[1], kBwdWarps, 0, 0);
    const float inv = rsqrtf(ss[0] * inv_c + eps);
    float m[2] = {0.f, 0.f};  // sums of dxhat and dxhat * xhat
    for (int c = t; c < C; c += kBwdThreads) {
      const float xhat = (ac::to_f32(xr[c]) - mean) * inv;
      const float dz = ac::to_f32(gr[c]) * gelu_grad(fmaf(xhat, scale[c], bias[c]));
      dsp[c] = fmaf(dz, xhat, dsp[c]);
      dbp[c] += dz;
      const float dxhat = dz * scale[c];
      m[0] += dxhat;
      m[1] = fmaf(dxhat, xhat, m[1]);
    }
    group_sum(m, &s_sum[2], kBwdWarps, 0, 0);
    const float m1 = m[0] * inv_c, m2 = m[1] * inv_c;
    T* dxr = dx + row * C;
    for (int c = t; c < C; c += kBwdThreads) {
      const float xhat = (ac::to_f32(xr[c]) - mean) * inv;
      const float dz = ac::to_f32(gr[c]) * gelu_grad(fmaf(xhat, scale[c], bias[c]));
      dxr[c] = ac::from_f32<T>(inv * (dz * scale[c] - m1 - xhat * m2));
    }
  }
}

template <typename T, int V, int K>
cudaError_t launch_bwd(const void* x, const void* scale, const void* bias, const void* g, void* dx,
                       void* ds_part, void* db_part, int64_t N, int C, float eps, int warps,
                       int blocks, cudaStream_t s) {
  if (C > warps * 32 * V * K) return cudaErrorInvalidValue;
  ln_gelu_bwd_kernel<T, V, K><<<blocks, kBwdThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(ds_part),
      static_cast<float*>(db_part), N, C, eps, warps);
  return cudaGetLastError();
}

// the instantiations: K = 3 (every width up to 96 vectors a warp of the
// group, all of SpectraNet's) and K = 8 (wider rows), V in {1, 2}; wider
// still takes ln_gelu_bwd_wide_kernel
template <typename T, int V>
cudaError_t launch_bwd_chunks(int chunks, const void* x, const void* scale, const void* bias,
                              const void* g, void* dx, void* ds_part, void* db_part, int64_t N,
                              int C, float eps, int warps, int blocks, cudaStream_t s) {
  if (chunks == 3)
    return launch_bwd<T, V, 3>(x, scale, bias, g, dx, ds_part, db_part, N, C, eps, warps, blocks, s);
  if (chunks == 8)
    return launch_bwd<T, V, 8>(x, scale, bias, g, dx, ds_part, db_part, N, C, eps, warps, blocks, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_bwd_vec(int vec, int chunks, const void* x, const void* scale, const void* bias,
                           const void* g, void* dx, void* ds_part, void* db_part, int64_t N, int C,
                           float eps, int warps, int blocks, cudaStream_t s) {
  if (chunks == 0) {  // the wide path: a block is one row group, one element a thread
    if (vec != 1 || warps != kBwdWarps) return cudaErrorInvalidValue;
    ln_gelu_bwd_wide_kernel<T><<<blocks, kBwdThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const T*>(g), static_cast<T*>(dx), static_cast<float*>(ds_part),
        static_cast<float*>(db_part), N, C, eps);
    return cudaGetLastError();
  }
  if (vec == 2 && C % 2 == 0)
    return launch_bwd_chunks<T, 2>(chunks, x, scale, bias, g, dx, ds_part, db_part, N, C, eps,
                                   warps, blocks, s);
  if (vec == 1)
    return launch_bwd_chunks<T, 1>(chunks, x, scale, bias, g, dx, ds_part, db_part, N, C, eps,
                                   warps, blocks, s);
  return cudaErrorInvalidValue;
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

// ds_part, db_part: (blocks, C) f32 partial rows, summed by the caller. The
// geometry (vec, warps, chunks, blocks) is ln_gelu.bwd_geometry(N, C) of the
// wrapper; a row group of `warps` warps must cover C in `chunks` vectors of
// `vec` elements a thread, and vec = 2 needs C even and 8-byte (f32) or
// 4-byte (bf16) aligned rows. chunks = 0 (with vec 1 and 16 warps) takes
// the wide path, for any C.
extern "C" int ac_ln_gelu_bwd(const void* x, const void* scale, const void* bias, const void* g,
                              void* dx, void* ds_part, void* db_part, int64_t N, int C, float eps,
                              int dtype, int vec, int warps, int chunks, int blocks, void* stream) {
  if (N == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  if (warps < 1 || warps > kBwdWarps || (warps & (warps - 1)) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == AC_F32) {
    err = launch_bwd_vec<float>(vec, chunks, x, scale, bias, g, dx, ds_part, db_part, N, C, eps,
                                warps, blocks, s);
  } else if (dtype == AC_BF16) {
    err = launch_bwd_vec<__nv_bfloat16>(vec, chunks, x, scale, bias, g, dx, ds_part, db_part, N, C,
                                        eps, warps, blocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
