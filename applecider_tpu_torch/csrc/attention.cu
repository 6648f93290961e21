// K2: eval-path masked self-attention of the photometry transformer.
//
// Replaces applecider_tpu/ops/attention.py:_mha_kernel (Pallas, TPU).
//
// q, k, v, out: (B, H, L, HD) contiguous, f32 or bf16; mask: (B, L) bytes,
// nonzero = padded key (may be null). Numerics follow the TPU kernel: the
// 1/sqrt(hd) scale is folded into q, -1e9 is added at padded keys, the
// softmax runs in f32 with max subtraction, the unnormalised P is rounded
// to the I/O dtype before P.V (accumulated in f32), and each output row is
// divided by its f32 row sum at the end.
//
// Bound on the H100: bytes in bf16, operations in f32. At the main-path
// shape (B = 256, H = 8, L = 258, HD = 16, bf16) q, k, v and out are 17 MB
// each, 68 MB in all, about 20 us at 3.35 TB/s; the two products are
// 4*B*H*L*L*HD = 8.7 GFLOP, about 9 us on the bf16 tensor cores. This first
// kernel runs the products on the f32 FMA units instead (67 TFLOP/s peak,
// about 0.13 ms), which makes operations its own limit: HD = 16 is one MMA
// k-step, and a tensor-core version is later work.
//
// Design: one block per (batch, head). K and V of the head are converted
// to f32 once into shared memory (rows padded to HD + 1 words, so neither
// the per-key score loop nor the P.V loop conflicts on banks), with the
// additive mask row beside them. Each warp owns query rows i = warp,
// warp + 8, ...: its lanes compute the scores of keys j = lane, lane + 32,
// ... into a per-warp shared row, reduce the row max and sum with shuffles,
// and then split the P.V product over (HD lanes) x (32 / HD key groups).
// The (L, L) scores never leave shared memory.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) mha_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int L, float scale) {
  static_assert(HD <= 32 && 32 % HD == 0, "HD must divide 32");
  extern __shared__ float smem[];
  constexpr int kStride = HD + 1;
  float* ks = smem;
  float* vs = ks + L * kStride;
  float* neg = vs + L * kStride;
  float* ps = neg + L;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * HD;
  for (int idx = threadIdx.x; idx < L * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    ks[j * kStride + d] = ac::to_f32(k[base + idx]);
    vs[j * kStride + d] = ac::to_f32(v[base + idx]);
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    neg[j] = (mask != nullptr && mask[static_cast<size_t>(b) * L + j]) ? -1e9f : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * L;
  constexpr int kGroups = 32 / HD;
  const int d = lane % HD, g = lane / HD;
  for (int i = warp; i < L; i += kWarps) {
    float qv[HD];
#pragma unroll
    for (int e = 0; e < HD; ++e) qv[e] = ac::to_f32(q[base + static_cast<size_t>(i) * HD + e]) * scale;

    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const float* kr = ks + j * kStride;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < HD; ++e) s = fmaf(qv[e], kr[e], s);
      s += neg[j];
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = ac::warp_max(m);

    float denom = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float e = expf(p[j] - m);
      denom += e;
      p[j] = ac::round_to<T>(e);
    }
    denom = ac::warp_sum(denom);
    __syncwarp();

    float acc = 0.f;
    for (int j = g; j < L; j += kGroups) acc = fmaf(p[j], vs[j * kStride + d], acc);
#pragma unroll
    for (int off = HD; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (g == 0) out[base + static_cast<size_t>(i) * HD + d] = ac::from_f32<T>(acc / denom);
    __syncwarp();  // the next row overwrites p
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int BH,
           int H, int L, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(2) * L * (HD + 1) + L + kWarps * L);
  auto kernel = mha_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<BH, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, L, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* mask, void* out, int BH,
                int H, int L, int hd, float scale, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, mask, out, BH, H, L, scale, stream);
    case 16: return launch<T, 16>(q, k, v, mask, out, BH, H, L, scale, stream);
    case 32: return launch<T, 32>(q, k, v, mask, out, BH, H, L, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int ac_masked_attention(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int B, int H, int L, int hd, float scale, int dtype,
                                   void* stream) {
  if (B == 0 || L == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == AC_F32) return dispatch_hd<float>(q, k, v, mask, out, B * H, H, L, hd, scale, s);
  if (dtype == AC_BF16)
    return dispatch_hd<__nv_bfloat16>(q, k, v, mask, out, B * H, H, L, hd, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
