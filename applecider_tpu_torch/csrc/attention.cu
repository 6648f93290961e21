// K2: eval-path masked self-attention of the photometry transformer.
//
// Replaces applecider_tpu/ops/attention.py:_mha_kernel (Pallas, TPU).
//
// q, k, v, out: (B, H, L, HD) contiguous, f32 or bf16 (bf16: 16-byte
// aligned); mask: (B, L) bytes, nonzero = padded key (may be null).
// Numerics follow the TPU kernel: q times 1/sqrt(hd) in f32, -1e9 added at
// padded keys, the softmax in f32 with max subtraction, the unnormalised P
// rounded to the I/O dtype before P.V (accumulated in f32), and each output
// row divided by its f32 row sum at the end.
//
// Bound on the H100: bytes. At the main-path shape (B = 256, H = 8, L =
// 258, HD = 16, bf16) q, k, v and out are 17 MB each, 68 MB in all, about
// 20 us at 3.35 TB/s; the two products are 4*B*H*L*L*HD = 8.7 GFLOP, about
// 9 us on the bf16 tensor cores, and the 136 M exponentials about 35 us on
// the SFUs (16 a clock an SM).
//
// bf16 (mha_mma_kernel): the products on the tensor cores, through the
// forward tile routine of mma.cuh that K4's forward shares: a block per
// (batch, head), kMmaWarps warps, a warp per 16-query-row tile, K and V in
// swizzled bf16 shared memory, S and P.V by mma.sync m16n8k16 with f32
// accumulation, two sweeps over the keys (the row max, then exp, the row
// sum and P.V). The scale stays in f32 as the contract has it: the mma
// multiplies the raw bf16 q, exact as an operand, and S is scaled in f32
// after the product (mul = scale * log2(e), scores in the log2 domain), so
// only the f32 rounding of q.scale.k differs from the plain version
// masked_attention_reference, which therefore stays as it is.
//
// f32 (mha_kernel): the products on the FMA units (67 TFLOP/s peak, about
// 0.13 ms of operations), as TF32 would miss the 1e-5 f32 agreement. One
// block per (batch, head): K and V of the head in f32 shared memory (rows
// padded to HD + 1 words, so neither the per-key score loop nor the P.V
// loop conflicts on banks), with the additive mask row beside them. Each
// warp owns query rows i = warp, warp + 8, ...: its lanes compute the
// scores of keys j = lane, lane + 32, ... into a per-warp shared row,
// reduce the row max and sum with shuffles, and then split the P.V product
// over (HD lanes) x (32 / HD key groups). The (L, L) scores never leave
// shared memory.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

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

constexpr int kMmaWarps = 4;

// bf16: see the header
template <int HD>
__global__ void __launch_bounds__(kMmaWarps * 32) mha_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
    int H, int L, float scale) {
  using namespace ac::mma;
  const int Lp = 16 * ((L + 15) / 16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + Lp * padded_width(HD);
  float* neg2 = reinterpret_cast<float*>(vs + Lp * padded_width(HD));
  const size_t base = static_cast<size_t>(blockIdx.x) * L * HD;
  load_kv<HD>(ks, vs, k + base, v + base, L);
  fill_key_mask<true>(neg2, mask != nullptr ? mask + static_cast<size_t>(blockIdx.x / H) * L : nullptr, L);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i0 = 16 * warp; i0 < L; i0 += 16 * kMmaWarps) {
    uint32_t qa[padded_width(HD) / 16][4];
    load_q<HD>(qa, q + base, i0, L, 1.f, lane);
    attend_rows<HD, false>(out + base, qa, ks, vs, neg2, nullptr, i0, L, scale * kLog2e, 1.f, lane);
  }
}

template <typename T, typename K>
int start(K kernel, int warps, size_t smem, const void* q, const void* k, const void* v, const void* mask,
          void* out, int BH, int H, int L, float scale, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<BH, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(mask), static_cast<T*>(out), H, L, scale);
  return static_cast<int>(cudaGetLastError());
}

// f32 on mha_kernel, bf16 on mha_mma_kernel
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int BH,
           int H, int L, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, float>) {
    const size_t smem = sizeof(float) * (static_cast<size_t>(2) * L * (HD + 1) + L + kWarps * L);
    return start<float>(mha_kernel<float, HD>, kWarps, smem, q, k, v, mask, out, BH, H, L, scale, stream);
  } else {
    return start<T>(mha_mma_kernel<HD>, kMmaWarps, ac::mma::kv_smem(L, HD), q, k, v, mask, out, BH, H, L,
                    scale, stream);
  }
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
