// K4: training-path self-attention with fused dropout, forward and backward.
//
// Replaces applecider_tpu/ops/flash_attention.py (Pallas, TPU):
//   forward  _fwd_kernel_prng, _fwd_kernel_prng_export, _fwd_kernel_bits;
//   backward _bwd_kernel_prng, _bwd_kernel_bits.
// One template per direction covers the three sources of the keep decision:
// none (rate rounds to 0: keep everything), in-kernel Philox bits, and
// injected u8 bits (the testable twin and the replay target).
//
// q, k, v, out, dout, dq, dk, dv: (B, H, L, HD) contiguous, f32 or bf16;
// mask: (B, L) bytes, nonzero = padded key (may be null); bits, keep_out:
// (B, H, L, L) u8. Numerics follow _fwd_pair / _bwd_pair exactly:
//   forward: q is scaled by 1/sqrt(hd) in f32 and ROUNDED TO THE I/O DTYPE
//   before Q.K^T (f32 accumulation); -1e9 is added at padded keys; f32
//   softmax with max subtraction; the denominator is the PRE-dropout row
//   sum; kept entries p_un * drop_scale (0 elsewhere) are rounded to the
//   I/O dtype before P.V (f32 accumulation), then divided by the
//   denominator.
//   backward: p = p_un / denom (f32), pd = keep * p * drop_scale; with the
//   operands rounded to the I/O dtype before each product,
//   dv = pd^T.do, dpd = do.v^T, dp = keep * dpd * drop_scale,
//   t = rowsum(dp * p), ds = p * (dp - t), dq = ds.k * scale,
//   dk = ds^T.(q_scaled / scale) * scale.
//
// Dropout bits. The TPU kernels draw from the TPU core's PRNG, which has no
// counterpart here; only the keep rule (keep iff byte >= round(rate*256))
// and the scale 256 / (256 - thresh) are contractual. This file draws each
// byte from a counter-based Philox4x32-10 keyed on (seed, 0): element
// e = ((b*H + h)*L + i)*L + j of the (B, H, L, L) mask takes the low byte
// of word e % 4 of Philox(counter = (e / 4 mod 2^32, e / 2^34, 0, 0)). The
// mapping is random access in (i, j), so the backward regenerates exactly
// the bits the forward used in any loop order, and
// ops/flash_attention.py:dropout_bits_reference reproduces it bit for bit.
//
// Bound on the H100 at the train shape (B = 256, H = 8, L = 258, HD = 16,
// bf16): bytes. The forward moves q, k, v and out once, 68 MB, about 20 us
// at 3.35 TB/s (its 8.7 GFLOP take 9 us on the bf16 tensor cores); the
// backward moves q, k, v, do, dq, dk and dv once, 119 MB, about 36 us. The
// (L, L) scores, probabilities and the 136 M dropout bytes a step never
// touch device memory. This first version runs every product on the f32
// FMA units (head width 16 is one MMA k-step), so arithmetic, not memory,
// is its own limit; a tensor-core version is later work.
//
// Design, one block per (batch, head), eight warps:
//   forward: K and V of the head in f32 shared memory (rows padded to
//   HD + 1 words: no bank conflicts), as K2. Each warp owns query rows i =
//   warp, warp + 8, ...: scores of keys j = lane, lane + 32, ... into a
//   per-warp shared row, max and sum by shuffles, then the keep decision
//   for the row (Philox: each lane draws one counter, four bytes, for the
//   elements of the row it covers), then P.V split over (HD lanes) x
//   (32 / HD key groups).
//   backward: Q, K, V and dO of the head in shared memory (4 x 258 x 17 x
//   4 B = 70 KB at the train shape). Pass A, a warp per query row: the row
//   max, denominator and t, stored in shared memory, the keep decisions as
//   a bit mask in shared memory (L x ceil(L / 32) words, 9.3 KB), and dq_i.
//   Pass B, a warp per key column j, lanes over the rows i: p_ij, keep_ij
//   and ds_ij recomputed from the stored row statistics, dk_j and dv_j
//   accumulated in registers and reduced by shuffles. No atomics: every
//   output element is written once, in a fixed summation order.
//
// K4x, the forward ablation ladder (replaces scripts/tpu_flash_microab.py
// _fwd_kernel and _fwd_kernel_batched, Pallas, TPU): the same forward with
// stages taken out, to split its time between them on the card. Its rungs
// are instantiations of flash_fwd_kernel, so the ladder times the kernel
// the training step runs: `full` is kPhilox and `no_prng` kKeepAll, and
// two forward-only modes are added as compile-time branches that leave
// those instantiations as they were:
//   kDrawOnly (`prng_only_no_apply`): kKeepAll's output, and the row's
//   Philox words drawn but not applied; each lane XORs the words it draws
//   and writes the XOR to keep_out only if keep_out is not null, which the
//   wrapper never passes, so the draw stays in the code and out of the
//   result.
//   kMatmulOnly (`matmul_only`): no max, exp or denominator; the raw
//   masked score (-1e9 included) is rounded to the I/O dtype, multiplied
//   into V and written undivided (outputs of order 1e9 are the contract).
// `batched{N}` is flash_fwd_pairs_kernel: kKeepAll for N heads of one
// batch row in one block, K and V kept in the I/O dtype so that eight
// heads fit (bf16, L = 258: 149 KB; f32 at L = 258, 281 KB, is refused
// at launch). Every rung has the forward's bound
// (bytes: q, k, v and out once).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr float kNeg = -1e9f;

enum KeepMode : int { kKeepAll = 0, kPhilox = 1, kBits = 2, kDrawOnly = 3, kMatmulOnly = 4 };

// Philox4x32-10 (Salmon et al., SC'11) keyed on (seed, 0) at counter
// (c mod 2^32, c / 2^32, 0, 0).
__device__ __forceinline__ uint4 philox(uint64_t c, uint32_t seed) {
  uint32_t x0 = static_cast<uint32_t>(c), x1 = static_cast<uint32_t>(c >> 32), x2 = 0u, x3 = 0u;
  uint32_t k0 = seed, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, x0), lo0 = 0xD2511F53u * x0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x2), lo1 = 0xCD9E8D57u * x2;
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
  }
  return make_uint4(x0, x1, x2, x3);
}

__device__ __forceinline__ uint32_t word(const uint4& r, int w) {
  return w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
}

// keep[j] (0/1) for the L elements of row i, whose element index starts at
// e0 = ((b*H + h)*L + i)*L. Called by all 32 lanes of a warp; the caller
// syncs the warp before reading keep.
template <int MODE>
__device__ __forceinline__ void row_keep(uint8_t* keep, const uint8_t* __restrict__ bits,
                                         uint64_t e0, int L, int thresh, uint32_t seed, int lane) {
  if (MODE == kKeepAll) {
    for (int j = lane; j < L; j += 32) keep[j] = 1;
  } else if (MODE == kBits) {
    for (int j = lane; j < L; j += 32) keep[j] = bits[e0 + j] >= thresh ? 1 : 0;
  } else {
    const uint64_t c0 = e0 >> 2, c1 = (e0 + L - 1) >> 2;
    for (uint64_t c = c0 + lane; c <= c1; c += 32) {
      const uint4 r = philox(c, seed);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const uint64_t e = 4 * c + w;
        if (e >= e0 && e < e0 + L) keep[e - e0] = (word(r, w) & 0xFFu) >= static_cast<uint32_t>(thresh);
      }
    }
  }
}

// kDrawOnly: the Philox counters row_keep<kPhilox> draws for the row
// starting at element e0, XORed into one word per lane.
__device__ __forceinline__ uint32_t row_draw(uint64_t e0, int L, uint32_t seed, int lane) {
  uint32_t x = 0u;
  const uint64_t c0 = e0 >> 2, c1 = (e0 + L - 1) >> 2;
  for (uint64_t c = c0 + lane; c <= c1; c += 32) {
    const uint4 r = philox(c, seed);
    x ^= r.x ^ r.y ^ r.z ^ r.w;
  }
  return x;
}

template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ bits, T* __restrict__ out,
    uint8_t* __restrict__ keep_out, int H, int L, float scale, int thresh, float drop_scale,
    uint32_t seed) {
  static_assert(HD <= 32 && 32 % HD == 0, "HD must divide 32");
  extern __shared__ float smem[];
  constexpr int kStride = HD + 1;
  float* ks = smem;
  float* vs = ks + L * kStride;
  float* neg = vs + L * kStride;
  float* ps = neg + L;
  uint8_t* kps = reinterpret_cast<uint8_t*>(ps + kWarps * L);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * HD;
  for (int idx = threadIdx.x; idx < L * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    ks[j * kStride + d] = ac::to_f32(k[base + idx]);
    vs[j * kStride + d] = ac::to_f32(v[base + idx]);
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    neg[j] = (mask != nullptr && mask[static_cast<size_t>(b) * L + j]) ? kNeg : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * L;
  uint8_t* keep = kps + warp * L;
  constexpr int kGroups = 32 / HD;
  const int d = lane % HD, g = lane / HD;
  uint32_t drawn = 0u;  // kDrawOnly: XOR of the words this lane drew
  for (int i = warp; i < L; i += kWarps) {
    float qv[HD];
#pragma unroll
    for (int e = 0; e < HD; ++e)
      qv[e] = ac::round_to<T>(ac::to_f32(q[base + static_cast<size_t>(i) * HD + e]) * scale);

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

    float denom = 0.f;
    if constexpr (MODE == kMatmulOnly) {
      for (int j = lane; j < L; j += 32) p[j] = ac::round_to<T>(p[j]);
    } else {
      m = ac::warp_max(m);
      for (int j = lane; j < L; j += 32) {
        const float pe = expf(p[j] - m);
        denom += pe;
        p[j] = pe;
      }
      denom = ac::warp_sum(denom);

      const uint64_t e0 = (static_cast<uint64_t>(bh) * L + i) * L;
      if constexpr (MODE == kDrawOnly) {
        drawn ^= row_draw(e0, L, seed, lane);
        for (int j = lane; j < L; j += 32) p[j] = ac::round_to<T>(p[j]);
      } else {
        row_keep<MODE>(keep, bits, e0, L, thresh, seed, lane);
        __syncwarp();
        for (int j = lane; j < L; j += 32) {
          const bool kp = keep[j] != 0;
          if (MODE == kKeepAll) {
            p[j] = ac::round_to<T>(p[j]);
          } else {
            p[j] = kp ? ac::round_to<T>(p[j] * drop_scale) : 0.f;
          }
          if (keep_out != nullptr) keep_out[e0 + j] = kp ? 1 : 0;
        }
      }
    }
    __syncwarp();

    float acc = 0.f;
    for (int j = g; j < L; j += kGroups) acc = fmaf(p[j], vs[j * kStride + d], acc);
#pragma unroll
    for (int off = HD; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if constexpr (MODE == kMatmulOnly) {
      if (g == 0) out[base + static_cast<size_t>(i) * HD + d] = ac::from_f32<T>(acc);
    } else {
      if (g == 0) out[base + static_cast<size_t>(i) * HD + d] = ac::from_f32<T>(acc / denom);
    }
    __syncwarp();  // the next row overwrites p and keep
  }
  if constexpr (MODE == kDrawOnly) {
    if (keep_out != nullptr) reinterpret_cast<uint32_t*>(keep_out)[blockIdx.x * blockDim.x + threadIdx.x] = drawn;
  }
}

// K4x `batched{N}`: kKeepAll for pair_block = N heads of one batch row per
// block (grid B * H / N). The mask row is loaded once; K and V of the N
// heads stay in the I/O dtype, rows padded to an odd number of 32-bit words
// (no bank conflicts); warps go over the N * L (head, query row) pairs with
// flash_fwd_kernel's per-row arithmetic, so the results equal kKeepAll's.
template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_pairs_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, T* __restrict__ out, int H, int L, int pair_block, float scale) {
  static_assert(HD <= 32 && 32 % HD == 0, "HD must divide 32");
  extern __shared__ float smem[];
  constexpr int kStride = HD + 4 / static_cast<int>(sizeof(T));
  float* neg = smem;
  float* ps = neg + L;
  T* ks = reinterpret_cast<T*>(ps + kWarps * L);
  T* vs = ks + static_cast<size_t>(pair_block) * L * kStride;

  const int groups = H / pair_block;
  const int b = blockIdx.x / groups;
  // heads h0 .. h0 + pair_block - 1 of batch row b are contiguous
  const size_t base = (static_cast<size_t>(b) * H + (blockIdx.x % groups) * pair_block) * L * HD;
  for (int idx = threadIdx.x; idx < pair_block * L * HD; idx += blockDim.x) {
    const int r = idx / HD, d = idx % HD;
    ks[r * kStride + d] = k[base + idx];
    vs[r * kStride + d] = v[base + idx];
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    neg[j] = (mask != nullptr && mask[static_cast<size_t>(b) * L + j]) ? kNeg : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = ps + warp * L;
  constexpr int kGroups = 32 / HD;
  const int d = lane % HD, g = lane / HD;
  for (int pr = warp; pr < pair_block * L; pr += kWarps) {
    const T* kh = ks + static_cast<size_t>(pr / L) * L * kStride;
    const T* vh = vs + static_cast<size_t>(pr / L) * L * kStride;
    float qv[HD];
#pragma unroll
    for (int e = 0; e < HD; ++e)
      qv[e] = ac::round_to<T>(ac::to_f32(q[base + static_cast<size_t>(pr) * HD + e]) * scale);

    float m = -INFINITY;
    for (int j = lane; j < L; j += 32) {
      const T* kr = kh + j * kStride;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < HD; ++e) s = fmaf(qv[e], ac::to_f32(kr[e]), s);
      s += neg[j];
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = ac::warp_max(m);
    float denom = 0.f;
    for (int j = lane; j < L; j += 32) {
      const float pe = expf(p[j] - m);
      denom += pe;
      p[j] = ac::round_to<T>(pe);
    }
    denom = ac::warp_sum(denom);
    __syncwarp();

    float acc = 0.f;
    for (int j = g; j < L; j += kGroups) acc = fmaf(p[j], ac::to_f32(vh[j * kStride + d]), acc);
#pragma unroll
    for (int off = HD; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (g == 0) out[base + static_cast<size_t>(pr) * HD + d] = ac::from_f32<T>(acc / denom);
    __syncwarp();  // the next pair overwrites p
  }
}

template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ bits, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int H, int L, float scale,
    int thresh, float drop_scale, uint32_t seed) {
  static_assert(HD <= 32 && 32 % HD == 0, "HD must divide 32");
  extern __shared__ float smem[];
  constexpr int kStride = HD + 1;
  const int W = (L + 31) / 32;  // keep-mask words per row
  float* qs = smem;             // raw q, f32
  float* ks = qs + L * kStride;
  float* vs = ks + L * kStride;
  float* dos = vs + L * kStride;
  float* neg = dos + L * kStride;
  float* rmax = neg + L;
  float* rden = rmax + L;
  float* rt = rden + L;
  float* pbuf = rt + L;             // per warp: p of the row, then ds rounded
  float* dpbuf = pbuf + kWarps * L;  // per warp: dp of the row
  uint32_t* keepbits = reinterpret_cast<uint32_t*>(dpbuf + kWarps * L);
  uint8_t* kps = reinterpret_cast<uint8_t*>(keepbits + L * W);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * HD;
  for (int idx = threadIdx.x; idx < L * HD; idx += blockDim.x) {
    const int j = idx / HD, d = idx % HD;
    qs[j * kStride + d] = ac::to_f32(q[base + idx]);
    ks[j * kStride + d] = ac::to_f32(k[base + idx]);
    vs[j * kStride + d] = ac::to_f32(v[base + idx]);
    dos[j * kStride + d] = ac::to_f32(dout[base + idx]);
  }
  for (int j = threadIdx.x; j < L; j += blockDim.x)
    neg[j] = (mask != nullptr && mask[static_cast<size_t>(b) * L + j]) ? kNeg : 0.f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kGroups = 32 / HD;
  const int d = lane % HD, g = lane / HD;

  // ---- pass A: a warp per query row i
  {
    float* p = pbuf + warp * L;
    float* dp = dpbuf + warp * L;
    uint8_t* keep = kps + warp * L;
    for (int i = warp; i < L; i += kWarps) {
      float qv[HD], dov[HD];
#pragma unroll
      for (int e = 0; e < HD; ++e) {
        qv[e] = ac::round_to<T>(qs[i * kStride + e] * scale);
        dov[e] = dos[i * kStride + e];
      }
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
        const float pe = expf(p[j] - m);
        denom += pe;
        p[j] = pe;
      }
      denom = ac::warp_sum(denom);

      const uint64_t e0 = (static_cast<uint64_t>(bh) * L + i) * L;
      row_keep<MODE>(keep, bits, e0, L, thresh, seed, lane);
      __syncwarp();
      float tsum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float pn = p[j] / denom;
        const float* vr = vs + j * kStride;
        float dpd = 0.f;
#pragma unroll
        for (int e = 0; e < HD; ++e) dpd = fmaf(dov[e], vr[e], dpd);
        float dpv = dpd;
        if (MODE != kKeepAll) dpv = keep[j] ? dpd * drop_scale : 0.f;
        p[j] = pn;
        dp[j] = dpv;
        tsum = fmaf(dpv, pn, tsum);
      }
      const float t = ac::warp_sum(tsum);
      for (int j = lane; j < L; j += 32) p[j] = ac::round_to<T>(p[j] * (dp[j] - t));
      for (int w = 0; w < W; ++w) {
        const int j = 32 * w + lane;
        const unsigned bit = __ballot_sync(0xffffffffu, j < L && keep[j] != 0);
        if (lane == 0) keepbits[i * W + w] = bit;
      }
      if (lane == 0) {
        rmax[i] = m;
        rden[i] = denom;
        rt[i] = t;
      }
      __syncwarp();

      float acc = 0.f;
      for (int j = g; j < L; j += kGroups) acc = fmaf(p[j], ks[j * kStride + d], acc);
#pragma unroll
      for (int off = HD; off < 32; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) dq[base + static_cast<size_t>(i) * HD + d] = ac::from_f32<T>(acc * scale);
      __syncwarp();  // the next row overwrites p, dp and keep
    }
  }
  __syncthreads();

  // ---- pass B: a warp per key column j, lanes over the query rows i
  for (int j = warp; j < L; j += kWarps) {
    float kv[HD], vv[HD], dka[HD], dva[HD];
#pragma unroll
    for (int e = 0; e < HD; ++e) {
      kv[e] = ks[j * kStride + e];
      vv[e] = vs[j * kStride + e];
      dka[e] = 0.f;
      dva[e] = 0.f;
    }
    const float negj = neg[j];
    const int wj = j / 32;
    const unsigned bj = 1u << (j % 32);
    for (int i = lane; i < L; i += 32) {
      const float* qr = qs + i * kStride;
      const float* dr = dos + i * kStride;
      float s = 0.f, dpd = 0.f;
#pragma unroll
      for (int e = 0; e < HD; ++e) {
        s = fmaf(ac::round_to<T>(qr[e] * scale), kv[e], s);
        dpd = fmaf(dr[e], vv[e], dpd);
      }
      s += negj;
      const float pn = expf(s - rmax[i]) / rden[i];
      const bool kp = (keepbits[i * W + wj] & bj) != 0;
      float pd = pn, dpv = dpd;
      if (MODE != kKeepAll) {
        pd = kp ? pn * drop_scale : 0.f;
        dpv = kp ? dpd * drop_scale : 0.f;
      }
      const float pdr = ac::round_to<T>(pd);
      const float dsr = ac::round_to<T>(pn * (dpv - rt[i]));
#pragma unroll
      for (int e = 0; e < HD; ++e) {
        dva[e] = fmaf(pdr, dr[e], dva[e]);
        dka[e] = fmaf(dsr, ac::round_to<T>((qr[e] * scale) / scale), dka[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < HD; ++e) {
      dka[e] = ac::warp_sum(dka[e]);
      dva[e] = ac::warp_sum(dva[e]);
    }
    if (lane == 0) {
      const size_t o = base + static_cast<size_t>(j) * HD;
#pragma unroll
      for (int e = 0; e < HD; ++e) {
        dk[o + e] = ac::from_f32<T>(dka[e] * scale);
        dv[o + e] = ac::from_f32<T>(dva[e]);
      }
    }
  }
}

size_t fwd_smem(int L, int hd) {
  return sizeof(float) * (static_cast<size_t>(2) * L * (hd + 1) + L + kWarps * L) + kWarps * L;
}

size_t pairs_smem(int L, int hd, int pair_block, size_t esize) {
  const size_t stride = hd + 4 / esize;
  return sizeof(float) * (static_cast<size_t>(L) + kWarps * L) + 2 * esize * pair_block * L * stride;
}

size_t bwd_smem(int L, int hd) {
  const size_t W = (L + 31) / 32;
  return sizeof(float) * (static_cast<size_t>(4) * L * (hd + 1) + 4 * L + 2 * kWarps * L) +
         sizeof(uint32_t) * L * W + kWarps * L;
}

template <typename K>
int prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

struct Args {
  const void *q, *k, *v, *mask, *bits, *dout;
  void *out, *keep_out, *dq, *dk, *dv;
  int BH, H, L;
  float scale;
  int thresh;
  float drop_scale;
  uint32_t seed;
  cudaStream_t stream;
};

template <typename T, int HD, int MODE>
int launch_fwd(const Args& a) {
  const size_t smem = fwd_smem(a.L, HD);
  auto kernel = flash_fwd_kernel<T, HD, MODE>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<a.BH, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const uint8_t*>(a.bits), static_cast<T*>(a.out),
      static_cast<uint8_t*>(a.keep_out), a.H, a.L, a.scale, a.thresh, a.drop_scale, a.seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, int MODE>
int launch_bwd(const Args& a) {
  const size_t smem = bwd_smem(a.L, HD);
  auto kernel = flash_bwd_kernel<T, HD, MODE>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<a.BH, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<const uint8_t*>(a.bits),
      static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.H, a.L, a.scale, a.thresh, a.drop_scale, a.seed);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_pairs(const Args& a, int pair_block) {
  const size_t smem = pairs_smem(a.L, HD, pair_block, sizeof(T));
  if (a.H % pair_block != 0) return static_cast<int>(cudaErrorInvalidValue);
  // K and V of pair_block heads over a block's shared memory (f32 batched8
  // at L = 258): refused, as "too many resources requested for launch"
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorLaunchOutOfResources);
  auto kernel = flash_fwd_pairs_kernel<T, HD>;
  if (int err = prepare(kernel, smem)) return err;
  kernel<<<a.BH / pair_block, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const uint8_t*>(a.mask), static_cast<T*>(a.out), a.H, a.L, pair_block, a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K4x: one rung of the ladder (see the header)
template <typename T, int HD>
int launch_ablate(const Args& a, int mode, int pair_block) {
  if (pair_block > 0) return mode == kKeepAll ? launch_pairs<T, HD>(a, pair_block)
                                              : static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kKeepAll: return launch_fwd<T, HD, kKeepAll>(a);
    case kPhilox: return launch_fwd<T, HD, kPhilox>(a);
    case kDrawOnly: return launch_fwd<T, HD, kDrawOnly>(a);
    case kMatmulOnly: return launch_fwd<T, HD, kMatmulOnly>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_ablate_hd(const Args& a, int hd, int mode, int pair_block) {
  switch (hd) {
    case 8: return launch_ablate<T, 8>(a, mode, pair_block);
    case 16: return launch_ablate<T, 16>(a, mode, pair_block);
    case 32: return launch_ablate<T, 32>(a, mode, pair_block);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBwd, typename T, int HD>
int dispatch_mode(const Args& a) {
  const int mode = a.thresh == 0 ? kKeepAll : (a.bits != nullptr ? kBits : kPhilox);
  if (mode == kKeepAll) return kBwd ? launch_bwd<T, HD, kKeepAll>(a) : launch_fwd<T, HD, kKeepAll>(a);
  if (mode == kBits) return kBwd ? launch_bwd<T, HD, kBits>(a) : launch_fwd<T, HD, kBits>(a);
  return kBwd ? launch_bwd<T, HD, kPhilox>(a) : launch_fwd<T, HD, kPhilox>(a);
}

template <bool kBwd, typename T>
int dispatch_hd(const Args& a, int hd) {
  switch (hd) {
    case 8: return dispatch_mode<kBwd, T, 8>(a);
    case 16: return dispatch_mode<kBwd, T, 16>(a);
    case 32: return dispatch_mode<kBwd, T, 32>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBwd>
int dispatch(const Args& a, int hd, int dtype) {
  if (a.BH == 0 || a.L == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == AC_F32) return dispatch_hd<kBwd, float>(a, hd);
  if (dtype == AC_BF16) return dispatch_hd<kBwd, __nv_bfloat16>(a, hd);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bits null: Philox keyed on seed (or keep-all when thresh == 0); keep_out
// null: no export of the keep mask.
extern "C" int ac_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* bits, void* out, void* keep_out, int B, int H, int L, int hd,
                            float scale, int thresh, float drop_scale, uint32_t seed, int dtype,
                            void* stream) {
  Args a{q, k, v, mask, bits, nullptr, out, keep_out, nullptr, nullptr, nullptr,
         B * H, H, L, scale, thresh, drop_scale, seed, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, hd, dtype);
}

extern "C" int ac_flash_bwd(const void* q, const void* k, const void* v, const void* mask,
                            const void* bits, const void* dout, void* dq, void* dk, void* dv, int B,
                            int H, int L, int hd, float scale, int thresh, float drop_scale,
                            uint32_t seed, int dtype, void* stream) {
  Args a{q, k, v, mask, bits, dout, nullptr, nullptr, dq, dk, dv,
         B * H, H, L, scale, thresh, drop_scale, seed, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, hd, dtype);
}

// K4x: mode is a KeepMode other than kBits; pair_block > 0 (kKeepAll only)
// runs N = pair_block heads a block. Launches never add to ac_flash_fwd's.
extern "C" int ac_flash_fwd_ablate(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int B, int H, int L, int hd, float scale, int thresh,
                                   float drop_scale, uint32_t seed, int dtype, int mode,
                                   int pair_block, void* stream) {
  Args a{q, k, v, mask, nullptr, nullptr, out, nullptr, nullptr, nullptr, nullptr,
         B * H, H, L, scale, thresh, drop_scale, seed, static_cast<cudaStream_t>(stream)};
  if (a.BH == 0 || a.L == 0) return static_cast<int>(cudaGetLastError());
  if (dtype == AC_F32) return dispatch_ablate_hd<float>(a, hd, mode, pair_block);
  if (dtype == AC_BF16) return dispatch_ablate_hd<__nv_bfloat16>(a, hd, mode, pair_block);
  return static_cast<int>(cudaErrorInvalidValue);
}
