// bf16 tensor-core building blocks of the attention kernels (K2 in
// attention.cu, K4 in flash_attention.cu): mma.sync m16n8k16 with bf16
// operands and f32 accumulation, fed by ldmatrix from XOR-swizzled bf16
// shared memory; and the forward tile routine both kernels run.
//
// The forward, per block (batch, head): K and V of the head in swizzled
// bf16 shared memory, rows zero-padded to Lp = 16 * ceil(L / 16) and
// columns to HDP = max(16, HD) (load_kv), beside the key mask in the log2
// domain (fill_key_mask). A warp owns a 16-query-row tile: its q rows go
// straight from device memory into A fragments (load_q), then attend_rows
// sweeps the keys 16 at a time twice, S = (q.K^T) * mul + neg2 by mma each
// time: sweep 1 takes the row max, sweep 2 p = 2^(s - m), the f32
// pre-dropout denominator, the keep bits (K4) and acc += P.V by mma with P
// rounded to bf16. P is rounded relative to the final row max, as in the
// plain versions, so only the order of the f32 sums differs from them. The
// K4x ladder's `matmul_only` is attend_rows' one-sweep form: the raw masked
// scores, in natural units, times V.
#pragma once

#include "common.cuh"

namespace ac::mma {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// 16 x 16 bf16 fragments from shared memory: four 8 x 8 matrices, lane l
// giving the address of row l % 8 of matrix l / 8. .trans transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a.b: m16n8k16, bf16 operands, f32 accumulation. Lane l = 4g + t
// holds a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)},
// b = {(k 2t..2t+1, n g), (k 2t+8.., n g)} and d = {(g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1)}: the d of two n8 tiles side by side, packed
// pairwise, is the a of one k16 step.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// a-fragment of the k16 step made of two n8 accumulator tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}

// Row r, 16-byte chunk ch of a (rows, HDP) bf16 array: the chunk is XORed
// with a function of r so that the eight rows one ldmatrix reads fall in
// distinct banks (rows of 32 or 64 bytes).
template <int HDP>
__device__ __forceinline__ int swz(int r, int ch) {
  constexpr int kChunks = HDP / 8;
  return r * HDP + 8 * (ch ^ ((r / (8 / kChunks)) % kChunks));
}

// Addresses lane l gives ldmatrix for the 16-row tile at row r0: the
// a-fragment (rows split over matrices 0/1, chunks over 2/3) of k-step ks;
// with .trans, on a tile whose 16 rows are k, the b-fragments {b0, b1} of
// columns 16ks..16ks+7, then of 16ks+8..16ks+15.
template <int HDP>
__device__ __forceinline__ const bf16* a_addr(const bf16* base, int r0, int ks, int lane) {
  return base + swz<HDP>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, 2 * ks + (lane >> 4));
}
// b-fragments of two n8 tiles (the tile's rows are n; chunks over 0/1, n
// tiles over 2/3) of k-step ks: {b0, b1} of rows r0..r0+7, then of r0+8..
template <int HDP>
__device__ __forceinline__ const bf16* b_addr(const bf16* base, int r0, int ks, int lane) {
  return base + swz<HDP>(r0 + (lane & 7) + ((lane >> 4) & 1) * 8, 2 * ks + ((lane >> 3) & 1));
}
// 2^x on the SFU (ex2.approx: 2^-22 relative error)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c = a.src^T of a 16 x 16 tile: a, 16 rows x HDP, in registers; src
// rows r0..r0+15 in shared memory
template <int HDP>
__device__ __forceinline__ void tile_abt(float (&c)[2][4], const uint32_t (&a)[HDP / 16][4],
                                         const bf16* src, int r0, int lane) {
#pragma unroll
  for (int n = 0; n < 2; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, b_addr<HDP>(src, r0, kk, lane));
    mma_bf16(c[0], a[kk], b[0], b[1]);
    mma_bf16(c[1], a[kk], b[2], b[3]);
  }
}

// Scores of the 16 x 16 tile at (the 16 rows of qa, keys j0..j0+15) in the
// log2 domain: (qa.ks^T) * mul + neg2, with neg2 the key mask times log2(e)
template <int HDP>
__device__ __forceinline__ void tile_scores(float (&s)[2][4], const uint32_t (&qa)[HDP / 16][4],
                                            const bf16* ks, const float* neg2, int j0,
                                            float mul, int lane) {
  tile_abt<HDP>(s, qa, ks, j0, lane);
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float2 ng = *reinterpret_cast<const float2*>(neg2 + j0 + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = fmaf(s[n][e], mul, (e & 1) ? ng.y : ng.x);
  }
}

// Whether element e of n8 tile n of lane (g, t)'s 16 x 16 accumulator tile
// is kept, from the lane's keep byte kb of that tile: keep(g + 8c, 2t + a +
// 8b) sits in bit 4c + 2b + a (flash_attention.cu, draw_tile_row and
// tile_dp)
__device__ __forceinline__ bool keep_bit(uint32_t kb, int n, int e) {
  return (kb >> (4 * (e >> 1) + 2 * n + (e & 1))) & 1u;
}

// acc (16 rows x HDP) += a (16 x 16, k = rows r0..r0+15 of src) . src
template <int HDP>
__device__ __forceinline__ void tile_acc(float (&acc)[HDP / 8][4], const uint32_t (&a)[4],
                                         const bf16* src, int r0, int lane) {
#pragma unroll
  for (int p = 0; p < HDP / 16; ++p) {
    uint32_t b[4];
    ldsm_x4_t(b, a_addr<HDP>(src, r0, p, lane));
    mma_bf16(acc[2 * p], a, b[0], b[1]);
    mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
  }
}

// out rows r0 + g, r0 + g + 8 (those < L) of the accumulator, times mul
template <int HD, int HDP>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[HDP / 8][4], int r0,
                                           int L, float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      if (r < L)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r) * HD + 8 * n + 2 * t) =
            __floats2bfloat162_rn(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
    }
  }
}

// ---- the forward tile routine

__host__ __device__ constexpr int padded_width(int hd) { return hd < 16 ? 16 : hd; }

// Bytes of load_kv's arrays for one head and its key mask: K and V as
// (Lp, HDP) bf16, the mask as Lp floats
inline size_t kv_smem(int L, int hd) {
  const size_t Lp = 16 * ((L + 15) / 16);
  return 2 * Lp * padded_width(hd) * sizeof(bf16) + Lp * sizeof(float);
}

// K and V of `heads` consecutive heads (k, v: heads x L rows of HD, 16-byte
// aligned) into ks and vs, head n at row n * Lp, swizzled, zero past row L
// of each head and past column HD. Called by the whole block; the caller
// syncs it before reading. Lp is a multiple of the swizzle's period, so
// head n's tile reads as a one-head array at ks + n * Lp * HDP.
template <int HD>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, const bf16* __restrict__ k,
                                        const bf16* __restrict__ v, int L, int heads = 1) {
  constexpr int HDP = padded_width(HD), kChunks = HDP / 8;
  const int Lp = 16 * ((L + 15) / 16);
  for (int idx = threadIdx.x; idx < heads * Lp * kChunks; idx += blockDim.x) {
    const int r = idx / kChunks, ch = idx % kChunks;
    const int n = r / Lp, i = r - n * Lp;
    uint4 kc = make_uint4(0u, 0u, 0u, 0u), vc = kc;
    if (i < L && ch < HD / 8) {
      const size_t src = (static_cast<size_t>(n) * L + i) * HD + 8 * ch;
      kc = *reinterpret_cast<const uint4*>(k + src);
      vc = *reinterpret_cast<const uint4*>(v + src);
    }
    *reinterpret_cast<uint4*>(ks + swz<HDP>(r, ch)) = kc;
    *reinterpret_cast<uint4*>(vs + swz<HDP>(r, ch)) = vc;
  }
}

// neg[j], j < Lp, the key mask of one batch row (mask_row: L bytes, nonzero
// = padded key; null: none padded). kLog2: the log2 domain, -1e9 * log2(e)
// at padded keys and -inf at j >= L, so that keys past L weigh exactly 0
// while a row whose every key is padded keeps the plain version's uniform
// softmax. Otherwise natural units for the raw scores of `matmul_only`:
// -1e9 at padded keys, as the plain version adds it, and 0 at j >= L,
// exact there because K and V are zero past row L (-inf would make
// -inf * 0 = NaN). Called by the whole block; the caller syncs it.
template <bool kLog2>
__device__ __forceinline__ void fill_key_mask(float* neg, const uint8_t* __restrict__ mask_row, int L) {
  const int Lp = 16 * ((L + 15) / 16);
  for (int j = threadIdx.x; j < Lp; j += blockDim.x) {
    const bool padded = j < L && mask_row != nullptr && mask_row[j];
    if (kLog2) {
      neg[j] = j >= L ? -INFINITY : (padded ? -1e9f * kLog2e : 0.f);
    } else {
      neg[j] = padded ? -1e9f : 0.f;
    }
  }
}

// A fragments of query rows i0..i0+15 of q (L rows of HD, 16-byte
// aligned), each element times qmul rounded to bf16 (exact for qmul = 1);
// zero past row L and column HD
template <int HD>
__device__ __forceinline__ void load_q(uint32_t (&qa)[padded_width(HD) / 16][4], const bf16* __restrict__ q,
                                       int i0, int L, float qmul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < padded_width(HD) / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = i0 + g + 8 * (x & 1), c = 16 * kk + 2 * t + 8 * (x >> 1);
      uint32_t w = 0u;
      if (r < L && c < HD) w = *reinterpret_cast<const uint32_t*>(q + r * HD + c);
      qa[kk][x] = pack_bf16(__uint_as_float(w << 16) * qmul, __uint_as_float(w & 0xFFFF0000u) * qmul);
    }
  }
}

// Output rows i0..i0+15 (those < L) of one warp's query tile qa: scores
// S = (qa.K^T) * mul + neg2 in the log2 domain; sweep 1 the row max m,
// sweep 2 p = 2^(s - m), denom = sum p (f32, before dropout), with kDrop p
// times drop_scale where kept and 0 elsewhere (keep byte of key tile J at
// krow[32 J], already offset to the lane), P rounded to bf16, acc += P.V;
// out = acc / denom. kMatmulOnly (the K4x ladder's `matmul_only`): one
// sweep with no max, exp or denominator, S = (qa.K^T) * mul + neg2 with
// mul = 1 and the mask in natural units (fill_key_mask<false>), rounded to
// bf16, acc += S.V, out = acc undivided.
template <int HD, bool kDrop, bool kMatmulOnly = false>
__device__ __forceinline__ void attend_rows(bf16* __restrict__ out, const uint32_t (&qa)[padded_width(HD) / 16][4],
                                            const bf16* ks, const bf16* vs, const float* neg2,
                                            const uint8_t* krow, int i0, int L, float mul, float drop_scale,
                                            int lane) {
  constexpr int HDP = padded_width(HD);
  const int Lp = 16 * ((L + 15) / 16);
  if constexpr (kMatmulOnly) {
    float acc[HDP / 8][4] = {};
    for (int j0 = 0; j0 < Lp; j0 += 16) {
      float s[2][4];
      tile_scores<HDP>(s, qa, ks, neg2, j0, mul, lane);
      uint32_t a[4];
      pack_a(a, s);
      tile_acc<HDP>(acc, a, vs, j0, lane);
    }
    store_rows<HD, HDP>(out, acc, i0, L, 1.f, lane);
    return;
  }
  float m[2] = {-INFINITY, -INFINITY};
  for (int j0 = 0; j0 < Lp; j0 += 16) {
    float s[2][4];
    tile_scores<HDP>(s, qa, ks, neg2, j0, mul, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      m[0] = fmaxf(m[0], fmaxf(s[n][0], s[n][1]));
      m[1] = fmaxf(m[1], fmaxf(s[n][2], s[n][3]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }
  float den[2] = {0.f, 0.f};
  float acc[HDP / 8][4] = {};
  for (int j0 = 0; j0 < Lp; j0 += 16) {
    float s[2][4];
    tile_scores<HDP>(s, qa, ks, neg2, j0, mul, lane);
    const uint32_t kb = kDrop ? krow[2 * j0] : 0u;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[n][e] - m[e >> 1]);
        den[e >> 1] += p;
        s[n][e] = kDrop ? (keep_bit(kb, n, e) ? p * drop_scale : 0.f) : p;
      }
    }
    uint32_t a[4];
    pack_a(a, s);
    tile_acc<HDP>(acc, a, vs, j0, lane);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] /= den[e >> 1];
  }
  store_rows<HD, HDP>(out, acc, i0, L, 1.f, lane);
}

}  // namespace ac::mma
