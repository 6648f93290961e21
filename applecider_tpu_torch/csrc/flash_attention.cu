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
// touch device memory. In bf16 both directions run their products on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulation: head
// width 16 is one k-step), so their own limit is the elementwise work
// between the products (exp, keep, ds) and the Philox draw: the forward's
// 136 M exponentials take ~35 us on the SFUs, its 34 M Philox counters a
// multiple of that on the integer units; the backward's 10 products of 2 *
// 16 * L^2 flops a head (4 x S, 3 x dO.V^T, dq, dk, dv), 44 GFLOP a launch,
// take ~0.05 ms at the dense rate. In f32 both run on the FMA units (TF32
// would miss the f32 limits), so arithmetic, not memory, is their limit.
//
// Design, one block per (batch, head):
//   forward, bf16 (flash_fwd_mma_kernel, kFwdWarps = 4 warps): the forward
//   tile routine of mma.cuh, which K2 shares: K and V in swizzled bf16
//   shared memory with the key mask; a warp per 16-query-row tile, q.scale
//   rounded to bf16 straight into A fragments, two sweeps over the keys
//   (the row max, then exp, the pre-dropout sum, the keep bits and P.V by
//   mma), so P is rounded relative to the final row max as in the plain
//   version. Before its sweeps the warp draws the keep mask of its 16 rows
//   with draw_tile_row into its scratch and the tile bytes, as pass A of
//   the backward does, so kPhilox and kBits differ only in
//   the fill and the Philox -> bits replay stays exact; with keep_out it
//   writes the rows' 0/1 bytes from its scratch bits. kKeepAll allocates no
//   keep bytes and draws nothing.
//   forward, f32 (flash_fwd_kernel, eight warps), and the K4x rungs in
//   f32: K and V of the head in f32 shared memory (rows padded to
//   HD + 1 words: no bank conflicts), as K2's f32 kernel. Each warp owns
//   query rows i = warp, warp + 8, ...: scores of keys j = lane, lane + 32,
//   ... into a per-warp shared row, max and sum by shuffles, then the keep
//   decision for the row (Philox: each lane draws one counter, four bytes,
//   for the elements of the row it covers), then P.V split over (HD lanes)
//   x (32 / HD key groups).
//   backward, f32 (flash_bwd_kernel, eight warps): Q, K, V and dO of the
//   head in f32 shared memory. Pass A, a warp per query row: the row max,
//   denominator and t, stored in shared memory, the keep decisions as a bit
//   mask in shared memory, and dq_i. Pass B, a warp per key column j, lanes
//   over the rows i: p_ij, keep_ij and ds_ij recomputed from the stored row
//   statistics, dk_j and dv_j accumulated in registers and reduced by
//   shuffles. f32 stays here: TF32 products would miss the f32 backward's
//   1e-4 * max(1, |g|) agreement with the plain version; launch_bwd picks
//   the kernel by dtype.
//   backward, bf16 (flash_bwd_mma_kernel, kBwdWarps = 4 warps): Q, K, V,
//   dO (and q.scale rounded to bf16 unless HD = 16, where scale = 1/4 makes
//   it exact) in bf16 shared memory, rows zero-padded to Lp = 16 *
//   ceil(L / 16) and to 16 columns, 16-byte chunks XOR-swizzled so that
//   ldmatrix is free of bank conflicts; the key mask; the row statistics
//   (m, 1 / denom, t); with dropout, the keep mask as one byte a lane for
//   every 16 x 16 tile: 51,664 bytes at the train shape, four blocks an SM.
//   Pass A, a warp per 16-query-row tile. The warp first draws the keep
//   mask of its 16 rows: the Philox counters (or the injected bytes) into
//   flat bits in its scratch, then converted into the tile bytes, so
//   kPhilox and kBits differ only there and every element is drawn once;
//   no block barrier holds the other warps meanwhile. Then three sweeps
//   over the keys, 16 at a time, S = (q.scale).K^T by mma: the row max;
//   then denom (the exact pre-dropout sum of exp(s - m)) and t with
//   dO.V^T by mma; then ds = p (dp - t), rounded to bf16 and kept in
//   registers (the accumulators of two n8 tiles are the A operand of one
//   k16 step), and dq += ds.K by mma with K read by ldmatrix.trans. Pass
//   B, a warp per 16-key tile, one sweep over the queries: S^T and dpd^T by
//   mma, p from the stored statistics, pd and ds in bf16 registers, dv +=
//   pd^T.dO and dk += ds^T.q by mma. dk takes the raw q: for a bf16 q,
//   round((q * scale) / scale) = q, since the f32 round trip stays within
//   an f32 ulp or two of q. Scores are kept in the log2 domain (times
//   log2(e)) so that each exp is one subtraction and one ex2. Keys at index
//   L or beyond score -inf and keep nothing, so their exp is exactly 0; the
//   user's key mask stays -1e9, so that a row with every key masked gets
//   the plain version's uniform softmax. Operands are rounded to bf16
//   before each product as in the FMA kernel, so only the order of the f32
//   sums differs from it. Neither kernel uses atomics: every output element
//   is written once, in a fixed summation order.
//
// K4x, the forward ablation ladder (replaces scripts/tpu_flash_microab.py
// _fwd_kernel and _fwd_kernel_batched, Pallas, TPU): K4's forward with
// stages taken out, to split its time between them on the card. Each rung
// is an instantiation of the training forward of its dtype, so that the
// ladder takes apart the forward the training step runs: in bf16
// flash_fwd_mma_kernel (tensor cores), in f32 flash_fwd_kernel (FMA).
// `full` is kPhilox and `no_prng` kKeepAll, launched by launch_fwd as
// ac_flash_fwd launches them; two forward-only modes are compile-time
// branches that leave those instantiations as they were:
//   kDrawOnly (`prng_only_no_apply`): kKeepAll's output, and the keep mask
//   drawn but not applied. bf16: kPhilox's keep bytes and scratch (so its
//   shared memory and occupancy), draw_tile_row<kPhilox> into them, then
//   attend_rows without dropout; the drawn bits reach keep_out only if it
//   is not null, which the wrapper never passes, so the draw stays in the
//   code and out of the result. The ladder's "draw" stage is then the
//   Philox counters, the fill of the tile bytes and the shared memory they
//   take; its "apply" stage is only keep_bit's select and the scale in
//   attend_rows. f32: each lane XORs the Philox words it draws for the row
//   and writes the XOR to keep_out only if keep_out is not null.
//   kMatmulOnly (`matmul_only`): no max, exp or denominator; the raw
//   masked score (-1e9 included) is rounded to the I/O dtype, multiplied
//   into V and written undivided (outputs of order 1e9 are the contract).
//   bf16: attend_rows' one-sweep form on the key mask in natural units
//   (fill_key_mask<false>), with no keep bytes.
// `batched{N}`: kKeepAll for N heads of one batch row a block (grid
// B * H / N), the mask row loaded once. bf16, flash_fwd_mma_pairs_kernel:
// K and V of the N heads swizzled as the one-head kernel holds them, warps
// over the N * T (head, 16-row tile) pairs with attend_rows, so each tile's
// arithmetic, and the output, is no_prng's bit for bit. At L = 258, hd =
// 16 (T = 17) N = 8 holds 140 KB of shared memory, one block an SM, so the
// block takes up to W = 32 warps (24 at hd = 32, whose registers 32 would
// cap at 64): ceil(N T / ceil(N T / W)) of them, as many as divide the
// tiles into equal rounds (136 tiles: 28 warps, 5 rounds; N = 4, 68
// tiles: 23 warps, 3 rounds). f32, flash_fwd_pairs_kernel:
// flash_fwd_kernel's per-row arithmetic, K and V in f32 rows of HD + 1
// words. A launch over a block's opt-in shared memory (f32 at L = 258 and
// hd >= 16; hd = 32 with N = 8 in both dtypes) is refused, never shrunk.
// Every rung has the forward's bound (bytes: q, k, v and out once).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace ac::mma;

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

// K4x `batched{N}` in f32: kKeepAll for pair_block = N heads of one batch
// row per block (grid B * H / N). The mask row is loaded once; K and V of
// the N heads in rows padded to an odd number of 32-bit words (no bank
// conflicts); warps go over the N * L (head, query row) pairs with
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

// ---- bf16 backward on the tensor cores (see the header)

// four warps a block: four blocks fit an SM, and 8 warps measured slower
// (PERF.md)
constexpr int kBwdWarps = 4;

// dp = keep * (da.vs^T) * drop_scale of the 16 x 16 tile at keys j0, its
// keep bits in byte krow[2 * j0] (pass A's layout, see draw_tile_row)
template <int HDP, int MODE>
__device__ __forceinline__ void tile_dp(float (&dp)[2][4], const uint32_t (&da)[HDP / 16][4],
                                        const __nv_bfloat16* vs, const uint8_t* krow, int j0,
                                        float drop_scale, int lane) {
  tile_abt<HDP>(dp, da, vs, j0, lane);
  if constexpr (MODE != kKeepAll) {
    const uint32_t kb = krow[2 * j0];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[n][e] *= (kb >> (4 * (e >> 1) + 2 * n + (e & 1))) & 1u ? drop_scale : 0.f;
    }
  }
}

// Words of a warp's scratch for the flat keep bits of 16 query rows: the
// draw fills whole 128-bit groups, and the conversion reads one word past
// the last bit of the last row's padded keys
__host__ __device__ __forceinline__ int scratch_words(int L) { return 4 * (((16 * L + 3) / 4 + 31) / 32) + 3; }

// The keep mask of query rows i0 .. i0 + 15, drawn by one warp: bits
// F = (i - i0)*L + j + d of the warp's scratch, d = e0 % 4 for the rows'
// first element e0, so that Philox counter e0 / 4 + u (or 32 injected
// bytes a ballot) fills bits 4u .. 4u + 3; then converted into one byte a
// lane for each 16 x 16 tile (I = i0 / 16, J): byte g + 8t holds pass A's
// lane (g, t) elements, keep(i0 + g + 8c, 16J + 2t + a + 8b) in bit
// 4c + 2b + a. Rows and keys at index L or beyond keep nothing.
template <int MODE>
__device__ __forceinline__ void draw_tile_row(uint8_t* ktile, uint32_t* sc, const uint8_t* __restrict__ bits,
                                              uint64_t e0, int I, int T, int L, int thresh, uint32_t seed,
                                              int lane) {
  const int rows = min(16, L - 16 * I);
  const int d = static_cast<int>(e0 & 3), nbits = rows * L + d;
  int filled;
  if constexpr (MODE == kPhilox) {
    const int ncnt = (nbits + 3) / 4;
    for (int u0 = 0; u0 < ncnt; u0 += 32) {
      const int u = u0 + lane;
      uint32_t nib = 0u;
      if (u < ncnt) {
        const uint4 r = philox((e0 >> 2) + u, seed);
        // the four low bytes side by side, compared at once: 0xFF where
        // kept; then byte x's low bit to bit x
        const uint32_t low = __byte_perm(__byte_perm(r.x, r.y, 0x0040), __byte_perm(r.z, r.w, 0x0040), 0x5410);
        const uint32_t kept = __vcmpgeu4(low, static_cast<uint32_t>(thresh) * 0x01010101u);
        nib = ((kept & 0x01010101u) * 0x01020408u) >> 24;
        // bits F = 4u + x outside [d, nbits): the elements before e0 and
        // after the last row
        const int lo = min(max(d - 4 * u, 0), 4), hi = min(max(nbits - 4 * u, 0), 4);
        nib &= ((1u << hi) - 1u) & ~((1u << lo) - 1u);
      }
      // lanes 8m .. 8m + 7 hold the 32 bits of word u0 / 8 + m
      uint32_t w = nib << (4 * (lane & 7));
      w |= __shfl_xor_sync(0xffffffffu, w, 1);
      w |= __shfl_xor_sync(0xffffffffu, w, 2);
      w |= __shfl_xor_sync(0xffffffffu, w, 4);
      if ((lane & 7) == 0) sc[u0 / 8 + lane / 8] = w;
    }
    filled = 4 * ((ncnt + 31) / 32);
  } else {
    filled = (nbits + 31) / 32;
#pragma unroll 4
    for (int m = 0; m < filled; ++m) {
      const int f = 32 * m + lane - d;
      const unsigned w = __ballot_sync(0xffffffffu, f >= 0 && f < rows * L &&
                                                         bits[e0 + f] >= static_cast<uint8_t>(thresh));
      if (lane == 0) sc[m] = w;
    }
  }
  for (int m = filled + lane; m < scratch_words(L); m += 32) sc[m] = 0u;
  __syncwarp();
  const int g = lane & 7, t = lane >> 3;
  for (int J = 0; J < T; ++J) {
    const int j0 = 16 * J;
    uint32_t byte = 0u;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int r = g + 8 * c;
      if (r < rows) {
        const int F = r * L + j0 + d;
        uint32_t w = __funnelshift_r(sc[F >> 5], sc[(F >> 5) + 1], F & 31);
        if (L - j0 < 16) w &= (1u << (L - j0)) - 1u;
        w >>= 2 * t;
        byte |= ((w & 3u) | ((w >> 6) & 12u)) << (4 * c);
      }
    }
    ktile[(I * T + J) * 32 + lane] = static_cast<uint8_t>(byte);
  }
  __syncwarp();  // the next tile row overwrites sc
}

// Block (batch, head), kBwdWarps warps; bf16 I/O. See the header.
template <int HD, int MODE>
__global__ void __launch_bounds__(kBwdWarps * 32, 16 / kBwdWarps) flash_bwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    const uint8_t* __restrict__ bits, const __nv_bfloat16* __restrict__ dout,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int H, int L, float scale, int thresh, float drop_scale, uint32_t seed) {
  using bf16 = __nv_bfloat16;
  constexpr int HDP = HD < 16 ? 16 : HD;  // head width padded to one k16 step
  constexpr int KS = HDP / 16;
  constexpr bool kPow2 = HD == 16;  // scale = 1/4: q.scale is exact in bf16
  constexpr float kLog2e = 1.4426950408889634f;
  static_assert(HD == 8 || HD == 16 || HD == 32, "head width");
  const int T = (L + 15) / 16, Lp = 16 * T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // raw q
  bf16* ks = qs + Lp * HDP;
  bf16* vs = ks + Lp * HDP;
  bf16* dos = vs + Lp * HDP;
  bf16* qsc = kPow2 ? qs : dos + Lp * HDP;  // q.scale rounded to bf16
  float* neg2 = reinterpret_cast<float*>((kPow2 ? dos : qsc) + Lp * HDP);
  float4* stat = reinterpret_cast<float4*>(neg2 + Lp);  // (m, 1 / denom, t, 0) of each query row
  uint8_t* ktile = reinterpret_cast<uint8_t*>(stat + Lp);  // T x T tiles of 32 keep bytes
  uint32_t* scratch = reinterpret_cast<uint32_t*>(ktile + T * T * 32);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const size_t base = static_cast<size_t>(bh) * L * HD;
  for (int idx = threadIdx.x; idx < Lp * HDP; idx += blockDim.x) {
    const int r = idx / HDP, c = idx % HDP;
    const bool in = r < L && c < HD;
    const size_t gi = base + static_cast<size_t>(r) * HD + c;
    const int o = swz<HDP>(r, c / 8) + c % 8;
    const bf16 zero = __float2bfloat16_rn(0.f);
    const bf16 qv = in ? q[gi] : zero;
    qs[o] = qv;
    ks[o] = in ? k[gi] : zero;
    vs[o] = in ? v[gi] : zero;
    dos[o] = in ? dout[gi] : zero;
    if (!kPow2) qsc[o] = __float2bfloat16_rn(__bfloat162float(qv) * scale);
  }
  // keys at index L or beyond: -inf, so that their exp is exactly 0
  for (int j = threadIdx.x; j < Lp; j += blockDim.x)
    neg2[j] = j >= L ? -INFINITY
                     : ((mask != nullptr && mask[static_cast<size_t>(b) * L + j]) ? kNeg * kLog2e : 0.f);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float mul = kPow2 ? scale * kLog2e : kLog2e;  // scores in the log2 domain

  // ---- pass A: a warp per 16-query-row tile, three sweeps over the keys
  for (int it = warp; it < T; it += kBwdWarps) {
    const int i0 = 16 * it;
    // the keep bytes of this tile row, drawn once, by the warp that reads
    // them here (pass B reads them after the block's barrier)
    if constexpr (MODE != kKeepAll)
      draw_tile_row<MODE>(ktile, scratch + warp * scratch_words(L), bits,
                          (static_cast<uint64_t>(bh) * L + i0) * L, it, T, L, thresh, seed, lane);
    const uint8_t* krow = ktile + it * T * 32 + g + 8 * t;
    uint32_t qa[KS][4], da[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(qa[kk], a_addr<HDP>(qsc, i0, kk, lane));
      ldsm_x4(da[kk], a_addr<HDP>(dos, i0, kk, lane));
    }
    // sweep 1: the row max (rows i0 + g and i0 + g + 8 of this lane)
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
    // sweep 2: denom = sum exp(s - m), the pre-dropout sum; t = sum dp.p
    float den[2] = {0.f, 0.f}, tu[2] = {0.f, 0.f};
    for (int j0 = 0; j0 < Lp; j0 += 16) {
      float s[2][4], dp[2][4];
      tile_scores<HDP>(s, qa, ks, neg2, j0, mul, lane);
      tile_dp<HDP, MODE>(dp, da, vs, krow, j0, drop_scale, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pu = ex2(s[n][e] - m[e >> 1]);
          den[e >> 1] += pu;
          tu[e >> 1] = fmaf(dp[n][e], pu, tu[e >> 1]);
        }
      }
    }
    float rden[2], tt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
      den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
      tu[h] += __shfl_xor_sync(0xffffffffu, tu[h], 1);
      tu[h] += __shfl_xor_sync(0xffffffffu, tu[h], 2);
      rden[h] = 1.f / den[h];
      tt[h] = tu[h] * rden[h];
      if (t == 0) stat[i0 + g + 8 * h] = make_float4(m[h], rden[h], tt[h], 0.f);
    }
    // sweep 3: ds = p (dp - t) in bf16, dq += ds.k
    float acc[HDP / 8][4] = {};
    for (int j0 = 0; j0 < Lp; j0 += 16) {
      float s[2][4], dp[2][4];
      tile_scores<HDP>(s, qa, ks, neg2, j0, mul, lane);
      tile_dp<HDP, MODE>(dp, da, vs, krow, j0, drop_scale, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          s[n][e] = ex2(s[n][e] - m[h]) * rden[h] * (dp[n][e] - tt[h]);
        }
      }
      uint32_t a[4];
      pack_a(a, s);
      tile_acc<HDP>(acc, a, ks, j0, lane);
    }
    store_rows<HD, HDP>(dq + base, acc, i0, L, scale, lane);
  }
  __syncthreads();

  // ---- pass B: a warp per 16-key tile, one sweep over the queries
  for (int jt = warp; jt < T; jt += kBwdWarps) {
    const int j0 = 16 * jt;
    // pass A's byte 2t + x + 8(g / 2) of tile (i0 / 16, jt) holds this lane's
    // keep(i0 + 2t + x + 8n, j0 + g + 8h) in bit 4n + 2h + g % 2
    const uint8_t* kcol = ktile + jt * 32 + 2 * t + 8 * (g >> 1);
    uint32_t ka[KS][4], va[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(ka[kk], a_addr<HDP>(ks, j0, kk, lane));
      ldsm_x4(va[kk], a_addr<HDP>(vs, j0, kk, lane));
    }
    const float ng[2] = {neg2[j0 + g], neg2[j0 + g + 8]};
    float dka[HDP / 8][4] = {}, dva[HDP / 8][4] = {};
    for (int i0 = 0; i0 < Lp; i0 += 16) {
      // s^T (keys j0 + g, + 8; queries i0 + 8n + 2t, + 1) and dpd^T
      float s[2][4], dpd[2][4];
      tile_abt<HDP>(s, ka, qsc, i0, lane);
      tile_abt<HDP>(dpd, va, dos, i0, lane);
      uint32_t kb = 0u;
      if (MODE != kKeepAll) kb = *reinterpret_cast<const uint16_t*>(kcol + i0 * T * 2) >> (g & 1);
      float pd[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float4 st = stat[i0 + 8 * n + 2 * t + x];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * h + x;
            const float p = ex2(fmaf(s[n][e], mul, ng[h]) - st.x) * st.y;
            float dp = dpd[n][e], pv = p;
            if (MODE != kKeepAll) {
              const float keep = (kb >> (8 * x + 4 * n + 2 * h)) & 1u ? drop_scale : 0.f;
              pv = p * keep;
              dp *= keep;
            }
            pd[n][e] = pv;
            s[n][e] = p * (dp - st.z);
          }
        }
      }
      uint32_t ap[4], as[4];
      pack_a(ap, pd);
      pack_a(as, s);
      tile_acc<HDP>(dva, ap, dos, i0, lane);
      tile_acc<HDP>(dka, as, qs, i0, lane);
    }
    store_rows<HD, HDP>(dk + base, dka, j0, L, scale, lane);
    store_rows<HD, HDP>(dv + base, dva, j0, L, 1.f, lane);
  }
}

// Forward, bf16 I/O, on the tensor cores. Block (batch, head), kFwdWarps
// warps, a warp per 16-query-row tile: the tile row's keep bytes drawn as
// pass A of the backward draws them (draw_tile_row), the keep mask
// exported from the warp's scratch bits when keep_out is not null, then
// attend_rows (mma.cuh) on q.scale rounded to bf16. kDrawOnly and
// kMatmulOnly are the K4x ladder's. See the header.
constexpr int kFwdWarps = 4;

// whether a forward mode draws the keep mask into tile bytes (and so
// allocates them)
__host__ __device__ constexpr bool draws(int mode) {
  return mode == kPhilox || mode == kBits || mode == kDrawOnly;
}

template <int HD, int MODE>
__global__ void __launch_bounds__(kFwdWarps * 32) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
    const uint8_t* __restrict__ bits, __nv_bfloat16* __restrict__ out, uint8_t* __restrict__ keep_out,
    int H, int L, float scale, int thresh, float drop_scale, uint32_t seed) {
  static_assert(HD == 8 || HD == 16 || HD == 32, "head width");
  constexpr bool kDraw = draws(MODE), kApply = MODE == kPhilox || MODE == kBits;
  constexpr bool kRaw = MODE == kMatmulOnly;
  const int T = (L + 15) / 16, Lp = 16 * T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + Lp * padded_width(HD);
  float* neg2 = reinterpret_cast<float*>(vs + Lp * padded_width(HD));
  uint32_t* scratch = reinterpret_cast<uint32_t*>(neg2 + Lp);  // per warp: scratch_words(L)
  uint8_t* ktile = reinterpret_cast<uint8_t*>(scratch + kFwdWarps * scratch_words(L));  // T x T tiles of 32

  const int bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * L * HD;
  load_kv<HD>(ks, vs, k + base, v + base, L);
  fill_key_mask<!kRaw>(neg2, mask != nullptr ? mask + static_cast<size_t>(bh / H) * L : nullptr, L);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint32_t* sc = scratch + warp * scratch_words(L);
  for (int it = warp; it < T; it += kFwdWarps) {
    const int i0 = 16 * it;
    const uint64_t e0 = (static_cast<uint64_t>(bh) * L + i0) * L;
    // kDrawOnly draws kPhilox's bits (draw_tile_row branches on kPhilox)
    if constexpr (kDraw)
      draw_tile_row<MODE == kBits ? kBits : kPhilox>(ktile, sc, bits, e0, it, T, L, thresh, seed, lane);
    if (keep_out != nullptr) {
      // element f = (i - i0) * L + j of the tile row is bit f + e0 % 4 of sc
      const int d = static_cast<int>(e0 & 3);
      for (int f = lane; f < min(16, L - i0) * L; f += 32)
        keep_out[e0 + f] = kDraw ? (sc[(f + d) >> 5] >> ((f + d) & 31)) & 1u : 1u;
      __syncwarp();  // the next tile row's draw overwrites sc
    }
    uint32_t qa[padded_width(HD) / 16][4];
    load_q<HD>(qa, q + base, i0, L, scale, lane);
    attend_rows<HD, kApply, kRaw>(out + base, qa, ks, vs, neg2, ktile + it * T * 32 + (lane >> 2) + 8 * (lane & 3),
                                  i0, L, kRaw ? 1.f : kLog2e, drop_scale, lane);
  }
}

// K4x `batched{N}` in bf16 (see the header): block (batch row, group of
// pair_block = N heads), up to pair_warps(HD) warps over the N * T (head,
// tile) pairs; K and V of head n at row n * Lp of ks and vs. 32 warps hold
// a thread to 64 registers, which hd = 32 needs more than
__host__ __device__ constexpr int pair_warps(int hd) { return hd == 32 ? 24 : 32; }

template <int HD>
__global__ void __launch_bounds__(pair_warps(HD) * 32, 1) flash_fwd_mma_pairs_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
    int H, int L, int pair_block, float scale) {
  static_assert(HD == 8 || HD == 16 || HD == 32, "head width");
  constexpr int HDP = padded_width(HD);
  const int T = (L + 15) / 16, Lp = 16 * T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + static_cast<size_t>(pair_block) * Lp * HDP;
  float* neg2 = reinterpret_cast<float*>(vs + static_cast<size_t>(pair_block) * Lp * HDP);

  const int groups = H / pair_block;
  const int b = blockIdx.x / groups;
  // heads h0 .. h0 + pair_block - 1 of batch row b are contiguous
  const size_t base = (static_cast<size_t>(b) * H + (blockIdx.x % groups) * pair_block) * L * HD;
  load_kv<HD>(ks, vs, k + base, v + base, L, pair_block);
  fill_key_mask<true>(neg2, mask != nullptr ? mask + static_cast<size_t>(b) * L : nullptr, L);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int pr = warp; pr < pair_block * T; pr += blockDim.x / 32) {
    const int n = pr / T, i0 = 16 * (pr - n * T);
    const size_t head = base + static_cast<size_t>(n) * L * HD;
    const size_t rows = static_cast<size_t>(n) * Lp * HDP;
    uint32_t qa[HDP / 16][4];
    load_q<HD>(qa, q + head, i0, L, scale, lane);
    attend_rows<HD, false>(out + head, qa, ks + rows, vs + rows, neg2, nullptr, i0, L, kLog2e, 1.f, lane);
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

// flash_bwd_mma_kernel: q, k, v, do (and q.scale unless HD = 16) as
// (Lp, max(16, HD)) bf16, Lp = L rounded up to 16; the key mask; the row
// statistics; with dropout, the keep bytes of every 16 x 16 tile and each
// warp's scratch for drawing them
size_t bwd_mma_smem(int L, int hd, int mode) {
  const size_t T = (L + 15) / 16, Lp = 16 * T, hdp = hd < 16 ? 16 : hd;
  const size_t arrays = hd == 16 ? 4 : 5;
  const size_t keep = mode == kKeepAll ? 0 : T * T * 32 + sizeof(uint32_t) * kBwdWarps * scratch_words(L);
  return arrays * Lp * hdp * 2 + Lp * (sizeof(float) + sizeof(float4)) + keep;
}

// flash_fwd_mma_kernel: K and V, the key mask (kv_smem); when the mode
// draws, each warp's scratch and the keep bytes of every 16 x 16 tile
size_t fwd_mma_smem(int L, int hd, int mode) {
  const size_t T = (L + 15) / 16;
  const size_t keep = draws(mode) ? sizeof(uint32_t) * kFwdWarps * scratch_words(L) + T * T * 32 : 0;
  return kv_smem(L, hd) + keep;
}

// flash_fwd_mma_pairs_kernel: K and V of pair_block heads, one mask row
size_t pairs_mma_smem(int L, int hd, int pair_block) {
  const size_t Lp = 16 * ((L + 15) / 16);
  return 2 * pair_block * Lp * padded_width(hd) * sizeof(__nv_bfloat16) + Lp * sizeof(float);
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

// ac_flash_fwd and the K4x rungs other than batched{N}: f32 runs on the
// FMA kernel, bf16 on the tensor-core kernel (see the header)
template <typename T, int HD, int MODE>
int launch_fwd(const Args& a) {
  if constexpr (std::is_same_v<T, float>) {
    const size_t smem = fwd_smem(a.L, HD);
    auto kernel = flash_fwd_kernel<float, HD, MODE>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<a.BH, kWarps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const uint8_t*>(a.bits), static_cast<float*>(a.out),
        static_cast<uint8_t*>(a.keep_out), a.H, a.L, a.scale, a.thresh, a.drop_scale, a.seed);
  } else {
    const size_t smem = fwd_mma_smem(a.L, HD, MODE);
    auto kernel = flash_fwd_mma_kernel<HD, MODE>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<a.BH, kFwdWarps * 32, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const uint8_t*>(a.bits), static_cast<T*>(a.out),
        static_cast<uint8_t*>(a.keep_out), a.H, a.L, a.scale, a.thresh, a.drop_scale, a.seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32 runs on the FMA kernel, bf16 on the tensor-core kernel (see the header)
template <typename T, int HD, int MODE>
int launch_bwd(const Args& a) {
  if constexpr (std::is_same_v<T, float>) {
    const size_t smem = bwd_smem(a.L, HD);
    auto kernel = flash_bwd_kernel<float, HD, MODE>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<a.BH, kWarps * 32, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const uint8_t*>(a.bits),
        static_cast<const float*>(a.dout), static_cast<float*>(a.dq), static_cast<float*>(a.dk),
        static_cast<float*>(a.dv), a.H, a.L, a.scale, a.thresh, a.drop_scale, a.seed);
  } else {
    const size_t smem = bwd_mma_smem(a.L, HD, MODE);
    auto kernel = flash_bwd_mma_kernel<HD, MODE>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<a.BH, kBwdWarps * 32, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const uint8_t*>(a.mask), static_cast<const uint8_t*>(a.bits),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.H, a.L, a.scale, a.thresh, a.drop_scale, a.seed);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4x batched{N}: f32 on flash_fwd_pairs_kernel, bf16 on
// flash_fwd_mma_pairs_kernel (see the header)
template <typename T, int HD>
int launch_pairs(const Args& a, int pair_block) {
  if (a.H % pair_block != 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kF32 = std::is_same_v<T, float>;
  const size_t smem = kF32 ? pairs_smem(a.L, HD, pair_block, sizeof(T)) : pairs_mma_smem(a.L, HD, pair_block);
  // K and V of pair_block heads over a block's shared memory (f32 batched8
  // at L = 258, hd = 32 batched8 in both dtypes): refused, as "too many
  // resources requested for launch"
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const uint8_t* mask = static_cast<const uint8_t*>(a.mask);
  if constexpr (kF32) {
    auto kernel = flash_fwd_pairs_kernel<float, HD>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<a.BH / pair_block, kWarps * 32, smem, a.stream>>>(q, k, v, mask, static_cast<T*>(a.out), a.H, a.L,
                                                                pair_block, a.scale);
  } else {
    // as many warps as divide the (head, tile) pairs into equal rounds
    const int tiles = pair_block * ((a.L + 15) / 16);
    const int rounds = (tiles + pair_warps(HD) - 1) / pair_warps(HD);
    auto kernel = flash_fwd_mma_pairs_kernel<HD>;
    if (int err = prepare(kernel, smem)) return err;
    kernel<<<a.BH / pair_block, 32 * ((tiles + rounds - 1) / rounds), smem, a.stream>>>(
        q, k, v, mask, static_cast<T*>(a.out), a.H, a.L, pair_block, a.scale);
  }
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
