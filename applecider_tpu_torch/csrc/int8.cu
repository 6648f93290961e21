// int8 serving: the input quantizer, the int8 GEMM, the implicit-GEMM
// convolution and the depthwise convolution, each with the dequantizing
// epilogue of the post-training quantization in ops/quant.py.
//
// No TPU kernel is replaced: the JAX package computes these products with
// XLA (applecider_tpu/ops/quant.py: quant_dense's lax.dot_general and
// quant_conv's lax.conv_general_dilated, preferred_element_type=int32).
// PyTorch has no eager int8 convolution on CUDA, and its one int8 GEMM,
// torch._int_mm, refuses most of the serving path's shapes (it needs M > 16
// and K, N multiples of 8: the photometry in_proj has K = 7, the metadata
// towers K = 19, the router N = 4).
//
// Arithmetic, as the JAX package orders it, so that the kernels and their
// plain versions agree bit for bit:
//  * ac_int8_quantize: q = clamp(rint(x * inv), -127, 127) as int8, the
//    product one f32 rounding (__fmul_rn: nvcc may contract nothing), rint
//    half to even as jnp.round;
//  * the products accumulate exactly in int32, in any order (|acc| <= K *
//    127^2 < 2^31 for K < 133,144; the serving path's largest K is
//    SpectraNet stage 1's 64 * 251 = 16,064 taps x channels);
//  * the epilogue: y = float(acc) * scale[n] (+ bias[n]), each one f32
//    rounding (__int2float_rn, __fmul_rn, __fadd_rn), then the output dtype
//    (f32, bf16 round to nearest even); out dtype 2 writes the raw int32
//    accumulators instead (the check of the products alone).
//
// Bounds on the H100. The GEMM and the convolution do 2 * M * N * K integer
// operations against 1,979 TOPS of dense int8 tensor-core rate and move
// M * K + N * K bytes in and M * N outputs out at 3.35 TB/s. SpectraNet's
// bank convolutions (K = 3 to 1,021 taps, 1 to 512 channels, ~1.3 int8
// TOPs a 193-spectra block) are bound by operations; the photometry
// transformer's GEMMs (M = 512 * 258 rows, K = 128 or 512) by bytes, most
// of them the bf16 output (101 MB at N = 384: 0.030 ms). The quantizer
// moves 5 (f32 in, int8 out) or 3 (bf16) bytes an element.
//
// Design of the GEMM and the convolution: one kernel, igemm_kernel<T,
// ALoader, BN>, on the int8 tensor cores (mma.sync m16n8k32, s8 x s8 ->
// s32). A block of 8 warps computes a 128 x BN tile of the (M, N) output:
// BN = 128, each warp 64 x 32 outputs (16 mma a k32 step), or, where N <= 64
// (SpectraNet stage 0 and its 1x1, N = 64; the router, N = 4), BN = 64,
// each warp 32 x 32 (8 mma). K streams through a ring of 4 stages of 64
// bytes of K in shared memory (A 128 rows, B BN rows of 64 bytes; 16-byte
// chunks XOR-swizzled so that ldmatrix reads 8 rows without bank
// conflicts), filled 3 stages ahead of the products. ldmatrix (.b16, rows of 16 bytes) loads
// the fragments: the int8 m16n8k32 fragments are, byte for byte, the bf16
// m16n8k16 ones. A chunk of 16 bytes of one row comes by one of three
// routes, chosen once a launch:
//  * cp.async.cg 16 bytes, zero-filled (src-size 0) past K, past the last
//    row and where the window reads padding: the GEMM's A and every B where
//    K % 16 == 0 and the base is 16-byte aligned (checked: a view can be
//    misaligned); the convolution's A where C % 16 == 0 (16 channels of one
//    tap: SpectraNet stages 1-4, ConvNeXt's downsamples) and x is aligned;
//  * a run of bytes assembled from the aligned words that hold it
//    (funnel shifts, bytes outside the run zeroed; no word outside the
//    tensor is read): the same rows where K or the base is not aligned
//    (the photometry in_proj K = 7, the metadata towers K = 19, the bank
//    weights of SpectraNet stage 0, K = 3, 61, 1,021), and the
//    convolution's A where C = 1 and kh = 1 (stage 0: a chunk is 16
//    consecutive taps of one row of x, padding zeroed);
//  * byte by byte, any other convolution (C = 3: ConvNeXt's stem).
// In BN = 64 tiles the last two load A into registers before a stage's
// products and store it to shared memory after them; elsewhere they store
// at once, so that no registers are held across the products. Chunks past
// K are zero in both operands, and a k32 step wholly past K is skipped:
// short rows are padded to the next 32. Two blocks of 128 registers a
// thread fit an SM. The epilogue's scale and bias columns are copied with
// the first stage; it stages the tile in shared memory of its own, beside
// the ring (64 or 128 rows at a time), and writes 16 bytes a thread where
// N * sizeof(T) % 16 == 0, else element by element. Conv1d
// runs as a 1 x L image.
//
// The depthwise convolution (groups = C = Cout: every ConvNeXt block's 7x7
// pad 3, at 15x15x96, 7x7x192, 3x3x384 and 1x1x768 on 63x63 stamps; 18
// launches a forward) reads each input byte and writes each output once:
// 1 byte in and 2 out (bf16) an output, 33.2 MB at stage 0 (B = 512), 0.0099
// ms at 3.35 TB/s; 14.5, 5.3 and 1.2 MB at stages 1-3. Its 49 MACs an output
// (38.4, 27.9, 9 and 1 of them inside the image) are no tensor-core work:
// each output channel has its own 49 weights. So after the bytes, what
// bounds it is the rate of its integer instructions (128 a clock an SM),
// and the design cuts those: dwconv_tile_kernel<T, R>.
//  * A block stages a tile in shared memory: NI whole images (one where the
//    image is large, up to 32 where it is small: stages 1-3) by a slice of
//    CS <= 128 channels, H rows of TW columns, the padding columns written
//    as zeros; rows wholly in the padding are not stored but skipped. Each
//    input byte is read from device memory once: by cp.async.cg 16 bytes
//    where C % 16 == 0 and x is 16-byte aligned (every ConvNeXt stage),
//    else byte by byte (C % 16 != 0, or a view off alignment: checked, not
//    assumed). Beside it, the slice's weights as words of 4 taps of one
//    channel (kw <= 8: two words a row, taps past kw zero). NI and CS are
//    chosen on the host so that the items of a block fill its 256 threads
//    (stage 2: 5 images, stage 3: 8) and at least two blocks an SM are in
//    flight.
//  * A thread owns a word of 4 channels and a run of R (8, 4 or 1, from Wo)
//    outputs along a row. For each row of the window inside the image it
//    reads the row's R + 7 positions once (4-byte words of its 4 channels,
//    the lanes of a warp on consecutive words), transposes them in
//    registers, 4 x 4 bytes by 8 __byte_perm, into channel-planar words (4
//    positions of one channel), and applies the row's taps to every output
//    of its run: __dp4a over 4 taps of one channel, the window's offset by
//    one funnel shift. That design was taken over int32 multiply-adds on
//    unpacked bytes (49 IMAD an output-channel and the unpacking): with
//    R = 8 a row costs 16 + 2 loads, 32 + 48 byte moves and 64 IDP4A for 32
//    output-channels, ~5 instructions an output-channel a row against ~9.
//    Stage 0 runs ~370 M of them, ~0.013 ms at 128 a clock an SM, beside
//    its 0.0099 ms of bytes. The sums are exact int32 in any order, so the
//    kernel stays bit for bit with its twin.
//  * Coordinates come from the block index (images, slice) and a 32-bit
//    item index a thread (no 64-bit division); the 1-D grid is sized to the
//    work. A warp stores consecutive channel words of one output pixel: 4
//    outputs a thread, 8 bytes in bf16, 16 in f32 and int32.
// Any other geometry (a stride other than 1, C % 4 != 0, kw > 8, an output
// not aligned to 4 outputs, one image's tile of the narrowest slice, 16
// channels or 4 where C % 16 != 0, past 96 KB) runs the general path,
// dwconv_general_kernel<T>: a thread an output, consecutive threads on
// consecutive channels, its taps read from device memory.
// ac_int8_dwconv_plan reports which path and launch a shape takes.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int AC_I32 = 2;  // out dtype code: the int32 accumulators, no epilogue
constexpr int kThreads = 256;  // the quantizer and the depthwise kernel
constexpr int kBM = 128;       // output rows of a tile
constexpr int kBK = 64;        // bytes of K a stage
constexpr int kChunks = kBK / 16;
constexpr int kStages = 4;

// the convolution's A routes (see the note above)
enum ConvMode : int { kRun16 = 0, kRun1 = 1, kBytes = 2 };

bool aligned(const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..3) of row r in a tile of 64-byte rows:
// the eight rows one ldmatrix reads fall in distinct banks.
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + 16 * (c ^ ((r >> 1) & 3)); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a.b: m16n8k32, s8 operands, s32 accumulation. Lane l = 4g + t holds
// a = {(g, 4t..4t+3), (g+8, 4t..), (g, 4t+16..), (g+8, 4t+16..)}, b = {(k
// 4t..4t+3, n g), (k 4t+16.., n g)}, d = {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)}.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes [lo, hi) of the 16 at p, zero elsewhere (none if lo >= hi). Reads
// only the aligned words that hold a byte of [p + lo, p + hi), so p may
// point before or past the tensor where lo and hi keep to it.
__device__ __forceinline__ uint4 load_run(const int8_t* p, int lo, int hi) {
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  if (lo < hi) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
    const int sh = static_cast<int>(addr & 3);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(addr - sh);
    uint32_t v[5];
    if (lo == 0 && hi == 16) {  // a whole chunk: no bytes to clear
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __ldg(w + j);
      v[4] = sh ? __ldg(w + 4) : 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = __funnelshift_r(v[q], v[q + 1], 8 * sh);
    } else {
      const int j0 = (lo + sh) >> 2, j1 = (hi - 1 + sh) >> 2;
#pragma unroll
      for (int j = 0; j < 5; ++j) v[j] = (j >= j0 && j <= j1) ? __ldg(w + j) : 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = min(max(lo - 4 * q, 0), 4), b = min(max(hi - 4 * q, 0), 4);
        const uint32_t keep = static_cast<uint32_t>((1ull << (8 * b)) - 1ull) &
                              ~static_cast<uint32_t>((1ull << (8 * a)) - 1ull);
        o[q] = __funnelshift_r(v[q], v[q + 1], 8 * sh) & keep;
      }
    }
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A chunk of 16 bytes of K of one row: a run of bytes [lo, hi) at p, or
// (run() false) bytes assembled by the loader one at a time. A loader's
// Cursor is a thread's k0 (the chunk's first column) as the stages of K
// advance, kBK bytes a step, with what the loader derives from it.
struct Run {
  const int8_t* p;
  int lo, hi;
};

// A of the GEMM: a row-major (M, K) int8 matrix.
struct GemmA {
  const int8_t* a;
  int64_t M;
  int K;
  bool async;  // K % 16 == 0 and a 16-byte aligned: a chunk is whole or past K
  struct Row {
    const int8_t* p;
    bool ok;
  };
  struct Cursor {
    int k0;
  };
  __device__ __forceinline__ Cursor cursor(int k0) const { return {k0}; }
  __device__ __forceinline__ void advance(Cursor& k) const { k.k0 += kBK; }
  __device__ __forceinline__ Row row(int64_t m) const { return {a + (m < M ? m : 0) * K, m < M}; }
  __device__ __forceinline__ bool run(const Row& r, const Cursor& k, Run& c) const {
    c = {r.p + k.k0, 0, r.ok ? min(16, K - k.k0) : 0};
    return true;
  }
  __device__ __forceinline__ uint4 bytes(const Row&, int) const { return make_uint4(0, 0, 0, 0); }
};

// A of the convolution: row m = (b, ho, wo), column k = (r, s, c) of the
// implicit-GEMM matrix of an NHWC int8 image against a (Cout, kh, kw, C)
// weight, zero where the window reads padding.
struct ConvA {
  const int8_t* x;  // (B, H, W, C)
  int64_t M;        // B * Ho * Wo
  int H, W, C, Ho, Wo, kw, sh, sw, ph, pw, K;
  int mode;    // ConvMode
  bool async;  // kRun16 and x 16-byte aligned
  struct Row {
    const int8_t* p;  // x[b, h0, w0, 0]; pixel (h0 + r, w0 + s) is at p + (r * W + s) * C
    int h0, w0;       // the window's top-left pixel; h0 = kNoRow past the last row
  };
  static constexpr int kNoRow = -(1 << 30);  // every tap of the row reads padding
  struct Cursor {
    int k0, ch, s, r;  // kRun16: k0 is channel ch of tap (r, s),
    int off;           // at off = (r * W + s) * C + ch from a row's p
  };
  __device__ __forceinline__ Cursor cursor(int k0) const {
    const int tap = k0 / C, ch = k0 - tap * C, s = tap % kw, r = tap / kw;
    return {k0, ch, s, r, (r * W + s) * C + ch};
  }
  __device__ __forceinline__ void advance(Cursor& k) const {
    k.k0 += kBK;
    if (mode != kRun16) return;
    for (k.ch += kBK; k.ch >= C; k.ch -= C) {  // C >= 16: at most 4 taps a step
      if (++k.s == kw) {
        k.s = 0;
        ++k.r;
      }
    }
    k.off = (k.r * W + k.s) * C + k.ch;
  }
  __device__ __forceinline__ Row row(int64_t m) const {
    const bool ok = m < M;
    if (!ok) m = 0;
    const int64_t hw = static_cast<int64_t>(Ho) * Wo;
    int64_t b;
    int rem;
    if (M <= 0x7fffffff) {  // 32-bit division where it will do
      b = static_cast<uint32_t>(m) / static_cast<uint32_t>(hw);
      rem = static_cast<int>(m - b * hw);
    } else {
      b = m / hw;
      rem = static_cast<int>(m - b * hw);
    }
    const int ho = rem / Wo, wo = rem - ho * Wo;
    const int h0 = ok ? ho * sh - ph : kNoRow, w0 = wo * sw - pw;
    return {x + ((b * H + h0) * static_cast<int64_t>(W) + w0) * C, h0, w0};
  }
  __device__ __forceinline__ bool run(const Row& r, const Cursor& k, Run& c) const {
    if (mode == kRun16) {  // 16 channels of one tap
      const int h = r.h0 + k.r, w = r.w0 + k.s;
      const bool in = k.k0 < K && h >= 0 && h < H && w >= 0 && w < W;
      c = {in ? r.p + k.off : x, 0, in ? 16 : 0};
      return true;
    }
    if (mode == kRun1) {  // C = 1, kh = 1: taps k0.. are consecutive pixels of row h0
      const int w = r.w0 + k.k0;
      const bool in = r.h0 >= 0 && r.h0 < H;
      c = {r.p + k.k0, max(0, -w), in ? min(16, min(W - w, K - k.k0)) : 0};
      return true;
    }
    return false;
  }
  __device__ __forceinline__ uint4 bytes(const Row& r, int k0) const {
    uint32_t o[4] = {0u, 0u, 0u, 0u};
    if (k0 < K) {
      const int tap = k0 / C;
      int ch = k0 - tap * C, rr = tap / kw, s = tap - rr * kw;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int h = r.h0 + rr, w = r.w0 + s;
        if (k0 + i < K && h >= 0 && h < H && w >= 0 && w < W)
          o[i >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(r.p[(rr * W + s) * C + ch]))
                       << (8 * (i & 3));
        if (++ch == C) {
          ch = 0;
          if (++s == kw) {
            s = 0;
            ++rr;
          }
        }
      }
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
};

template <int BN>
struct Tile {
  static constexpr int kThreads = 256;
  static constexpr int kWarpsN = BN / 32;        // warps along N, 32 outputs each
  static constexpr int kWarpsM = 8 / kWarpsN;    // warps along M
  static constexpr int kMT = kBM / 16 / kWarpsM;  // m16 tiles a warp: 64 or 32 rows
  static constexpr int kAChunks = kBM * kChunks / kThreads;  // A chunks a thread loads a stage
  static constexpr int kBChunks = BN * kChunks / kThreads;
  static constexpr int kStageBytes = (kBM + BN) * kBK;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // the epilogue stages kPassRows rows of the tile at a time: all 128 in
  // bf16, 64 in f32 and int32, in rows padded by 8 outputs
  template <typename T>
  __host__ __device__ static constexpr int pass_rows() { return sizeof(T) == 2 ? kBM : kBM / 2; }
  template <typename T>
  __host__ __device__ static constexpr int out_row_bytes() {
    return (BN + 8) * static_cast<int>(sizeof(T));
  }
  template <typename T>
  __host__ __device__ static constexpr int epi_bytes() {
    return pass_rows<T>() * out_row_bytes<T>();
  }
  // then the tile's scale and bias columns, f32
  template <typename T>
  __host__ __device__ static constexpr int smem_bytes() {
    return kRingBytes + epi_bytes<T>() + 2 * BN * 4;
  }
};

template <typename T>
__device__ __forceinline__ T epilogue(int acc, float scale, float bias, bool has_bias) {
  if constexpr (std::is_same<T, int>::value) {
    return acc;
  } else {
    float y = __fmul_rn(__int2float_rn(acc), scale);
    if (has_bias) y = __fadd_rn(y, bias);
    return ac::from_f32<T>(y);
  }
}

template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T v[2];
};

// (M, N) = A (M, K) x B (N, K)^T, int8 in, int32 accumulated on the tensor
// cores, then the epilogue. Block blockIdx.x computes tile (blockIdx.x /
// n_tiles, blockIdx.x % n_tiles): the N tiles of one row of tiles run side
// by side and share its A rows in L2.
template <typename T, typename ALoader, int BN>
__global__ void __launch_bounds__(256, 2) igemm_kernel(
    ALoader a, const int8_t* __restrict__ bmat, int N, bool b_async,
    const float* __restrict__ scale, const float* __restrict__ bias, T* __restrict__ out,
    bool out_vec) {
  using Cfg = Tile<BN>;
  constexpr int kT = Cfg::kThreads, kMT = Cfg::kMT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Cfg::kWarpsM, wn = warp / Cfg::kWarpsM;
  const int n_tiles = (N + BN - 1) / BN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int K = a.K, nk = (K + kBK - 1) / kBK;
  const int cc = tid & 3;  // the chunk of a stage's 64 bytes this thread loads

  typename ALoader::Row arow[Cfg::kAChunks];
#pragma unroll
  for (int j = 0; j < Cfg::kAChunks; ++j) arow[j] = a.row(m0 + (tid >> 2) + j * (kT / 4));
  const int8_t* brow[Cfg::kBChunks];
  bool bok[Cfg::kBChunks];
#pragma unroll
  for (int j = 0; j < Cfg::kBChunks; ++j) {
    const int n = n0 + (tid >> 2) + j * (kT / 4);
    bok[j] = n < N;
    brow[j] = bmat + static_cast<int64_t>(bok[j] ? n : 0) * K;
  }
  // A chunks that cp.async does not copy wait in registers across a
  // stage's products in BN = 64 tiles (SpectraNet stage 0's rows, assembled
  // from words); elsewhere they, and B's, go to shared memory at once, which
  // keeps the 128 x 128 tiles within 128 registers a thread
  constexpr bool kHoldA = BN == 64;
  uint4 held_a[Cfg::kAChunks];
  typename ALoader::Cursor kc = a.cursor(16 * cc);

  // the next step of K (kc) into ring slot `slot`: cp.async chunks go
  // straight to shared memory, the others as said above
  auto fetch = [&](int slot) {
    unsigned char* const as = smem + slot * Cfg::kStageBytes;
    unsigned char* const bs = as + kBM * kBK;
    const int k0 = kc.k0;
#pragma unroll
    for (int j = 0; j < Cfg::kAChunks; ++j) {
      const int r = (tid >> 2) + j * (kT / 4);
      Run c;
      uint4 v;
      if (!a.run(arow[j], kc, c)) {
        v = a.bytes(arow[j], k0);
      } else if (a.async) {
        const bool full = c.hi == 16;
        cp_async16(smem_u32(as + swz(r, cc)), full ? c.p : bmat, full);
        continue;
      } else {
        v = load_run(c.p, c.lo, c.hi);
      }
      if (kHoldA)
        held_a[j] = v;
      else
        *reinterpret_cast<uint4*>(as + swz(r, cc)) = v;
    }
#pragma unroll
    for (int j = 0; j < Cfg::kBChunks; ++j) {
      const int r = (tid >> 2) + j * (kT / 4);
      const int hi = bok[j] ? min(16, K - k0) : 0;
      if (b_async)
        cp_async16(smem_u32(bs + swz(r, cc)), hi == 16 ? brow[j] + k0 : bmat, hi == 16);
      else
        *reinterpret_cast<uint4*>(bs + swz(r, cc)) = load_run(brow[j] + k0, 0, hi);
    }
    a.advance(kc);
  };
  auto store_held = [&](int slot) {
    if (kHoldA && !a.async) {
      unsigned char* const as = smem + slot * Cfg::kStageBytes;
#pragma unroll
      for (int j = 0; j < Cfg::kAChunks; ++j)
        *reinterpret_cast<uint4*>(as + swz((tid >> 2) + j * (kT / 4), cc)) = held_a[j];
    }
  };

  int acc[kMT][4][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // the epilogue's scale and bias columns come with the first stage
  unsigned char* const epi = smem + Cfg::kRingBytes;
  float* const sb = reinterpret_cast<float*>(epi + Cfg::template epi_bytes<T>());  // scale, bias
  const bool has_bias = bias != nullptr;
  if constexpr (!std::is_same<T, int>::value) {
    if (tid < 2 * BN && (tid < BN || has_bias)) {
      const int n = n0 + tid % BN;
      const float* src = tid < BN ? scale : bias;
      cp_async4(smem_u32(sb + tid), n < N ? src + n : src, n < N);
    }
  }
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) {
      fetch(s);
      store_held(s);
    }
    cp_async_commit();
  }
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int pf = kt + kStages - 1;  // refills the slot read in step kt - 1
    if (pf < nk) fetch(pf % kStages);
    cp_async_commit();
    const uint32_t as = smem_u32(smem + (kt % kStages) * Cfg::kStageBytes), bs = as + kBM * kBK;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      if (kt * kBK + 32 * ks >= K) break;
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldsm_x4(r, bs + swz(wn * 32 + np * 16 + (lane & 7) + ((lane >> 4) & 1) * 8,
                            2 * ks + ((lane >> 3) & 1)));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t af[4];
        ldsm_x4(af, as + swz(wm * 16 * kMT + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             2 * ks + (lane >> 4)));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], af, b[nt][0], b[nt][1]);
      }
    }
    if (pf < nk) store_held(pf % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // sb has arrived (no step of K waited for it where K = 0)

  // the epilogue: kPassRows rows of the tile at a time through `epi`, its
  // own shared memory, then 16-byte stores
  constexpr int kRow = Cfg::template out_row_bytes<T>();
  constexpr int kPassRows = Cfg::template pass_rows<T>();
  const int g = lane >> 2, t4 = lane & 3;
  float sc[4][2], bi[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * 32 + nt * 8 + 2 * t4 + e;
      sc[nt][e] = std::is_same<T, int>::value ? 0.f : sb[col];
      bi[nt][e] = has_bias ? sb[BN + col] : 0.f;
    }
#pragma unroll
  for (int pass = 0; pass < kBM / kPassRows; ++pass) {
    if (pass > 0) __syncthreads();  // the previous pass's rows are out
    if (wm * 16 * kMT / kPassRows == pass) {  // this warp's rows are in the pass
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = wn * 32 + nt * 8 + 2 * t4;
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = wm * 16 * kMT + mt * 16 + g + 8 * half - pass * kPassRows;
            Pair<T> p;
            p.v[0] = epilogue<T>(acc[mt][nt][2 * half], sc[nt][0], bi[nt][0], has_bias);
            p.v[1] = epilogue<T>(acc[mt][nt][2 * half + 1], sc[nt][1], bi[nt][1], has_bias);
            *reinterpret_cast<Pair<T>*>(epi + row * kRow + col * sizeof(T)) = p;
          }
      }
    }
    __syncthreads();
    constexpr int kV = 16 / sizeof(T);  // outputs a 16-byte store
    constexpr int kRowChunks = BN / kV;
    for (int e = tid; e < kPassRows * kRowChunks; e += kT) {
      const int row = e / kRowChunks, col = (e % kRowChunks) * kV;
      const int64_t m = m0 + pass * kPassRows + row;
      const int n = n0 + col;
      if (m >= a.M || n >= N) continue;
      const unsigned char* src = epi + row * kRow + col * sizeof(T);
      T* dst = out + m * N + n;
      if (out_vec && n + kV <= N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < kV && n + j < N; ++j) dst[j] = reinterpret_cast<const T*>(src)[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) quantize_kernel(const T* __restrict__ x,
                                                            int8_t* __restrict__ q, int64_t n,
                                                            float inv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float r = rintf(__fmul_rn(ac::to_f32(x[i]), inv));
    q[i] = static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -127.0f), 127.0f)));
  }
}

unsigned int grid_stride_blocks(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

// Depthwise convolution (groups = C), the general path: a thread per output
// (b, ho, wo, c), any geometry; w is (kh, kw, C).
template <typename T>
__global__ void __launch_bounds__(kThreads) dwconv_general_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int64_t total, int H, int W, int C,
    int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int c = static_cast<int>(idx % C);
    int64_t p = idx / C;
    const int wo = static_cast<int>(p % Wo);
    p /= Wo;
    const int ho = static_cast<int>(p % Ho);
    const int64_t b = p / Ho;
    int acc = 0;
    for (int r = 0; r < kh; ++r) {
      const int h = ho * sh - ph + r;
      if (h < 0 || h >= H) continue;
      for (int s = 0; s < kw; ++s) {
        const int ww = wo * sw - pw + s;
        if (ww < 0 || ww >= W) continue;
        acc += static_cast<int>(x[((b * H + h) * static_cast<int64_t>(W) + ww) * C + c]) *
               static_cast<int>(w[(r * kw + s) * C + c]);
      }
    }
    out[idx] = epilogue<T>(acc, std::is_same<T, int>::value ? 0.f : scale[c],
                           bias != nullptr ? bias[c] : 0.f, bias != nullptr);
  }
}

// The depthwise tile kernel (see the note above), stride 1.
constexpr int kDwQuads = 2;                 // words of 4 taps a kernel row: kw <= 8
constexpr int kDwMaxCS = 128;               // channels of a slice
constexpr int kDwMaxImages = 32;            // images a block
constexpr int kDwTileBudget = 96 * 1024;    // bytes of image tile a block: two blocks an SM
constexpr int kDwMaxSmem = 227 * 1024;      // an H100 block's shared memory
constexpr int kSMs = 132;                   // an H100's SMs
enum DwLoad : int { kDwAsync16 = 0, kDwBytes = 1 };

struct DwTile {
  const int8_t* x;  // (B, H, W, C)
  const int8_t* w;  // (kh, kw, C)
  int64_t B;
  int H, W, C, Ho, Wo, kh, kw, ph, pw;
  int NI;      // images a block
  int CS, PS;  // channels of a slice; bytes of a tile pixel (CS rounded up to 16)
  int slices;  // slices of C
  int TW;      // tile columns: column p holds w = p - pw, zero outside the image
  int runs;    // runs of R outputs along a row
  int load;    // DwLoad
};

// 4 outputs of one pixel, stored at once
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

// Block blockIdx.x: channel slice blockIdx.x % slices of images NI *
// (blockIdx.x / slices) onward. A thread's items, 256 apart: channel word
// (fastest), run, output row, image.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2) dwconv_tile_kernel(
    const DwTile a, const float* __restrict__ scale, const float* __restrict__ bias,
    T* __restrict__ out) {
  constexpr int G = (R + 4 * kDwQuads + 2) / 4;  // words of 4 positions a run reads a row
  extern __shared__ __align__(128) unsigned char smem[];  // as igemm_kernel declares it
  const int tid = threadIdx.x;
  const int slice = blockIdx.x % a.slices;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x / a.slices) * a.NI;
  const int ni = a.B - b0 < a.NI ? static_cast<int>(a.B - b0) : a.NI;  // the last block: fewer
  const int c0 = slice * a.CS, cs = min(a.CS, a.C - c0), n_cw = cs / 4;
  const int row_bytes = a.TW * a.PS;  // a row of the tile
  unsigned char* const tile = smem;  // (NI * H, TW, PS)
  // then the weights, (kh, quads, CS) words
  uint32_t* const wsm = reinterpret_cast<uint32_t*>(smem + a.NI * a.H * row_bytes);

  // the images' pixels into columns pw..pw+W-1; px = (image * H + h) * W + w
  const int8_t* const xb = a.x + b0 * a.H * a.W * a.C + c0;
  const int n_px = ni * a.H * a.W;
  if (a.load == kDwAsync16) {
    const int per_px = cs / 16;
    for (int e = tid; e < n_px * per_px; e += kThreads) {
      const int k = e % per_px, px = e / per_px;
      const int col = a.pw + px % a.W, row = px / a.W;
      cp_async16(smem_u32(tile + row * row_bytes + col * a.PS + 16 * k),
                 xb + static_cast<int64_t>(px) * a.C + 16 * k, true);
    }
  } else {
    for (int e = tid; e < n_px * cs; e += kThreads) {
      const int k = e % cs, px = e / cs;
      const int col = a.pw + px % a.W, row = px / a.W;
      tile[row * row_bytes + col * a.PS + k] =
          static_cast<unsigned char>(xb[static_cast<int64_t>(px) * a.C + k]);
    }
  }
  cp_async_commit();
  // the padding columns 0..pw-1 and pw+W..TW-1, zero
  const int pad_cols = a.TW - a.W, chunks = a.PS / 16;
  for (int e = tid; e < ni * a.H * pad_cols * chunks; e += kThreads) {
    const int k = e % chunks, t = e / chunks;
    const int col = t % pad_cols, row = t / pad_cols;
    *reinterpret_cast<uint4*>(tile + row * row_bytes + (col < a.pw ? col : col + a.W) * a.PS +
                              16 * k) = make_uint4(0u, 0u, 0u, 0u);
  }
  // the weights: word (r, q, c) holds taps 4q..4q+3 of row r of channel c0 + c
  for (int e = tid; e < a.kh * kDwQuads * cs; e += kThreads) {
    const int c = e % cs, rq = e / cs;
    const int q = rq % kDwQuads, r = rq / kDwQuads;
    uint32_t v = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * q + i;
      if (s < a.kw)
        v |= static_cast<uint32_t>(static_cast<uint8_t>(a.w[(r * a.kw + s) * a.C + c0 + c]))
             << (8 * i);
    }
    wsm[rq * a.CS + c] = v;
  }
  cp_async_wait<0>();
  __syncthreads();

  const bool has_bias = bias != nullptr;
  const int per_image = n_cw * a.Ho * a.runs;
  for (int it = tid; it < ni * per_image; it += kThreads) {
    const int cw = it % n_cw;
    int t = it / n_cw;
    const int run = t % a.runs;
    t /= a.runs;
    const int ho = t % a.Ho, img = t / a.Ho;
    int acc[R][4];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][c] = 0;
    // the run's first column of the image's row 0, this thread's channel word
    const unsigned char* const run0 = tile + img * a.H * row_bytes + run * R * a.PS + 4 * cw;
    const int r0 = max(0, a.ph - ho), r1 = min(a.kh, a.H + a.ph - ho);  // rows inside the image
    for (int r = r0; r < r1; ++r) {
      const unsigned char* const src = run0 + (ho - a.ph + r) * row_bytes;
      uint32_t xw[4 * G];  // position i of the run: channels 0..3
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) xw[i] = *reinterpret_cast<const uint32_t*>(src + i * a.PS);
      uint32_t pl[4][G];  // pl[c][g]: positions 4g..4g+3 of channel c
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t t0 = __byte_perm(xw[4 * g], xw[4 * g + 1], 0x5140);
        const uint32_t t1 = __byte_perm(xw[4 * g], xw[4 * g + 1], 0x7362);
        const uint32_t t2 = __byte_perm(xw[4 * g + 2], xw[4 * g + 3], 0x5140);
        const uint32_t t3 = __byte_perm(xw[4 * g + 2], xw[4 * g + 3], 0x7362);
        pl[0][g] = __byte_perm(t0, t2, 0x5410);
        pl[1][g] = __byte_perm(t0, t2, 0x7632);
        pl[2][g] = __byte_perm(t1, t3, 0x5410);
        pl[3][g] = __byte_perm(t1, t3, 0x7632);
      }
#pragma unroll
      for (int q = 0; q < kDwQuads; ++q) {
        const uint4 wq = *reinterpret_cast<const uint4*>(wsm + (r * kDwQuads + q) * a.CS + 4 * cw);
        const int wv[4] = {static_cast<int>(wq.x), static_cast<int>(wq.y), static_cast<int>(wq.z),
                           static_cast<int>(wq.w)};
#pragma unroll
        for (int j = 0; j < R; ++j) {
          // output j's taps 4q..4q+3 are positions o..o+3: words g and (sh > 0) g + 1
          const int o = j + 4 * q, g = o / 4, sh = o % 4, g1 = g + 1 < G ? g + 1 : g;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t win = sh ? __funnelshift_r(pl[c][g], pl[c][g1], 8 * sh) : pl[c][g];
            acc[j][c] = __dp4a(static_cast<int>(win), wv[c], acc[j][c]);
          }
        }
      }
    }
    const int c = c0 + 4 * cw;
    float sc[4], bi[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sc[k] = std::is_same<T, int>::value ? 0.f : scale[c + k];
      bi[k] = has_bias ? bias[c + k] : 0.f;
    }
    T* const orow = out + ((b0 + img) * a.Ho + ho) * static_cast<int64_t>(a.Wo) * a.C + c;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int wo = run * R + j;
      if (wo >= a.Wo) break;
      Quad<T> v;
#pragma unroll
      for (int k = 0; k < 4; ++k) v.v[k] = epilogue<T>(acc[j][k], sc[k], bi[k], has_bias);
      *reinterpret_cast<Quad<T>*>(orow + static_cast<int64_t>(wo) * a.C) = v;
    }
  }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t round_up(int64_t a, int64_t b) { return ceil_div(a, b) * b; }

// The tile kernel's launch for a depthwise convolution, or false where the
// general kernel runs it (see the note above). out_size: bytes of an output.
struct DwPlan {
  DwTile a;
  int R;
  int64_t blocks;
  int smem;
};

bool plan_dwconv(DwTile a, int sh, int sw, const void* out, int out_size, DwPlan& p) {
  if (sh != 1 || sw != 1 || a.C % 4 != 0 || a.kw > 4 * kDwQuads || !aligned(out, 4 * out_size))
    return false;
  const int R = a.Wo >= 5 ? 8 : a.Wo >= 2 ? 4 : 1;
  const int G = (R + 4 * kDwQuads + 2) / 4;
  a.runs = static_cast<int>(ceil_div(a.Wo, R));
  a.TW = (a.runs - 1) * R + 4 * G;
  // slices of at most 128 channels, as even as the load's unit allows;
  // narrower where one image's tile would pass the budget
  const int unit = a.C % 16 == 0 ? 16 : 4;
  int64_t CS = round_up(ceil_div(a.C, ceil_div(a.C, kDwMaxCS)), unit);
  while (CS > unit && static_cast<int64_t>(a.H) * a.TW * round_up(CS, 16) > kDwTileBudget)
    CS = round_up(CS / 2, unit);
  const int64_t image_bytes = static_cast<int64_t>(a.H) * a.TW * round_up(CS, 16);
  const int64_t weight_bytes = static_cast<int64_t>(a.kh) * kDwQuads * CS * 4;
  if (image_bytes > kDwTileBudget || image_bytes + weight_bytes > kDwMaxSmem) return false;
  a.CS = static_cast<int>(CS);
  a.PS = static_cast<int>(round_up(CS, 16));
  a.slices = static_cast<int>(ceil_div(a.C, CS));
  // images a block: the most even fill of the block's 256 threads by items
  // (and of B by blocks), keeping two blocks an SM in flight
  const int64_t per_image = CS / 4 * a.Ho * a.runs;
  int NI = 1;
  double best = -1.0;
  for (int ni = 1; ni <= kDwMaxImages && ni <= a.B; ++ni) {
    const int64_t groups = ceil_div(a.B, ni);
    if (ni > 1 && (ni * image_bytes > kDwTileBudget ||
                   groups * a.slices < 2 * kSMs || ni * per_image > 0x7fffffff))
      break;
    const int64_t items = ni * per_image;
    const double fill = static_cast<double>(items) / round_up(items, kThreads) *
                        static_cast<double>(a.B) / static_cast<double>(groups * ni);
    if (fill > best + 1e-9) {
      best = fill;
      NI = ni;
    }
  }
  a.NI = NI;
  p.blocks = ceil_div(a.B, NI) * a.slices;
  if (p.blocks > 0x7fffffff || NI * per_image > 0x7fffffff) return false;
  a.load = a.C % 16 == 0 && aligned(a.x, 16) ? kDwAsync16 : kDwBytes;
  p.a = a;
  p.R = R;
  p.smem = static_cast<int>(NI * image_bytes + weight_bytes);
  return true;
}

template <typename T, int R>
cudaError_t launch_dw_tile(const DwPlan& p, const float* scale, const float* bias, void* out,
                           cudaStream_t s) {
  if (p.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dwconv_tile_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
  }
  dwconv_tile_kernel<T, R><<<static_cast<unsigned int>(p.blocks), kThreads, p.smem, s>>>(
      p.a, scale, bias, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dwconv(const DwTile& a, int sh, int sw, const float* scale, const float* bias,
                          void* out, cudaStream_t s) {
  DwPlan p;
  if (plan_dwconv(a, sh, sw, out, sizeof(T), p)) {
    if (p.R == 8) return launch_dw_tile<T, 8>(p, scale, bias, out, s);
    if (p.R == 4) return launch_dw_tile<T, 4>(p, scale, bias, out, s);
    return launch_dw_tile<T, 1>(p, scale, bias, out, s);
  }
  const int64_t total = a.B * a.Ho * a.Wo * a.C;
  dwconv_general_kernel<T><<<grid_stride_blocks(total), kThreads, 0, s>>>(
      a.x, a.w, scale, bias, static_cast<T*>(out), total, a.H, a.W, a.C, a.Ho, a.Wo, a.kh, a.kw,
      sh, sw, a.ph, a.pw);
  return cudaGetLastError();
}

template <typename T, typename ALoader, int BN>
cudaError_t launch_tile(const ALoader& a, const int8_t* bmat, int N, bool b_async,
                        const float* scale, const float* bias, void* out, cudaStream_t s) {
  constexpr int smem = Tile<BN>::template smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(igemm_kernel<T, ALoader, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (a.M + kBM - 1) / kBM * ((N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const bool out_vec = N * sizeof(T) % 16 == 0 && aligned(out, 16);
  igemm_kernel<T, ALoader, BN><<<static_cast<unsigned int>(tiles), Tile<BN>::kThreads, smem, s>>>(
      a, bmat, N, b_async, scale, bias, static_cast<T*>(out), out_vec);
  return cudaGetLastError();
}

template <typename T, typename ALoader>
cudaError_t launch_igemm_t(const ALoader& a, const int8_t* bmat, int N, bool b_async,
                           const float* scale, const float* bias, void* out, cudaStream_t s) {
  return N <= 64 ? launch_tile<T, ALoader, 64>(a, bmat, N, b_async, scale, bias, out, s)
                 : launch_tile<T, ALoader, 128>(a, bmat, N, b_async, scale, bias, out, s);
}

// b (N, K) row-major; b_async: its rows take cp.async (K % 16 == 0, b 16-byte aligned)
template <typename ALoader>
cudaError_t launch_igemm(const ALoader& a, const void* bmat, const void* scale, const void* bias,
                         void* out, int N, int out_dtype, cudaStream_t s) {
  const auto* b8 = static_cast<const int8_t*>(bmat);
  const bool b_async = a.K % 16 == 0 && aligned(bmat, 16);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (out_dtype == AC_F32) return launch_igemm_t<float>(a, b8, N, b_async, sc, bi, out, s);
  if (out_dtype == AC_BF16)
    return launch_igemm_t<__nv_bfloat16>(a, b8, N, b_async, sc, bi, out, s);
  if (out_dtype == AC_I32) return launch_igemm_t<int>(a, b8, N, b_async, sc, bi, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ac_int8_quantize(const void* x, void* q, int64_t n, float inv, int dtype,
                                void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = grid_stride_blocks(n);
  if (dtype == AC_F32) {
    quantize_kernel<float><<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                       static_cast<int8_t*>(q), n, inv);
  } else if (dtype == AC_BF16) {
    quantize_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q), n, inv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (M, N) = epilogue(a (M, K) x b (N, K)^T); bias may be null.
extern "C" int ac_int8_gemm(const void* a, const void* b, const void* scale, const void* bias,
                            void* out, int64_t M, int N, int K, int out_dtype, void* stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const GemmA loader{static_cast<const int8_t*>(a), M, K, K % 16 == 0 && aligned(a, 16)};
  return static_cast<int>(
      launch_igemm(loader, b, scale, bias, out, N, out_dtype, static_cast<cudaStream_t>(stream)));
}

// out (B, Ho, Wo, Cout) = epilogue(conv(x (B, H, W, C), w (Cout, kh, kw, C))),
// stride (sh, sw), zero padding (ph, pw); bias may be null.
extern "C" int ac_int8_conv(const void* x, const void* w, const void* scale, const void* bias,
                            void* out, int64_t B, int H, int W, int C, int Ho, int Wo, int Cout,
                            int kh, int kw, int sh, int sw, int ph, int pw, int out_dtype,
                            void* stream) {
  const int64_t M = B * Ho * Wo;
  if (M == 0 || Cout == 0) return static_cast<int>(cudaGetLastError());
  const int mode = C % 16 == 0 ? kRun16 : (C == 1 && kh == 1) ? kRun1 : kBytes;
  const ConvA loader{static_cast<const int8_t*>(x), M,  H,  W,  C,  Ho, Wo, kw,
                     sh, sw, ph, pw, kh * kw * C, mode, mode == kRun16 && aligned(x, 16)};
  return static_cast<int>(launch_igemm(loader, w, scale, bias, out, Cout, out_dtype,
                                       static_cast<cudaStream_t>(stream)));
}

// out (B, Ho, Wo, C) = epilogue(depthwise conv(x (B, H, W, C), w (kh, kw, C))).
extern "C" int ac_int8_dwconv(const void* x, const void* w, const void* scale, const void* bias,
                              void* out, int64_t B, int H, int W, int C, int Ho, int Wo, int kh,
                              int kw, int sh, int sw, int ph, int pw, int out_dtype,
                              void* stream) {
  if (B * Ho * Wo * C == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DwTile a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), B, H, W, C, Ho, Wo, kh,
           kw, ph, pw};
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (out_dtype == AC_F32) return static_cast<int>(launch_dwconv<float>(a, sh, sw, sc, bi, out, s));
  if (out_dtype == AC_BF16)
    return static_cast<int>(launch_dwconv<__nv_bfloat16>(a, sh, sw, sc, bi, out, s));
  if (out_dtype == AC_I32) return static_cast<int>(launch_dwconv<int>(a, sh, sw, sc, bi, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch ac_int8_dwconv makes for these arguments, into plan[0..7]: 1
// for the tile kernel (then R, images a block, channels a slice, slices,
// blocks, dynamic shared bytes, DwLoad), 0 for the general kernel. Returns
// cudaErrorInvalidValue for an unknown out dtype.
extern "C" int ac_int8_dwconv_plan(const void* x, const void* out, int64_t B, int H, int W, int C,
                                   int Ho, int Wo, int kh, int kw, int sh, int sw, int ph, int pw,
                                   int out_dtype, int64_t* plan) {
  const int size = out_dtype == AC_BF16 ? 2 : out_dtype == AC_F32 || out_dtype == AC_I32 ? 4 : 0;
  if (size == 0) return static_cast<int>(cudaErrorInvalidValue);
  const DwTile a{static_cast<const int8_t*>(x), nullptr, B, H, W, C, Ho, Wo, kh, kw, ph, pw};
  DwPlan p;
  const bool tile = B * Ho * Wo * C > 0 && plan_dwconv(a, sh, sw, out, size, p);
  const int64_t v[8] = {tile, tile ? p.R : 0, tile ? p.a.NI : 0, tile ? p.a.CS : 0,
                        tile ? p.a.slices : 0, tile ? p.blocks : 0, tile ? p.smem : 0,
                        tile ? p.a.load : 0};
  for (int i = 0; i < 8; ++i) plan[i] = v[i];
  return 0;
}
