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
//  * the products accumulate exactly in int32 (|acc| <= K * 127^2 < 2^31 for
//    K < 133,144; the serving path's largest K is SpectraNet stage 1's 64 *
//    251 = 16,064 taps x channels);
//  * the epilogue: y = float(acc) * scale[n] (+ bias[n]), each one f32
//    rounding (__int2float_rn, __fmul_rn, __fadd_rn), then the output dtype
//    (f32, bf16 round to nearest even); out dtype 2 writes the raw int32
//    accumulators instead (the check of the products alone).
//
// Bounds on the H100. The GEMM and the convolutions do 2 * M * N * K
// integer operations against 1,979 TOPS of dense int8 tensor-core rate;
// at the serving shapes (e.g. the photometry in_proj, M = 512 * 258, K =
// 128, N = 384, or SpectraNet's bank convolutions, K up to 16,064) the
// operations bound them. The quantizer and the depthwise convolution move
// bytes: 5 (f32 in, int8 out) or 3 (bf16) bytes an element, and the
// depthwise 7x7's 49 MACs an output are far below the byte time.
//
// Design: right first, simple, no tensor cores (their redesign is a later
// item). The GEMM and the convolution share one tiled kernel: a block of
// 256 threads computes a 64 x 64 tile of the (M, N) output, each thread 4 x
// 4 outputs, over K in steps of 32 bytes staged in shared memory as words of
// 4 consecutive k (k-major, so a warp reads a row of words without bank
// conflicts), multiplied with __dp4a (4 int8 products summed into int32 per
// instruction). The A operand comes through a loader: GemmA reads a
// row-major (M, K) int8 matrix, ConvA gathers the implicit-GEMM row of an
// NHWC int8 image (row m = (b, ho, wo), column k = (r, s, c) of the weight
// in (Cout, kh, kw, Cin) order), zero where the window reads padding. Rows
// whose K (or channel count) is a multiple of 4 load a word at once; other
// rows (K = 7, 19; Cin = 1, 3) assemble words byte by byte. Conv1d runs as
// a 1 x L image. The depthwise kernel is a thread per output: its 49 taps
// read the channel's pixels, consecutive threads on consecutive channels.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int AC_I32 = 2;  // out dtype code: the int32 accumulators, no epilogue
constexpr int kThreads = 256;
constexpr int kBM = 64;   // output rows of a tile
constexpr int kBN = 64;   // output columns of a tile
constexpr int kBKW = 8;   // words of 4 k staged a step: 32 bytes of K

__device__ __forceinline__ int pack_byte(int word, int8_t v, int t) {
  return word | (static_cast<int>(static_cast<uint8_t>(v)) << (8 * t));
}

// The word of k0 .. k0 + 3 (k0 a multiple of 4) of row `row` of a
// row-major (rows, K) int8 matrix, zero past its edges.
__device__ __forceinline__ int matrix_word(const int8_t* __restrict__ p, int64_t row, int64_t rows,
                                           int K, int k0, bool aligned) {
  if (row >= rows || k0 >= K) return 0;
  const int8_t* r = p + row * static_cast<int64_t>(K);
  if (aligned) return *reinterpret_cast<const int*>(r + k0);  // K % 4 == 0: k0 + 3 < K
  int word = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (k0 + t < K) word = pack_byte(word, r[k0 + t], t);
  return word;
}

struct GemmA {
  const int8_t* a;
  int64_t M;
  int K;
  bool aligned;
  __device__ __forceinline__ int word(int64_t m, int k0) const {
    return matrix_word(a, m, M, K, k0, aligned);
  }
};

struct ConvA {
  const int8_t* x;  // (B, H, W, C)
  int64_t M;        // B * Ho * Wo
  int H, W, C, Ho, Wo, kw, sh, sw, ph, pw, K;
  bool aligned;     // C % 4 == 0 and x 4-byte aligned: a word is 4 channels of one tap
  __device__ __forceinline__ int word(int64_t m, int k0) const {
    if (m >= M || k0 >= K) return 0;
    const int64_t hw = static_cast<int64_t>(Ho) * Wo;
    const int64_t b = m / hw;
    const int rem = static_cast<int>(m - b * hw);
    const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
    if (aligned) {
      const int tap = k0 / C, c = k0 - tap * C;
      const int h = ho * sh - ph + tap / kw, w = wo * sw - pw + tap % kw;
      if (h < 0 || h >= H || w < 0 || w >= W) return 0;
      return *reinterpret_cast<const int*>(x + ((b * H + h) * static_cast<int64_t>(W) + w) * C + c);
    }
    int word = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = k0 + t;
      if (k >= K) break;
      const int tap = k / C, c = k - tap * C;
      const int h = ho * sh - ph + tap / kw, w = wo * sw - pw + tap % kw;
      if (h >= 0 && h < H && w >= 0 && w < W)
        word = pack_byte(word, x[((b * H + h) * static_cast<int64_t>(W) + w) * C + c], t);
    }
    return word;
  }
};

template <typename T>
__device__ __forceinline__ void store(T* __restrict__ out, int64_t idx, int acc, int n,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ bias) {
  if constexpr (std::is_same<T, int>::value) {
    out[idx] = acc;
  } else {
    float y = __fmul_rn(__int2float_rn(acc), scale[n]);
    if (bias != nullptr) y = __fadd_rn(y, bias[n]);
    out[idx] = ac::from_f32<T>(y);
  }
}

// (M, N) = A (M, K) x B (N, K)^T, int8 in, int32 accumulated, then the
// epilogue. A tile of kBM x kBN outputs a block; thread (tx, ty) of the
// 16 x 16 grid owns rows ty + 16 i and columns tx + 16 j, i, j < 4.
template <typename T, typename ALoader>
__global__ void __launch_bounds__(kThreads) igemm_kernel(
    ALoader a, const int8_t* __restrict__ bmat, const float* __restrict__ scale,
    const float* __restrict__ bias, T* __restrict__ out, int N, bool b_aligned) {
  __shared__ int As[kBKW][kBM];
  __shared__ int Bs[kBKW][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = a.K;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int kb = 0; kb < K; kb += 4 * kBKW) {
#pragma unroll
    for (int e = tid; e < kBKW * kBM; e += kThreads) {
      const int row = e % kBM, kw = e / kBM;
      As[kw][row] = a.word(m0 + row, kb + 4 * kw);
      Bs[kw][row] = matrix_word(bmat, n0 + row, N, K, kb + 4 * kw, b_aligned);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kw][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kw][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) store<T>(out, m * N + n, acc[i][j], n, scale, bias);
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

// Depthwise convolution (groups = C): a thread per output (b, ho, wo, c);
// w is (kh, kw, C).
template <typename T>
__global__ void __launch_bounds__(kThreads) dwconv_kernel(
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
    store<T>(out, idx, acc, c, scale, bias);
  }
}

unsigned int grid_stride_blocks(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

template <typename ALoader>
cudaError_t launch_igemm(const ALoader& a, const void* bmat, const void* scale, const void* bias,
                         void* out, int N, int out_dtype, bool b_aligned, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned int>((a.M + kBM - 1) / kBM),
                  static_cast<unsigned int>((N + kBN - 1) / kBN));
  const auto* b8 = static_cast<const int8_t*>(bmat);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (out_dtype == AC_F32) {
    igemm_kernel<float, ALoader><<<grid, kThreads, 0, s>>>(a, b8, sc, bi,
                                                          static_cast<float*>(out), N, b_aligned);
  } else if (out_dtype == AC_BF16) {
    igemm_kernel<__nv_bfloat16, ALoader><<<grid, kThreads, 0, s>>>(
        a, b8, sc, bi, static_cast<__nv_bfloat16*>(out), N, b_aligned);
  } else if (out_dtype == AC_I32) {
    igemm_kernel<int, ALoader><<<grid, kThreads, 0, s>>>(a, b8, sc, bi, static_cast<int*>(out), N,
                                                        b_aligned);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  const bool aligned = K % 4 == 0 && aligned4(a) && aligned4(b);
  const GemmA loader{static_cast<const int8_t*>(a), M, K, aligned};
  return static_cast<int>(launch_igemm(loader, b, scale, bias, out, N, out_dtype, aligned,
                                       static_cast<cudaStream_t>(stream)));
}

// out (B, Ho, Wo, Cout) = epilogue(conv(x (B, H, W, C), w (Cout, kh, kw, C))),
// stride (sh, sw), zero padding (ph, pw); bias may be null.
extern "C" int ac_int8_conv(const void* x, const void* w, const void* scale, const void* bias,
                            void* out, int64_t B, int H, int W, int C, int Ho, int Wo, int Cout,
                            int kh, int kw, int sh, int sw, int ph, int pw, int out_dtype,
                            void* stream) {
  const int64_t M = B * Ho * Wo;
  if (M == 0 || Cout == 0) return static_cast<int>(cudaGetLastError());
  const int K = kh * kw * C;
  const ConvA loader{static_cast<const int8_t*>(x), M, H, W, C, Ho, Wo, kw, sh, sw, ph, pw, K,
                     C % 4 == 0 && aligned4(x)};
  return static_cast<int>(launch_igemm(loader, w, scale, bias, out, Cout, out_dtype,
                                       K % 4 == 0 && aligned4(w),
                                       static_cast<cudaStream_t>(stream)));
}

// out (B, Ho, Wo, C) = epilogue(depthwise conv(x (B, H, W, C), w (kh, kw, C))).
extern "C" int ac_int8_dwconv(const void* x, const void* w, const void* scale, const void* bias,
                              void* out, int64_t B, int H, int W, int C, int Ho, int Wo, int kh,
                              int kw, int sh, int sw, int ph, int pw, int out_dtype,
                              void* stream) {
  const int64_t total = B * Ho * Wo * C;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = grid_stride_blocks(total);
  const auto* x8 = static_cast<const int8_t*>(x);
  const auto* w8 = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  if (out_dtype == AC_F32) {
    dwconv_kernel<float><<<blocks, kThreads, 0, s>>>(x8, w8, sc, bi, static_cast<float*>(out),
                                                     total, H, W, C, Ho, Wo, kh, kw, sh, sw, ph,
                                                     pw);
  } else if (out_dtype == AC_BF16) {
    dwconv_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        x8, w8, sc, bi, static_cast<__nv_bfloat16*>(out), total, H, W, C, Ho, Wo, kh, kw, sh, sw,
        ph, pw);
  } else if (out_dtype == AC_I32) {
    dwconv_kernel<int><<<blocks, kThreads, 0, s>>>(x8, w8, sc, bi, static_cast<int*>(out), total,
                                                   H, W, C, Ho, Wo, kh, kw, sh, sw, ph, pw);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
