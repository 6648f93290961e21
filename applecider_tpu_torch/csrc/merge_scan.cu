// K1: greedy per-band group starts of the 12-hour light-curve merge.
//
// Replaces applecider_tpu/ops/merge_scan.py:_seg_ids_kernel (Pallas, TPU).
//
// For each light curve (a row of the (B, P) inputs, time-ascending with
// +inf at invalid slots) the recurrence walks the P steps in order. A point
// of band k opens a new group when t > t0[k] + dt; every valid point of
// band k in [0, 3) gets the position of its group's start, other slots P.
//
// Bound on the H100: bytes. At the main-path shape (B = 1024, P = 257) the
// kernel reads t (f32), band (i32) and valid (u8) once and writes seg
// (i32): 13 bytes a step, 3.4 MB, about 1 us at 3.35 TB/s; the arithmetic
// is a few compares a step. The recurrence is sequential in P, so the only
// parallelism is the batch: one thread per light curve, which leaves most
// of the card idle and makes the time the latency of P dependent steps.
//
// Design: each thread keeps its three open groups (t0, start) in
// registers. The inputs are row-major, so a thread walking its own row
// would issue one scattered load per step; instead each block stages a
// tile of kSteps steps for its kRows rows through shared memory with
// coalesced loads (a warp reads 32 consecutive steps of one row), walks
// the tile from shared memory, and writes the output tile back the same
// way. Rows are padded by one word so the per-thread walk is free of bank
// conflicts.
#include "common.cuh"

namespace {

constexpr int kRows = 64;   // light curves per block, one thread each
constexpr int kSteps = 32;  // time steps staged per tile
constexpr int kBands = 3;

__global__ void __launch_bounds__(kRows) seg_ids_kernel(
    const float* __restrict__ t, const int32_t* __restrict__ band,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ out, int B, int P, float dt) {
  __shared__ float s_t[kRows][kSteps + 1];
  __shared__ int32_t s_b[kRows][kSteps + 1];
  __shared__ int32_t s_v[kRows][kSteps + 1];
  __shared__ int32_t s_o[kRows][kSteps + 1];

  const int row0 = blockIdx.x * kRows;
  const int r = threadIdx.x;
  const bool live = row0 + r < B;
  float t0[kBands];
  int start[kBands];
#pragma unroll
  for (int k = 0; k < kBands; ++k) {
    t0[k] = -INFINITY;
    start[k] = 0;
  }

  for (int i0 = 0; i0 < P; i0 += kSteps) {
    const int n = min(kSteps, P - i0);
    for (int idx = threadIdx.x; idx < kRows * kSteps; idx += blockDim.x) {
      const int rr = idx / kSteps, c = idx % kSteps;
      const int row = row0 + rr;
      if (row < B && c < n) {
        const size_t g = static_cast<size_t>(row) * P + i0 + c;
        s_t[rr][c] = t[g];
        s_b[rr][c] = band[g];
        s_v[rr][c] = valid[g];
      }
    }
    __syncthreads();
    if (live) {
      for (int c = 0; c < n; ++c) {
        const float ti = s_t[r][c];
        const int bi = s_b[r][c];
        const bool vi = s_v[r][c] != 0;
        int seg = P;
#pragma unroll
        for (int k = 0; k < kBands; ++k) {
          const bool is_b = vi && bi == k;
          if (is_b && ti > t0[k] + dt) {
            t0[k] = ti;
            start[k] = i0 + c;
          }
          if (is_b) seg = start[k];
        }
        s_o[r][c] = seg;
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * kSteps; idx += blockDim.x) {
      const int rr = idx / kSteps, c = idx % kSteps;
      const int row = row0 + rr;
      if (row < B && c < n) out[static_cast<size_t>(row) * P + i0 + c] = s_o[rr][c];
    }
    __syncthreads();  // the next tile overwrites shared memory
  }
}

}  // namespace

extern "C" int ac_seg_ids(const void* t, const void* band, const void* valid, void* out, int B,
                          int P, float dt, void* stream) {
  if (B > 0 && P > 0) {
    const int blocks = (B + kRows - 1) / kRows;
    seg_ids_kernel<<<blocks, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t), static_cast<const int32_t*>(band),
        static_cast<const uint8_t*>(valid), static_cast<int32_t*>(out), B, P, dt);
  }
  return static_cast<int>(cudaGetLastError());
}
