// K1: greedy per-band group starts of the 12-hour light-curve merge.
//
// Replaces applecider_tpu/ops/merge_scan.py:_seg_ids_kernel (Pallas, TPU).
//
// The recurrence, per light curve (a row of the (B, P) inputs): walk the P
// steps in order; a valid point of band k in [0, 3) opens a new group when
// t > t0[k] + dt (the sum rounded to f32 once), t0[k] being the time of the
// band's open group (-inf at first, start 0); it gets the position of its
// group's start, every other slot P.
//
// Bound on the H100: bytes. The kernel reads t (f32), band (i32) and valid
// (u8) once and writes seg (i32): 13 bytes a step, 3.4 MB at B = 1024,
// P = 257, about 1 us at 3.35 TB/s. A launch costs a few us by itself (the
// launch floor), more than the byte bound at every serving shape, so what
// the design aims at is one row's latency on top of that floor: every row
// at once, and a depth of O(log P) steps where the recurrence has P.
//
// Design: a block per light curve and a thread per step, so that B = 512
// rows of 257 steps are 512 blocks of 9 warps, all resident at once.
//  1. Each thread reads its step, coalesced: t, and its band code (0..2 for
//     a valid point of an in-range band, else 3).
//  2. The block packs each band's points in order into one list in shared
//     memory, band 0 then 1 then 2: times T and steps pos (ballots a warp,
//     then the warps' counts scanned by warp 0). One vote: is
//     0 <= dt < inf, and are the times of each band non-decreasing, with no
//     NaN and no -inf? Then a band's recurrence is the chain s0 = its first
//     point, s_{m+1} = the first later point of its band with
//     T > T[s_m] + dt.
//  3. Parallel path, a thread per list index c. Its successor f(c), or
//     cnt, the list's end: the band's list is ascending, so the points with
//     T > T[c] + dt are a suffix, found by probing c+1, c+2, c+4, ... and
//     bisecting the last gap (one probe where every point opens a group).
//     The chain from each band's first point is marked by pointer doubling:
//     round r marks f^(2^r) of every marked point and squares f, until
//     f^(2^r) of every band's first point is the end (at most
//     ceil(log2 P) + 1 rounds). A mark only ever lands on the chain, so
//     threads that write the same byte in one round agree and the marks do
//     not depend on their order. A point's group start is then the largest
//     marked list index at or before it: a ballot in its warp, else the
//     last mark of the warps before; it stays inside the point's band since
//     each band's first point is marked.
//  4. Rows that fail the vote, and rows longer than kMaxSteps (a block has
//     at most 1024 threads; such rows are launched with one warp a block),
//     take the recurrence itself: warp 0 reads the row 32 steps at a time,
//     coalesced, and every lane runs the same recurrence on the step
//     broadcast by shuffles, lane j keeping step j's result. Each such row
//     adds one to *walked; the serving layout (time-ascending prefixes,
//     +inf in the invalid tail) gives none.
//  5. The result goes back coalesced from shared memory. One launch; no
//     atomics on the result, so two launches give the same bits.
#include <stddef.h>

#include "common.cuh"

namespace {

constexpr int kMaxSteps = 1024;  // longest row with a thread a step
constexpr int kMaxWarps = kMaxSteps / 32;
constexpr int kBands = 3;
constexpr unsigned kAll = 0xffffffffu;

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t{15}; }

// Dynamic shared memory of a row: T (then the int32 result), pos, two jump
// tables of P + 1 entries, and P + 1 marks.
__host__ __device__ constexpr size_t row_bytes(size_t P) {
  return align16(4 * P) + align16(2 * P) + 2 * align16(2 * (P + 1)) + align16(P + 1);
}

__device__ __forceinline__ int band_code(int32_t b, uint8_t v) {
  return v && static_cast<unsigned>(b) < static_cast<unsigned>(kBands) ? b : kBands;
}

// The recurrence, for any row, by one warp in lockstep.
__device__ void walk_row(const float* __restrict__ t, const int32_t* __restrict__ band,
                         const uint8_t* __restrict__ valid, int32_t* __restrict__ out, int P,
                         float dt, int lane) {
  float t0[kBands];
  int start[kBands];
#pragma unroll
  for (int k = 0; k < kBands; ++k) {
    t0[k] = -INFINITY;
    start[k] = 0;
  }
  float t_next = 0.f;
  int code_next = kBands;
  if (lane < P) {
    t_next = t[lane];
    code_next = band_code(band[lane], valid[lane]);
  }
  for (int i0 = 0; i0 < P; i0 += 32) {
    const float ti = t_next;
    const int ci = code_next;
    if (i0 + 32 + lane < P) {  // the next chunk's loads fly while this one is walked
      t_next = t[i0 + 32 + lane];
      code_next = band_code(band[i0 + 32 + lane], valid[i0 + 32 + lane]);
    }
    const int steps = min(32, P - i0);
    int mine = P;
    for (int j = 0; j < steps; ++j) {
      const float tj = __shfl_sync(kAll, ti, j);
      const int kj = __shfl_sync(kAll, ci, j);
      int seg = P;
#pragma unroll
      for (int k = 0; k < kBands; ++k) {
        if (kj == k) {
          if (tj > t0[k] + dt) {
            t0[k] = tj;
            start[k] = i0 + j;
          }
          seg = start[k];
        }
      }
      if (lane == j) mine = seg;
    }
    if (i0 + lane < P) out[i0 + lane] = mine;
  }
}

// Steps 1-3 and 5 of the header, by the whole block (blockDim.x = 32 *
// ceil(P / 32)); false for every thread, with nothing written, when the
// vote fails.
__device__ bool chain_row(const float* __restrict__ t, const int32_t* __restrict__ band,
                          const uint8_t* __restrict__ valid, int32_t* __restrict__ out, int P,
                          float dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_off[kBands][kMaxWarps];  // a warp's first list index in each band
  __shared__ int s_cnt[kBands];
  __shared__ int s_last[kMaxWarps];  // the last mark in each warp's 32 list indices, or -1
  unsigned char* sm = smem;
  float* s_T = reinterpret_cast<float*>(sm);
  int32_t* s_out = reinterpret_cast<int32_t*>(sm);  // T is dead once the successors are found
  sm += align16(4 * P);
  int16_t* s_pos = reinterpret_cast<int16_t*>(sm);
  sm += align16(2 * P);
  int16_t* f = reinterpret_cast<int16_t*>(sm);
  sm += align16(2 * (P + 1));
  int16_t* f2 = reinterpret_cast<int16_t*>(sm);
  sm += align16(2 * (P + 1));
  uint8_t* s_mark = sm;

  const int i = threadIdx.x;  // this thread's step, then its list index
  const int lane = i & 31, warp = i >> 5, warps = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;

  // 1. read the step
  float ti = 0.f;
  int code = kBands;
  if (i < P) {
    ti = t[i];
    code = band_code(band[i], valid[i]);
  }

  // 2. pack each band's points in order, then vote
  int rank = 0;  // among this warp's points of this thread's band
#pragma unroll
  for (int k = 0; k < kBands; ++k) {
    const unsigned m = __ballot_sync(kAll, code == k);
    if (code == k) rank = __popc(m & below);
    if (lane == 0) s_off[k][warp] = __popc(m);
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
#pragma unroll
    for (int k = 0; k < kBands; ++k) {
      const int own = lane < warps ? s_off[k][lane] : 0;
      int v = own;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kAll, v, d);
        if (lane >= d) v += o;
      }
      const int total = __shfl_sync(kAll, v, 31);
      if (lane < warps) s_off[k][lane] = base + v - own;
      if (lane == 0) s_cnt[k] = total;
      base += total;
    }
  }
  __syncthreads();
  const int n0 = s_cnt[0], n1 = s_cnt[1], n2 = s_cnt[2];
  const int off1 = n0, off2 = n0 + n1, cnt = off2 + n2;
  if (code < kBands) {
    const int c = s_off[code][warp] + rank;
    s_T[c] = ti;
    s_pos[c] = static_cast<int16_t>(i);
  }
  __syncthreads();
  const int c = i;
  const int end = c < off1 ? off1 : c < off2 ? off2 : cnt;
  bool ok = dt >= 0.f && dt < INFINITY;
  if (c < cnt) ok = ok && s_T[c] > -INFINITY && (c + 1 == end || s_T[c] <= s_T[c + 1]);
  if (!__syncthreads_and(ok)) return false;

  // 3. successor: probe c+1, c+2, c+4, ..., then bisect the last gap
  if (c < cnt) {
    const float x = s_T[c] + dt;
    int lo = c + 1, span = 1;  // every point in [c + 1, lo) has T <= x
    while (lo + span - 1 < end && !(s_T[lo + span - 1] > x)) {
      lo += span;
      span <<= 1;
    }
    int hi = min(lo + span - 1, end);  // T[hi] > x, or hi == end
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_T[mid] > x) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    f[c] = static_cast<int16_t>(lo < end ? lo : cnt);
    s_mark[c] = c == 0 || c == off1 || c == off2;  // each band's first point
  }
  if (i == 0) f[cnt] = f2[cnt] = static_cast<int16_t>(cnt);
  __syncthreads();
  if (i < P) s_out[i] = P;
  // pointer doubling; a thread that reads a mark set in the same round only
  // marks more of the chain sooner
  while ((n0 && f[0] < cnt) || (n1 && f[off1] < cnt) || (n2 && f[off2] < cnt)) {
    if (c < cnt) {
      const int fc = f[c];
      f2[c] = f[fc];
      if (s_mark[c]) s_mark[fc] = 1;
    }
    __syncthreads();
    int16_t* swap = f;
    f = f2;
    f2 = swap;
  }
  const unsigned m = __ballot_sync(kAll, c < cnt && s_mark[c]);
  if (lane == 0) s_last[warp] = m ? 32 * warp + 31 - __clz(m) : -1;
  __syncthreads();
  if (c < cnt) {
    const unsigned mine = m & (below | (1u << lane));
    int start = mine ? 32 * warp + 31 - __clz(mine) : -1;
    for (int w = warp - 1; start < 0; --w) start = s_last[w];  // list index 0 is marked
    s_out[s_pos[c]] = s_pos[start];
  }
  __syncthreads();

  // 5. write back
  if (i < P) out[i] = s_out[i];
  return true;
}

__global__ void __launch_bounds__(kMaxSteps) seg_ids_kernel(
    const float* __restrict__ t, const int32_t* __restrict__ band,
    const uint8_t* __restrict__ valid, int32_t* __restrict__ out, unsigned* __restrict__ walked,
    int P, float dt) {
  const size_t g = static_cast<size_t>(blockIdx.x) * P;
  if (P <= kMaxSteps && chain_row(t + g, band + g, valid + g, out + g, P, dt)) return;
  if (threadIdx.x < 32) {
    walk_row(t + g, band + g, valid + g, out + g, P, dt, threadIdx.x);
    if (threadIdx.x == 0) atomicAdd(walked, 1u);
  }
}

}  // namespace

extern "C" int ac_seg_ids(const void* t, const void* band, const void* valid, void* out,
                          void* walked, int B, int P, float dt, void* stream) {
  if (B > 0 && P > 0) {
    const bool staged = P <= kMaxSteps;
    seg_ids_kernel<<<B, staged ? 32 * ((P + 31) / 32) : 32, staged ? row_bytes(P) : 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(t), static_cast<const int32_t*>(band),
        static_cast<const uint8_t*>(valid), static_cast<int32_t*>(out),
        static_cast<unsigned*>(walked), P, dt);
  }
  return static_cast<int>(cudaGetLastError());
}
