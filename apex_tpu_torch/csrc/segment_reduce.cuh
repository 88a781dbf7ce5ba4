// Per-row and per-segment reductions over the flat fp32 (rows, 1024)
// optimizer buffers: the row layout, segment_bounds and block_sum, shared
// by segment_stats.cu and lamb.cu; segment_reduce_kernel, lamb.cu's.
//
// Every 1024-element row of a flat buffer belongs to one tensor (its
// segment), and each segment's rows are contiguous and in order
// (apex_tpu_torch/ops/flat_buffer.py). So a per-segment sum is done in two
// steps, with no float atomics: a row kernel writes one partial per row and
// statistic, then segment_reduce_kernel sums each segment's rows, one block
// per segment, each thread a fixed stripe of rows and the threads in a fixed
// order. The result is the same bits in every run. (The TPU kernels do the
// same reduction as a one-hot matrix product on the MXU.)

#pragma once

#include "common.cuh"

constexpr int kLane = 1024;                 // elements per row
constexpr int kRowThreads = 256;            // row kernels: 8 warps, a warp per row
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kVecPerLane = kLane / 4 / 32;  // float4s each lane takes of a row
constexpr int kReduceThreads = 256;

// lo = the first row of segment s, hi = the first row past it (the first
// index whose seg_rows entry is >= s, >= s + 1; n if none), found by the
// block together: each round every thread probes the last entry of its
// chunk of the range still open (sorted, so the probes below the key are
// a prefix, counted by __syncthreads_count) and the range shrinks to one
// chunk less its probe. ~log_blockDim(n) rounds, both bounds at once;
// every thread of the block must call it.
__device__ __forceinline__ void segment_bounds(const int* __restrict__ seg_rows, int n, int s,
                                               int& lo, int& hi) {
  const int nt = static_cast<int>(blockDim.x);
  int lo0 = 0, hi0 = n, lo1 = 0, hi1 = n;  // each answer in [lo, hi]
  while (hi0 > lo0 || hi1 > lo1) {
    const int c0 = max(1, (hi0 - lo0 + nt - 1) / nt);
    const int c1 = max(1, (hi1 - lo1 + nt - 1) / nt);
    const int p0 = lo0 + (threadIdx.x + 1) * c0 - 1, p1 = lo1 + (threadIdx.x + 1) * c1 - 1;
    const bool b0 = hi0 > lo0 && p0 < hi0 && seg_rows[p0] < s;
    const bool b1 = hi1 > lo1 && p1 < hi1 && seg_rows[p1] < s + 1;
    const int n0 = __syncthreads_count(b0), n1 = __syncthreads_count(b1);
    if (hi0 > lo0) {
      hi0 = min(hi0, lo0 + (n0 + 1) * c0 - 1);
      lo0 += n0 * c0;
    }
    if (hi1 > lo1) {
      hi1 = min(hi1, lo1 + (n1 + 1) * c1 - 1);
      lo1 += n1 * c1;
    }
  }
  lo = lo0;
  hi = lo1;
}

// Sum over the threads of a block in a fixed order: shuffles in each warp,
// then the warps' sums in warp order. Every thread gets the result.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // scratch free from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  V total = scratch[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) total += scratch[w];
  return total;
}

// out[k][s] = sum over the rows r of segment s of part[k][r], for k <
// n_stats; the statistic `count_stat` (or none, -1) holds integer counts
// and is summed as an integer, so the count is exact. The other sums are
// taken in fp64 (a segment has up to ~31k rows; the adds are few beside the
// row kernels' reads), so they lose nothing beyond the per-row partials'
// fp32 rounding.
__global__ void __launch_bounds__(kReduceThreads)
segment_reduce_kernel(const float* __restrict__ part, const int* __restrict__ seg_rows,
                      int rows, float* __restrict__ out, int segments, int n_stats,
                      int count_stat) {
  __shared__ double fs[kReduceThreads / 32];
  __shared__ long long cs[kReduceThreads / 32];
  const int s = blockIdx.x;
  int lo, hi;
  segment_bounds(seg_rows, rows, s, lo, hi);
  for (int k = 0; k < n_stats; ++k) {
    const float* pk = part + (long)k * rows;
    if (k == count_stat) {
      long long c = 0;
      for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) c += static_cast<long long>(pk[r]);
      c = block_sum(c, cs);
      if (threadIdx.x == 0) out[(long)k * segments + s] = static_cast<float>(c);
    } else {
      double acc = 0.0;
      for (int r = lo + threadIdx.x; r < hi; r += blockDim.x) acc += pk[r];
      acc = block_sum(acc, fs);
      if (threadIdx.x == 0) out[(long)k * segments + s] = static_cast<float>(acc);
    }
  }
}
