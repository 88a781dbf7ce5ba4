// Per-row and per-segment reductions over the flat fp32 (rows, 1024)
// optimizer buffers, shared by segment_stats.cu and lamb.cu.
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

// First index i in [0, n) with seg_rows[i] >= s (n if none).
__device__ __forceinline__ int lower_bound_rows(const int* seg_rows, int n, int s) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_rows[mid] < s)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
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
  const int lo = lower_bound_rows(seg_rows, rows, s);
  const int hi = lower_bound_rows(seg_rows, rows, s + 1);
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
