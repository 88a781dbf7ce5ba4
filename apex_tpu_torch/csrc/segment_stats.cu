// Per-segment statistics of the flat fp32 (rows, 1024) buffers: the sum of
// squares of A, optionally of B, and the count of non-finite entries of A.
//
// Replaces the TPU kernel apex_tpu/ops/optim_kernels.py::_stats_kernel
// (pallas_call in segment_stats): the global gradient norm and the
// inf/NaN check of FusedLAMB (and of the amp loss scaler) in one pass over
// the gradients. Output out is fp32 [3][segments]: row 0 sumsq(A), row 1
// sumsq(B) (0 without B), row 2 the non-finite count of A.
//
// What bounds it on the H100: bytes. It reads A (and B) once, 4 bytes per
// element, for 3 operations per element. BERT-Large's 336 M gradients are
// 1.34 GB: 0.40 ms at 3.35 TB/s.
//
// Design: two launches, no atomics, every sum in an order fixed by the
// shape, so the same bits from run to run.
//  - stats_rows_kernel: a warp a row (8 rows a block), each lane eight
//    float4 of the row, warp-shuffle sums: fp32 per-row partials in a
//    [3][rows] scratch; then the block adds its 8 rows' partials in row
//    order (fp64 sums, an integer count) into one group partial.
//  - stats_segments_kernel: a block a segment finds the segment's rows
//    [lo, hi) by a search of seg_rows that all its threads share
//    (segment_reduce.cuh's segment_bounds: a few rounds of one load each,
//    not a chain of dependent loads), then sums the whole groups inside
//    [lo, hi) from their group partials and the rows before and after
//    them from their row partials: each thread a
//    fixed stripe in fp64 (counts as integers), then the threads in a
//    fixed order. A segment of 30522 rows (BERT's word embeddings) is ~3.8 K
//    group partials over 512 threads: a block walking its 30 K row
//    partials 256 at a time (segment_reduce.cuh's segment_reduce_kernel,
//    which lamb.cu uses) took 0.150 ms of the call's 0.578 at BERT's shape
//    (`NVIDIA H100 80GB HBM3, 700.00 W`, kernel_ab.py --device-ms).

#include "segment_reduce.cuh"

namespace {

constexpr int kGroup = kRowWarps;  // rows a group partial sums: a row block's
constexpr int kSegThreads = 512;

__global__ void __launch_bounds__(kRowThreads)
stats_rows_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                  float* __restrict__ part, double* __restrict__ gsum,
                  long long* __restrict__ gcnt, int rows) {
  __shared__ float rs[3][kRowWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * kRowWarps + warp;
  float sa = 0.f, sb = 0.f, bad = 0.f;
  if (row < rows) {
    const float4* ar = a + row * (kLane / 4);
#pragma unroll
    for (int i = 0; i < kVecPerLane; ++i) {
      const float4 x = ar[lane + 32 * i];
      sa = fmaf(x.x, x.x, sa);
      sa = fmaf(x.y, x.y, sa);
      sa = fmaf(x.z, x.z, sa);
      sa = fmaf(x.w, x.w, sa);
      bad += (isfinite(x.x) ? 0.f : 1.f) + (isfinite(x.y) ? 0.f : 1.f) +
             (isfinite(x.z) ? 0.f : 1.f) + (isfinite(x.w) ? 0.f : 1.f);
    }
    if (b != nullptr) {
      const float4* br = b + row * (kLane / 4);
#pragma unroll
      for (int i = 0; i < kVecPerLane; ++i) {
        const float4 x = br[lane + 32 * i];
        sb = fmaf(x.x, x.x, sb);
        sb = fmaf(x.y, x.y, sb);
        sb = fmaf(x.z, x.z, sb);
        sb = fmaf(x.w, x.w, sb);
      }
    }
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    bad = warp_sum(bad);
    if (lane == 0) {
      part[row] = sa;
      part[(long)rows + row] = sb;
      part[2L * rows + row] = bad;
    }
  }
  if (lane == 0) {
    rs[0][warp] = sa;
    rs[1][warp] = sb;
    rs[2][warp] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double ga = 0.0, gb = 0.0;
    long long gc = 0;
    for (int w = 0; w < kRowWarps; ++w) {
      ga += rs[0][w];
      gb += rs[1][w];
      gc += static_cast<long long>(rs[2][w]);
    }
    gsum[blockIdx.x] = ga;
    gsum[gridDim.x + blockIdx.x] = gb;
    gcnt[blockIdx.x] = gc;
  }
}

__global__ void __launch_bounds__(kSegThreads)
stats_segments_kernel(const float* __restrict__ part, const double* __restrict__ gsum,
                      const long long* __restrict__ gcnt, const int* __restrict__ seg_rows,
                      int rows, int groups, float* __restrict__ out, int segments) {
  __shared__ double fs[kSegThreads / 32];
  __shared__ long long cs[kSegThreads / 32];
  const int s = blockIdx.x;
  int lo, hi;
  segment_bounds(seg_rows, rows, s, lo, hi);
  // the whole groups [g0, g1) inside [lo, hi), and the rows [lo, r0) before
  // and [r1, hi) after them (every row of [lo, hi) when no group is whole)
  const int g0 = (lo + kGroup - 1) / kGroup, g1 = hi / kGroup;
  const bool whole = g0 < g1;
  const int r0 = whole ? g0 * kGroup : hi, r1 = whole ? g1 * kGroup : hi;
  double sa = 0.0, sb = 0.0;
  long long c = 0;
  if (whole) {
#pragma unroll 4
    for (int g = g0 + threadIdx.x; g < g1; g += kSegThreads) {
      sa += gsum[g];
      sb += gsum[groups + g];
      c += gcnt[g];
    }
  }
  const int n_head = r0 - lo, n_rows = n_head + (hi - r1);
  for (int i = threadIdx.x; i < n_rows; i += kSegThreads) {
    const int r = i < n_head ? lo + i : r1 + (i - n_head);
    sa += part[r];
    sb += part[(long)rows + r];
    c += static_cast<long long>(part[2L * rows + r]);
  }
  sa = block_sum(sa, fs);
  sb = block_sum(sb, fs);
  c = block_sum(c, cs);
  if (threadIdx.x == 0) {
    out[s] = static_cast<float>(sa);
    out[segments + s] = static_cast<float>(sb);
    out[2L * segments + s] = static_cast<float>(c);
  }
}

}  // namespace

// a, b (or null): fp32 [rows, 1024]; seg_rows int32 [rows], each segment's
// rows contiguous and in order; scratch: 24 * groups + 12 * rows bytes,
// groups = ceil(rows / 8) (ops/optim_kernels.py::stats_scratch_bytes),
// 8-byte aligned: the group partials (fp64 [2][groups], int64 [groups]),
// then the row partials (fp32 [3][rows]); out fp32 [3, segments].
extern "C" int apex_segment_stats(const void* a, const void* b, const void* seg_rows,
                                  void* scratch, void* out, int rows, int segments,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || segments <= 0) return static_cast<int>(cudaGetLastError());
  const int groups = (rows + kGroup - 1) / kGroup;
  auto* gsum = static_cast<double*>(scratch);
  auto* gcnt = reinterpret_cast<long long*>(gsum + 2L * groups);
  auto* part = reinterpret_cast<float*>(gcnt + groups);
  stats_rows_kernel<<<groups, kRowThreads, 0, s>>>(static_cast<const float4*>(a),
                                                   static_cast<const float4*>(b), part, gsum,
                                                   gcnt, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_segments_kernel<<<segments, kSegThreads, 0, s>>>(
      part, gsum, gcnt, static_cast<const int*>(seg_rows), rows, groups,
      static_cast<float*>(out), segments);
  return static_cast<int>(cudaGetLastError());
}
