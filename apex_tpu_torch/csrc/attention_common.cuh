// Online-softmax row state shared by the flash prefill and paged decode
// kernels.
//
// One warp owns one query row at a time. A key tile of up to 32 keys sits in
// shared memory as fp32 rows of stride `ld`; lane j scores key j against the
// query row (also in shared memory), the warp reduces the tile's max and sum
// with shuffles, and each lane accumulates the output dimensions
// lane, lane + 32, ... of p @ V. Scores, softmax statistics and the
// accumulator are fp32, as in the TPU kernels. Keys a row may not see carry
// probability exactly 0, and a row that saw no key at all ends with l == 0
// and outputs exactly 0.

#pragma once

#include "common.cuh"

constexpr int kMaxHeadDim = 128;
constexpr int kDimsPerLane = kMaxHeadDim / 32;
constexpr int kTileKeys = 32;
constexpr int kTileStride = kMaxHeadDim + 1;  // +1 keeps lane-strided reads conflict-free

struct RowState {
  float m;
  float l;
  float acc[kDimsPerLane];
};

__device__ __forceinline__ void row_init(RowState& st) {
  st.m = -INFINITY;
  st.l = 0.f;
#pragma unroll
  for (int r = 0; r < kDimsPerLane; ++r) st.acc[r] = 0.f;
}

// Fold the tile's keys into the row: `valid` says whether this lane's key is
// visible to the row. Warp-uniform control flow throughout.
__device__ __forceinline__ void row_fold(RowState& st, const float* qrow, const float* ks,
                                         const float* vs, int d, bool valid, float scale,
                                         int lane) {
  float s = -INFINITY;
  if (valid) {
    const float* krow = ks + lane * kTileStride;
    float dot = 0.f;
    for (int i = 0; i < d; ++i) dot = fmaf(qrow[i], krow[i], dot);
    s = dot * scale;
  }
  const float tmax = warp_max(s);
  if (tmax == -INFINITY) return;  // no visible key in this tile
  const float m_new = fmaxf(st.m, tmax);
  const float alpha = expf(st.m - m_new);
  const float p = valid ? expf(s - m_new) : 0.f;
  st.l = st.l * alpha + warp_sum(p);
  st.m = m_new;
#pragma unroll
  for (int r = 0; r < kDimsPerLane; ++r) st.acc[r] *= alpha;
  for (int j = 0; j < kTileKeys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    if (pj == 0.f) continue;  // masked or unloaded rows of the tile are never read
    const float* vrow = vs + j * kTileStride;
#pragma unroll
    for (int r = 0; r < kDimsPerLane; ++r) {
      const int c = lane + 32 * r;
      if (c < d) st.acc[r] = fmaf(pj, vrow[c], st.acc[r]);
    }
  }
}

// Write the normalized row; returns the row's log-sum-exp.
template <typename T>
__device__ __forceinline__ float row_store(const RowState& st, T* out, int d, int lane) {
  const float l_safe = st.l == 0.f ? 1.f : st.l;
#pragma unroll
  for (int r = 0; r < kDimsPerLane; ++r) {
    const int c = lane + 32 * r;
    if (c < d) out[c] = from_f32<T>(st.acc[r] / l_safe);
  }
  return st.m + logf(l_safe);
}

// Copy `rows` rows of `d` elements (row stride `src_stride` elements) into a
// shared fp32 tile of stride kTileStride. All threads of the block take part.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int d,
                                          long src_stride) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * kTileStride + c] = to_f32<T>(src[r * src_stride + c]);
  }
}
