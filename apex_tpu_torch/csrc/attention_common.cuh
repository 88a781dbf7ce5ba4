// Online-softmax row state shared by the flash prefill and paged decode
// kernels, and the masking (causal, sliding window, segment ids, dropout)
// the three flash kernels share.
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

#include <float.h>
#include <stdint.h>

#include "common.cuh"

// The reference's DEFAULT_MASK_VALUE: the LSE of a row that saw no key.
constexpr float kMaskValue = -0.7f * FLT_MAX;

// The keep-mask hash of apex_tpu/ops/flash_attention.py::_dropout_keep,
// bit for bit: the global position (bh = b * H + h with H the QUERY heads,
// row, col) and the seed mix in uint32, then the murmur3 finalizer. The
// forward and both backward kernels regenerate the same mask from it.
__device__ __forceinline__ uint32_t dropout_hash(uint32_t seed, uint32_t bh, uint32_t row,
                                                 uint32_t col) {
  uint32_t x = row * 0x9E3779B1u + col * 0x85EBCA77u + bh * 0xC2B2AE3Du + seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Which (query row, key) pairs a row sees, and the dropout factor of a pair.
// Rows index Sq and keys Sk of one batch entry b; under `causal` a row sees
// keys <= row + (Sk - Sq), under a sliding window (with causal) only keys
// >= row + (Sk - Sq) - (window - 1), under segment ids only keys of its own
// segment.
struct AttnMask {
  const int* q_seg;   // int32 [B, Sq], or null: no segments
  const int* kv_seg;  // int32 [B, Sk]
  int causal;
  int dropout;
  uint32_t seed;
  uint32_t threshold;  // min(int(rate * 2^32), 2^32 - 1), from the host
  float keep_scale;    // 1 / (1 - rate) in fp32, from the host
  int window;          // sliding window in keys, 0 = none

  __device__ __forceinline__ bool visible(int b, int sq, int sk, int row, int key) const {
    if (causal && key > row + (sk - sq)) return false;
    if (window > 0 && key < row + (sk - sq) - (window - 1)) return false;
    return q_seg == nullptr || q_seg[(long)b * sq + row] == kv_seg[(long)b * sk + key];
  }

  // The first key tile (a multiple of kTileKeys) any of the rows >= row0 may
  // see: the band floor of row0 under a window, else 0. The band only moves
  // forward with the row, so later rows' floors are no lower.
  __device__ __forceinline__ int first_key(int sq, int sk, int row0, int tile) const {
    if (window <= 0) return 0;
    const int lo = max(0, row0 + (sk - sq) - (window - 1));
    return lo / tile * tile;
  }

  // One past the last row that sees a key <= key_last: under a window the
  // row whose band floor is key_last, else sq. The band only moves forward
  // with the row, so no later row sees a key <= key_last.
  __device__ __forceinline__ int last_row(int sq, int sk, int key_last) const {
    if (window <= 0) return sq;
    return max(0, min(sq, key_last - (sk - sq) + window));
  }

  // keep_scale where the pair is kept, 0 where it is dropped, 1 without dropout
  __device__ __forceinline__ float keep(uint32_t bh, int row, int key) const {
    if (!dropout) return 1.f;
    return dropout_hash(seed, bh, static_cast<uint32_t>(row), static_cast<uint32_t>(key)) >=
                   threshold
               ? keep_scale
               : 0.f;
  }
};

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
// visible to the row, `keep` is its dropout factor (AttnMask::keep). The
// denominator l sums the undropped probabilities; only the PV product sees
// p * keep, as in the reference. Warp-uniform control flow throughout.
__device__ __forceinline__ void row_fold(RowState& st, const float* qrow, const float* ks,
                                         const float* vs, int d, bool valid, float scale,
                                         int lane, float keep) {
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
  const float pd = p * keep;
  for (int j = 0; j < kTileKeys; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pd, j);
    if (pj == 0.f) continue;  // masked, dropped or unloaded keys are never read
    const float* vrow = vs + j * kTileStride;
#pragma unroll
    for (int r = 0; r < kDimsPerLane; ++r) {
      const int c = lane + 32 * r;
      if (c < d) st.acc[r] = fmaf(pj, vrow[c], st.acc[r]);
    }
  }
}

// Write the normalized row; returns the row's log-sum-exp (kMaskValue for a
// row that saw no key, as the reference's).
template <typename T>
__device__ __forceinline__ float row_store(const RowState& st, T* out, int d, int lane) {
  const float l_safe = st.l == 0.f ? 1.f : st.l;
#pragma unroll
  for (int r = 0; r < kDimsPerLane; ++r) {
    const int c = lane + 32 * r;
    if (c < d) out[c] = from_f32<T>(st.acc[r] / l_safe);
  }
  return st.l == 0.f ? kMaskValue : st.m + logf(l_safe);
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
