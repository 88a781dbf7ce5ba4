// Online-softmax row state of the fp32 flash forward, and the masking
// (causal, sliding window, segment ids, dropout) and additive bias the
// three flash kernels share.
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

// Which (query row, key) pairs a row sees, the dropout factor of a pair and
// its additive bias. Rows index Sq and keys Sk of one batch entry b; under
// `causal` a row sees keys <= row + offset, under a sliding window (with
// causal) only keys >= row + offset - (window - 1), under segment ids only
// keys of its own segment. `offset` is the diagonal: Sk - Sq unless the
// caller gives one (ring attention's global positions, the reference's
// causal_offset: r * s_loc for a chunk r hops upstream, negative for a
// chunk downstream). A row it leaves with no key outputs 0 with LSE
// kMaskValue, as every row that sees nothing. The bias is any tensor that broadcasts to
// [B, H, Sq, Sk] (H the query heads), read in place through four element
// strides, 0 on a broadcast dimension, so a (1, H, Sq, Sk) table serves
// every batch entry and is never expanded in memory. It shifts the scores
// only: a pair the masks hide stays hidden whatever its bias, as in the
// reference (_fwd_kernel adds it before _mask_block).
struct AttnMask {
  const int* q_seg;   // int32 [B, Sq], or null: no segments
  const int* kv_seg;  // int32 [B, Sk]
  int causal;
  int dropout;
  uint32_t seed;
  uint32_t threshold;  // min(int(rate * 2^32), 2^32 - 1), from the host
  float keep_scale;    // 1 / (1 - rate) in fp32, from the host
  int window;          // sliding window in keys, 0 = none
  const void* bias;    // the additive bias, or null: none
  int bias_bf16;       // its dtype: 1 bf16, 0 fp32
  long long bias_sb, bias_sh, bias_sq, bias_sk;  // element strides of b, h, row, key
  int offset;          // the causal diagonal: row r sees keys <= r + offset

  __device__ __forceinline__ bool visible(int b, int sq, int sk, int row, int key) const {
    return in_band(row, key) &&
           (q_seg == nullptr || q_seg[(long)b * sq + row] == kv_seg[(long)b * sk + key]);
  }

  // the causal and window tests of visible(), without the segment ids
  __device__ __forceinline__ bool in_band(int row, int key) const {
    if (causal && key > row + offset) return false;
    return !(window > 0 && key < row + offset - (window - 1));
  }

  // Whether every row of [row_a, row_b] sees every key of [key_a, key_b]
  // (inclusive; the caller has checked both lie inside sq and sk): no
  // segment ids, the whole tile on or below the diagonal of row_a and on
  // or above the band floor of row_b.
  __device__ __forceinline__ bool tile_visible(int row_a, int row_b, int key_a,
                                               int key_b) const {
    return q_seg == nullptr && (!causal || key_b <= row_a + offset) &&
           !(window > 0 && key_a < row_b + offset - (window - 1));
  }

  // The first key tile (a multiple of kTileKeys) any of the rows >= row_a may
  // see: the band floor of row_a under a window, else 0. The band only moves
  // forward with the row, so later rows' floors are no lower.
  __device__ __forceinline__ int first_key(int row_a, int tile) const {
    if (window <= 0) return 0;
    const int lo = max(0, row_a + offset - (window - 1));
    return lo / tile * tile;
  }

  // One past the last key any of the rows < row_end may see, capped at sk:
  // under causal row_end - 1 + offset + 1, else sk; 0 when the diagonal
  // leaves every row before row_end with no key.
  __device__ __forceinline__ int key_end(int sk, int row_end) const {
    return causal ? max(0, min(sk, row_end + offset)) : sk;
  }

  // The first row that may see a key >= key_a: under causal the row whose
  // diagonal reaches key_a, else 0 (may pass sq: then no row does).
  __device__ __forceinline__ int first_row(int key_a) const {
    return causal ? max(0, key_a - offset) : 0;
  }

  // One past the last row that sees a key <= key_last: under a window the
  // row whose band floor is key_last, else sq. The band only moves forward
  // with the row, so no later row sees a key <= key_last.
  __device__ __forceinline__ int last_row(int sq, int key_last) const {
    if (window <= 0) return sq;
    return max(0, min(sq, key_last - offset + window));
  }

  // the bias of (b, query head h, row, key) as fp32; 0 without a bias
  __device__ __forceinline__ float bias_at(int b, int h, int row, int key) const {
    if (bias == nullptr) return 0.f;
    const long long i = b * bias_sb + h * bias_sh + row * bias_sq + key * bias_sk;
    return bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[i])
                     : static_cast<const float*>(bias)[i];
  }

  // the biases of (row, key) and (row, key + 1), each read only where its
  // pair is visible (in0, in1), 0 elsewhere; both in one 4-byte (bf16) or
  // 8-byte (fp32) load when the key stride is 1 and the pair is aligned
  __device__ __forceinline__ float2 bias_pair(int b, int h, int row, int key, bool in0,
                                              bool in1) const {
    float2 r = make_float2(0.f, 0.f);
    if (bias == nullptr) return r;
    const long long i = b * bias_sb + h * bias_sh + row * bias_sq + key * bias_sk;
    if (in0 && in1 && bias_sk == 1) {
      if (bias_bf16) {
        const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(bias) + i;
        if ((reinterpret_cast<uintptr_t>(p) & 3) == 0)
          return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      } else {
        const float* p = static_cast<const float*>(bias) + i;
        if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) return *reinterpret_cast<const float2*>(p);
      }
    }
    if (in0) r.x = bias_at(b, h, row, key);
    if (in1) r.y = bias_at(b, h, row, key + 1);
    return r;
  }

  // the score of a pair: scale * (q . k), then its bias added, each rounded
  // once as the reference's fp32 `s * scale + bias` (no fused multiply-add)
  __device__ __forceinline__ float score(float dot, float scale, int b, int h, int row,
                                         int key) const {
    return __fadd_rn(__fmul_rn(dot, scale), bias_at(b, h, row, key));
  }

  // keep_scale where the pair is kept, 0 where it is dropped, 1 without
  // dropout. The pair hashes at its global position (row0 + row, col0 +
  // key), as _dropout_keep adds the origins; in uint32 the origins' terms
  // row0 * 0x9E3779B1 + col0 * 0x85EBCA77 are a constant of the call, which
  // the host folds into `seed`, so the kernels hash (row, key) as before
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
// visible to the row, `bias` is its additive bias (AttnMask::bias_at; 0
// leaves the score scale * dot bit for bit), `keep` is its dropout factor
// (AttnMask::keep). The
// denominator l sums the undropped probabilities; only the PV product sees
// p * keep, as in the reference. Warp-uniform control flow throughout.
__device__ __forceinline__ void row_fold(RowState& st, const float* qrow, const float* ks,
                                         const float* vs, int d, bool valid, float scale,
                                         int lane, float keep, float bias = 0.f) {
  float s = -INFINITY;
  if (valid) {
    const float* krow = ks + lane * kTileStride;
    float dot = 0.f;
    for (int i = 0; i < d; ++i) dot = fmaf(qrow[i], krow[i], dot);
    s = __fadd_rn(__fmul_rn(dot, scale), bias);
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
