// Fused dequant-matmul: y = x @ dequant(w).T with the weights read at their
// narrow width and widened in registers.
//
// Replaces the TPU kernels apex_tpu/ops/quant.py::_fused_wq_kernel (int8 or
// fp8 e4m3 weights (out, in) with fp32 per-channel scales (out,), applied as
// the epilogue) and ::_fused_w4_kernel (int4 nibbles packed group-locally,
// (out, in/2) uint8, fp32 scales (in/gs, out): one scaled partial dot per
// group), both behind pallas_call in fused_dequant_matmul. x is (m, in) in
// fp32 or bf16, accumulation fp32, y (m, out) in x's dtype.
//
// What bounds it on the H100: bytes at decode (m = 8 slots: 2 FLOPs per
// weight element per row, far below the ~295 FLOP/byte balance point), the
// tensor cores' rate (and the L2 traffic of the tiles below) at a prefill
// of m = 32..1024 rows. Two pairs of kernels, routed by x's dtype:
//
// bf16 x, dequant_matmul_mma_kernel<KIND> (int8, e4m3) and
// dequant_matmul_w4_mma_kernel (int4, any power-of-two group): the products on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulators). Output
// channels are the M of the product (the weight (out, in) with K
// contiguous is the A operand as stored), tokens the N: a decode step's 8
// slots are one n8 tile. A block of 4 warps owns 32 channels and 32 tokens
// and streams K in stages of 256 values through a double-buffered ring of
// 16- (or 8-) byte cp.async copies at the weights' narrow width, into
// XOR-swizzled shared tiles (52 KB a block); K's tail is zero-filled,
// channels past n_out and tokens past m are not copied (they reach only
// outputs that are not written). Warp w takes the w-th 64 values of every
// stage, four k16 steps, so each weight byte is read from device memory
// once per block's token tile. Within a k16 step
// the 16 K values are permuted, the same way for the weight and for x, so
// that lane (g, t) takes four contiguous values (4t..4t+3 of the step):
// one 32-bit word of int8/e4m3 weight per fragment row, one 64-bit word of
// x per n8 tile. Widening is exact and in registers, two values at a time:
// int8 as bf16 (128 + (u & 127)) - (128 + (u & 128)), e4m3 by
// cvt.rn.f16x2.e4m3x2, int4 as bf16 (128 + nibble) - 136; so the products
// are exact and only the order of the fp32 sums differs from the twin.
// int4 packs byte j of a group's gs/2 bytes with values j (low nibble) and
// j + gs/2 (high): a step takes the low nibbles of 16 bytes of one group,
// then their high nibbles (gs >= 32), or the low and high halves of one
// 8-byte group together (gs = 16); x is staged as the values under the low
// and under the high nibbles. Each group's (or, for groups wider than a
// warp's 64 values, each sub-tile's) partial has fp32 fragments of its
// own, folded into the sum with fmaf(partial, s[g, o], sum). int8/e4m3
// scale once, in the epilogue.
//
// Every shape the reference serves (apex_tpu/ops/quant.py:186-196,
// :321-372): groups of 2, 4 and 8 take 8 / half groups in a k16 step's 8
// bytes; they cannot share one product and keep their own scales, so the
// step runs one product a group with the A operand's other K positions
// zeroed (a mask per lane: lane t holds bytes 2t and 2t + 1), 2, 4 or 8
// products where gs = 16 runs one, each partial folded with its group's
// scale; their x is gathered value by value (the values under 8 bytes'
// low nibbles are 8 / half runs of half). Groups of 1024 and more fold
// per sub-tile as 64-512 do, the scale of group k / gs staged per stage
// (a stage lies inside one group). Rows that are no whole 16- or 8-byte
// chunks (int8/e4m3 n_in not a multiple of 8; int4 rows of gs < 16) are
// copied one element at a time, zero past the row's end, into the same
// swizzled tiles; the weight is never copied or padded per call. At gs 2
// and 4 a stage's scales outgrow the int8 stage, so the int4 stage grows
// to 28 or 36 KB.
//
// The sum's order is fixed by (n_in, n_out) alone, never by m: the four
// warps' sums are added in warp order through shared memory, and where a
// decode step's one token tile would leave SMs idle, K is split across
// parts = mma_k_split(n_in, n_out) blocks (ops/quant.py, at most 8), one
// thread-block cluster a tile: each part leaves its fp32 sums in its
// shared memory and the first block adds the others' (distributed shared
// memory) in part order. Where the grid has blocks enough without the
// split (a prefill), one block walks the parts in turn and adds each to
// its running sum in the same order: the same bits. So a row's value does
// not depend on m or on its place in the batch, bit for bit.
//
// fp32 x, dequant_matmul_kernel<float, KIND> and dequant_matmul_w4_kernel
// <float> (the serving path's greedy-identity bar rests on them): CUDA
// cores. A block of 8 warps owns 8 rows of x and 32 output channels, 4 per
// warp. x is staged in shared memory in K tiles of 512 weight bytes
// (int4: the values under the bytes' low nibbles, then under their high
// ones, so that every group size reads them alike; zero past the row's
// end, which rows that are no whole 8-byte chunks read byte by byte), and
// groups of 2, 4 and 8 fold 8 / half partials a chunk; for each tile every lane
// first issues the loads of its weight chunks (8 bytes of one channel: 8
// int8/e4m3 values, or 16 int4 values), so their latency overlaps the
// staging, then widens them in registers and folds them against the 8
// staged rows. A lane's chunks are fixed by `in` alone and the lanes' sums
// are added by a fixed butterfly, so an output's value does not depend on
// m or on its row's place in the batch either.

#include <cooperative_groups.h>

#include "mma_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                      // x rows per block
constexpr int kChans = 4;                     // output channels per warp
constexpr int kBlockChans = kWarps * kChans;  // output channels per block
constexpr int kTileBytes = 512;               // weight bytes of a row per K tile
constexpr int kMaxTileK = 2 * kTileBytes;     // x values staged per row and tile

enum WeightKind { W_INT8 = 0, W_E4M3 = 1, W_INT4 = 2 };

// the K tile holds 64 chunks of 8 weight bytes, two per lane: 512 values
// of an int8/e4m3 row or 1024 of an int4 row
constexpr int kChunksPerLane = 2;

template <int KIND>
__device__ __forceinline__ float widen(uint32_t byte) {
  if constexpr (KIND == W_INT8) return static_cast<float>(static_cast<int8_t>(byte));
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(v);
}

// weight bytes b .. b + 7 of a row: one 8-byte load (vec: rows of whole
// aligned chunks), else byte by byte, zero past the row's end
__device__ __forceinline__ uint2 load8(const uint8_t* __restrict__ row, long b, long row_bytes,
                                       int vec) {
  if (vec) return __ldg(reinterpret_cast<const uint2*>(row + b));
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (b + i < row_bytes) {
      const uint32_t v = __ldg(row + b + i);
      if (i < 4) lo |= v << (8 * i);
      else hi |= v << (8 * (i - 4));
    }
  }
  return make_uint2(lo, hi);
}

// int4: the x column under byte b's low nibble (hi 0) or its high nibble,
// for groups of 2 * half values (half = 1 << hshift)
__device__ __forceinline__ int nibble_col(long b, int hshift, int hi) {
  const int half = 1 << hshift;
  return static_cast<int>(((b >> hshift) << (hshift + 1)) + (b & (half - 1))) + hi * half;
}

// kRagged: int8/e4m3 rows that are no whole 8-byte chunks, int4 groups
// below 16 or above 1024, weights off an 8-byte boundary: bytes read one at a
// time where a chunk would cross the row, x staged by the bytes' nibbles,
// and int4 groups folded a group at a time. The other shapes compile
// without these paths.
template <typename T, int KIND, bool kRagged>
__device__ __forceinline__ void dequant_matmul(const T* __restrict__ x,
                                               const uint8_t* __restrict__ w,
                                               const float* __restrict__ scale,
                                               T* __restrict__ y, int m, int n_in, int n_out,
                                               int gs, int w_vec8) {
  // x[r][col]: the tile's values (kRagged int4: the value under byte col's
  // low nibble, x[r][kTileBytes + col] the one under its high nibble)
  __shared__ __align__(16) float xs[kRows][kMaxTileK];
  constexpr int kTile = KIND == W_INT4 ? kMaxTileK : kMaxTileK / 2;  // x values a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - m0);
  const int o0 = blockIdx.x * kBlockChans + warp * kChans;
  const long row_bytes = KIND == W_INT4 ? n_in / 2 : n_in;
  const int half = gs / 2;
  const int hshift = KIND == W_INT4 ? __ffs(half) - 1 : 0;
  const int n_groups = KIND == W_INT4 ? n_in / gs : 0;

  float acc[kRows][kChans];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kChans; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < n_in; k0 += kTile) {
    const int tk = min(kTile, n_in - k0);
    const int tb = KIND == W_INT4 ? tk / 2 : tk;  // the tile's weight bytes of a row
    const int chunks = kRagged ? (tb + 7) / 8 : tb / 8;
    const long byte0 = KIND == W_INT4 ? k0 / 2 : k0;
    // this tile's weight chunks, loaded before the staging so that their
    // latency overlaps it; absent chunks and channels read as 0
    uint2 raw[kChunksPerLane][kChans];
#pragma unroll
    for (int u = 0; u < kChunksPerLane; ++u) {
      const int c = lane + 32 * u;
#pragma unroll
      for (int j = 0; j < kChans; ++j) {
        raw[u][j] = make_uint2(0u, 0u);
        if (c < chunks && o0 + j < n_out) {
          const uint8_t* row = w + (long)(o0 + j) * row_bytes;
          raw[u][j] = kRagged ? load8(row, byte0 + 8 * c, row_bytes, w_vec8)
                              : __ldg(reinterpret_cast<const uint2*>(row + byte0 + 8 * c));
        }
      }
    }
    __syncthreads();  // the previous tile is consumed
    if constexpr (!kRagged) {
      for (int i = threadIdx.x; i < kRows * tk; i += kThreads) {
        const int r = i / tk, col = i - r * tk;
        xs[r][col] = r < rows ? to_f32<T>(x[(long)(m0 + r) * n_in + k0 + col]) : 0.f;
      }
    } else {
      // the tile's whole chunks, zero past the row's end
      const int span = 8 * chunks, width = KIND == W_INT4 ? 2 * span : span;
      for (int r = 0; r < kRows; ++r) {
        for (int i = threadIdx.x; i < width; i += kThreads) {
          const int hi = KIND == W_INT4 && i >= span, col = i - hi * span;
          float v = 0.f;
          if (r < rows && col < tb) {
            const long k = KIND == W_INT4 ? nibble_col(byte0 + col, hshift, hi) : byte0 + col;
            v = to_f32<T>(x[(long)(m0 + r) * n_in + k]);
          }
          xs[r][hi * kTileBytes + col] = v;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kChunksPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c >= chunks) break;
      if constexpr (KIND != W_INT4) {
        // 8 values k0 + 8c .. k0 + 8c + 7 of each channel
        float wv[kChans][8];
#pragma unroll
        for (int j = 0; j < kChans; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            wv[j][i] = widen<KIND>(((i < 4 ? raw[u][j].x : raw[u][j].y) >> (8 * (i % 4))) & 0xffu);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 xa = *reinterpret_cast<const float4*>(&xs[r][8 * c]);
          const float4 xb = *reinterpret_cast<const float4*>(&xs[r][8 * c + 4]);
          const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int j = 0; j < kChans; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][j] = fmaf(xv[i], wv[j][i], acc[r][j]);
        }
      } else {
        // bytes 8c .. 8c + 7 of the tile's packed row, both nibbles biased
        // by +8: group gt of the tile at byte offset jj, low nibbles at
        // values gt*gs + jj + i, high nibbles at gt*gs + gs/2 + jj + i (or,
        // kRagged, at xs[r][8c + i] and xs[r][kTileBytes + 8c + i])
        float lo[kChans][8], hi[kChans][8];
#pragma unroll
        for (int j = 0; j < kChans; ++j) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t b = ((i < 4 ? raw[u][j].x : raw[u][j].y) >> (8 * (i % 4))) & 0xffu;
            lo[j][i] = static_cast<float>(static_cast<int>(b & 15u) - 8);
            hi[j][i] = static_cast<float>(static_cast<int>(b >> 4) - 8);
          }
        }
        if constexpr (!kRagged) {
          const int gt = (8 * c) / half, jj = (8 * c) % half;
          const int lo0 = gt * gs + jj, hi0 = lo0 + half;
          const int g = k0 / gs + gt;
          float s[kChans];
#pragma unroll
          for (int j = 0; j < kChans; ++j)
            s[j] = o0 + j < n_out ? scale[(long)g * n_out + o0 + j] : 0.f;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float4 la = *reinterpret_cast<const float4*>(&xs[r][lo0]);
            const float4 lb = *reinterpret_cast<const float4*>(&xs[r][lo0 + 4]);
            const float4 ha = *reinterpret_cast<const float4*>(&xs[r][hi0]);
            const float4 hb = *reinterpret_cast<const float4*>(&xs[r][hi0 + 4]);
            const float xl[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
            const float xh[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
            for (int j = 0; j < kChans; ++j) {
              float p = 0.f;
#pragma unroll
              for (int i = 0; i < 8; ++i) p = fmaf(xl[i], lo[j][i], p);
#pragma unroll
              for (int i = 0; i < 8; ++i) p = fmaf(xh[i], hi[j][i], p);
              acc[r][j] = fmaf(p, s[j], acc[r][j]);  // this chunk's share of group g
            }
          }
        } else {
          // group g0 holds the chunk's first byte; groups of 2, 4 or 8
          // values are 8 / half groups in the 8 bytes, byte i in group
          // g0 + (i >> hshift), each partial folded with its own scale
          const long g0 = (byte0 + 8 * c) >> hshift;
          auto group_scale = [&](long g, int o) {
            return g < n_groups && o < n_out ? __ldg(scale + g * n_out + o) : 0.f;
          };
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int j = 0; j < kChans; ++j) {
              float p = 0.f;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                p = fmaf(xs[r][8 * c + i], lo[j][i], p);
                p = fmaf(xs[r][kTileBytes + 8 * c + i], hi[j][i], p);
                if (((i + 1) & (half - 1)) == 0 || (i == 7 && half >= 8)) {
                  acc[r][j] = fmaf(p, group_scale(g0 + (i >> hshift), o0 + j), acc[r][j]);
                  p = 0.f;
                }
              }
            }
          }
        }
      }
    }
  }

  // lane r * kChans + j writes (row m0 + r, channel o0 + j)
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kChans; ++j) {
      const float v = warp_sum(acc[r][j]);
      if (lane == r * kChans + j) mine = v;
    }
  const int r = lane / kChans, o = o0 + lane % kChans;
  if (r < rows && o < n_out) {
    const float v = KIND == W_INT4 ? mine : mine * scale[o];
    y[(long)(m0 + r) * n_out + o] = from_f32<T>(v);
  }
}

static_assert(kRows * kChans == 32, "one output per lane in the epilogue");

// two entry symbols, so that a profile tells the per-channel kernel
// (KIND int8 or e4m3) from the int4 one
template <typename T, int KIND, bool kRagged>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ y, int m, int n_in,
                      int n_out, int w_vec8) {
  dequant_matmul<T, KIND, kRagged>(x, w, scale, y, m, n_in, n_out, 0, w_vec8);
}

template <typename T, bool kRagged>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_w4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                         const float* __restrict__ scale, T* __restrict__ y, int m, int n_in,
                         int n_out, int gs, int w_vec8) {
  dequant_matmul<T, W_INT4, kRagged>(x, w, scale, y, m, n_in, n_out, gs, w_vec8);
}


template <int KIND>
void launch_f32(const void* x, const void* w, const void* scale, void* y, int m, int n_in,
                int n_out, int gs, cudaStream_t stream) {
  dim3 grid((n_out + kBlockChans - 1) / kBlockChans, (m + kRows - 1) / kRows);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const uint8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto yp = static_cast<float*>(y);
  const int row_bytes = KIND == W_INT4 ? n_in / 2 : n_in;
  const int w_vec8 = row_bytes % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  // the common shapes: whole aligned 8-byte chunks, int4 groups 16..1024
  // (a K tile of 1024 values holds whole groups, a chunk's 8 bytes one)
  const bool ragged = !w_vec8 || (KIND == W_INT4 && (gs < 16 || gs > 1024));
#define APEX_DEQUANT_F32(R)                                                                   \
  if constexpr (KIND == W_INT4)                                                               \
    dequant_matmul_w4_kernel<float, R><<<grid, kThreads, 0, stream>>>(xp, wp, sp, yp, m, n_in, \
                                                                      n_out, gs, w_vec8);     \
  else                                                                                        \
    dequant_matmul_kernel<float, KIND, R><<<grid, kThreads, 0, stream>>>(xp, wp, sp, yp, m,    \
                                                                         n_in, n_out, w_vec8)
  if (ragged) {
    APEX_DEQUANT_F32(true);
  } else {
    APEX_DEQUANT_F32(false);
  }
#undef APEX_DEQUANT_F32
}

// --- bf16 x: the tensor-core kernels ----------------------------------------

namespace tc {

namespace cg = cooperative_groups;
using mma_tile::cp_async_16;
using mma_tile::cp_async_4;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::mma_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChans = 32;                 // output channels a block owns: two m16 fragments
constexpr int kTokens = 32;                // rows of x a block owns: four n8 tiles
constexpr int kMF = kChans / 16;
constexpr int kNF = kTokens / 8;
constexpr int kSubK = 64;                  // K values of a warp's sub-tile: four k16 steps
constexpr int kStageK = kWarps * kSubK;    // K values of a stage (ops/quant.py MMA_STAGE_K)
constexpr int kStages = 2;
constexpr int kMaxParts = 8;               // a cluster's blocks (ops/quant.py MMA_MAX_PARTS)

// One stage in shared memory, by sub-tile (warp), rows unpadded; the
// 16-byte chunks of a row are XOR-swizzled so that a warp's fragment loads
// fall in distinct banks (int8/e4m3: weights [warp][channel][64 bytes],
// x [warp][token][64 bf16]; int4: weights [warp][channel][32 bytes], x
// [warp][low, high][token][32 bf16], then the stage's scales
// [group][channel]). The warps' sums of a part go to the stage just
// consumed; after the ring, the parts' running sum.
constexpr int kW8Row = 64, kX8Row = 128, kW4Row = 32, kX4Row = 64;
constexpr int kW8Sub = kChans * kW8Row, kX8Sub = kTokens * kX8Row;
constexpr int kW4Sub = kChans * kW4Row, kX4Half = kTokens * kX4Row, kX4Sub = 2 * kX4Half;
constexpr int kW8Stage = kWarps * kW8Sub, kW4Stage = kWarps * kW4Sub;
constexpr int kX4Stage = kWarps * kX4Sub;
constexpr int kStageBytes = kW8Stage + kWarps * kX8Sub;
constexpr int kRedPitch = kChans + 4;      // the warps' sums, [warp][token][channel]
constexpr int kSumBytes = kChans * kTokens * 4;
static_assert(kWarps * kTokens * kRedPitch * 4 <= kStageBytes, "the warps' sums");

// a stage's bytes: int4 stages the scales of the kStageK / gs groups it
// touches after its tiles, which at gs 2 and 4 needs more than the int8
// stage's room
__host__ __device__ constexpr int stage_bytes(bool int4, int gs) {
  const int need = int4 ? kW4Stage + kX4Stage + (kStageK / gs) * kChans * 4 : 0;
  return need > kStageBytes ? need : kStageBytes;
}
__host__ __device__ constexpr int smem_bytes(bool int4, int gs) {
  return kStages * stage_bytes(int4, gs) + kSumBytes;
}
constexpr int kRaggedSmem = smem_bytes(true, 2);  // the most any shape takes

// the physical 16-byte chunk of logical chunk c in row r of each tile
__device__ __forceinline__ int swz_w8(int r, int c) { return c ^ ((r >> 1) & 3); }
__device__ __forceinline__ int swz_x8(int r, int c) { return c ^ ((r & 3) << 1); }
__device__ __forceinline__ int swz_w4(int r, int c) { return c ^ ((r >> 2) & 1); }
__device__ __forceinline__ int swz_x4(int r, int c) { return c ^ (r & 2); }

using bf16 = __nv_bfloat16;

// 8 bytes from global to shared memory, asynchronously (weights whose rows
// are not 16-byte aligned); src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(mma_tile::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint2 ld64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ uint32_t ld16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// the two halves of a cluster barrier, the arrival without ordering
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

constexpr uint32_t kOnes = 0x3F803F80u;    // bf16x2 (1, 1)

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// the int8 values in bits 0-7 and 16-23 of h as bf16x2, exactly:
// (128 + (u & 127)) - (128 + (u & 128)) for the two's-complement byte u
__device__ __forceinline__ uint32_t int8_pair(uint32_t h) {
  return bf16x2_fma((h & 0x007F007Fu) | 0x43004300u, kOnes, (h & 0x00800080u) | 0xC300C300u);
}

// the e4m3 values in bits 0-7 and 8-15 of h as bf16x2 (the lower byte in
// the lower half); every e4m3 value is exact in f16 and in bf16
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t h) {
  const __half2_raw r =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(h & 0xFFFFu), __NV_E4M3);
  const __nv_bfloat162 b = __float22bfloat162_rn(__half22float2(__half2(r)));
  return *reinterpret_cast<const uint32_t*>(&b);
}

// the int4 nibbles at bits s..s+3 and s+16..s+19 of w (biased by +8) as
// bf16x2 values in -8..7, exactly: (128 + nibble) - 136
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w, int s) {
  return bf16x2_fma(((w >> s) & 0x000F000Fu) | 0x43004300u, kOnes, 0xC308C308u);
}

// a fragment row's word (bytes 0..3 at the step's K values 4t..4t+3) as
// the A registers of that row: values 4t, 4t+1 (logical 2t, 2t+1) and 4t+2,
// 4t+3 (logical 2t+8, 2t+9)
template <int KIND>
__device__ __forceinline__ void widen_word(uint32_t w, uint32_t& k01, uint32_t& k23) {
  if constexpr (KIND == W_INT8) {
    k01 = int8_pair(__byte_perm(w, 0, 0x4140));
    k23 = int8_pair(__byte_perm(w, 0, 0x4342));
  } else {
    k01 = e4m3_pair(w);
    k23 = e4m3_pair(w >> 16);
  }
}

// kRagged: rows that are no whole 8-byte chunks (int8/e4m3 n_in % 8,
// int4 rows of groups below 16) and int4 groups below 16; the others compile
// without these paths
template <int KIND, bool kRagged>
__device__ __forceinline__ void dequant_mma(const bf16* __restrict__ x,
                                            const uint8_t* __restrict__ w,
                                            const float* __restrict__ scale, bf16* __restrict__ y,
                                            int m, int n_in, int n_out, int gs, int per,
                                            int seq, int w_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kInt4 = KIND == W_INT4;
  constexpr int kRowBytes = kInt4 ? kStageK / 2 : kStageK;  // weight bytes of a stage's row
  constexpr int kSubBytes = kRowBytes / kWarps;             // = kW8Row or kW4Row
  constexpr int kWSub = kInt4 ? kW4Sub : kW8Sub;
  constexpr int kWStage = kInt4 ? kW4Stage : kW8Stage;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lg = lane / 4, lt = lane % 4;
  const int ch0 = blockIdx.x * kChans, tok0 = blockIdx.y * kTokens, part = blockIdx.z;
  // seq: this block walks every part in turn; else it is part `part` of
  // a cluster of gridDim.z
  const int row_bytes = kInt4 ? n_in / 2 : n_in;
  const int total = (n_in + kStageK - 1) / kStageK;
  const int s_begin = seq ? 0 : part * per;
  const int n_st = (seq ? total : min(total, s_begin + per)) - s_begin;
  const int half = gs / 2;  // int4: bytes of a group, values under its low nibbles
  const int nt_live = min(kNF, (m - tok0 + 7) / 8);
  const int n_rows = min(kChans, n_out - ch0), n_toks = min(kTokens, m - tok0);
  const int st_bytes = kRagged ? stage_bytes(kInt4, gs) : kStageBytes;
  // x's rows 16-byte aligned (the wrapper aligns x itself): its K values
  // go by 16-byte copies, else one at a time
  const bool x_vec = !kRagged || n_in % 8 == 0;

  // weights in whole 16- (or 8-) byte chunks, zero past the row's end;
  // rows past n_out and tokens past m are not copied (they reach only
  // outputs that are not written)
  auto w_dst = [&](unsigned char* base, int r, int col) {
    const int sub = col / kSubBytes, c = col % kSubBytes;
    const int chunk = kInt4 ? swz_w4(r, c / 16) : swz_w8(r, c / 16);
    return base + sub * kWSub + r * kSubBytes + chunk * 16 + c % 16;
  };
  // int4: a byte's group and offset by shifts (gs a power of two)
  const int hshift = kInt4 ? __ffs(half) - 1 : 0;
  auto load_stage = [&](int st, int buf) {
    unsigned char* base = smem + buf * st_bytes;
    const int b0 = st * kRowBytes;  // the stage's first weight byte of a row
    if (kRagged && w_mode == 0) {
      // rows that are no whole 8-byte chunks: bytes one at a time, zero
      // past the row's end
      constexpr int kPerRow = kRowBytes / 16;
#pragma unroll
      for (int it = 0; it < kChans * kPerRow / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int r = c / kPerRow, col = c % kPerRow * 16, b = b0 + col;
        if (r >= n_rows) continue;
        const uint8_t* src = w + (long)(ch0 + r) * row_bytes;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (b + i < row_bytes) v[i / 4] |= static_cast<uint32_t>(__ldg(src + b + i)) << (8 * (i % 4));
        *reinterpret_cast<uint4*>(w_dst(base, r, col)) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    } else if (w_mode == 2) {
      constexpr int kPerRow = kRowBytes / 16;
#pragma unroll
      for (int it = 0; it < kChans * kPerRow / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int r = c / kPerRow, col = c % kPerRow * 16, b = b0 + col;
        const int n = max(0, min(16, row_bytes - b));
        if (r < n_rows)
          cp_async_16(w_dst(base, r, col), n > 0 ? w + (long)(ch0 + r) * row_bytes + b : w, n);
      }
    } else {
      constexpr int kPerRow = kRowBytes / 8;
#pragma unroll
      for (int it = 0; it < kChans * kPerRow / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int r = c / kPerRow, col = c % kPerRow * 8, b = b0 + col;
        const int n = max(0, min(8, row_bytes - b));
        if (r < n_rows)
          cp_async_8(w_dst(base, r, col), n > 0 ? w + (long)(ch0 + r) * row_bytes + b : w, n);
      }
    }
    unsigned char* xs = base + kWStage;
    if constexpr (!kInt4) {
      // x[token][b0 + 64 sub + 8 q .. + 8] for each sub-tile, token and chunk q
#pragma unroll
      for (int it = 0; it < kWarps * kTokens * 8 / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int sub = c / (kTokens * 8), r = c / 8 % kTokens, q = c % 8;
        const int k = b0 + sub * kSubK + q * 8;
        const bool in = k < n_in;
        if (r >= n_toks) continue;
        unsigned char* dst = xs + sub * kX8Sub + r * kX8Row + swz_x8(r, q) * 16;
        if (x_vec) {
          cp_async_16(dst, in ? x + (long)(tok0 + r) * n_in + k : x, in ? 16 : 0);
        } else {
          // a row that is no whole 16-byte chunks: values one at a time,
          // zero past its end
          const unsigned short* src =
              reinterpret_cast<const unsigned short*>(x + (long)(tok0 + r) * n_in);
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (k + i < n_in) v[i / 2] |= static_cast<uint32_t>(__ldg(src + k + i)) << (16 * (i % 2));
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    } else {
      // the values under the low (hi = 0) and the high nibbles of 8 packed
      // bytes: 8 contiguous values of x where gs/2 is a multiple of 8
#pragma unroll
      for (int it = 0; it < kWarps * 2 * kTokens * 4 / kThreads; ++it) {
        const int c = threadIdx.x + it * kThreads;
        const int sub = c / (2 * kTokens * 4), hi = c / (kTokens * 4) % 2;
        const int r = c / 4 % kTokens, q = c % 4;
        const int b = b0 + sub * kSubBytes + q * 8;
        if (r >= n_toks) continue;
        unsigned char* dst = xs + sub * kX4Sub + hi * kX4Half + r * kX4Row + swz_x4(r, q) * 16;
        if (!kRagged || half >= 8) {
          const int k = ((b >> hshift) << (hshift + 1)) + (b & (half - 1)) + hi * half;
          const bool in = b < row_bytes;
          cp_async_16(dst, in ? x + (long)(tok0 + r) * n_in + k : x, in ? 16 : 0);
        } else {
          // groups of 2, 4 or 8 values: the 8 bytes' values lie in 8 / half
          // runs of half; gathered one at a time, zero past the row's end
          const unsigned short* src =
              reinterpret_cast<const unsigned short*>(x + (long)(tok0 + r) * n_in);
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int bi = b + i;
            const int k = ((bi >> hshift) << (hshift + 1)) + (bi & (half - 1)) + hi * half;
            if (bi < row_bytes) v[i / 2] |= static_cast<uint32_t>(__ldg(src + k)) << (16 * (i % 2));
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    // the scales of the groups the stage touches, [group][channel]
    if constexpr (kInt4) {
      float* ss = reinterpret_cast<float*>(xs + kX4Stage);
      const int g0 = b0 >> hshift, n_groups = n_in / gs;
      const int ng = max(1, kRowBytes >> hshift);
      for (int c = threadIdx.x; c < ng * kChans; c += kThreads) {
        const int g = g0 + c / kChans, r = c % kChans;  // kChans: a shift
        const bool in = g < n_groups && r < n_rows;
        cp_async_4(ss + c, in ? scale + (long)g * n_out + ch0 + r : scale, in ? 4 : 0);
      }
    }
  };

  float acc[kMF][kNF][4];
  float prt[kMF][kNF][4];  // int4: the running group's partial
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = prt[i][j][e] = 0.f;

  // sum += partial * s[g, o] for the group at local index gi of the stage
  auto fold = [&](const float* ss, int gi) {
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = ss[gi * kChans + i * 16 + lg + 8 * h];
#pragma unroll
        for (int j = 0; j < kNF; ++j)
#pragma unroll
          for (int e = 2 * h; e < 2 * h + 2; ++e) {
            acc[i][j][e] = fmaf(prt[i][j][e], s, acc[i][j][e]);
            prt[i][j][e] = 0.f;
          }
      }
  };

  auto compute = [&](int buf, int st) {
    const unsigned char* base = smem + buf * st_bytes;
    const unsigned char* ws = base + warp * kWSub;
    if constexpr (!kInt4) {
      const unsigned char* xs = base + kWStage + warp * kX8Sub;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t a[kMF][4];
#pragma unroll
        for (int i = 0; i < kMF; ++i) {
          const int r0 = i * 16 + lg, r1 = r0 + 8;
          widen_word<KIND>(ld32(ws + r0 * kW8Row + swz_w8(r0, s) * 16 + 4 * lt), a[i][0],
                           a[i][2]);
          widen_word<KIND>(ld32(ws + r1 * kW8Row + swz_w8(r1, s) * 16 + 4 * lt), a[i][1],
                           a[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNF; ++j) {
          if (j < nt_live) {
            const int r = j * 8 + lg;
            const uint2 b =
                ld64(xs + r * kX8Row + swz_x8(r, 2 * s + lt / 2) * 16 + 8 * (lt % 2));
#pragma unroll
            for (int i = 0; i < kMF; ++i) mma_bf16(acc[i][j], a[i], b.x, b.y);
          }
        }
      }
    } else {
      const unsigned char* xlo = base + kWStage + warp * kX4Sub;
      const unsigned char* xhi = xlo + kX4Half;
      const float* ss = reinterpret_cast<const float*>(base + kWStage + kX4Stage);
      const int g0 = (st * kRowBytes) >> hshift;
      const int bw = st * kRowBytes + warp * kSubBytes;  // the warp's first packed byte
      if (gs <= 16) {
        // a step is 8 bytes: one group at gs = 16, else 8 / half groups of
        // half bytes; lane t takes bytes 2t, 2t+1, their low nibbles at
        // the step's K positions 2t, 2t+1 (x staged as the values under
        // the bytes' low nibbles), their high nibbles at 8 + 2t, 9 + 2t
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t a[kMF][4];
#pragma unroll
          for (int i = 0; i < kMF; ++i) {
            const int r0 = i * 16 + lg, r1 = r0 + 8;
            const int off = 8 * (q % 2) + 2 * lt;
            const uint32_t lo = __byte_perm(
                ld16(ws + r0 * kW4Row + swz_w4(r0, q / 2) * 16 + off), 0, 0x4140);
            const uint32_t hi = __byte_perm(
                ld16(ws + r1 * kW4Row + swz_w4(r1, q / 2) * 16 + off), 0, 0x4140);
            a[i][0] = nibble_pair(lo, 0);
            a[i][2] = nibble_pair(lo, 4);
            a[i][1] = nibble_pair(hi, 0);
            a[i][3] = nibble_pair(hi, 4);
          }
          uint32_t b0[kNF], b1[kNF];
#pragma unroll
          for (int j = 0; j < kNF; ++j) {
            const int r = j * 8 + lg;
            const int off = r * kX4Row + swz_x4(r, q) * 16 + 4 * lt;
            b0[j] = j < nt_live ? ld32(xlo + off) : 0u;
            b1[j] = j < nt_live ? ld32(xhi + off) : 0u;
          }
          if (gs == 16) {
#pragma unroll
            for (int j = 0; j < kNF; ++j)
              if (j < nt_live)
#pragma unroll
                for (int i = 0; i < kMF; ++i) mma_bf16(prt[i][j], a[i], b0[j], b1[j]);
            fold(ss, ((bw + 8 * q) >> hshift) - g0);
            continue;
          }
          if constexpr (!kRagged) continue;
          // one product a group, the A operand's K positions of the other
          // groups zeroed: lane t's byte 2t is the lower half of each of
          // its registers, byte 2t + 1 the upper
          for (int qq = 0; qq < (8 >> hshift); ++qq) {
            const uint32_t keep = (((2 * lt) >> hshift) == qq ? 0x0000FFFFu : 0u) |
                                  (((2 * lt + 1) >> hshift) == qq ? 0xFFFF0000u : 0u);
            uint32_t am[kMF][4];
#pragma unroll
            for (int i = 0; i < kMF; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) am[i][e] = a[i][e] & keep;
#pragma unroll
            for (int j = 0; j < kNF; ++j)
              if (j < nt_live)
#pragma unroll
                for (int i = 0; i < kMF; ++i) mma_bf16(prt[i][j], am[i], b0[j], b1[j]);
            fold(ss, ((bw + 8 * q) >> hshift) + qq - g0);
          }
        }
      } else {
        // a 16-byte unit of one group: lane t takes bytes 4t..4t+3, first
        // their low nibbles (values 4t..4t+3 of the unit), then their high
        // nibbles (the same + gs/2)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          uint32_t wl[kMF], wh[kMF];
#pragma unroll
          for (int i = 0; i < kMF; ++i) {
            // bytes (B0, B2, B1, B3), so each nibble pair is two neighbours
            const int r0 = i * 16 + lg, r1 = r0 + 8;
            wl[i] = __byte_perm(ld32(ws + r0 * kW4Row + swz_w4(r0, u) * 16 + 4 * lt), 0, 0x3120);
            wh[i] = __byte_perm(ld32(ws + r1 * kW4Row + swz_w4(r1, u) * 16 + 4 * lt), 0, 0x3120);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t a[kMF][4];
#pragma unroll
            for (int i = 0; i < kMF; ++i) {
              a[i][0] = nibble_pair(wl[i], 4 * h);
              a[i][2] = nibble_pair(wl[i], 8 + 4 * h);
              a[i][1] = nibble_pair(wh[i], 4 * h);
              a[i][3] = nibble_pair(wh[i], 8 + 4 * h);
            }
            const unsigned char* xs = h ? xhi : xlo;
#pragma unroll
            for (int j = 0; j < kNF; ++j) {
              if (j < nt_live) {
                const int r = j * 8 + lg;
                const uint2 b =
                    ld64(xs + r * kX4Row + swz_x4(r, 2 * u + lt / 2) * 16 + 8 * (lt % 2));
#pragma unroll
                for (int i = 0; i < kMF; ++i) mma_bf16(prt[i][j], a[i], b.x, b.y);
              }
            }
          }
          if (gs == 32) fold(ss, ((bw + 16 * u) >> hshift) - g0);
        }
        if (gs >= 64) fold(ss, (bw >> hshift) - g0);
      }
    }
  };

  // the four warps' sums of a part, added in warp order (through the stage
  // buffer just consumed), then to the parts' running sum in part order:
  // `sums`, each thread's kPer outputs, set by the first part
  constexpr int kPer = kTokens * kChans / kThreads;  // outputs of a thread
  const int c = threadIdx.x % kChans, r0 = threadIdx.x / kChans;
  float* sums = reinterpret_cast<float*>(smem + kStages * st_bytes);
  auto reduce_part = [&](int buf, bool first) {
    float* red = reinterpret_cast<float*>(smem + buf * st_bytes);
    __syncthreads();  // every warp is done with the stage
#pragma unroll
    for (int i = 0; i < kMF; ++i)
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(warp * kTokens + j * 8 + 2 * lt + (e & 1)) * kRedPitch + i * 16 + lg +
              8 * (e >> 1)] = acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = r0 + j * (kThreads / kChans);
      float sum = red[r * kRedPitch + c];
#pragma unroll
      for (int wp = 1; wp < kWarps; ++wp) sum += red[(wp * kTokens + r) * kRedPitch + c];
      float& total = sums[j * kThreads + threadIdx.x];
      total = first ? sum : total + sum;
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_st) load_stage(s_begin + i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; every warp is done with stage i - 1
    const int next = i + kStages - 1;
    if (next < n_st) load_stage(s_begin + next, next % kStages);
    cp_async_commit();
    compute(i % kStages, s_begin + i);
    if ((i + 1) % per == 0 || i + 1 == n_st) reduce_part(i % kStages, i < per);
  }
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) v[j] = sums[j * kThreads + threadIdx.x];
  if (gridDim.z > 1) {
    // the K split's parts are one cluster: the first block adds the
    // others' sums (their shared memory) in part order
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (part != 0) {  // stay until the first block has read these sums
      cluster_arrive_relaxed();
      cluster_wait();
      return;
    }
    for (int p = 1; p < static_cast<int>(gridDim.z); ++p) {
      const float* peer = cluster.map_shared_rank(sums, p);
#pragma unroll
      for (int j = 0; j < kPer; ++j) v[j] += peer[j * kThreads + threadIdx.x];
    }
    cluster_arrive_relaxed();
  }
  const int o = ch0 + c;
  if (o >= n_out) return;
  const float s_o = kInt4 ? 1.f : scale[o];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int tok = tok0 + r0 + j * (kThreads / kChans);
    if (tok < m) y[(long)tok * n_out + o] = __float2bfloat16_rn(v[j] * s_o);
  }
}

template <int KIND, bool kRagged>
__global__ void __launch_bounds__(kThreads, 4)
dequant_matmul_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                          const float* __restrict__ scale, bf16* __restrict__ y, int m, int n_in,
                          int n_out, int per, int seq, int w_mode) {
  dequant_mma<KIND, kRagged>(x, w, scale, y, m, n_in, n_out, 0, per, seq, w_mode);
}

template <bool kRagged>
__global__ void __launch_bounds__(kThreads, 3)
dequant_matmul_w4_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                             const float* __restrict__ scale, bf16* __restrict__ y, int m,
                             int n_in, int n_out, int gs, int per, int seq, int w_mode) {
  dequant_mma<W_INT4, kRagged>(x, w, scale, y, m, n_in, n_out, gs, per, seq, w_mode);
}

// above 48 KB of shared memory only after opting in, once per device and
// kernel
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int* opted, int smem_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && !opted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return err;
    opted[dev] = 1;
  }
  return cudaSuccess;
}

// a grid of (channel tiles, token tiles, parts), the parts of a tile one
// cluster (parts 1: one block walks them all)
template <typename Kernel, typename... Args>
cudaError_t launch_grid(Kernel kernel, int m, int n_out, int parts, int smem, cudaStream_t stream,
                        Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((n_out + kChans - 1) / kChans, (m + kTokens - 1) / kTokens, parts);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = parts;
  config.attrs = attr;
  config.numAttrs = parts > 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <int KIND, bool kRagged>
int launch_kind(const void* x, const void* w, const void* scale, void* y, int m, int n_in,
                int n_out, int gs, int parts, int per, int seq, int w_mode,
                cudaStream_t stream) {
  const int grid_parts = seq ? 1 : parts;
  static int opted[64] = {};
  const int smem = kRagged ? smem_bytes(KIND == W_INT4, gs) : smem_bytes(false, 0);
  const int smem_max = kRagged ? kRaggedSmem : smem_bytes(false, 0);
  auto xp = static_cast<const bf16*>(x);
  auto wp = static_cast<const uint8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto yp = static_cast<bf16*>(y);
  cudaError_t err;
  if constexpr (KIND == W_INT4) {
    err = opt_in(dequant_matmul_w4_mma_kernel<kRagged>, opted, smem_max);
    if (err == cudaSuccess)
      err = launch_grid(dequant_matmul_w4_mma_kernel<kRagged>, m, n_out, grid_parts, smem,
                        stream, xp, wp, sp, yp, m, n_in, n_out, gs, per, seq, w_mode);
  } else {
    err = opt_in(dequant_matmul_mma_kernel<KIND, kRagged>, opted, smem_max);
    if (err == cudaSuccess)
      err = launch_grid(dequant_matmul_mma_kernel<KIND, kRagged>, m, n_out, grid_parts, smem,
                        stream, xp, wp, sp, yp, m, n_in, n_out, per, seq, w_mode);
  }
  return static_cast<int>(err);
}

template <int KIND>
int launch(const void* x, const void* w, const void* scale, void* y, int m, int n_in, int n_out,
           int gs, int parts, int per, int seq, cudaStream_t stream) {
  if (parts < 1 || parts > kMaxParts || per < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = KIND == W_INT4 ? n_in / 2 : n_in;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  // the weights' copies: 16 bytes, 8 bytes, or (rows that are no whole
  // 8-byte chunks) one byte at a time
  const int w_mode = row_bytes % 16 == 0 && wa % 16 == 0 ? 2
                     : row_bytes % 8 == 0 && wa % 8 == 0 ? 1 : 0;
  const bool ragged = w_mode == 0 || (KIND != W_INT4 && n_in % 8 != 0) ||
                      (KIND == W_INT4 && gs < 16);
  return ragged ? launch_kind<KIND, true>(x, w, scale, y, m, n_in, n_out, gs, parts, per, seq,
                                          w_mode, stream)
                : launch_kind<KIND, false>(x, w, scale, y, m, n_in, n_out, gs, parts, per, seq,
                                           w_mode, stream);
}

}  // namespace tc

}  // namespace

// int8 (w_dtype APEX_I8) or e4m3 (APEX_E4M3) weights (n_out, n_in), any
// n_in, per-channel scales (n_out,). A bf16 x (16-byte aligned)
// takes the tensor-core kernel, its K split into `parts` (1..8) of `per`
// stages each, summed in part order by a cluster of `parts` blocks or, with
// `seq`, by one block in turn (the same sums); fp32 ignores the three.
extern "C" int apex_dequant_matmul(const void* x, const void* w, const void* scale, void* y,
                                   int m, int n_in, int n_out, int dtype, int w_dtype,
                                   int parts, int per, int seq, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (dtype == APEX_BF16)
    err = w_dtype == APEX_E4M3
              ? tc::launch<W_E4M3>(x, w, scale, y, m, n_in, n_out, 0, parts, per, seq, s)
              : tc::launch<W_INT8>(x, w, scale, y, m, n_in, n_out, 0, parts, per, seq, s);
  else if (w_dtype == APEX_E4M3)
    launch_f32<W_E4M3>(x, w, scale, y, m, n_in, n_out, 0, s);
  else
    launch_f32<W_INT8>(x, w, scale, y, m, n_in, n_out, 0, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}

// int4 weights packed group-locally (n_out, n_in / 2), scales (n_in / gs,
// n_out), gs any power of two >= 2 dividing n_in; parts, per and seq as
// above
extern "C" int apex_dequant_matmul_w4(const void* x, const void* w, const void* scale, void* y,
                                      int m, int n_in, int n_out, int gs, int dtype, int parts,
                                      int per, int seq, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int err = 0;
  if (dtype == APEX_BF16)
    err = tc::launch<W_INT4>(x, w, scale, y, m, n_in, n_out, gs, parts, per, seq, s);
  else
    launch_f32<W_INT4>(x, w, scale, y, m, n_in, n_out, gs, s);
  return err ? err : static_cast<int>(cudaGetLastError());
}
