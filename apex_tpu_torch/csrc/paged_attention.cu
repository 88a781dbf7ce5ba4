// Paged attention over the KV page pool: s = 1 decode and s > 1 query
// blocks (a speculative verify chunk, a chunked-prefill piece), the page
// walk split over blocks and merged in a fixed order (flash-decode).
//
// Replaces the TPU kernel apex_tpu/ops/paged_attention.py::_paged_kernel
// (pallas_call in paged_attention, grid (batch, kv heads, max_pages)), with
// or without a sliding window, in its two branches: an fp32 or bf16 pool
// (entry point apex_paged_attention), and a quantized pool of int8 or fp8
// e4m3 pages with fp32 per-(page, kv head) scales (entry point
// apex_paged_attention_quant; the reference's quantized branch,
// _paged_kernel lines 108-121 and 141-143). The pool is (num_pages,
// kv_heads, page_size, D); slot b's position p lives in page
// block_tables[b, p / page_size] at offset p % page_size.
//
// Rows. q and out are (batch, heads, s, D). Slot b's s queries sit at
// positions lengths[b] - s + i. The rep = heads / kv_heads query heads of
// one kv head and the s positions make s * rep rows, position-major as in
// the reference (row r = i * rep + g is query i of group member g,
// _paged_kernel lines 122-127), so row r sits at qpos_r = lengths[b] - s +
// r / rep and sees the positions pos <= qpos_r; under a window w (> 0) only
// those with pos > qpos_r - w (its own band floor, lines 128-132). Query
// head h reads kv head h / rep without repeating it. A row with nothing to
// see (qpos_r < 0: a slot shorter than s, or a slot of length 0) outputs
// exactly 0. Pages at or past lengths[b] are never read (dead table
// entries point at the null page 0), nor pages wholly below the earliest
// row's band floor lengths[b] - s - w + 1 (the reference's dead-page gate,
// lines 90-103).
//
// What bounds it on the H100: bytes. Each live page is read once per kv
// head (2 * page_size * D elements) for ~4 * s * rep * page_size * D FLOPs,
// far below the card's ~295 FLOP/byte balance point; only Mistral-7B's
// s = 16 block (64 rows a kv head) does arithmetic enough per page to be
// slow on the CUDA cores, and at GPT-2's pool (3.7 MB of live pages, in L2)
// a call is two launches' latency.
//
// The split. On the TPU the page axis is the sequential last grid axis,
// folded into VMEM accumulators. Here a slot's live pages are cut into
// splits of `split_pages` pages anchored at absolute page indices (split k
// holds pages [k * split_pages, (k + 1) * split_pages)), so where a slot's
// splits fall depends only on its own length; split_pages comes from the
// shape alone (ops/paged_attention.py::paged_split_plan: 128 positions a
// split at d <= 64, 512 above, never from the batch, the lengths or the
// table width). The grid is (splits, kv heads x
// row groups, batch), sized on the host from the table width, the window,
// s and page_size without reading the lengths; grid column x of slot b is
// its (first live split + x)-th split, and a block past its slot's live
// splits exits at once. One block of 4 warps takes every row of one kv head
// (s * rep rows, up to 64; more rows make row groups of 64), so all of a kv
// head's rows read each page once:
// - its pages are staged 16 positions (one page at page_size 16) at a time
//   in their own type (fp32, bf16, int8 or e4m3) by 16-byte cp.async into a
//   ring of 2-3 stages, the page's table entry read ahead (all of the
//   split's entries at the block's start) and a quantized page's two scales
//   copied with the page; values are widened in registers;
// - the warps split the rows into tiles of 16 and the stages' chunks among
//   themselves: with one tile (up to 16 rows, every decode step) each warp
//   folds every 4th chunk, so the warps split the keys, not the rows; with
//   four tiles each warp takes one tile and every chunk;
// - fp32 q, and bf16 q over a quantized pool, run fp32 math on the CUDA
//   cores (paged_split_simt_kernel): lane (half, key) holds half of one
//   key's row in registers, its dot product over that half is reduced with
//   the other half by one shuffle, the tile's rows run without a branch so
//   that their chains interleave (instances for 1, 4 and 16 rows a warp),
//   and each lane owns D / 32 adjacent dimensions of the PV accumulators,
//   p read for 4 rows at a time;
// - bf16 q over a bf16 pool runs mma.sync m16n8k16 as the bf16 flash
//   forward does (paged_split_mma_kernel, csrc/mma_tile.cuh), at every row
//   count (a decode step's rows padded to a tile of 16): Q's fragments in
//   registers, K by ldmatrix, P as hi + lo bf16 parts into PV (one rounding
//   of P left the flash forward's RMS bar on the first rows of Mistral's
//   windowed prefill).
//
// The merge. The warps that shared a split's keys merge their (m, l, acc)
// in shared memory in warp order. A slot with one live split writes its
// rows at once; otherwise each split writes an unnormalised fp32 partial
// (acc, m, l) to scratch the wrapper allocates, and paged_merge_kernel
// merges a slot's live splits in split order (m the largest, each weighed by
// exp(m_i - m)), a split that saw nothing weighing 0, and writes acc / l (0
// where l == 0). Every sum runs in an order fixed by the shape and the
// slot's own length, so a row has the same bits alone, in any batch, at any
// table width and from one call to the next.
//
// The quantized branch reads a page at 1 byte per value and the two scales
// of (page, kv head) through the same block-table entry. The k scale folds
// into the score scale (scores are q.k * scale * k_scale), the v scale into
// the probabilities that enter the PV product (p * v_scale), while the
// denominator l sums the unscaled p, as in the reference. A page's
// dequantized values never exist in memory.

#include <algorithm>
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkKeys = 16;       // positions of a staged chunk: a page at page_size 16
constexpr int kTileRows = 16;        // rows a warp carries
constexpr int kBlockRows = kWarps * kTileRows;  // rows of a block: a kv head's s * rep, up to 64
constexpr int kMaxSplitPages = 64;   // split_pages cap: the split's table entries in shared memory
constexpr float kLog2e = 1.4426950408889634f;

struct PagedArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scales;  // (num_pages, kv_heads), or null: an unquantized pool
  const float* v_scales;
  const int* block_tables;
  const int* lengths;
  void* out;
  float* part;  // partial acc (grid) x block_rows x d, then (m, l) per row
  int heads, kv_heads, s, page_size, d, max_pages;
  float scale;
  int window;       // 0 = none
  int split_pages;  // pages per split
  int grid_splits;  // gridDim.x
  int groups;       // row groups of 64 per kv head
  int block_rows;   // min(s * rep, 64): the partials' row stride
  int vec;          // 16-byte copies: page rows of whole 16-byte chunks, aligned pools
};

// The live pages and splits of slot b: [page_lo, page_hi) runs from the page
// holding the earliest row's band floor to the one holding the last
// position; its splits first_split .. first_split + n_live - 1.
struct SlotSpan {
  int len, page_lo, page_hi, first_split, n_live;
};

__device__ __forceinline__ SlotSpan slot_span(const PagedArgs& a, int b) {
  SlotSpan sp;
  sp.len = max(a.lengths[b], 0);
  const int hi = min(sp.len, a.max_pages * a.page_size);
  const int lo = a.window > 0 ? max(sp.len - a.s - a.window + 1, 0) : 0;
  sp.page_lo = lo / a.page_size;
  sp.page_hi = (hi + a.page_size - 1) / a.page_size;
  sp.first_split = sp.page_lo / a.split_pages;
  sp.n_live = sp.page_hi > sp.page_lo ? (sp.page_hi - 1) / a.split_pages - sp.first_split + 1 : 0;
  return sp;
}

// 16-byte chunks of a staged row of D elements of P, and the XOR that
// spreads eight rows read at one logical chunk over eight bank groups
template <typename P, int D>
constexpr int kRowChunks = D * static_cast<int>(sizeof(P)) / 16;
template <typename P, int D>
constexpr int kSwzMask = (kRowChunks<P, D> < 8 ? kRowChunks<P, D> : 8) - 1;

template <typename P>
__device__ __forceinline__ P zero_elt() {
  P z;
  memset(&z, 0, sizeof(P));
  return z;
}

// Stage 16 rows of a page (row stride d elements) into a tile of 16 x D:
// logical chunk c of row r at chunk c ^ (r & mask) when kSwz; rows >= nk and
// columns >= d are zero. vec: one cp.async a chunk (the caller commits and
// waits); otherwise element copies, visible after the caller's barrier.
template <typename P, int D, bool kSwz>
__device__ __forceinline__ void stage_rows(P* dst, const P* src, int nk, int d, int vec) {
  constexpr int kCh = kRowChunks<P, D>;
  constexpr int kEpc = 16 / static_cast<int>(sizeof(P));
  if (vec) {
    for (int i = threadIdx.x; i < kChunkKeys * kCh; i += kThreads) {
      const int r = i / kCh, c = i % kCh;
      const int pc = kSwz ? (c ^ (r & kSwzMask<P, D>)) : c;
      const bool in = r < nk && c * kEpc < d;
      mma_tile::cp_async_16(dst + r * D + pc * kEpc, in ? src + (long)r * d + c * kEpc : src,
                            in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kChunkKeys * D; i += kThreads) {
      const int r = i / D, col = i % D, c = col / kEpc;
      const int pc = kSwz ? (c ^ (r & kSwzMask<P, D>)) : c;
      dst[r * D + pc * kEpc + col % kEpc] =
          (r < nk && col < d) ? src[(long)r * d + col] : zero_elt<P>();
    }
  }
}

// 16 bytes of P (the CUDA-core pass's page types) widened to fp32
template <typename P>
__device__ __forceinline__ void widen16(const uint4& u, float* f);
template <>
__device__ __forceinline__ void widen16<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void widen16<int8_t>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<int>(w[i] << (24 - 8 * j)) >> 24);
}
template <>
__device__ __forceinline__ void widen16<__nv_fp8_e4m3>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
          static_cast<__nv_fp8x2_storage_t>((w[i] >> (16 * j)) & 0xffffu), __NV_E4M3);
      const float2 v = __half22float2(__half2(h));
      f[4 * i + 2 * j] = v.x;
      f[4 * i + 2 * j + 1] = v.y;
    }
}

// n values of P (n * sizeof(P) of 2, 4, 8 or 16 bytes, aligned) widened
template <typename P, int N>
__device__ __forceinline__ void load_widen(const P* src, float* f) {
  constexpr int kBytes = N * static_cast<int>(sizeof(P));
  static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes == 16, "a vector load");
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (kBytes == 16) {
    u = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(src);
    u.x = w.x;
    u.y = w.y;
  } else if constexpr (kBytes == 4) {
    u.x = *reinterpret_cast<const uint32_t*>(src);
  } else {
    u.x = *reinterpret_cast<const uint16_t*>(src);
  }
  float all[16 / sizeof(P)];
  widen16<P>(u, all);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = all[i];
}

// The block's shared memory, carved in 128-byte aligned regions: the ring
// of page chunks (K then V, kStages stages of ks_n chunks of 16 x D each),
// which the warps' states (16 rows of (acc, m, l) a warp) take over once
// the walk is done; q's rows; the SIMT warps' p; the chunks' scales; the
// split's table entries. The host sizes it for the block with the most
// warps a chunk (ks_n) and rows; each block carves its own.
struct Layout {
  int q, p, scales, pages, bytes;
};

__host__ __device__ __forceinline__ int align128(int x) { return (x + 127) / 128 * 128; }

__host__ __device__ __forceinline__ Layout make_layout(int ring_bytes, int merge_bytes,
                                                       int q_bytes, int p_bytes) {
  Layout L;
  L.q = align128(2 * ring_bytes > merge_bytes ? 2 * ring_bytes : merge_bytes);
  L.p = L.q + align128(q_bytes);
  L.scales = L.p + align128(p_bytes);
  L.pages = L.scales + 128 + kBlockRows * 4;  // scales, then the rows' positions
  L.bytes = L.pages + kMaxSplitPages * 4;
  return L;
}

template <int D>
constexpr int kMergeBytes = kWarps * kTileRows * (D + 2) * 4;

// warps a chunk: the warps split a block's rows into tiles of 16, and the
// chunks among the warps of a tile
__host__ __device__ __forceinline__ int warps_a_chunk(int rows) {
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  return kWarps / tiles > 1 ? kWarps / tiles : 1;
}

// What one block works on: its slot, kv head and row group, its split's
// pages, its rows and how its warps share them.
struct BlockPlan {
  int b, hk, grp, x, rep, row0, rows, ks_n, wr, ks, n_chunks, pg0, cpp;
  SlotSpan sp;
};

__device__ __forceinline__ bool plan_block(const PagedArgs& a, BlockPlan& p) {
  p.x = blockIdx.x;
  p.hk = blockIdx.y / a.groups;
  p.grp = blockIdx.y % a.groups;
  p.b = blockIdx.z;
  p.sp = slot_span(a, p.b);
  if (p.x >= p.sp.n_live) return false;
  const int split = p.sp.first_split + p.x;
  p.pg0 = max(split * a.split_pages, p.sp.page_lo);
  const int pg1 = min((split + 1) * a.split_pages, p.sp.page_hi);
  p.rep = a.heads / a.kv_heads;
  p.row0 = p.grp * kBlockRows;
  p.rows = min(kBlockRows, a.s * p.rep - p.row0);
  const int wr_n = (p.rows + kTileRows - 1) / kTileRows;
  p.ks_n = warps_a_chunk(p.rows);
  const int warp = threadIdx.x / 32;
  p.wr = warp / p.ks_n;
  p.ks = warp % p.ks_n;
  if (p.wr >= wr_n) p.wr = -1;  // an idle warp (three row tiles)
  p.cpp = (a.page_size + kChunkKeys - 1) / kChunkKeys;
  p.n_chunks = (pg1 - p.pg0) * p.cpp;
  return true;
}

// q row r of the block (block row, not slot row) -> its element offset
__device__ __forceinline__ long q_row_offset(const PagedArgs& a, const BlockPlan& p, int r) {
  const int rr = p.row0 + r, i = rr / p.rep, g = rr - i * p.rep;
  return (((long)p.b * a.heads + (long)p.hk * p.rep + g) * a.s + i) * a.d;
}

// Issue stage t's chunks: chunk t * ks_n + k goes to ring slot (t % kStages)
// * ks_n + k; a quantized page's scales ride along (k's, then v's, kStages
// x 4 each).
template <typename P, int D, int kStages, bool kSwzV>
__device__ __forceinline__ void issue_stage(const PagedArgs& a, const BlockPlan& p, int t,
                                            P* ring_k, P* ring_v, float* scales,
                                            const int* pages) {
  const int slot = t % kStages;
  for (int k = 0; k < p.ks_n; ++k) {
    const int c = t * p.ks_n + k;
    if (c >= p.n_chunks) break;
    const int page = pages[c / p.cpp];
    const int sub = (c % p.cpp) * kChunkKeys;
    const int nk = min(kChunkKeys, a.page_size - sub);
    const long base = (((long)page * a.kv_heads + p.hk) * a.page_size + sub) * a.d;
    const int at = (slot * p.ks_n + k) * kChunkKeys * D;
    stage_rows<P, D, true>(ring_k + at, static_cast<const P*>(a.k_pages) + base, nk, a.d,
                           a.vec);
    stage_rows<P, D, kSwzV>(ring_v + at, static_cast<const P*>(a.v_pages) + base, nk, a.d,
                            a.vec);
    if (a.k_scales != nullptr && threadIdx.x < 2) {
      const float* src = (threadIdx.x == 0 ? a.k_scales : a.v_scales) +
                         (long)page * a.kv_heads + p.hk;
      mma_tile::cp_async_4(scales + threadIdx.x * kStages * kWarps + slot * p.ks_n + k, src, 4);
    }
  }
}

// The positions chunk c of the block covers: pos0 .. pos0 + nk - 1
__device__ __forceinline__ void chunk_pos(const PagedArgs& a, const BlockPlan& p, int c,
                                          int& pos0, int& nk) {
  const int page = p.pg0 + c / p.cpp;
  const int sub = (c % p.cpp) * kChunkKeys;
  pos0 = page * a.page_size + sub;
  nk = min(kChunkKeys, a.page_size - sub);
}

// The walk: the ring primed kStages - 1 deep, then one barrier a stage;
// fold(c, ring slot) runs on every warp with rows for its chunks.
template <typename P, int D, int kStages, bool kSwzV, typename Fold>
__device__ __forceinline__ void walk(const PagedArgs& a, const BlockPlan& p, P* ring_k,
                                     P* ring_v, float* scales, const int* pages, Fold&& fold) {
  const int n_stages = (p.n_chunks + p.ks_n - 1) / p.ks_n;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_stages) issue_stage<P, D, kStages, kSwzV>(a, p, t, ring_k, ring_v, scales, pages);
    mma_tile::cp_async_commit();
  }
  for (int t = 0; t < n_stages; ++t) {
    mma_tile::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t has landed; every warp is done with stage t - 1
    if (t + kStages - 1 < n_stages)
      issue_stage<P, D, kStages, kSwzV>(a, p, t + kStages - 1, ring_k, ring_v, scales, pages);
    mma_tile::cp_async_commit();
    const int c = t * p.ks_n + p.ks;
    if (p.wr >= 0 && c < p.n_chunks) fold(c, (t % kStages) * p.ks_n + p.ks);
  }
  mma_tile::cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' states take its place
}

// Merge the warps that shared the block's keys (warp order) and write: the
// rows themselves when the slot has one live split, else the split's
// partial. mg: per warp 16 rows of acc (stride D), then (m, l) per row.
template <typename T, int D>
__device__ __forceinline__ void finish_block(const PagedArgs& a, const BlockPlan& p,
                                             const float* mg) {
  const float* mg_ml = mg + kWarps * kTileRows * D;
  const bool direct = p.sp.n_live == 1;
  const long slot_part =
      ((((long)p.b * a.kv_heads + p.hk) * a.groups + p.grp) * a.grid_splits + p.x) *
      a.block_rows;
  for (int e = threadIdx.x; e < p.rows * a.d; e += kThreads) {
    const int r = e / a.d, c = e - r * a.d;
    const int w0 = (r / kTileRows) * p.ks_n, rr = r % kTileRows;
    float m = -INFINITY;
    for (int k = 0; k < p.ks_n; ++k) m = fmaxf(m, mg_ml[((w0 + k) * kTileRows + rr) * 2]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
      for (int k = 0; k < p.ks_n; ++k) {
        const int w = (w0 + k) * kTileRows + rr;
        const float mk = mg_ml[w * 2];
        const float wt = mk == -INFINITY ? 0.f : expf(mk - m);
        acc += mg[w * D + c] * wt;
        l += mg_ml[w * 2 + 1] * wt;
      }
    }
    if (direct) {
      static_cast<T*>(a.out)[q_row_offset(a, p, r) + c] = from_f32<T>(l == 0.f ? 0.f : acc / l);
    } else {
      a.part[(slot_part + r) * a.d + c] = acc;
      if (c == 0) {
        float* ml = a.part + (long)gridDim.z * a.kv_heads * a.groups * a.grid_splits *
                                 a.block_rows * a.d;
        ml[(slot_part + r) * 2] = m;
        ml[(slot_part + r) * 2 + 1] = l;
      }
    }
  }
}

// ---- fp32 math on the CUDA cores --------------------------------------------

// q fp32 (pages fp32, int8 or e4m3) or bf16 (pages int8 or e4m3); D = 64
// (d <= 64) or 128; RT: the rows a warp may carry (1, 4, or 16 for blocks
// of more than 4 rows; up to 4, at most 168 registers: three blocks an SM).
// Ring stages: 2 for fp32 pages at D = 128 (64 KB a stage), else 3.
template <typename P, int D>
constexpr int kSimtStages = sizeof(P) == 4 && D == 128 ? 2 : 3;
template <typename P, int D, int RT>
__host__ __device__ __forceinline__ Layout simt_layout(int rows) {
  return make_layout(kSimtStages<P, D> * warps_a_chunk(rows) * kChunkKeys * D *
                         static_cast<int>(sizeof(P)),
                     kMergeBytes<D>, rows * D * 4, kWarps * RT * kChunkKeys * 4);
}

template <typename T, typename P, int D, int RT>
__global__ void __launch_bounds__(kThreads, RT <= 4 ? 3 : 1)
paged_split_simt_kernel(PagedArgs a) {
  constexpr int kStages = kSimtStages<P, D>;
  constexpr int kHalf = D / 2;                       // dims of a lane's half row
  constexpr int kCh = kRowChunks<P, D>;
  constexpr int kEpc = 16 / static_cast<int>(sizeof(P));
  constexpr int kDl = D / 32;                        // PV dims a lane owns
  extern __shared__ __align__(128) unsigned char smem[];

  BlockPlan p;
  if (!plan_block(a, p)) return;
  const Layout L = simt_layout<P, D, RT>(p.rows);
  P* ring_k = reinterpret_cast<P*>(smem);
  P* ring_v = ring_k + kStages * p.ks_n * kChunkKeys * D;
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* pbuf = reinterpret_cast<float*>(smem + L.p);
  float* scales = reinterpret_cast<float*>(smem + L.scales);
  int* pages = reinterpret_cast<int*>(smem + L.pages);
  int* qpos = reinterpret_cast<int*>(smem + L.scales + 128);  // each block row's position

  const int n_pages = (p.n_chunks + p.cpp - 1) / p.cpp;
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    pages[i] = a.block_tables[(long)p.b * a.max_pages + p.pg0 + i];
  for (int r = threadIdx.x; r < p.rows; r += kThreads)
    qpos[r] = p.sp.len - a.s + (p.row0 + r) / p.rep;
  for (int e = threadIdx.x; e < p.rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[e] = c < a.d ? to_f32<T>(static_cast<const T*>(a.q)[q_row_offset(a, p, r) + c]) : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int key = lane & 15, half = lane >> 4;
  const int tile0 = max(p.wr, 0) * kTileRows;        // the warp's first block row
  const int nr = min(RT, p.rows - tile0);
  const int* qp = qpos + tile0;
  float m[RT], l[RT], acc[RT][kDl];
#pragma unroll
  for (int rr = 0; rr < RT; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < kDl; ++j) acc[rr][j] = 0.f;
  }
  float* pb = pbuf + warp * RT * kChunkKeys;         // p of (key, row) at key * RT + row
  const float* qw = qs + tile0 * D + half * kHalf;

  walk<P, D, kStages, false>(a, p, ring_k, ring_v, scales, pages, [&](int c, int slot) {
    int pos0, nk;
    chunk_pos(a, p, c, pos0, nk);
    const P* kt = ring_k + slot * kChunkKeys * D;
    const P* vt = ring_v + slot * kChunkKeys * D;
    const float score_scale =
        a.k_scales != nullptr ? a.scale * scales[(0 * kStages) * kWarps + slot] : a.scale;
    const float v_scale = a.k_scales != nullptr ? scales[(1 * kStages) * kWarps + slot] : 1.f;
    // this lane's half of key `key`'s row, widened
    float kr[kHalf];
#pragma unroll
    for (int i = 0; i < kCh / 2; ++i) {
      const int pc = (half * (kCh / 2) + i) ^ (key & kSwzMask<P, D>);
      widen16<P>(*reinterpret_cast<const uint4*>(kt + key * D + pc * kEpc), kr + i * kEpc);
    }
    const int pos = pos0 + key;
    // every row of the tile without a branch, so that their chains
    // interleave; a row past the block's (rr >= nr) sees no key and keeps
    // its state: m -inf, l 0, acc 0
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      const float* qrow = qw + min(rr, nr - 1) * D;
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; i += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + i);
        d0 = fmaf(qv.x, kr[i], d0);
        d1 = fmaf(qv.y, kr[i + 1], d1);
        d2 = fmaf(qv.z, kr[i + 2], d2);
        d3 = fmaf(qv.w, kr[i + 3], d3);
      }
      float dot = (d0 + d1) + (d2 + d3);
      dot += __shfl_xor_sync(0xffffffffu, dot, 16);  // the other half of the row
      const int qr = qp[min(rr, nr - 1)];
      const bool valid =
          rr < nr && key < nk && pos <= qr && (a.window <= 0 || pos > qr - a.window);
      const float sc = valid ? __fmul_rn(dot, score_scale) : -INFINITY;
      float tmax = sc;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
      // both halves hold the same scores; a chunk the row sees nothing of
      // leaves m (m_new == m: alpha 1), and one before any visible key
      // leaves the empty state (alpha 1, p 0)
      const float m_new = fmaxf(m[rr], tmax);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[rr] - m_new);
      const float pr = valid ? expf(sc - m_new) : 0.f;
      l[rr] = l[rr] * alpha + pr;  // this lane's key; summed over the keys at the end
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < kDl; ++j) acc[rr][j] *= alpha;
      if (half == 0) pb[key * RT + rr] = pr * v_scale;
    }
    __syncwarp();
    // O += p V: lane owns the kDl dims from lane * kDl; keys past nk carry
    // p = 0 (their rows zero-filled)
#pragma unroll 4
    for (int kk = 0; kk < kChunkKeys; ++kk) {
      float v[kDl];
      load_widen<P, kDl>(vt + kk * D + lane * kDl, v);
      float pk[RT];
#pragma unroll
      for (int rr = 0; rr < RT; rr += (RT >= 4 ? 4 : 1)) {
        if constexpr (RT >= 4) {
          const float4 p4 = *reinterpret_cast<const float4*>(pb + kk * RT + rr);
          pk[rr] = p4.x;
          pk[rr + 1] = p4.y;
          pk[rr + 2] = p4.z;
          pk[rr + 3] = p4.w;
        } else {
          pk[rr] = pb[kk * RT + rr];
        }
      }
#pragma unroll
      for (int rr = 0; rr < RT; ++rr)
#pragma unroll
        for (int j = 0; j < kDl; ++j) acc[rr][j] = fmaf(pk[rr], v[j], acc[rr][j]);
    }
    __syncwarp();
  });

  // this warp's state into the merge region (the ring's place)
  float* mg = reinterpret_cast<float*>(smem);
  float* mg_ml = mg + kWarps * kTileRows * D;
  if (p.wr >= 0) {
#pragma unroll
    for (int rr = 0; rr < RT; ++rr) {
      float lr = l[rr];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) lr += __shfl_xor_sync(0xffffffffu, lr, o);
      if (rr < nr) {
#pragma unroll
        for (int j = 0; j < kDl; ++j)
          mg[(warp * kTileRows + rr) * D + lane * kDl + j] = acc[rr][j];
        if (lane == 0) {
          mg_ml[(warp * kTileRows + rr) * 2] = m[rr];
          mg_ml[(warp * kTileRows + rr) * 2 + 1] = lr;
        }
      }
    }
  }
  __syncthreads();
  finish_block<T, D>(a, p, mg);
}

// ---- bf16 over a bf16 pool on the tensor cores ------------------------------

// two ring stages and 168 registers a thread: three blocks an SM, a
// stage's copy in flight while the other is read
constexpr int kMmaStages = 2;
template <int D>
__host__ __device__ __forceinline__ Layout mma_layout(int rows) {
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  return make_layout(kMmaStages * warps_a_chunk(rows) * kChunkKeys * D * 2, kMergeBytes<D>,
                     tiles * kTileRows * D * 2, 0);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3)
paged_split_mma_kernel(PagedArgs a) {
  using namespace mma_tile;
  extern __shared__ __align__(128) unsigned char smem[];

  BlockPlan p;
  if (!plan_block(a, p)) return;
  const Layout L = mma_layout<D>(p.rows);
  bf16* ring_k = reinterpret_cast<bf16*>(smem);
  bf16* ring_v = ring_k + kMmaStages * p.ks_n * kChunkKeys * D;
  bf16* qs = reinterpret_cast<bf16*>(smem + L.q);
  int* pages = reinterpret_cast<int*>(smem + L.pages);
  const int q_rows = (p.rows + kTileRows - 1) / kTileRows * kTileRows;

  const int n_pages = (p.n_chunks + p.cpp - 1) / p.cpp;
  for (int i = threadIdx.x; i < n_pages; i += kThreads)
    pages[i] = a.block_tables[(long)p.b * a.max_pages + p.pg0 + i];
  for (int e = threadIdx.x; e < q_rows * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[swz<D>(r, c)] = r < p.rows && c < a.d
                           ? static_cast<const bf16*>(a.q)[q_row_offset(a, p, r) + c]
                           : __float2bfloat16(0.f);
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tile0 = max(p.wr, 0) * kTileRows;
  const uint32_t swz_x = (lane & 7) << 4;
  uint32_t qf[D / 16][4];
  {
    const uint32_t q_lane = smem_addr(qs) + (tile0 + (lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 +
                            (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], (q_lane + kk * 32) ^ swz_x);
  }
  // this thread's rows: tile0 + g and tile0 + g + 8
  int qpos[2];
  bool row_in[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = tile0 + frag_row(lane, 2 * h);
    row_in[h] = r < p.rows;
    qpos[h] = p.sp.len - a.s + (p.row0 + r) / p.rep;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  const uint32_t k_base = smem_addr(ring_k) + (lane & 7) * D * 2 + (lane >> 3) * 16;
  const uint32_t v_base =
      smem_addr(ring_v) + ((lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 + (lane >> 4) * 16;

  walk<bf16, D, kMmaStages, true>(a, p, ring_k, ring_v, nullptr, pages, [&](int c, int slot) {
    int pos0, nk;
    chunk_pos(a, p, c, pos0, nk);
    const uint32_t kt = k_base + slot * kChunkKeys * D * 2;
    const uint32_t vt = v_base + slot * kChunkKeys * D * 2;
    // S = Q K^T over the chunk's 16 keys: two n-tiles of 8
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kp = 0; kp < D / 32; ++kp) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t kf[4];
        ldmatrix_x4(kf, (kt + nt * 8 * D * 2 + kp * 64) ^ swz_x);
        mma_bf16(s[nt], qf[2 * kp], kf[0], kf[1]);
        mma_bf16(s[nt], qf[2 * kp + 1], kf[2], kf[3]);
      }
    }
    // scale and mask, then the online softmax per row across its quad
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = nt * 8 + frag_col(lane, e);
          const int pos = pos0 + kk;
          const bool valid = row_in[h] && kk < nk && pos <= qpos[h] &&
                             (a.window <= 0 || pos > qpos[h] - a.window);
          float& x = s[nt][2 * h + e];
          x = valid ? __fmul_rn(x, a.scale) : -INFINITY;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[h], tmax);
      // a row that has seen no key yet keeps p = 0 (exp(-inf)) and acc 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f((m[h] - m_use) * kLog2e);
      const float m_log2 = m_use * kLog2e;
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * h + e];
          x = exp2f(fmaf(x, kLog2e, -m_log2));
          sum += x;
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
    }
    // O += P V, P as two bf16 parts (hi + lo); V rows are B's rows
    uint32_t hi[4], lo[4];
    split_a_frag(s[0], s[1], hi, lo);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, (vt + dp * 32) ^ swz_x);
      mma_bf16(acc[2 * dp], hi, vf[0], vf[1]);
      mma_bf16(acc[2 * dp + 1], hi, vf[2], vf[3]);
      mma_bf16(acc[2 * dp], lo, vf[0], vf[1]);
      mma_bf16(acc[2 * dp + 1], lo, vf[2], vf[3]);
    }
  });

  float* mg = reinterpret_cast<float*>(smem);
  float* mg_ml = mg + kWarps * kTileRows * D;
  if (p.wr >= 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int rr = frag_row(lane, 2 * h);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        mg[(warp * kTileRows + rr) * D + j * 8 + frag_col(lane, 0)] = acc[j][2 * h];
        mg[(warp * kTileRows + rr) * D + j * 8 + frag_col(lane, 1)] = acc[j][2 * h + 1];
      }
      if (lane % 4 == 0) {
        mg_ml[(warp * kTileRows + rr) * 2] = m[h];
        mg_ml[(warp * kTileRows + rr) * 2 + 1] = l[h];
      }
    }
  }
  __syncthreads();
  finish_block<bf16, D>(a, p, mg);
}

// ---- the merge of a slot's splits --------------------------------------------

// One block per (row, kv head x row group, slot): a slot with one live split
// was written by its split; otherwise the row's splits are merged in split
// order, each thread one dimension: m the largest m_i, each split weighed by
// exp(m_i - m) (0 for one that saw nothing), acc and l summed in split
// order, every load independent of the others (a slot with no live split,
// length 0 or a table too narrow, outputs 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_merge_kernel(PagedArgs a) {
  const int r = blockIdx.x;
  const int hk = blockIdx.y / a.groups, grp = blockIdx.y % a.groups, b = blockIdx.z;
  const SlotSpan sp = slot_span(a, b);
  const int rep = a.heads / a.kv_heads;
  const int row0 = grp * kBlockRows, rows = min(kBlockRows, a.s * rep - row0);
  if (sp.n_live == 1 || r >= rows) return;
  const int n = sp.n_live;
  // the row's entry in split i: at + i * block_rows
  const long at = (((long)b * a.kv_heads + hk) * a.groups + grp) * a.grid_splits * a.block_rows + r;
  const float* ml = a.part + (long)gridDim.z * a.kv_heads * a.groups * a.grid_splits *
                                 a.block_rows * a.d;
  const int rr = row0 + r, qi = rr / rep, g = rr - qi * rep;
  T* out = static_cast<T*>(a.out) + (((long)b * a.heads + (long)hk * rep + g) * a.s + qi) * a.d;
  for (int c = threadIdx.x; c < a.d; c += kThreads) {
    float m = -INFINITY;
#pragma unroll 8
    for (int i = 0; i < n; ++i) m = fmaxf(m, ml[(at + (long)i * a.block_rows) * 2]);
    float acc = 0.f, l = 0.f;
    if (m != -INFINITY) {
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const long e = at + (long)i * a.block_rows;
        const float mi = ml[e * 2];
        const float wt = mi == -INFINITY ? 0.f : expf(mi - m);
        l += ml[e * 2 + 1] * wt;
        acc += a.part[e * a.d + c] * wt;
      }
    }
    out[c] = from_f32<T>(l == 0.f ? 0.f : acc / l);
  }
}

// ---- launches ----------------------------------------------------------------

// Opt a kernel into the most dynamic shared memory any block of it takes
// (above 48 KB), once per device and instance; layout(rows) sizes a block.
template <typename K, typename F>
int opt_in(K kernel, F layout, int* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && opted[dev]) return 0;
  int most = 0;
  for (int rows = 1; rows <= kBlockRows; ++rows) most = std::max(most, layout(rows).bytes);
  if (most > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dev < 64) opted[dev] = 1;
  return 0;
}

// the bytes of the launch's largest block: its row groups hold block_rows
// rows, the last one rows_last
template <typename F>
int launch_bytes(F layout, const PagedArgs& a, int rows_last) {
  return std::max(layout(a.block_rows).bytes, layout(rows_last).bytes);
}

template <typename T, typename P, int D, int RT>
int launch_simt(const PagedArgs& a, dim3 grid, int rows_last, cudaStream_t st) {
  static int opted[64] = {};
  const auto layout = [](int rows) { return simt_layout<P, D, RT>(rows); };
  const int err = opt_in(paged_split_simt_kernel<T, P, D, RT>, layout, opted);
  if (err) return err;
  paged_split_simt_kernel<T, P, D, RT>
      <<<grid, kThreads, launch_bytes(layout, a, rows_last), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const PagedArgs& a, dim3 grid, int rows_last, cudaStream_t st) {
  static int opted[64] = {};
  const auto layout = [](int rows) { return mma_layout<D>(rows); };
  const int err = opt_in(paged_split_mma_kernel<D>, layout, opted);
  if (err) return err;
  paged_split_mma_kernel<D><<<grid, kThreads, launch_bytes(layout, a, rows_last), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P, int D>
int launch_split_d(const PagedArgs& a, dim3 grid, int rows_last, cudaStream_t st) {
  if (a.block_rows == 1) return launch_simt<T, P, D, 1>(a, grid, rows_last, st);
  if (a.block_rows <= 4) return launch_simt<T, P, D, 4>(a, grid, rows_last, st);
  return launch_simt<T, P, D, 16>(a, grid, rows_last, st);
}

// the CUDA cores' instance: the head-dim bucket and the rows a warp carries
template <typename T, typename P>
int launch_split(const PagedArgs& a, dim3 grid, int rows_last, cudaStream_t st) {
  return a.d > 64 ? launch_split_d<T, P, 128>(a, grid, rows_last, st)
                  : launch_split_d<T, P, 64>(a, grid, rows_last, st);
}

// The split pass, then the merge: two launches a call, on `st`.
template <typename T, typename P>
int run(PagedArgs a, int batch, cudaStream_t st) {
  const int rows = a.s * (a.heads / a.kv_heads);
  a.groups = (rows + kBlockRows - 1) / kBlockRows;
  a.block_rows = min(rows, kBlockRows);
  if (a.split_pages < 1 || a.split_pages > kMaxSplitPages || a.grid_splits < 1 || a.d > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elt = static_cast<int>(sizeof(P));
  a.vec = (a.d * elt) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(a.k_pages) | reinterpret_cast<uintptr_t>(a.v_pages)) &
           15) == 0;
  const dim3 grid(a.grid_splits, a.kv_heads * a.groups, batch);
  const int rows_last = rows - (a.groups - 1) * kBlockRows;
  int err;
  if constexpr (std::is_same<T, bf16>::value && std::is_same<P, bf16>::value) {
    // bf16 over a bf16 pool: the tensor cores, every row count (element
    // copies where the rows are no whole 16-byte chunks: the same tiles)
    err = a.d > 64 ? launch_mma<128>(a, grid, rows_last, st)
                   : launch_mma<64>(a, grid, rows_last, st);
  } else {
    err = launch_split<T, P>(a, grid, rows_last, st);
  }
  if (err) return err;
  paged_merge_kernel<T><<<dim3(a.block_rows, a.kv_heads * a.groups, batch), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

PagedArgs make_args(const void* q, const void* kp, const void* vp, const void* ksc,
                    const void* vsc, const void* bt, const void* len, void* out, void* part,
                    int heads, int kv_heads, int s, int page_size, int d, int max_pages,
                    float scale, int window, int split_pages, int grid_splits) {
  PagedArgs a;
  a.q = q;
  a.k_pages = kp;
  a.v_pages = vp;
  a.k_scales = static_cast<const float*>(ksc);
  a.v_scales = static_cast<const float*>(vsc);
  a.block_tables = static_cast<const int*>(bt);
  a.lengths = static_cast<const int*>(len);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.s = s;
  a.page_size = page_size;
  a.d = d;
  a.max_pages = max_pages;
  a.scale = scale;
  a.window = window;
  a.split_pages = split_pages;
  a.grid_splits = grid_splits;
  a.groups = 1;
  a.block_rows = 1;
  a.vec = 0;
  return a;
}

}  // namespace

// s: query positions per slot (1 <= s <= page_size); window: the sliding
// window in positions, 0 = none; part: fp32 scratch of batch x kv_heads x
// row groups x grid_splits x min(s * rep, 64) x (d + 2) values;
// split_pages, grid_splits: ops/paged_attention.py::paged_split_plan
extern "C" int apex_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const void* block_tables, const void* lengths, void* out,
                                    void* part, int batch, int heads, int kv_heads, int s,
                                    int page_size, int d, int max_pages, float scale,
                                    int window, int split_pages, int grid_splits, int dtype,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const PagedArgs a = make_args(q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths,
                                out, part, heads, kv_heads, s, page_size, d, max_pages, scale,
                                window, split_pages, grid_splits);
  if (dtype == APEX_BF16) return run<bf16, bf16>(a, batch, st);
  return run<float, float>(a, batch, st);
}

// q of `dtype` (f32 or bf16), pages of `page_dtype` (APEX_I8 or APEX_E4M3),
// scales fp32 (num_pages, kv_heads); the rest as apex_paged_attention's
extern "C" int apex_paged_attention_quant(const void* q, const void* k_pages,
                                          const void* v_pages, const void* k_scales,
                                          const void* v_scales, const void* block_tables,
                                          const void* lengths, void* out, void* part,
                                          int batch, int heads, int kv_heads, int s,
                                          int page_size, int d, int max_pages, float scale,
                                          int window, int split_pages, int grid_splits,
                                          int dtype, int page_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const PagedArgs a = make_args(q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths,
                                out, part, heads, kv_heads, s, page_size, d, max_pages, scale,
                                window, split_pages, grid_splits);
  if (dtype == APEX_BF16) {
    if (page_dtype == APEX_E4M3) return run<bf16, __nv_fp8_e4m3>(a, batch, st);
    return run<bf16, int8_t>(a, batch, st);
  }
  if (page_dtype == APEX_E4M3) return run<float, __nv_fp8_e4m3>(a, batch, st);
  return run<float, int8_t>(a, batch, st);
}
