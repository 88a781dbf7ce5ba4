// Paged attention over the KV page pool: s = 1 decode and s > 1 query
// blocks (a speculative verify chunk, a chunked-prefill piece).
//
// Replaces the TPU kernel apex_tpu/ops/paged_attention.py::_paged_kernel
// (pallas_call in paged_attention), with or without a sliding window, in
// its two branches: an fp32 or bf16 pool (paged_decode_kernel, entry point
// apex_paged_attention), and a quantized pool of int8 or fp8 e4m3 pages
// with fp32 per-(page, kv head) scales (paged_decode_quant_kernel, entry
// point apex_paged_attention_quant; the reference's quantized branch,
// _paged_kernel lines 108-121 and 141-143). The page type is a template
// parameter apart from q's type. The pool is (num_pages, kv_heads,
// page_size, D); slot b's position p lives in page
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
// row's band floor (the reference's dead-page gate, line 102): the walk
// starts at the page holding that floor, lengths[b] - s - w + 1.
//
// Design: one block of 4 warps per (kv head, slot, group of 16 rows): the
// grid is (kv_heads, batch, ceil(s * rep / 16)). A block walks the pages its
// rows need, from the page holding its earliest row's band floor to the
// one holding its last row's position, staging each page 32 positions at a
// time in shared memory as fp32; its rows are spread over the warps, each
// carrying its online-softmax state in registers (attention_common.cuh),
// and only the per-row mask differs between rows. The TPU kernel's
// sequential page axis becomes the loop inside the block. At s = 1 with
// rep <= 16 the grid has one group and the walk and masks reduce to the
// decode kernel's: the last row's position is lengths[b] - 1, the floor
// lengths[b] - w.
//
// The cost of the row groups: a block of s * rep > 16 rows is split into
// groups that each walk the slot's pages again (mostly from L2), so the
// pages' bytes are read ceil(s * rep / 16) times per kv head. GPT-2 (rep 1)
// verifies s = 4 and feeds chunks of s = 16 in one group; Mistral-7B (rep
// 4) at s = 16 takes 4 groups.
//
// What bounds it on the H100: bytes. Each live page is read once per kv head
// (2 * page_size * D elements) for ~4 * s * rep * page_size * D FLOPs, far
// below the card's ~295 FLOP/byte balance point. With one block per (slot,
// kv head, group) an 8-slot, 12-head batch fills only 96 of the 132 SMs and
// each block streams its pages serially; splitting a slot's pages across
// blocks (flash-decode) is the next step.
//
// The quantized branch reads a page at 1 byte per value, widened to fp32 as
// it is staged, and the two scales of (page, kv head) through the same
// block-table entry. The k scale folds into the score scale (scores are
// q.k * scale * k_scale), the v scale into the probabilities that enter the
// PV product (p * v_scale), while the denominator l sums the unscaled p, as
// in the reference. A page's dequantized values never exist in memory.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kGroupRows = 16;  // query rows per block
constexpr int kRowsPerWarp = kGroupRows / kWarps;

// q and out of type T, pages of type P; k_scales/v_scales (num_pages,
// kv_heads) fp32, or null for an unquantized pool
template <typename T, typename P>
__device__ __forceinline__ void paged_block(const T* __restrict__ q, const P* __restrict__ k_pages,
                                            const P* __restrict__ v_pages,
                                            const float* __restrict__ k_scales,
                                            const float* __restrict__ v_scales,
                                            const int* __restrict__ block_tables,
                                            const int* __restrict__ lengths, T* __restrict__ out,
                                            int heads, int kv_heads, int s, int page_size, int d,
                                            int max_pages, float scale, int window) {
  __shared__ float qs[kGroupRows][kMaxHeadDim];
  __shared__ float ks[kTileKeys * kTileStride];
  __shared__ float vs[kTileKeys * kTileStride];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = heads / kv_heads;
  const int rows = s * rep;
  const int row0 = blockIdx.z * kGroupRows;
  const int nrows = min(kGroupRows, rows - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = max(lengths[b], 0);
  // the block's rows sit at positions first_q .. last_q
  const int first_q = len - s + row0 / rep;
  const int last_q = len - s + (row0 + nrows - 1) / rep;

  // row r = i * rep + g is q[b, hk * rep + g, i]
  for (int e = threadIdx.x; e < nrows * d; e += blockDim.x) {
    const int rr = e / d, c = e - rr * d;
    const int r = row0 + rr, i = r / rep, g = r - i * rep;
    qs[rr][c] = to_f32<T>(q[(((long)b * heads + (long)hk * rep + g) * s + i) * d + c]);
  }

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) row_init(st[rr]);

  const int* table = block_tables + (long)b * max_pages;
  // one past the last position any row sees, and the band floor of the
  // earliest row (its first visible position)
  const int hi = min(last_q + 1, max_pages * page_size);
  const int lo = window > 0 ? max(first_q - window + 1, 0) : 0;
  const int live_pages = (hi + page_size - 1) / page_size;
  for (int j = lo / page_size; j < live_pages; ++j) {
    const long page = table[j];
    const long base = (page * kv_heads + hk) * page_size * d;
    // this page's dequant scales: k's joins the score scale, v's weighs p
    // in the PV product only (row_fold's `keep`)
    const float k_scale = k_scales != nullptr ? k_scales[page * kv_heads + hk] : 1.f;
    const float v_scale = v_scales != nullptr ? v_scales[page * kv_heads + hk] : 1.f;
    for (int c0 = 0; c0 < page_size; c0 += kTileKeys) {
      const int nk = min(min(kTileKeys, page_size - c0), hi - (j * page_size + c0));
      if (nk <= 0) break;
      __syncthreads();  // previous tile fully consumed (and qs visible)
      load_tile<P>(ks, k_pages + base + (long)c0 * d, nk, d, d);
      load_tile<P>(vs, v_pages + base + (long)c0 * d, nk, d, d);
      __syncthreads();
      const int pos = j * page_size + c0 + lane;
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp + rr * kWarps;
        if (r >= nrows) continue;  // warp-uniform
        const int qpos = len - s + (row0 + r) / rep;
        const bool valid =
            lane < nk && pos <= qpos && (window <= 0 || pos > qpos - window);
        row_fold(st[rr], qs[r], ks, vs, d, valid, scale * k_scale, lane, v_scale);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= nrows) continue;
    const int i = (row0 + r) / rep, g = (row0 + r) - i * rep;
    row_store<T>(st[rr], out + (((long)b * heads + (long)hk * rep + g) * s + i) * d, d, lane);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int heads,
                    int kv_heads, int s, int page_size, int d, int max_pages, float scale,
                    int window) {
  paged_block<T, T>(q, k_pages, v_pages, nullptr, nullptr, block_tables, lengths, out, heads,
                    kv_heads, s, page_size, d, max_pages, scale, window);
}

template <typename T, typename P>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_quant_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                          const P* __restrict__ v_pages, const float* __restrict__ k_scales,
                          const float* __restrict__ v_scales,
                          const int* __restrict__ block_tables, const int* __restrict__ lengths,
                          T* __restrict__ out, int heads, int kv_heads, int s, int page_size,
                          int d, int max_pages, float scale, int window) {
  paged_block<T, P>(q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, out, heads,
                    kv_heads, s, page_size, d, max_pages, scale, window);
}

dim3 grid_of(int batch, int heads, int kv_heads, int s) {
  const int rows = s * (heads / kv_heads);
  return dim3(kv_heads, batch, (rows + kGroupRows - 1) / kGroupRows);
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const int* bt, const int* len,
            void* out, int batch, int heads, int kv_heads, int s, int page_size, int d,
            int max_pages, float scale, int window, cudaStream_t stream) {
  paged_decode_kernel<T><<<grid_of(batch, heads, kv_heads, s), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, len,
      static_cast<T*>(out), heads, kv_heads, s, page_size, d, max_pages, scale, window);
}

template <typename T, typename P>
void launch_quant(const void* q, const void* kp, const void* vp, const float* ksc,
                  const float* vsc, const int* bt, const int* len, void* out, int batch,
                  int heads, int kv_heads, int s, int page_size, int d, int max_pages,
                  float scale, int window, cudaStream_t stream) {
  paged_decode_quant_kernel<T, P><<<grid_of(batch, heads, kv_heads, s), kWarps * 32, 0,
                                    stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp), ksc, vsc,
      bt, len, static_cast<T*>(out), heads, kv_heads, s, page_size, d, max_pages, scale,
      window);
}

template <typename T>
void launch_quant_pages(int page_dtype, const void* q, const void* kp, const void* vp,
                        const float* ksc, const float* vsc, const int* bt, const int* len,
                        void* out, int batch, int heads, int kv_heads, int s, int page_size,
                        int d, int max_pages, float scale, int window, cudaStream_t stream) {
  if (page_dtype == APEX_E4M3)
    launch_quant<T, __nv_fp8_e4m3>(q, kp, vp, ksc, vsc, bt, len, out, batch, heads, kv_heads,
                                   s, page_size, d, max_pages, scale, window, stream);
  else
    launch_quant<T, int8_t>(q, kp, vp, ksc, vsc, bt, len, out, batch, heads, kv_heads, s,
                            page_size, d, max_pages, scale, window, stream);
}

}  // namespace

// s: query positions per slot (1 <= s <= page_size); window: the sliding
// window in positions, 0 = none
extern "C" int apex_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const void* block_tables, const void* lengths, void* out,
                                    int batch, int heads, int kv_heads, int s, int page_size,
                                    int d, int max_pages, float scale, int window, int dtype,
                                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* bt = static_cast<const int*>(block_tables);
  auto* ln = static_cast<const int*>(lengths);
  if (dtype == APEX_BF16)
    launch<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, out, batch, heads, kv_heads, s,
                          page_size, d, max_pages, scale, window, st);
  else
    launch<float>(q, k_pages, v_pages, bt, ln, out, batch, heads, kv_heads, s, page_size, d,
                  max_pages, scale, window, st);
  return static_cast<int>(cudaGetLastError());
}

// q of `dtype` (f32 or bf16), pages of `page_dtype` (APEX_I8 or APEX_E4M3),
// scales fp32 (num_pages, kv_heads); s and window as apex_paged_attention's
extern "C" int apex_paged_attention_quant(const void* q, const void* k_pages,
                                          const void* v_pages, const void* k_scales,
                                          const void* v_scales, const void* block_tables,
                                          const void* lengths, void* out, int batch, int heads,
                                          int kv_heads, int s, int page_size, int d,
                                          int max_pages, float scale, int window, int dtype,
                                          int page_dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto* bt = static_cast<const int*>(block_tables);
  auto* ln = static_cast<const int*>(lengths);
  auto* ksc = static_cast<const float*>(k_scales);
  auto* vsc = static_cast<const float*>(v_scales);
  if (dtype == APEX_BF16)
    launch_quant_pages<__nv_bfloat16>(page_dtype, q, k_pages, v_pages, ksc, vsc, bt, ln, out,
                                      batch, heads, kv_heads, s, page_size, d, max_pages,
                                      scale, window, st);
  else
    launch_quant_pages<float>(page_dtype, q, k_pages, v_pages, ksc, vsc, bt, ln, out, batch,
                              heads, kv_heads, s, page_size, d, max_pages, scale, window, st);
  return static_cast<int>(cudaGetLastError());
}
