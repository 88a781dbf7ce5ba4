// Paged-attention decode (one query token per slot) over the KV page pool.
//
// Replaces the TPU kernel apex_tpu/ops/paged_attention.py::_paged_kernel
// (pallas_call in paged_attention), unquantized branch at s = 1 with no
// window. The pool is (num_pages, kv_heads, page_size, D); slot b's position
// p lives in page block_tables[b, p / page_size] at offset p % page_size.
// Query head h reads kv head h / rep without repeating it. The query sits at
// position lengths[b] - 1 and sees every position below lengths[b]. Pages at
// or past lengths[b] are never read (dead table entries point at the null
// page 0), and a slot of length 0 outputs exactly 0.
//
// Design: one block of 4 warps per (kv head, slot). The block walks the
// slot's live pages through its block table, staging each page 32 positions
// at a time in shared memory as fp32; the rep query heads of the group are
// spread over the warps, each carrying its online-softmax state in registers
// (attention_common.cuh). The TPU kernel's sequential page axis becomes the
// loop inside the block.
//
// What bounds it on the H100: bytes. Each live page is read once per kv head
// (2 * page_size * D elements) for ~4 * rep * page_size * D FLOPs, far below
// the card's ~295 FLOP/byte balance point. With one block per (slot, kv
// head) an 8-slot, 12-head batch fills only 96 of the 132 SMs and each block
// streams its pages serially; splitting a slot's pages across blocks
// (flash-decode) is the next step.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxRep = 16;
constexpr int kRowsPerWarp = kMaxRep / kWarps;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out, int heads,
                    int kv_heads, int page_size, int d, int max_pages, float scale) {
  __shared__ float qs[kMaxRep][kMaxHeadDim];
  __shared__ float ks[kTileKeys * kTileStride];
  __shared__ float vs[kTileKeys * kTileStride];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), max_pages * page_size);

  const T* qb = q + ((long)b * heads + (long)hk * rep) * d;
  for (int i = threadIdx.x; i < rep * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    qs[r][c] = to_f32<T>(qb[(long)r * d + c]);
  }

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) row_init(st[rr]);

  const int* table = block_tables + (long)b * max_pages;
  const int live_pages = (len + page_size - 1) / page_size;
  for (int j = 0; j < live_pages; ++j) {
    const long page = table[j];
    const long base = (page * kv_heads + hk) * page_size * d;
    for (int c0 = 0; c0 < page_size; c0 += kTileKeys) {
      const int nk = min(min(kTileKeys, page_size - c0), len - (j * page_size + c0));
      if (nk <= 0) break;
      __syncthreads();  // previous tile fully consumed (and qs visible)
      load_tile<T>(ks, k_pages + base + (long)c0 * d, nk, d, d);
      load_tile<T>(vs, v_pages + base + (long)c0 * d, nk, d, d);
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp + rr * kWarps;
        if (r >= rep) continue;  // warp-uniform
        row_fold(st[rr], qs[r], ks, vs, d, lane < nk, scale, lane, 1.f);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= rep) continue;
    row_store<T>(st[rr], out + ((long)b * heads + (long)hk * rep + r) * d, d, lane);
  }
}

template <typename T>
void launch(const void* q, const void* kp, const void* vp, const int* bt, const int* len,
            void* out, int batch, int heads, int kv_heads, int page_size, int d,
            int max_pages, float scale, cudaStream_t stream) {
  dim3 grid(kv_heads, batch);
  paged_decode_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), bt, len,
      static_cast<T*>(out), heads, kv_heads, page_size, d, max_pages, scale);
}

}  // namespace

extern "C" int apex_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                                    const void* block_tables, const void* lengths, void* out,
                                    int batch, int heads, int kv_heads, int page_size, int d,
                                    int max_pages, float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* bt = static_cast<const int*>(block_tables);
  auto* ln = static_cast<const int*>(lengths);
  if (dtype == APEX_BF16)
    launch<__nv_bfloat16>(q, k_pages, v_pages, bt, ln, out, batch, heads, kv_heads, page_size,
                          d, max_pages, scale, s);
  else
    launch<float>(q, k_pages, v_pages, bt, ln, out, batch, heads, kv_heads, page_size, d,
                  max_pages, scale, s);
  return static_cast<int>(cudaGetLastError());
}
