// Tensor-core tile helpers for the bf16 attention kernels: the m16n8k16
// bf16 mma.sync with fp32 accumulators, ldmatrix fragments, 16-byte
// cp.async copies into XOR-swizzled shared tiles, where each element of a
// fragment sits, and the scale, bias and masks applied to a score tile's
// accumulator fragments.
//
// A shared tile holds `rows` rows of D bf16 values (D a multiple of 64).
// Each row is D / 8 chunks of 16 bytes; logical chunk c of row r sits at
// chunk c ^ (r & 7). Eight consecutive rows read at one logical chunk (one
// 8 x 8 matrix of an ldmatrix) thus touch eight different 16-byte bank
// groups: ldmatrix, plain or transposed, is free of bank conflicts.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"): with g = lane / 4 and t = lane % 4, a thread holds
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                            a3 (g+8, 2t+8..), two bf16 per register;
//   B (16 x 8, col-major):   b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
//   C (16 x 8, fp32):        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace mma_tile {

// the row of a fragment's element: c[0..1] of row g, c[2..3] of row g + 8
__device__ __forceinline__ int frag_row(int lane, int i) { return lane / 4 + (i >= 2 ? 8 : 0); }
// the column (key or dim) of c[i] within its 8-wide n-tile
__device__ __forceinline__ int frag_col(int lane, int i) { return 2 * (lane % 4) + (i & 1); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of logical (row, col) in a swizzled tile of D columns
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// 16 bytes from global to shared memory, asynchronously; src_bytes 0
// fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 4 bytes from global to shared memory, asynchronously (a row's lse,
// delta or segment id); src_bytes 0 writes a zero and reads nothing
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the shared-window address (32
// bits: a loop keeps few registers for its addresses) of row l % 8 of
// matrix l / 8 and receives r[i], its fragment of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// the same, each matrix transposed (B fragments of a row-major [k][n] tile)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a b on the tensor cores: A 16 x 16 bf16, B 16 x 8 bf16, C fp32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as one register of two bf16, lo in the low half (the
// lower column), each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as two bf16 pairs, hi the rounded values and lo the rounded
// remainders a - hi.x, b - hi.y: hi + lo carries ~16 significant bits, so
// an A operand split so costs two products and keeps fp32 operands' value
// to ~2^-16 relative
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// The A fragments of the 16 x 16 block made of accumulator n-tiles x0 (its
// columns 0-7) and x1 (8-15), each value as two bf16 parts (split_bf16):
// an fp32 tile fed to a second product as A costs two products, hi and lo
__device__ __forceinline__ void split_a_frag(const float (&x0)[4], const float (&x1)[4],
                                             uint32_t hi[4], uint32_t lo[4]) {
  split_bf16(x0[0], x0[1], hi[0], lo[0]);
  split_bf16(x0[2], x0[3], hi[1], lo[1]);
  split_bf16(x1[0], x1[1], hi[2], lo[2]);
  split_bf16(x1[2], x1[3], hi[3], lo[3]);
}

// Copy rows [0, rows) of a [*, d] bf16 matrix (row stride d) into a
// swizzled tile of kRows x D; rows >= `rows` and columns >= d are zero.
// `vec`: d % 8 == 0 and src 16-byte aligned, so each chunk is one
// cp.async (the caller commits and waits); otherwise element loads,
// written with plain stores (visible after the caller's barrier). All
// threads of the block take part.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                                int rows, int d, bool vec) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kThreads == 0, "every thread copies as many chunks");
#pragma unroll
  for (int it = 0; it < kRows * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    __nv_bfloat16* dst = tile + r * D + ((c ^ (r & 7)) << 3);
    if (vec) {
      const bool in = r < rows && c * 8 < d;
      cp_async_16(dst, in ? src + (long)r * d + c * 8 : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = c * 8 + e;
        dst[e] = (r < rows && col < d) ? src[(long)r * d + col] : __float2bfloat16(0.f);
      }
    }
  }
}

// Scale, bias and mask a warp's 16 x (8 N) score tile in place, rows x
// keys (fp32 accumulators of Q K^T in; scores, -inf where hidden, out):
// this thread's rows are row0 and row0 + 8 (segment ids seg0, seg1), its
// keys k0 + nt * 8 + frag_col. Each score is the reference's fp32 scale *
// (q . k) + bias, each step rounded once. kFull: every pair is visible
// (AttnMask::tile_visible), so no per-element test.
template <bool kFull, int N>
__device__ __forceinline__ void score_tile(float (&s)[N][4], const AttnMask& mask, int b, int h,
                                           int sq, int sk, int k0, int row0, int seg0, int seg1,
                                           float scale, int lane) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      const int key = k0 + nt * 8 + frag_col(lane, 0);
      bool in0 = true, in1 = true;
      if (!kFull) {
        const bool row_in = row < sq;
        in0 = row_in && key < sk && mask.in_band(row, key);
        in1 = row_in && key + 1 < sk && mask.in_band(row, key + 1);
        if (mask.q_seg != nullptr) {
          const int seg = half ? seg1 : seg0;
          const int* kv = mask.kv_seg + (long)b * sk;
          in0 = in0 && kv[key] == seg;
          in1 = in1 && kv[key + 1] == seg;
        }
      }
      float& x0 = s[nt][2 * half];
      float& x1 = s[nt][2 * half + 1];
      x0 = __fmul_rn(x0, scale);
      x1 = __fmul_rn(x1, scale);
      if (mask.bias != nullptr) {  // adding 0 would round nothing
        const float2 bias = mask.bias_pair(b, h, row, key, in0, in1);
        x0 = __fadd_rn(x0, bias.x);
        x1 = __fadd_rn(x1, bias.y);
      }
      if (!in0) x0 = -INFINITY;
      if (!in1) x1 = -INFINITY;
    }
  }
}

}  // namespace mma_tile
