// Fused scale + mask + softmax over the last axis (forward) and its
// gradient (backward): Megatron's attention softmax.
//
// Replaces the TPU kernels apex_tpu/ops/scaled_softmax.py::_fwd_kernel (:41,
// the pallas_call in _softmax_fwd) and ::_bwd_kernel (:59, in
// _softmax_bwd_impl). x is [b, np, sq, sk] contiguous, fp32, bf16 or fp16;
// each of its b * np * sq rows is, in fp32:
//   v  = x * scale, then MASK_FILL (-10000) where the mask is nonzero
//        (true = masked out) and, when causal, where q < k (q the row's
//        index within its sq, k the column, counted from the top left
//        whatever sq and sk are)
//   y  = exp(v - max v) / sum exp(v - max v)                  (x's dtype)
//   dx = ((dy - sum_k y dy) * y) * scale                      (dy's dtype)
// The fill is -10000, not -inf, so a row masked everywhere comes out
// uniform, 1 / sk. The mask is read in place through the strides of its
// broadcast to [mb, 1, sq, sk] (a [b, 1, 1, sk] padding mask has a row
// stride of 0 and is never expanded), its batch block taken as b % mb as
// the reference's index map does. The products are rounded on their own
// (__fmul_rn), never fused into the add that follows, as the plain twin
// computes them.
//
// Design of the forward (sized by sk: ops/scaled_softmax.py::fwd_path
// chooses the path and passes it here as nvec):
//  - sk <= 1024 (nvec > 0): a warp per row, four rows a block. The whole
//    row sits in registers, NVEC 16-byte units a lane (kPack values each:
//    8 in bf16 and fp16, 4 in fp32), so x is read once with 16-byte loads
//    (one element at a time where sk leaves rows unaligned) and the mask
//    once, 8 or 4 bytes a unit where its column stride is 1 and its row is
//    aligned (byte by byte otherwise). A unit wholly right of the causal
//    diagonal reads nothing, and one that the mask covers reads no x: it is
//    all fill. The max and the sum are
//    warp shuffles with no barrier; exp runs once per element, and one
//    reciprocal of the sum per row scales it.
//  - longer rows (nvec 0): a block of 256 threads per row, two passes.
//    The first keeps each thread's running max and its sum of exp rescaled
//    to it (online, a unit at a time), then the block combines the pairs, the
//    warps in warp order; the second reads the row again (L2) and writes
//    exp(v - max) times the reciprocal of the sum. No cap on sk.
// Every reduction runs in an order fixed by the shape, so a row's result is
// the same bits in every run. The backward: one block of 128 threads per
// row, two strided passes (the dot, the write), the warps' sums combined
// in a fixed order (block_reduce).
//
// What bounds it on the H100: bytes. Each element the function needs is
// read once and each output written once (forward), or two read and one
// written (backward), for ~8 operations. Scores that are fill need no read:
// at GPT-2-small's causal training scores, 96 x 1024 x 1024 bf16, the
// forward reads the 50.4 M scores at or left of the diagonal and writes all
// 100.7 M, 302 MB, and the backward moves 604 MB: 0.090 ms and 0.180 ms at
// 3.35 TB/s.

#include <cfloat>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kMaskFill = -10000.f;
constexpr int kRowsPerBlock = 4;  // the warp path's rows (warps) a block
constexpr int kLongThreads = 256;

// kPack values of T in one 16-byte unit
template <typename T>
__host__ __device__ constexpr int pack_of() {
  return 16 / sizeof(T);
}

template <typename T>
__device__ __forceinline__ float unit_elem(const uint4& r, int e) {
  const uint32_t w = (&r.x)[e * sizeof(T) / 4];
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {
    const unsigned short h = static_cast<unsigned short>((e & 1) ? (w >> 16) : (w & 0xffffu));
    if constexpr (std::is_same_v<T, __half>) return __half2float(__ushort_as_half(h));
    return __uint_as_float(static_cast<uint32_t>(h) << 16);
  }
}

template <typename T>
__device__ __forceinline__ uint4 to_unit(const float* v) {
  uint4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      (&r.x)[i] = __float_as_uint(v[i]);
    } else {
      const T lo = from_f32<T>(v[2 * i]), hi = from_f32<T>(v[2 * i + 1]);
      (&r.x)[i] = static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&lo)) |
                  (static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(&hi)) << 16);
    }
  }
  return r;
}

// One row's view: its x and y, its mask row (null: none), the causal
// diagonal q, and how the mask is read (mvec: kPack bytes at a time).
template <typename T>
struct Row {
  const T* x;
  T* y;
  const uint8_t* m;
  long long msk;
  int q, sk, causal, mvec;
  float scale;

  // the kPack scores of unit u (values u * kPack ..) into v; -inf past sk
  __device__ __forceinline__ void unit_scores(int u, int xvec, float* v) const {
    constexpr int kPack = pack_of<T>();
    const int k0 = u * kPack;
    if (causal && k0 > q) {  // wholly right of the diagonal: all fill
#pragma unroll
      for (int e = 0; e < kPack; ++e) v[e] = k0 + e < sk ? kMaskFill : -INFINITY;
      return;
    }
    uint64_t mbits = 0;
    if (m != nullptr) {
      if (mvec && k0 + kPack <= sk) {
        mbits = kPack == 8 ? *reinterpret_cast<const uint64_t*>(m + k0)
                           : *reinterpret_cast<const uint32_t*>(m + k0);
      } else {
#pragma unroll
        for (int e = 0; e < kPack; ++e)
          if (k0 + e < sk) mbits |= static_cast<uint64_t>(m[(k0 + e) * msk] != 0) << (8 * e);
      }
      if (k0 + kPack <= sk) {  // a unit masked everywhere: all fill, x not read
        bool all = true;
#pragma unroll
        for (int e = 0; e < kPack; ++e) all = all && ((mbits >> (8 * e)) & 0xffu) != 0;
        if (all) {
#pragma unroll
          for (int e = 0; e < kPack; ++e) v[e] = kMaskFill;
          return;
        }
      }
    }
    if (xvec) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(x + k0));
#pragma unroll
      for (int e = 0; e < kPack; ++e) v[e] = __fmul_rn(unit_elem<T>(r, e), scale);
    } else {
#pragma unroll
      for (int e = 0; e < kPack; ++e)
        v[e] = k0 + e < sk ? __fmul_rn(to_f32<T>(x[k0 + e]), scale) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      if ((mbits >> (8 * e)) & 0xffu) v[e] = kMaskFill;
      if (causal && q < k0 + e) v[e] = kMaskFill;
      if (k0 + e >= sk) v[e] = -INFINITY;
    }
  }

  __device__ __forceinline__ void store_unit(int u, int xvec, const float* v) const {
    constexpr int kPack = pack_of<T>();
    const int k0 = u * kPack;
    if (xvec) {
      *reinterpret_cast<uint4*>(y + k0) = to_unit<T>(v);
      return;
    }
#pragma unroll
    for (int e = 0; e < kPack; ++e)
      if (k0 + e < sk) y[k0 + e] = from_f32<T>(v[e]);
  }
};

template <typename T>
__device__ __forceinline__ Row<T> row_view(const T* x, T* y, const uint8_t* mask, long long msb,
                                           long long msq, long long msk, int mb, int np, int sq,
                                           int sk, float scale, int causal, long long row) {
  constexpr int kPack = pack_of<T>();
  Row<T> r;
  r.q = static_cast<int>(row % sq);
  const int b = static_cast<int>(row / (static_cast<long long>(sq) * np));
  r.x = x + row * sk;
  r.y = y + row * sk;
  r.m = mask ? mask + (b % mb) * msb + r.q * msq : nullptr;
  r.msk = msk;
  r.sk = sk;
  r.causal = causal;
  r.scale = scale;
  r.mvec = r.m != nullptr && msk == 1 && reinterpret_cast<uintptr_t>(r.m) % kPack == 0;
  return r;
}

// nvec > 0: a warp per row, NVEC units a lane in registers. xvec:
// rows 16-byte aligned (lane l takes units l + 32 j); else one element at
// a time (unit u = l + 32 j covers elements u * kPack ..., read singly)
template <typename T, int NVEC>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
scaled_softmax_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const uint8_t* __restrict__ mask, long long mask_sb,
                               long long mask_sq, long long mask_sk, int mb, int np, int sq,
                               int sk, float scale, int causal, long long rows, int xvec) {
  constexpr int kPack = pack_of<T>();
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const Row<T> r = row_view(x, y, mask, mask_sb, mask_sq, mask_sk, mb, np, sq, sk, scale, causal,
                            row);
  float v[NVEC][kPack];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NVEC; ++j) {
    const int u = lane + 32 * j;
    if (u * kPack < sk) {
      r.unit_scores(u, xvec, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < kPack; ++e) v[j][e] = -INFINITY;
    }
#pragma unroll
    for (int e = 0; e < kPack; ++e) m = fmaxf(m, v[j][e]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NVEC; ++j)
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      v[j][e] = expf(v[j][e] - m);
      s += v[j][e];
    }
  const float inv = 1.f / warp_sum(s);
#pragma unroll
  for (int j = 0; j < NVEC; ++j) {
    const int u = lane + 32 * j;
    if (u * kPack >= sk) continue;
#pragma unroll
    for (int e = 0; e < kPack; ++e) v[j][e] *= inv;
    r.store_unit(u, xvec, v[j]);
  }
}

// (m, s) pairs: the sum s of exp(v - m) over some values, combined into
// the larger max; a side that holds no value has m = -inf and s = 0
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = (m == mn ? s : s * expf(m - mn)) + (m2 == mn ? s2 : s2 * expf(m2 - mn));
  m = mn;
}

// nvec 0: a block of 256 threads per row, two passes (an online
// max and sum, then the write), units as in the warp kernel, strided by
// the block
template <typename T>
__global__ void __launch_bounds__(kLongThreads)
scaled_softmax_fwd_long_kernel(const T* __restrict__ x, T* __restrict__ y,
                               const uint8_t* __restrict__ mask, long long mask_sb,
                               long long mask_sq, long long mask_sk, int mb, int np, int sq,
                               int sk, float scale, int causal, int xvec) {
  constexpr int kPack = pack_of<T>();
  __shared__ float red_m[kLongThreads / 32], red_s[kLongThreads / 32];
  const Row<T> r = row_view(x, y, mask, mask_sb, mask_sq, mask_sk, mb, np, sq, sk, scale, causal,
                            static_cast<long long>(blockIdx.x));
  const int units = (sk + kPack - 1) / kPack;
  float m = -INFINITY, s = 0.f;
  for (int u = threadIdx.x; u < units; u += kLongThreads) {
    float v[kPack];
    r.unit_scores(u, xvec, v);
    float um = v[0];
#pragma unroll
    for (int e = 1; e < kPack; ++e) um = fmaxf(um, v[e]);
    float us = 0.f;
#pragma unroll
    for (int e = 0; e < kPack; ++e) us += expf(v[e] - um);
    merge(m, s, um, us);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o), __shfl_xor_sync(0xffffffffu, s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  m = red_m[0];
  s = red_s[0];
  for (int w = 1; w < kLongThreads / 32; ++w) merge(m, s, red_m[w], red_s[w]);
  const float inv = 1.f / s;
  for (int u = threadIdx.x; u < units; u += kLongThreads) {
    float v[kPack];
    r.unit_scores(u, xvec, v);
#pragma unroll
    for (int e = 0; e < kPack; ++e) v[e] = expf(v[e] - m) * inv;
    r.store_unit(u, xvec, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy, T* __restrict__ dx,
                          int sk, float scale) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const T* yr = y + row * sk;
  const T* gr = dy + row * sk;
  T* dr = dx + row * sk;
  float dot = 0.f;
  for (int k = threadIdx.x; k < sk; k += kThreads) dot += to_f32<T>(yr[k]) * to_f32<T>(gr[k]);
  dot = block_reduce<false>(dot, red);
  for (int k = threadIdx.x; k < sk; k += kThreads) {
    const float t = __fmul_rn(__fsub_rn(to_f32<T>(gr[k]), dot), to_f32<T>(yr[k]));
    dr[k] = from_f32<T>(__fmul_rn(t, scale));
  }
}

template <typename T>
cudaError_t launch_fwd(const void* xv, void* yv, const void* maskv, long long msb, long long msq,
                       long long msk, int mb, int np, int sq, int sk, float scale, int causal,
                       long long rows, int nvec, cudaStream_t s) {
  // nvec units of kPack values a lane must hold the row
  if (nvec > 0 && static_cast<long long>(nvec) * 32 * pack_of<T>() < sk)
    return cudaErrorInvalidValue;
  auto x = static_cast<const T*>(xv);
  auto y = static_cast<T*>(yv);
  auto mask = static_cast<const uint8_t*>(maskv);
  const int xvec = sk % pack_of<T>() == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (nvec == 0) {
    scaled_softmax_fwd_long_kernel<T><<<static_cast<unsigned>(rows), kLongThreads, 0, s>>>(
        x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, xvec);
    return cudaGetLastError();
  }
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
#define APEX_SOFTMAX_WARP(N)                                                                  \
  scaled_softmax_fwd_warp_kernel<T, N><<<blocks, kRowsPerBlock * 32, 0, s>>>(                 \
      x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, rows, xvec)
  switch (nvec) {
    case 1: APEX_SOFTMAX_WARP(1); break;
    case 2: APEX_SOFTMAX_WARP(2); break;
    case 4: APEX_SOFTMAX_WARP(4); break;
    case 8:
      if constexpr (sizeof(T) == 4) {
        APEX_SOFTMAX_WARP(8);
        break;
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef APEX_SOFTMAX_WARP
  return cudaGetLastError();
}

template <typename T>
void launch_bwd(const void* y, const void* dy, void* dx, int sk, float scale, long long rows,
                cudaStream_t s) {
  scaled_softmax_bwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy), static_cast<T*>(dx), sk, scale);
}

}  // namespace

// x, y: [b, np, sq, sk] (dtype code); mask: null, or uint8 (0 keeps) read at
// (b % mb) * msb + q * msq + k * msk (element strides of its broadcast to
// [mb, 1, sq, sk]); causal: fill where q < k. nvec: the path
// (ops/scaled_softmax.py::fwd_path), the 16-byte units a lane of a row's
// warp holds (1, 2, 4, or 8 in fp32), or 0 for a block per row.
extern "C" int apex_scaled_softmax_fwd(const void* x, void* y, const void* mask, long long msb,
                                       long long msq, long long msk, int mb, int b, int np,
                                       int sq, int sk, float scale, int causal, int dtype,
                                       int nvec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * np * sq;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSuccess;
  if (rows > 0 && sk > 0) {
    if (dtype == APEX_BF16)
      err = launch_fwd<__nv_bfloat16>(x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal,
                                      rows, nvec, s);
    else if (dtype == APEX_F16)
      err = launch_fwd<__half>(x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, rows,
                               nvec, s);
    else
      err = launch_fwd<float>(x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, rows,
                              nvec, s);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// y, dy, dx: [rows, sk], one dtype.
extern "C" int apex_scaled_softmax_bwd(const void* y, const void* dy, void* dx, long long rows,
                                       int sk, float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (rows > 0 && sk > 0) {
    if (dtype == APEX_BF16)
      launch_bwd<__nv_bfloat16>(y, dy, dx, sk, scale, rows, s);
    else if (dtype == APEX_F16)
      launch_bwd<__half>(y, dy, dx, sk, scale, rows, s);
    else
      launch_bwd<float>(y, dy, dx, sk, scale, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}
