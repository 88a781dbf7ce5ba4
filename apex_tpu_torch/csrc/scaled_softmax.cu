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
// Design: one block of 128 threads per row and three passes over it (max,
// sum of exp, write), each a strided loop over the whole row, so any sk
// runs: there is no cap on the row's length and nothing of it sits in
// registers or shared memory. The backward is two passes (the dot, the
// write). The block's sums combine the warps in a fixed order
// (block_reduce), so a row's result is the same bits in every run. The row
// (2 to 4 bytes a column) is read from device memory once; its second and
// third reads hit the SM's L1.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (forward), or two read and one written (backward), for ~8 operations.
// At GPT-2-small's training scores, 96 x 1024 x 1024 bf16, that is 403 MB
// forward and 604 MB backward: 0.120 ms and 0.180 ms at 3.35 TB/s.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kMaskFill = -10000.f;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_softmax_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                          const uint8_t* __restrict__ mask, long long mask_sb,
                          long long mask_sq, long long mask_sk, int mb, int np, int sq,
                          int sk, float scale, int causal) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const int q = static_cast<int>(row % sq);
  const int b = static_cast<int>(row / (static_cast<long long>(sq) * np));
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const uint8_t* mr = mask ? mask + (b % mb) * mask_sb + q * mask_sq : nullptr;

  auto score = [&](int k) {
    float v = __fmul_rn(to_f32<T>(xr[k]), scale);
    if (mr != nullptr && mr[k * mask_sk] != 0) v = kMaskFill;
    if (causal && q < k) v = kMaskFill;
    return v;
  };

  float m = -FLT_MAX;
  for (int k = threadIdx.x; k < sk; k += kThreads) m = fmaxf(m, score(k));
  m = block_reduce<true>(m, red);
  float s = 0.f;
  for (int k = threadIdx.x; k < sk; k += kThreads) s += expf(score(k) - m);
  s = block_reduce<false>(s, red);
  for (int k = threadIdx.x; k < sk; k += kThreads) yr[k] = from_f32<T>(expf(score(k) - m) / s);
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
void launch_fwd(const void* x, void* y, const void* mask, long long msb, long long msq,
                long long msk, int mb, int np, int sq, int sk, float scale, int causal,
                long long rows, cudaStream_t s) {
  scaled_softmax_fwd_kernel<T><<<static_cast<unsigned>(rows), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<const uint8_t*>(mask), msb, msq,
      msk, mb, np, sq, sk, scale, causal);
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
// [mb, 1, sq, sk]); causal: fill where q < k.
extern "C" int apex_scaled_softmax_fwd(const void* x, void* y, const void* mask, long long msb,
                                       long long msq, long long msk, int mb, int b, int np,
                                       int sq, int sk, float scale, int causal, int dtype,
                                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * np * sq;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (rows > 0 && sk > 0) {
    if (dtype == APEX_BF16)
      launch_fwd<__nv_bfloat16>(x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, rows, s);
    else if (dtype == APEX_F16)
      launch_fwd<__half>(x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, rows, s);
    else
      launch_fwd<float>(x, y, mask, msb, msq, msk, mb, np, sq, sk, scale, causal, rows, s);
  }
  return static_cast<int>(cudaGetLastError());
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
