// Fused softmax cross entropy with label smoothing: per-row loss and LSE
// (forward) and dx (backward).
//
// Replaces the TPU kernels apex_tpu/ops/xentropy.py::_fwd_kernel and
// ::_bwd_kernel (the pallas_calls in _xent_fwd_call and _xent_bwd_call).
// Logits x are [R, V] fp32 or bf16, labels int32 [R]; with conf = 1 - s
// and s the smoothing, in fp32 whatever x's dtype:
//   lse  = log(sum_v exp(x_v))
//   loss = lse - conf * x[label] - s * mean_v(x_v)
//   dx   = (exp(x - lse) - conf * onehot(label) - s / V) * dy    (x's dtype)
// A label outside [0, V) contributes no x[label] and no onehot. Rows whose
// label is padding_idx (when has_pad) get loss 0 and dx 0. Only the LSE is
// kept for the backward, which recomputes the softmax (the saving over
// log_softmax + nll is the point of the op).
//
// Design: one block of 256 threads per row. The forward is one pass: each
// thread keeps an online-softmax pair (max, sum of exp) and the plain sum
// of its strided columns, the block merges the threads' pairs in a fixed
// order (warp shuffles, then the 8 warps in order), so a row's loss is the
// same bits in every run. The backward is one elementwise pass per row.
// The TPU kernels hold whole vocab rows in VMEM; here the row streams
// through registers, and no row ever sits in shared memory.
//
// What bounds it on the H100: bytes. The forward reads x once (4 or 2 bytes
// per element) for ~5 operations per element; the backward reads x and
// writes dx. At BERT's MLM head (640 x 30528 fp32) that is 78 MB and 156 MB:
// 0.023 ms and 0.047 ms at 3.35 TB/s.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// (m, s) holds s = sum exp(x - m), m finite; merge another pair into it
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xentropy_fwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse, int vocab, float conf,
                    float smoothing, int has_pad, int padding_idx) {
  __shared__ float sm[kWarps], ss[kWarps], sx[kWarps];
  const long row = blockIdx.x;
  const T* xr = x + row * vocab;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // m starts finite, so a -inf logit (a masked column) adds exp(-inf) = 0
  // however early it comes, never exp(-inf - -inf) = NaN
  float m = -FLT_MAX, s = 0.f, sum_x = 0.f;
  for (int c = threadIdx.x; c < vocab; c += kThreads) {
    const float v = to_f32<T>(xr[c]);
    if (v > m) {
      s = s * expf(m - v) + 1.f;
      m = v;
    } else {
      s += expf(v - m);
    }
    sum_x += v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
    sum_x += __shfl_xor_sync(0xffffffffu, sum_x, o);
  }
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
    sx[warp] = sum_x;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  m = sm[0];
  s = ss[0];
  sum_x = sx[0];
  for (int w = 1; w < kWarps; ++w) {
    lse_merge(m, s, sm[w], ss[w]);
    sum_x += sx[w];
  }
  const float l = m + logf(s);
  const int label = labels[row];
  const float x_t = (label >= 0 && label < vocab) ? to_f32<T>(xr[label]) : 0.f;
  float out = l - conf * x_t;
  if (smoothing > 0.f) out -= smoothing * (sum_x / static_cast<float>(vocab));
  if (has_pad && label == padding_idx) out = 0.f;
  loss[row] = out;
  lse[row] = l;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xentropy_bwd_kernel(const T* __restrict__ x, const int* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ dy,
                    T* __restrict__ dx, int vocab, float conf, float smooth_per_class,
                    int has_pad, int padding_idx) {
  const long row = blockIdx.x;
  const T* xr = x + row * vocab;
  T* dxr = dx + row * vocab;
  const int label = labels[row];
  if (has_pad && label == padding_idx) {
    for (int c = threadIdx.x; c < vocab; c += kThreads) dxr[c] = from_f32<T>(0.f);
    return;
  }
  const float l = lse[row], g = dy[row];
  for (int c = threadIdx.x; c < vocab; c += kThreads) {
    float grad = expf(to_f32<T>(xr[c]) - l);
    if (c == label) grad -= conf;
    grad -= smooth_per_class;
    dxr[c] = from_f32<T>(grad * g);
  }
}

}  // namespace

// x: [rows, vocab] (dtype code), labels int32 [rows]; loss and lse fp32 [rows].
extern "C" int apex_xentropy_fwd(const void* x, const void* labels, void* loss, void* lse,
                                 int rows, int vocab, float conf, float smoothing, int has_pad,
                                 int padding_idx, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* lb = static_cast<const int*>(labels);
  auto* lo = static_cast<float*>(loss);
  auto* ls = static_cast<float*>(lse);
  if (rows > 0) {
    if (dtype == APEX_BF16)
      xentropy_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), lb, lo, ls, vocab, conf, smoothing, has_pad,
          padding_idx);
    else
      xentropy_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(x), lb, lo, ls, vocab, conf, smoothing, has_pad,
          padding_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

// smooth_per_class = s / V (0 without smoothing); dy fp32 [rows]; dx as x.
extern "C" int apex_xentropy_bwd(const void* x, const void* labels, const void* lse,
                                 const void* dy, void* dx, int rows, int vocab, float conf,
                                 float smooth_per_class, int has_pad, int padding_idx, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* lb = static_cast<const int*>(labels);
  auto* ls = static_cast<const float*>(lse);
  auto* g = static_cast<const float*>(dy);
  if (rows > 0) {
    if (dtype == APEX_BF16)
      xentropy_bwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), lb, ls, g, static_cast<__nv_bfloat16*>(dx),
          vocab, conf, smooth_per_class, has_pad, padding_idx);
    else
      xentropy_bwd_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(x), lb, ls, g, static_cast<float*>(dx), vocab, conf,
          smooth_per_class, has_pad, padding_idx);
  }
  return static_cast<int>(cudaGetLastError());
}
