// LayerNorm forward: y = (x - mean) * rstd * w + b over the last dimension,
// with fp32 statistics, fp32 weight and bias over an fp32 or bf16 x, and y
// in x's dtype. Also writes the per-row fp32 mean and rstd.
//
// Replaces the TPU kernel apex_tpu/ops/layer_norm.py::_ln_fwd_kernel
// (pallas_call in _ln_fwd), affine LayerNorm branch.
//
// Design: one block of 256 threads per row. Two passes over the row for the
// mean and the centred variance (the TPU kernel's formula, not a one-pass
// E[x^2] - E[x]^2), block reductions through warp shuffles and a 8-float
// shared scratch, then the affine epilogue. The row (768 elements for
// GPT-2-small) is re-read from L1/L2, not device memory.
//
// What bounds it on the H100: bytes. It reads x once and writes y once
// (plus 8 bytes of statistics per row) for ~8 FLOPs per element. At the
// decode shapes (8 rows) the launch itself dominates; fusing the norm into
// its neighbours is the lever there, not this kernel's loop.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  v = warp_sum(v);
  __syncthreads();  // scratch free from any previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float t = lane < kWarps ? scratch[lane] : 0.f;
  return warp_sum(t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int cols,
                      float eps) {
  __shared__ float scratch[kWarps];
  const long row = blockIdx.x;
  const T* xr = x + row * cols;
  T* yr = y + row * cols;

  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) s += to_f32<T>(xr[c]);
  const float mean = block_sum(s, scratch) / cols;

  float ss = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float xc = to_f32<T>(xr[c]) - mean;
    ss = fmaf(xc, xc, ss);
  }
  const float var = block_sum(ss, scratch) / cols;
  const float rstd = rsqrtf(var + eps);

  for (int c = threadIdx.x; c < cols; c += kThreads) {
    float v = (to_f32<T>(xr[c]) - mean) * rstd;
    if (w != nullptr) v *= w[c];
    if (bias != nullptr) v += bias[c];
    yr[c] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

}  // namespace

extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                   void* mean, void* rstd, int rows, int cols, float eps,
                                   int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<const float*>(w);
  auto* bf = static_cast<const float*>(b);
  auto* m = static_cast<float*>(mean);
  auto* r = static_cast<float*>(rstd);
  if (rows > 0) {
    if (dtype == APEX_BF16)
      layer_norm_fwd_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), wf, bf, static_cast<__nv_bfloat16*>(y), m, r,
          cols, eps);
    else
      layer_norm_fwd_kernel<float><<<rows, kThreads, 0, s>>>(
          static_cast<const float*>(x), wf, bf, static_cast<float*>(y), m, r, cols, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
