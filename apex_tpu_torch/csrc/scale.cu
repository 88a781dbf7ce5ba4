// y = float32(x) * scale over a flat (rows, 1024) buffer of fp32 or bf16.
//
// Replaces the TPU kernel apex_tpu/ops/optim_kernels.py::_scale_kernel
// (pallas_call in multi_tensor_scale), the counterpart of apex's
// multi_tensor_scale: one launch over every tensor of a network. The
// scale is read from a 1-float device tensor, so it may be a loss scaler's
// state with no host read. One rounding per element, as the reference's
// fp32 product.
//
// Design: one block of 256 threads per row, four elements per thread (a
// float4 of fp32, or four packed bf16 in 8 bytes), one float4 stored.
//
// What bounds it on the H100: bytes. fp32: 4 bytes read and 4 written per
// element; bf16: 2 read and 4 written; one multiply.

#include "common.cuh"

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = kLane / 4;

__global__ void __launch_bounds__(kThreads)
scale_f32_kernel(const float* __restrict__ s, const float4* __restrict__ x,
                 float4* __restrict__ y) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  const float k = s[0];
  const float4 v = x[i];
  y[i] = make_float4(v.x * k, v.y * k, v.z * k, v.w * k);
}

__global__ void __launch_bounds__(kThreads)
scale_bf16_kernel(const float* __restrict__ s, const uint2* __restrict__ x,
                  float4* __restrict__ y) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  const float k = s[0];
  const uint2 raw = x[i];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  y[i] = make_float4(__low2float(lo) * k, __high2float(lo) * k, __low2float(hi) * k,
                     __high2float(hi) * k);
}

}  // namespace

// s fp32 [1]; x [rows, 1024] fp32 (dtype 0) or bf16 (dtype 1); y fp32
// [rows, 1024].
extern "C" int apex_scale(const void* s, const void* x, void* y, int rows, int dtype,
                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (rows > 0) {
    if (dtype == APEX_BF16)
      scale_bf16_kernel<<<rows, kThreads, 0, st>>>(static_cast<const float*>(s),
                                                   static_cast<const uint2*>(x),
                                                   static_cast<float4*>(y));
    else
      scale_f32_kernel<<<rows, kThreads, 0, st>>>(static_cast<const float*>(s),
                                                  static_cast<const float4*>(x),
                                                  static_cast<float4*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}
