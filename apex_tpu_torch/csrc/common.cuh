// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel source is built on its own into one shared library with a
// plain C interface (apex_tpu_torch/ops/_build.py): pointers and the CUDA
// stream arrive as void*, and each entry point returns cudaGetLastError()
// right after its launch so the Python wrapper can raise on a refused
// launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
enum ApexDtype { APEX_F32 = 0, APEX_BF16 = 1, APEX_I8 = 2, APEX_E4M3 = 3 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// the narrow storage types of quantized weights and KV pages: every int8
// and e4m3 value is exact in fp32
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);
}
template <> __device__ __forceinline__ float to_f32<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
