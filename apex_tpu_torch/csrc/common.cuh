// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel source is built on its own into one shared library with a
// plain C interface (apex_tpu_torch/ops/_build.py): pointers and the CUDA
// stream arrive as void*, and each entry point returns cudaGetLastError()
// right after its launch so the Python wrapper can raise on a refused
// launch.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes shared with the Python wrappers (_build.DTYPE_CODES)
// (APEX_F16 is taken by the scaled-softmax and GroupNorm kernels only)
enum ApexDtype { APEX_F32 = 0, APEX_BF16 = 1, APEX_I8 = 2, APEX_E4M3 = 3, APEX_F16 = 4 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }
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
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
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

// Sum (kMax: max) of v over the block; every thread gets the result. The
// warps' partials are combined in a fixed order, so the result is the same
// bits in every run. red: blockDim.x / 32 floats of shared memory, free for
// the call (the leading barrier lets a caller reuse it from the previous
// one); every thread of the block must call it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x / 32); ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

extern "C" const char* apex_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
