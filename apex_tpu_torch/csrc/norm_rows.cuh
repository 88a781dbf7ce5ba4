// Row helpers shared by the LayerNorm/RMSNorm forward and backward kernels
// (layer_norm_fwd.cu, layer_norm_bwd.cu): a row is read and written in
// 16-byte slots of kPack values (8 bf16 or 4 fp32), one uint4 each, or
// element by element where the width or a pointer is not 16-byte aligned;
// a team of threads wider than a warp meets at its own named barrier.

#pragma once

#include "common.cuh"

namespace {

// 16 bytes of T: kPack values, one uint4
template <typename T>
struct Slot {
  static constexpr int kPack = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ float elem(const uint4& r, int e) {
  const uint32_t w = (&r.x)[e * sizeof(T) / 4];
  if constexpr (sizeof(T) == 4) return __uint_as_float(w);
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// slot s of a row (values s * kPack ..): one 16-byte load, or (vec 0)
// elements one at a time; zero past the row's end
template <typename T>
__device__ __forceinline__ uint4 load_slot(const T* __restrict__ row, int s, int cols, int vec) {
  constexpr int kPack = Slot<T>::kPack;
  const int c0 = s * kPack;
  if (c0 >= cols) return make_uint4(0u, 0u, 0u, 0u);
  if (vec) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int e = 0; e < kPack; ++e) {
    if (c0 + e < cols) {
      uint32_t& w = (&r.x)[e * sizeof(T) / 4];
      if constexpr (sizeof(T) == 4)
        w = __float_as_uint(__ldg(reinterpret_cast<const float*>(row) + c0 + e));
      else
        w |= static_cast<uint32_t>(__ldg(h + c0 + e)) << (16 * (e & 1));
    }
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void store_slot(T* __restrict__ row, int s, int cols, int vec,
                                           const float (&v)[Slot<T>::kPack]) {
  constexpr int kPack = Slot<T>::kPack;
  const int c0 = s * kPack;
  if (c0 >= cols) return;
  if (vec) {
    uint4 r;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        (&r.x)[i] = __float_as_uint(v[i]);
      } else {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        (&r.x)[i] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
    *reinterpret_cast<uint4*>(row + c0) = r;
    return;
  }
#pragma unroll
  for (int e = 0; e < kPack; ++e)
    if (c0 + e < cols) row[c0 + e] = from_f32<T>(v[e]);
}

// the team's barrier: `n` threads under barrier `id` (1.., 0 is
// __syncthreads)
__device__ __forceinline__ void team_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

}  // namespace
