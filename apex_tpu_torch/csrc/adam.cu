// Fused Adam / AdamW step over the flat fp32 (rows, 1024) parameter buffers.
//
// Replaces the TPU kernel apex_tpu/ops/optim_kernels.py::_adam_kernel
// (pallas_call in adam_update). Per element, with the hyper-parameters read
// from a 9-float device row hp = [b1, b2, eps, wd, lr, rbc1, rbc2,
// grad_scale, noop] (the reference's SMEM row, so a captured CUDA graph
// needs no host value):
//   g = g * grad_scale;            L2 mode (adam_w = 0): g += wd * p
//   m = b1 m + (1 - b1) g;         v = b2 v + (1 - b2) g g
//   u = (m rbc1) / (sqrt(v rbc2) + eps);   AdamW (adam_w = 1): u += wd * p
//   p = p - lr u
// rbc1 = 1 / (1 - b1^t) and rbc2 = 1 / (1 - b2^t), or 1 without bias
// correction. wd is hp[3], or per tensor wd_seg[seg_rows[row]] when a
// row -> segment map is given (each 1024-element row belongs to one tensor).
// p, m and v are updated in place (the reference's input_output_aliases).
// noop > 0 leaves all three untouched, bit for bit (the reference's
// where-select): the block returns before it reads or writes anything.
//
// Design: one block of 256 threads per row, one float4 per thread, so every
// load and store is a coalesced 16-byte access.
//
// What bounds it on the H100: bytes. 16 bytes read per element (g, p, m, v)
// and 12 written (p, m, v) for ~15 FLOPs: 28 bytes per element, 3.5 GB for
// GPT-2-small's 124.5 M parameters, ~1.0 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = kLane / 4;

__device__ __forceinline__ void adam_elem(float g, float& p, float& m, float& v, float b1,
                                          float b2, float eps, float wd, float lr, float rbc1,
                                          float rbc2, float gscale, bool adam_w) {
  g = g * gscale;
  if (!adam_w) g = g + wd * p;
  m = b1 * m + (1.f - b1) * g;
  v = b2 * v + (1.f - b2) * g * g;
  float u = (m * rbc1) / (sqrtf(v * rbc2) + eps);
  if (adam_w) u = u + wd * p;
  p = p - lr * u;
}

__global__ void __launch_bounds__(kThreads)
adam_kernel(const float* __restrict__ hp, const float4* __restrict__ g, float4* __restrict__ p,
            float4* __restrict__ m, float4* __restrict__ v, const int* __restrict__ seg_rows,
            const float* __restrict__ wd_seg, int adam_w) {
  if (hp[8] > 0.f) return;  // noop: state stays bit-identical
  const long row = blockIdx.x;
  const long i = row * kThreads + threadIdx.x;
  const float b1 = hp[0], b2 = hp[1], eps = hp[2], lr = hp[4];
  const float rbc1 = hp[5], rbc2 = hp[6], gscale = hp[7];
  const float wd = seg_rows != nullptr ? wd_seg[seg_rows[row]] : hp[3];
  const bool aw = adam_w != 0;
  const float4 gv = g[i];
  float4 pv = p[i], mv = m[i], vv = v[i];
  adam_elem(gv.x, pv.x, mv.x, vv.x, b1, b2, eps, wd, lr, rbc1, rbc2, gscale, aw);
  adam_elem(gv.y, pv.y, mv.y, vv.y, b1, b2, eps, wd, lr, rbc1, rbc2, gscale, aw);
  adam_elem(gv.z, pv.z, mv.z, vv.z, b1, b2, eps, wd, lr, rbc1, rbc2, gscale, aw);
  adam_elem(gv.w, pv.w, mv.w, vv.w, b1, b2, eps, wd, lr, rbc1, rbc2, gscale, aw);
  p[i] = pv;
  m[i] = mv;
  v[i] = vv;
}

}  // namespace

extern "C" int apex_adam(const void* hp, const void* g, void* p, void* m, void* v,
                         const void* seg_rows, const void* wd_seg, int rows, int adam_w,
                         void* stream) {
  if (rows > 0)
    adam_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hp), static_cast<const float4*>(g), static_cast<float4*>(p),
        static_cast<float4*>(m), static_cast<float4*>(v), static_cast<const int*>(seg_rows),
        static_cast<const float*>(wd_seg), adam_w);
  return static_cast<int>(cudaGetLastError());
}
