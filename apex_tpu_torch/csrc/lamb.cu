// Fused LAMB step over the flat fp32 (rows, 1024) parameter buffers, in two
// phases with the per-tensor trust ratio computed between them.
//
// Replaces the TPU kernels apex_tpu/ops/optim_kernels.py::_lamb_phase1_kernel
// and ::_lamb_phase2_kernel (the two pallas_calls in lamb_update). The
// hyper-parameters come from device rows, so no host value is read per step:
// hp1 = [b1, b2, eps, beta3, rbc1, rbc2, grad_scale, noop, 0] and
// hp2 = [lr, noop]. Per element, with wd = wd_seg[seg_rows[row]]:
//   phase 1:  g = g * grad_scale
//             m = b1 m + beta3 g;   v = b2 v + (1 - b2) g g
//             u = (m rbc1) / (sqrt(v rbc2) + eps) + wd p
//             and per segment ||p||^2 and ||u||^2
//   phase 2:  p = p - lr ratio[seg] u
// noop > 0 leaves p, m and v bit-identical (the reference's where-select):
// phase 1 writes u = 0, counts no ||u||^2 and leaves m and v unwritten;
// phase 2 returns before it reads anything. ||p||^2 is summed either way.
//
// Design: one warp per row (8 rows a block), each lane eight float4 of the
// row, every access a coalesced 16-byte one. Phase 1's per-row ||p||^2 and
// ||u||^2 go to a [2][rows] scratch that segment_reduce.cuh sums per segment
// in a fixed order: no float atomics, the same trust ratios in every run.
//
// What bounds it on the H100: bytes. Phase 1 reads g, p, m, v and writes u,
// m, v: 28 bytes per element, 9.4 GB for BERT-Large's 336 M parameters,
// 2.8 ms at 3.35 TB/s. Phase 2 reads u and p and writes p: 12 bytes per
// element, 1.2 ms.

#include "segment_reduce.cuh"

namespace {

// One element of phase 1: updates m and v, returns u.
__device__ __forceinline__ float lamb_elem(float g, float p, float& m, float& v, float b1,
                                           float b2, float eps, float beta3, float rbc1,
                                           float rbc2, float gscale, float wd) {
  g = g * gscale;
  m = b1 * m + beta3 * g;
  v = b2 * v + (1.f - b2) * g * g;
  return (m * rbc1) / (sqrtf(v * rbc2) + eps) + wd * p;
}

__global__ void __launch_bounds__(kRowThreads)
lamb_phase1_kernel(const float* __restrict__ hp, const float4* __restrict__ g,
                   const float4* __restrict__ p, float4* __restrict__ m, float4* __restrict__ v,
                   float4* __restrict__ u, const int* __restrict__ seg_rows,
                   const float* __restrict__ wd_seg, float* __restrict__ part, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * kRowWarps + warp;
  if (row >= rows) return;
  const float b1 = hp[0], b2 = hp[1], eps = hp[2], beta3 = hp[3];
  const float rbc1 = hp[4], rbc2 = hp[5], gscale = hp[6];
  const bool skip = hp[7] > 0.f;
  const float wd = wd_seg[seg_rows[row]];
  const long base = row * (kLane / 4);
  float sp = 0.f, su = 0.f;
#pragma unroll 2
  for (int i = 0; i < kVecPerLane; ++i) {
    const long idx = base + lane + 32 * i;
    const float4 pv = p[idx];
    sp = fmaf(pv.x, pv.x, sp);
    sp = fmaf(pv.y, pv.y, sp);
    sp = fmaf(pv.z, pv.z, sp);
    sp = fmaf(pv.w, pv.w, sp);
    if (skip) {
      u[idx] = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const float4 gv = g[idx];
    float4 mv = m[idx], vv = v[idx], uv;
    uv.x = lamb_elem(gv.x, pv.x, mv.x, vv.x, b1, b2, eps, beta3, rbc1, rbc2, gscale, wd);
    uv.y = lamb_elem(gv.y, pv.y, mv.y, vv.y, b1, b2, eps, beta3, rbc1, rbc2, gscale, wd);
    uv.z = lamb_elem(gv.z, pv.z, mv.z, vv.z, b1, b2, eps, beta3, rbc1, rbc2, gscale, wd);
    uv.w = lamb_elem(gv.w, pv.w, mv.w, vv.w, b1, b2, eps, beta3, rbc1, rbc2, gscale, wd);
    su = fmaf(uv.x, uv.x, su);
    su = fmaf(uv.y, uv.y, su);
    su = fmaf(uv.z, uv.z, su);
    su = fmaf(uv.w, uv.w, su);
    m[idx] = mv;
    v[idx] = vv;
    u[idx] = uv;
  }
  sp = warp_sum(sp);
  su = warp_sum(su);
  if (lane == 0) {
    part[row] = sp;
    part[(long)rows + row] = su;
  }
}

__global__ void __launch_bounds__(kRowThreads)
lamb_phase2_kernel(const float* __restrict__ hp, const float4* __restrict__ u,
                   float4* __restrict__ p, const float* __restrict__ ratio,
                   const int* __restrict__ seg_rows, int rows) {
  if (hp[1] > 0.f) return;  // noop: p stays bit-identical
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = (long)blockIdx.x * kRowWarps + warp;
  if (row >= rows) return;
  const float step = hp[0] * ratio[seg_rows[row]];  // lr * ratio, as the reference
  const long base = row * (kLane / 4);
#pragma unroll
  for (int i = 0; i < kVecPerLane; ++i) {
    const long idx = base + lane + 32 * i;
    const float4 uv = u[idx];
    float4 pv = p[idx];
    pv.x = pv.x - step * uv.x;
    pv.y = pv.y - step * uv.y;
    pv.z = pv.z - step * uv.z;
    pv.w = pv.w - step * uv.w;
    p[idx] = pv;
  }
}

}  // namespace

// g, p, m, v, u: fp32 [rows, 1024] (m, v updated in place, u written);
// seg_rows int32 [rows] with each segment's rows contiguous and in order;
// wd_seg fp32 [segments]; part fp32 [2 * rows] scratch; stats fp32
// [2, segments] = per segment ||p||^2, ||u||^2.
extern "C" int apex_lamb_phase1(const void* hp, const void* g, const void* p, void* m, void* v,
                                void* u, const void* seg_rows, const void* wd_seg, void* part,
                                void* stats, int rows, int segments, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || segments <= 0) return static_cast<int>(cudaGetLastError());
  auto* pt = static_cast<float*>(part);
  auto* sr = static_cast<const int*>(seg_rows);
  lamb_phase1_kernel<<<(rows + kRowWarps - 1) / kRowWarps, kRowThreads, 0, s>>>(
      static_cast<const float*>(hp), static_cast<const float4*>(g),
      static_cast<const float4*>(p), static_cast<float4*>(m), static_cast<float4*>(v),
      static_cast<float4*>(u), sr, static_cast<const float*>(wd_seg), pt, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_reduce_kernel<<<segments, kReduceThreads, 0, s>>>(pt, sr, rows,
                                                            static_cast<float*>(stats),
                                                            segments, 2, -1);
  return static_cast<int>(cudaGetLastError());
}

// p updated in place from u; ratio fp32 [segments]; hp2 = [lr, noop].
extern "C" int apex_lamb_phase2(const void* hp, const void* u, void* p, const void* ratio,
                                const void* seg_rows, int rows, void* stream) {
  if (rows > 0)
    lamb_phase2_kernel<<<(rows + kRowWarps - 1) / kRowWarps, kRowThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hp), static_cast<const float4*>(u), static_cast<float4*>(p),
        static_cast<const float*>(ratio), static_cast<const int*>(seg_rows), rows);
  return static_cast<int>(cudaGetLastError());
}
