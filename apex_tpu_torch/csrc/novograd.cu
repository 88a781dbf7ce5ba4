// Fused NovoGrad update over the flat fp32 (rows, 1024) parameter buffers,
// normalized by a per-tensor second moment.
//
// Replaces the TPU kernel apex_tpu/ops/optim_kernels.py::_novograd_kernel
// (pallas_call in novograd_update). The per-tensor sum(g^2) comes first
// from the segment_stats kernel, and the wrapper turns it into
// vden[t] = sqrt(v[t]) + eps on the device (a vector of one float per
// tensor). Per element of row r, with the hyper-parameters read from a
// 7-float device row hp = [b1, beta3, eps (unused), wd, lr, grad_scale,
// noop]:
//   gn = (g grad_scale) / vden[seg_rows[r]] + wd p
//   m = b1 m + beta3 gn;      p = p - lr m
// The reference gathers vden per row with a one-hot product on the MXU;
// here each block reads its row's tensor index and that one float. p and m
// are updated in place. noop > 0 leaves both untouched, bit for bit: the
// block returns before it reads or writes anything.
//
// Design: one block of 256 threads per row, one float4 per thread
// (coalesced 16-byte accesses); the division is IEEE fp32, as the
// reference's.
//
// What bounds it on the H100: bytes. 12 bytes read per element (g, p, m)
// and 8 written (p, m): ResNet-50's 25,021 rows of 1024 move 512 MB,
// ~0.153 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = kLane / 4;

__device__ __forceinline__ void novograd_elem(float g, float& p, float& m, float b1, float beta3,
                                              float wd, float lr, float gscale, float den) {
  const float gn = (g * gscale) / den + wd * p;
  m = b1 * m + beta3 * gn;
  p = p - lr * m;
}

__global__ void __launch_bounds__(kThreads)
novograd_kernel(const float* __restrict__ hp, const float4* __restrict__ g,
                float4* __restrict__ p, float4* __restrict__ m, const float* __restrict__ vden,
                const int* __restrict__ seg_rows) {
  if (hp[6] > 0.f) return;  // noop: state stays bit-identical
  const long row = blockIdx.x;
  const long i = row * kThreads + threadIdx.x;
  const float b1 = hp[0], beta3 = hp[1], wd = hp[3], lr = hp[4], gscale = hp[5];
  const float den = vden[seg_rows[row]];
  const float4 gv = g[i];
  float4 pv = p[i], mv = m[i];
  novograd_elem(gv.x, pv.x, mv.x, b1, beta3, wd, lr, gscale, den);
  novograd_elem(gv.y, pv.y, mv.y, b1, beta3, wd, lr, gscale, den);
  novograd_elem(gv.z, pv.z, mv.z, b1, beta3, wd, lr, gscale, den);
  novograd_elem(gv.w, pv.w, mv.w, b1, beta3, wd, lr, gscale, den);
  p[i] = pv;
  m[i] = mv;
}

}  // namespace

// hp fp32 [7]; g, p, m fp32 [rows, 1024]; vden fp32 [segments]; seg_rows
// int32 [rows].
extern "C" int apex_novograd(const void* hp, const void* g, void* p, void* m, const void* vden,
                             const void* seg_rows, int rows, void* stream) {
  if (rows > 0)
    novograd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hp), static_cast<const float4*>(g), static_cast<float4*>(p),
        static_cast<float4*>(m), static_cast<const float*>(vden),
        static_cast<const int*>(seg_rows));
  return static_cast<int>(cudaGetLastError());
}
