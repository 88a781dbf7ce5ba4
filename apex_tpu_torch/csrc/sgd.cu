// Fused SGD step (momentum, dampening, Nesterov blend, weight decay) over
// the flat fp32 (rows, 1024) parameter buffers.
//
// Replaces the TPU kernel apex_tpu/ops/optim_kernels.py::_sgd_kernel
// (pallas_call in sgd_update). Per element, with the hyper-parameters read
// from a 6-float device row hp = [lr, momentum, dampening, wd, nesterov,
// noop] (the reference's SMEM row; no grad scale, which the reference's row
// has no slot for):
//   g = g + wd p
//   with momentum:  m = mu m + (1 - damp) g
//                   d = nesterov (g + mu m) + (1 - nesterov) m
//   without:        d = g, m untouched
//   p = p - lr d
// The first-step rule (dampening 0 at step 1) is folded into hp by the
// wrapper. The Nesterov blend is the reference's expression, not a branch,
// so a non-finite gradient gives the reference's result. p and m are
// updated in place (the reference's input_output_aliases). noop > 0 leaves
// both untouched, bit for bit: the block returns before it reads or writes.
//
// Design: one block of 256 threads per row, one float4 per thread, so every
// load and store is a coalesced 16-byte access.
//
// What bounds it on the H100: bytes. With momentum, 12 bytes read per
// element (g, p, m) and 8 written (p, m) for ~9 FLOPs: ResNet-50's
// 25,021 rows of 1024 move 512 MB, ~0.153 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kLane = 1024;
constexpr int kThreads = kLane / 4;

__device__ __forceinline__ void sgd_elem(float g, float& p, float& m, float lr, float mu,
                                         float damp, float wd, float nest, bool use_momentum) {
  g = g + wd * p;
  float d = g;
  if (use_momentum) {
    m = mu * m + (1.f - damp) * g;
    d = nest * (g + mu * m) + (1.f - nest) * m;
  }
  p = p - lr * d;
}

__global__ void __launch_bounds__(kThreads)
sgd_kernel(const float* __restrict__ hp, const float4* __restrict__ g, float4* __restrict__ p,
           float4* __restrict__ m, int use_momentum) {
  if (hp[5] > 0.f) return;  // noop: state stays bit-identical
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  const float lr = hp[0], mu = hp[1], damp = hp[2], wd = hp[3], nest = hp[4];
  const bool um = use_momentum != 0;
  const float4 gv = g[i];
  float4 pv = p[i];
  float4 mv = um ? m[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  sgd_elem(gv.x, pv.x, mv.x, lr, mu, damp, wd, nest, um);
  sgd_elem(gv.y, pv.y, mv.y, lr, mu, damp, wd, nest, um);
  sgd_elem(gv.z, pv.z, mv.z, lr, mu, damp, wd, nest, um);
  sgd_elem(gv.w, pv.w, mv.w, lr, mu, damp, wd, nest, um);
  p[i] = pv;
  if (um) m[i] = mv;
}

}  // namespace

// hp fp32 [6]; g, p, m fp32 [rows, 1024]; use_momentum 0 leaves m unread
// and unwritten.
extern "C" int apex_sgd(const void* hp, const void* g, void* p, void* m, int rows,
                        int use_momentum, void* stream) {
  if (rows > 0)
    sgd_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(hp), static_cast<const float4*>(g), static_cast<float4*>(p),
        static_cast<float4*>(m), use_momentum);
  return static_cast<int>(cudaGetLastError());
}
