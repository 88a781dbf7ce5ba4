// NHWC GroupNorm with an optional fused SiLU: forward (y, and the mean and
// rstd of each (sample, group) slab) and backward (dx, and per-sample
// partials of dweight and dbias).
//
// Replaces the TPU kernels apex_tpu/ops/group_norm.py::_gn_fwd_kernel (:56,
// the pallas_call in _gn_fwd) and ::_gn_bwd_kernel (:153, in _gn_bwd). x is
// [n, hw, c] contiguous (NHWC), fp32, bf16 or fp16, in g groups of cg = c / g
// channels; slab (i, j) is x[i, :, j cg : (j + 1) cg], m = hw cg values,
// read in place (channel stride 1, row stride c): nothing is transposed.
// In fp32, with w and b fp32 (or no affine: w = 1, b = 0):
//   mean = sum x / m;  var = sum (x - mean)^2 / m   (two passes, as the
//        reference's group_norm_reference, which serves every shape whose
//        cg is not a multiple of 128: all of Stable Diffusion's)
//   rstd = rsqrt(var + eps);  xhat = (x - mean) rstd
//   y    = xhat w + b, then silu(y) = y sigmoid(y)            (x's dtype)
// and backward, from the saved mean and rstd, with y' = xhat w + b:
//   d    = dy, or under SiLU dy sig(y') (1 + y' (1 - sig(y')))
//   dw_i = sum_rows d xhat, db_i = sum_rows d      (per sample i, fp32)
//   dyw  = d w;  A = sum_slab dyw / m;  B = sum_slab dyw xhat / m
//   dx   = rstd ((dyw - A) - xhat B)                           (x's dtype)
// The caller sums dw_i and db_i over the samples.
//
// Design: one block of 1024 threads per slab. The threads tile the slab as
// rows of cg channels (cg <= 1024: 1024 / cg rows of threads, each thread
// on one channel, striding over the spatial rows; wider groups: one row of
// 1024 threads striding over the channels), so each thread's channel, and
// its weight and bias, are fixed, no index is divided per element, and a
// thread's channel partials stay in registers until one shared-memory sum
// per channel. The forward makes three passes over the slab (sum, squared
// deviations, write), the backward two (partials and sums, write); the
// later passes hit L2. At Stable Diffusion's n = 8, g = 32 the 256 slabs
// run as one wave on 132 SMs at two blocks each. Sums combine the warps in
// a fixed order (block_reduce): the same bits in every run.
//
// What bounds it on the H100: bytes. The forward reads x once and writes y
// once; the backward reads x and dy and writes dx, ~20 operations an
// element. At Stable Diffusion v1.5's (8, 320, 64, 64) in bf16 that is 42 MB
// and 63 MB: 0.0125 ms and 0.0188 ms at 3.35 TB/s.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

// the thread's place in the slab's tiling: channels jt, jt + tpr, ... < cg
// over spatial rows r0, r0 + rows_per, ... < hw; a thread with r0 >=
// rows_per has no place
struct Tiling {
  int tpr, rows_per, jt, r0;
  __device__ explicit Tiling(int cg) {
    tpr = cg < kThreads ? cg : kThreads;
    rows_per = kThreads / tpr;
    jt = threadIdx.x % tpr;
    r0 = threadIdx.x / tpr;
  }
  __device__ bool active() const { return r0 < rows_per; }
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
group_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y, float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int hw, int c, int cg, float eps) {
  __shared__ float red[kThreads / 32];
  const int slab = blockIdx.x;
  const int groups = c / cg;
  const int i = slab / groups, g = slab % groups;
  const long long base = static_cast<long long>(i) * hw * c + static_cast<long long>(g) * cg;
  const Tiling t(cg);
  const float m = static_cast<float>(hw) * static_cast<float>(cg);

  float s = 0.f;
  if (t.active())
    for (int j = t.jt; j < cg; j += t.tpr)
      for (int p = t.r0; p < hw; p += t.rows_per)
        s += to_f32<T>(x[base + static_cast<long long>(p) * c + j]);
  const float mean = block_reduce<false>(s, red) / m;
  float ss = 0.f;
  if (t.active())
    for (int j = t.jt; j < cg; j += t.tpr)
      for (int p = t.r0; p < hw; p += t.rows_per) {
        const float d = __fsub_rn(to_f32<T>(x[base + static_cast<long long>(p) * c + j]), mean);
        ss += d * d;
      }
  const float var = block_reduce<false>(ss, red) / m;
  const float rstd = rsqrtf(var + eps);
  if (t.active())
    for (int j = t.jt; j < cg; j += t.tpr) {
      const float wj = w != nullptr ? w[g * cg + j] : 1.f;
      const float bj = w != nullptr ? b[g * cg + j] : 0.f;
      for (int p = t.r0; p < hw; p += t.rows_per) {
        const long long at = base + static_cast<long long>(p) * c + j;
        float v = __fmul_rn(__fsub_rn(to_f32<T>(x[at]), mean), rstd);
        if (w != nullptr) v = __fadd_rn(__fmul_rn(v, wj), bj);
        if (kSilu) v = __fmul_rn(v, sigmoid(v));
        y[at] = from_f32<T>(v);
      }
    }
  if (threadIdx.x == 0) {
    mean_out[slab] = mean;
    rstd_out[slab] = rstd;
  }
}

// d of one element: dy, through the SiLU's derivative when fused
template <bool kSilu>
__device__ __forceinline__ float upstream(float dy, float xhat, float wj, float bj) {
  if (!kSilu) return dy;
  const float pre = __fadd_rn(__fmul_rn(xhat, wj), bj);
  const float sig = sigmoid(pre);
  return __fmul_rn(dy, __fmul_rn(sig, __fadd_rn(1.f, __fmul_rn(pre, __fsub_rn(1.f, sig)))));
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ w, const float* __restrict__ b,
                      const float* __restrict__ mean_in, const float* __restrict__ rstd_in,
                      T* __restrict__ dx, float* __restrict__ dw_part, float* __restrict__ db_part,
                      int hw, int c, int cg) {
  __shared__ float red[kThreads / 32];
  __shared__ float sdw[kThreads], sdb[kThreads];
  const int slab = blockIdx.x;
  const int groups = c / cg;
  const int i = slab / groups, g = slab % groups;
  const long long base = static_cast<long long>(i) * hw * c + static_cast<long long>(g) * cg;
  const Tiling t(cg);
  const float m = static_cast<float>(hw) * static_cast<float>(cg);
  const float mean = mean_in[slab], rstd = rstd_in[slab];
  const bool affine = w != nullptr;

  float sum_dyw = 0.f, sum_dyw_xhat = 0.f;
  if (t.active())
    for (int j = t.jt; j < cg; j += t.tpr) {
      const float wj = affine ? w[g * cg + j] : 1.f;
      const float bj = affine ? b[g * cg + j] : 0.f;
      float pdw = 0.f, pdb = 0.f;
      for (int p = t.r0; p < hw; p += t.rows_per) {
        const long long at = base + static_cast<long long>(p) * c + j;
        const float xhat = __fmul_rn(__fsub_rn(to_f32<T>(x[at]), mean), rstd);
        const float d = upstream<kSilu>(to_f32<T>(dy[at]), xhat, wj, bj);
        pdw += d * xhat;
        pdb += d;
        const float dyw = __fmul_rn(d, wj);
        sum_dyw += dyw;
        sum_dyw_xhat += dyw * xhat;
      }
      if (!affine) continue;
      if (t.rows_per == 1) {  // the thread owns the whole channel
        dw_part[static_cast<long long>(i) * c + g * cg + j] = pdw;
        db_part[static_cast<long long>(i) * c + g * cg + j] = pdb;
      } else {  // one channel a thread: summed over the thread rows below
        sdw[threadIdx.x] = pdw;
        sdb[threadIdx.x] = pdb;
      }
    }
  if (affine && t.rows_per > 1) {
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < cg) {
      float a = 0.f, z = 0.f;
      for (int r = 0; r < t.rows_per; ++r) {
        a += sdw[r * t.tpr + threadIdx.x];
        z += sdb[r * t.tpr + threadIdx.x];
      }
      dw_part[static_cast<long long>(i) * c + g * cg + threadIdx.x] = a;
      db_part[static_cast<long long>(i) * c + g * cg + threadIdx.x] = z;
    }
  }
  const float a = block_reduce<false>(sum_dyw, red) / m;
  const float bq = block_reduce<false>(sum_dyw_xhat, red) / m;
  if (t.active())
    for (int j = t.jt; j < cg; j += t.tpr) {
      const float wj = affine ? w[g * cg + j] : 1.f;
      const float bj = affine ? b[g * cg + j] : 0.f;
      for (int p = t.r0; p < hw; p += t.rows_per) {
        const long long at = base + static_cast<long long>(p) * c + j;
        const float xhat = __fmul_rn(__fsub_rn(to_f32<T>(x[at]), mean), rstd);
        const float dyw = __fmul_rn(upstream<kSilu>(to_f32<T>(dy[at]), xhat, wj, bj), wj);
        const float v = __fsub_rn(__fsub_rn(dyw, a), __fmul_rn(xhat, bq));
        dx[at] = from_f32<T>(__fmul_rn(rstd, v));
      }
    }
}

template <typename T>
void launch_fwd(const void* x, const float* w, const float* b, void* y, float* mean, float* rstd,
                int slabs, int hw, int c, int cg, float eps, int silu, cudaStream_t s) {
  auto* xt = static_cast<const T*>(x);
  auto* yt = static_cast<T*>(y);
  if (silu)
    group_norm_fwd_kernel<T, true><<<slabs, kThreads, 0, s>>>(xt, w, b, yt, mean, rstd, hw, c, cg, eps);
  else
    group_norm_fwd_kernel<T, false><<<slabs, kThreads, 0, s>>>(xt, w, b, yt, mean, rstd, hw, c, cg, eps);
}

template <typename T>
void launch_bwd(const void* x, const void* dy, const float* w, const float* b, const float* mean,
                const float* rstd, void* dx, float* dwp, float* dbp, int slabs, int hw, int c,
                int cg, int silu, cudaStream_t s) {
  auto* xt = static_cast<const T*>(x);
  auto* gt = static_cast<const T*>(dy);
  auto* dt = static_cast<T*>(dx);
  if (silu)
    group_norm_bwd_kernel<T, true><<<slabs, kThreads, 0, s>>>(xt, gt, w, b, mean, rstd, dt, dwp,
                                                              dbp, hw, c, cg);
  else
    group_norm_bwd_kernel<T, false><<<slabs, kThreads, 0, s>>>(xt, gt, w, b, mean, rstd, dt, dwp,
                                                               dbp, hw, c, cg);
}

}  // namespace

// x, y: [n, hw, c] (dtype code); w, b: fp32 [c] or both null (no affine);
// mean, rstd: fp32 [n, c / cg].
extern "C" int apex_group_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                   void* mean, void* rstd, int n, int hw, int c, int cg,
                                   float eps, int silu, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<const float*>(w);
  auto* bf = static_cast<const float*>(b);
  auto* mf = static_cast<float*>(mean);
  auto* rf = static_cast<float*>(rstd);
  const int slabs = n * (c / cg);
  if (slabs > 0 && hw > 0) {
    if (dtype == APEX_BF16)
      launch_fwd<__nv_bfloat16>(x, wf, bf, y, mf, rf, slabs, hw, c, cg, eps, silu, s);
    else if (dtype == APEX_F16)
      launch_fwd<__half>(x, wf, bf, y, mf, rf, slabs, hw, c, cg, eps, silu, s);
    else
      launch_fwd<float>(x, wf, bf, y, mf, rf, slabs, hw, c, cg, eps, silu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: [n, hw, c] (dtype code); w, b: fp32 [c] or null; mean, rstd:
// the forward's; dw_part, db_part: fp32 [n, c] (null without affine).
extern "C" int apex_group_norm_bwd(const void* x, const void* dy, const void* w, const void* b,
                                   const void* mean, const void* rstd, void* dx, void* dw_part,
                                   void* db_part, int n, int hw, int c, int cg, int silu,
                                   int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* wf = static_cast<const float*>(w);
  auto* bf = static_cast<const float*>(b);
  auto* mf = static_cast<const float*>(mean);
  auto* rf = static_cast<const float*>(rstd);
  auto* dwp = static_cast<float*>(dw_part);
  auto* dbp = static_cast<float*>(db_part);
  const int slabs = n * (c / cg);
  if (slabs > 0 && hw > 0) {
    if (dtype == APEX_BF16)
      launch_bwd<__nv_bfloat16>(x, dy, wf, bf, mf, rf, dx, dwp, dbp, slabs, hw, c, cg, silu, s);
    else if (dtype == APEX_F16)
      launch_bwd<__half>(x, dy, wf, bf, mf, rf, dx, dwp, dbp, slabs, hw, c, cg, silu, s);
    else
      launch_bwd<float>(x, dy, wf, bf, mf, rf, dx, dwp, dbp, slabs, hw, c, cg, silu, s);
  }
  return static_cast<int>(cudaGetLastError());
}
