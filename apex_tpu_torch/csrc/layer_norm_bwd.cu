// LayerNorm and RMSNorm backward: dx, and the fp32 dgamma/dbeta summed over
// all rows.
//
// Replaces the TPU kernel apex_tpu/ops/layer_norm.py::_ln_bwd_kernel
// (pallas_call in _ln_bwd) in all its branches, as compile-time flags:
//  - kRms (rms=True, :158-159, :172-173): xhat = x * rstd with no mean, and
//    dx has no c2 term; no dbeta.
//  - kFromY (memory_efficient=True, :150-156): the forward saved its output
//    y instead of x, and xhat is recovered from it as (y - b) / w with an
//    affine weight (b = 0 without a bias) and as y without one.
// With wdy = w * dy, per row:
//   c1 = mean(xhat * wdy), c2 = mean(wdy),
//   dx = (wdy - xhat * c1 - c2) * rstd       (LayerNorm)
//   dx = (wdy - xhat * c1) * rstd            (RMSNorm)
// and over all rows: dgamma = sum(dy * xhat), dbeta = sum(dy). fp32 math,
// dx in dy's dtype.
//
// Design. The TPU kernel carries dgamma/dbeta in its output block across a
// sequential grid. Hopper's blocks run in no order, so the sum over rows is
// split in two kernels, with no atomics:
//  1. layer_norm_bwd_dx_kernel: one block of 8 warps per tile of kRowsPerBlock
//     rows. Each warp takes whole rows (warp-shuffle sums for c1, c2) and
//     writes dx. Then the block walks its tile column by column, one thread
//     per column (coalesced), and writes its partial sums of dy * xhat and
//     dy into a (n_tiles, cols) fp32 scratch. The tile was just read, so the
//     second walk reads L1/L2, not device memory.
//  2. layer_norm_bwd_dw_kernel: one block per 32 columns sums the scratch
//     over the tiles, each warp a fixed stripe of tiles, then the 8 warps'
//     sums in warp order.
// Every sum is taken in an order fixed by the shapes, so dgamma/dbeta are
// the same bits from run to run (deterministic), unlike fp32 atomicAdd. The
// branches change how xhat is formed and which terms are summed, not the
// order of any sum.
//
// What bounds it on the H100: bytes. It reads dy and x (or y) once from
// device memory and writes dx once, for ~12 FLOPs per element; the scratch
// adds 8 bytes per (tile, column), 1/kRowsPerBlock of the x bytes in fp32.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 32;

// xhat of one element from the saved source `src` (x, or y under kFromY):
// `mu`/`rs` are the row's mean and rstd, `wc`/`bc` the column's weight and
// bias (1 and 0 when absent).
template <bool kRms, bool kFromY>
__device__ __forceinline__ float xhat_of(float src, float mu, float rs, float wc, float bc) {
  if (kFromY) return (src - bc) / wc;
  return kRms ? src * rs : (src - mu) * rs;
}

template <typename T, bool kRms, bool kFromY>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ src,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const float* __restrict__ w, const float* __restrict__ b,
                         T* __restrict__ dx, float* __restrict__ part_w,
                         float* __restrict__ part_b, int rows, int cols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int nr = min(kRowsPerBlock, rows - r0);
  const float inv_cols = 1.f / cols;

  for (int rr = warp; rr < nr; rr += kWarps) {
    const long row = r0 + rr;
    const T* dyr = dy + row * cols;
    const T* sr = src + row * cols;
    const float mu = (kRms || kFromY) ? 0.f : mean[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < cols; c += 32) {
      const float g = to_f32<T>(dyr[c]);
      const float wc = w != nullptr ? w[c] : 1.f;
      const float bc = b != nullptr ? b[c] : 0.f;
      const float wdy = wc * g;
      const float xhat = xhat_of<kRms, kFromY>(to_f32<T>(sr[c]), mu, rs, wc, bc);
      s1 = fmaf(xhat, wdy, s1);
      if (!kRms) s2 += wdy;
    }
    const float c1 = warp_sum(s1) * inv_cols;
    const float c2 = kRms ? 0.f : warp_sum(s2) * inv_cols;
    T* dxr = dx + row * cols;
    for (int c = lane; c < cols; c += 32) {
      const float g = to_f32<T>(dyr[c]);
      const float wc = w != nullptr ? w[c] : 1.f;
      const float bc = b != nullptr ? b[c] : 0.f;
      const float wdy = wc * g;
      const float xhat = xhat_of<kRms, kFromY>(to_f32<T>(sr[c]), mu, rs, wc, bc);
      dxr[c] = from_f32<T>((wdy - xhat * c1 - c2) * rs);
    }
  }

  if (part_w == nullptr) return;
  for (int c = threadIdx.x; c < cols; c += kThreads) {
    const float wc = w[c];
    const float bc = b != nullptr ? b[c] : 0.f;
    float aw = 0.f, ab = 0.f;
    for (int rr = 0; rr < nr; ++rr) {
      const long row = r0 + rr;
      const float g = to_f32<T>(dy[row * cols + c]);
      const float mu = (kRms || kFromY) ? 0.f : mean[row];
      const float xhat =
          xhat_of<kRms, kFromY>(to_f32<T>(src[row * cols + c]), mu, rstd[row], wc, bc);
      aw = fmaf(g, xhat, aw);
      ab += g;
    }
    part_w[(long)blockIdx.x * cols + c] = aw;
    if (part_b != nullptr) part_b[(long)blockIdx.x * cols + c] = ab;
  }
}

__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_dw_kernel(const float* __restrict__ part_w, const float* __restrict__ part_b,
                         float* __restrict__ dw, float* __restrict__ db, int tiles, int cols) {
  __shared__ float sw[kWarps][32];
  __shared__ float sb[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float aw = 0.f, ab = 0.f;
  if (c < cols) {
    for (int t = warp; t < tiles; t += kWarps) {
      aw += part_w[(long)t * cols + c];
      if (part_b != nullptr) ab += part_b[(long)t * cols + c];
    }
  }
  sw[warp][lane] = aw;
  sb[warp][lane] = ab;
  __syncthreads();
  if (warp == 0 && c < cols) {
    float tw = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      tw += sw[i][lane];
      tb += sb[i][lane];
    }
    dw[c] = tw;
    if (db != nullptr) db[c] = tb;
  }
}

template <typename T, bool kRms, bool kFromY>
void launch_dx(const void* dy, const void* src, const float* mean, const float* rstd,
               const float* w, const float* b, void* dx, float* part_w, float* part_b, int rows,
               int cols, int tiles, cudaStream_t s) {
  layer_norm_bwd_dx_kernel<T, kRms, kFromY><<<tiles, kThreads, 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(src), mean, rstd, w, b,
      static_cast<T*>(dx), part_w, part_b, rows, cols);
}

template <typename T>
void launch_dx_branch(int rms, int from_y, const void* dy, const void* src, const float* mean,
                      const float* rstd, const float* w, const float* b, void* dx,
                      float* part_w, float* part_b, int rows, int cols, int tiles,
                      cudaStream_t s) {
  if (rms && from_y)
    launch_dx<T, true, true>(dy, src, mean, rstd, w, b, dx, part_w, part_b, rows, cols, tiles, s);
  else if (rms)
    launch_dx<T, true, false>(dy, src, mean, rstd, w, b, dx, part_w, part_b, rows, cols, tiles, s);
  else if (from_y)
    launch_dx<T, false, true>(dy, src, mean, rstd, w, b, dx, part_w, part_b, rows, cols, tiles, s);
  else
    launch_dx<T, false, false>(dy, src, mean, rstd, w, b, dx, part_w, part_b, rows, cols, tiles,
                               s);
}

}  // namespace

// fp32 elements of the dgamma/dbeta scratch for a (rows, cols) input: the
// wrapper sizes `part` from this, so the tile layout is decided here only.
extern "C" long long apex_layer_norm_bwd_scratch_floats(int rows, int cols) {
  const long long tiles = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  return 2 * tiles * cols;
}

// src: x, or the forward's output y when from_y. mean: null under rms or
// from_y (it is not read). b: the bias, read only under from_y (null: none).
// Scratch: `part` holds apex_layer_norm_bwd_scratch_floats(rows, cols) fp32;
// null when w is null (no dgamma/dbeta). db null: no dbeta.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* src, const void* mean,
                                   const void* rstd, const void* w, const void* b, void* dx,
                                   void* dw, void* db, void* part, int rows, int cols, int rms,
                                   int from_y, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  auto* wf = static_cast<const float*>(w);
  auto* bf = from_y ? static_cast<const float*>(b) : nullptr;
  float* pw = nullptr;
  float* pb = nullptr;
  if (wf != nullptr) {
    pw = static_cast<float*>(part);
    if (db != nullptr) pb = pw + (long)tiles * cols;
  }
  auto* m = static_cast<const float*>(mean);
  auto* r = static_cast<const float*>(rstd);
  if (dtype == APEX_BF16)
    launch_dx_branch<__nv_bfloat16>(rms, from_y, dy, src, m, r, wf, bf, dx, pw, pb, rows, cols,
                                    tiles, s);
  else
    launch_dx_branch<float>(rms, from_y, dy, src, m, r, wf, bf, dx, pw, pb, rows, cols, tiles,
                            s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || wf == nullptr) return static_cast<int>(err);
  layer_norm_bwd_dw_kernel<<<(cols + 31) / 32, kThreads, 0, s>>>(
      pw, pb, static_cast<float*>(dw), static_cast<float*>(db), tiles, cols);
  return static_cast<int>(cudaGetLastError());
}
