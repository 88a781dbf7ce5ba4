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
// What bounds it on the H100: bytes. It reads dy and x (or y) once from
// device memory and writes dx once, for ~12 FLOPs per element.
//
// Design. A row belongs to a team of `ts` threads (a warp, or 2-8 warps for
// wide rows), and a block of 256 threads holds 256 / ts teams. The tile
// choice lives in one place, ops/layer_norm.py::norm_bwd_plan, which the
// wrapper passes here: the team's width, NV 16-byte slots a thread holds
// (up to 2 in bf16, 4 in fp32: 16 values, whose accumulators fit the 128
// registers of two blocks an SM; 3 bf16 slots spilled 160-220 bytes), the
// blocks (a team a row up to two blocks an SM). Team t of the grid takes
// rows t, t + T, t + 2T, ...
// (T the grid's teams). Per row:
//  - each thread reads its slots of dy and x (or y) once, with 16-byte
//    loads where the width and the pointers allow (one element at a time
//    otherwise, zero past the row), and keeps dy and xhat in registers;
//    xhat is formed once per element. Under kFromY the division by w is a
//    multiplication by 1 / w, one correctly rounded reciprocal of each
//    column per block, kept in shared memory.
//  - c1 and c2 are warp-shuffle sums, then (teams wider than a warp) the
//    warps' sums in warp order through shared memory behind the team's own
//    named barrier: no block-wide barrier per row.
//  - dx is written from the registers, and each thread adds g * xhat and g
//    into its columns' fp32 dgamma/dbeta accumulators, also registers.
// After its rows the block adds its teams' accumulators in team order
// through shared memory and writes one partial row. Then the grid,
// co-resident by construction (at most two 256-thread blocks an SM under
// __launch_bounds__(256, 2), launched cooperatively), meets at a grid
// barrier, and its blocks sum the partial rows, 32 columns at a time: each
// warp a fixed stripe of the partials, then the 8 warps in warp order. So
// the call is one launch at every row count (a second kernel for the sum
// measured 0.7-0.9 us less on the card's clock at 77 rows, and costs the
// host a launch). Every sum runs in an order fixed by the shape,
// so dgamma/dbeta are the same bits from run to run (no fp32 atomicAdd). A
// row wider than 256 threads x NV slots is walked in
// `passes`: x is read again (from L2) and xhat formed again for dx, and
// each thread keeps its columns' accumulators in the block's shared memory
// (acc_smem: 8 bytes a column, up to ~28 K columns), 16 bytes at a time
// and read and written by that thread alone; the block then writes them
// as its partial row. Rows wider than that keep them in the partial row
// in device memory.

#include <cooperative_groups.h>

#include "norm_rows.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Per-column parameters (w, b, 1 / w) are read again for every row, from
// L1 or shared memory, by loads the compiler may not hoist out of the row
// loop: hoisted, a thread's slots of them would hold 8-24 registers each
// for the whole kernel and spill the accumulators.
template <bool kGlobal>
__device__ __forceinline__ float4 ld_param4(const float* p) {
  float4 v;
  if constexpr (kGlobal)
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
  else
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

template <bool kGlobal>
__device__ __forceinline__ float ld_param(const float* p) {
  float v;
  if constexpr (kGlobal)
    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  else
    asm volatile("ld.shared.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// kPack values of a per-column vector from column c0 (`fill` past the
// row's end): 16-byte loads when vec (c0 is then a multiple of 4)
template <bool kGlobal, int kPack>
__device__ __forceinline__ void load_cols(const float* p, int c0, int cols, int vec, float fill,
                                          float (&v)[kPack]) {
  if (vec && c0 + kPack <= cols) {
#pragma unroll
    for (int i = 0; i < kPack / 4; ++i) {
      const float4 f = ld_param4<kGlobal>(p + c0 + 4 * i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < kPack; ++e) v[e] = c0 + e < cols ? ld_param<kGlobal>(p + c0 + e) : fill;
}

// dgamma/dbeta of columns 32 chunk .. 32 chunk + 31: the `tiles` partial
// rows summed by warp w over tiles w, w + 8, ..., then the 8 warps' sums in
// warp order (sw, sb: the block's [8][32] shared scratch)
__device__ __forceinline__ void sum_partials(const float* __restrict__ part_w,
                                             const float* __restrict__ part_b,
                                             float* __restrict__ dw, float* __restrict__ db,
                                             int tiles, int cols, int chunk, float (*sw)[32],
                                             float (*sb)[32]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = chunk * 32 + lane;
  constexpr int kBatch = 4;  // partials in flight a warp, added in order
  float aw = 0.f, ab = 0.f;
  if (c < cols) {
    for (int t0 = warp; t0 < tiles; t0 += kWarps * kBatch) {
      float vw[kBatch], vb[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int t = t0 + i * kWarps;
        vw[i] = t < tiles ? __ldcg(part_w + static_cast<long>(t) * cols + c) : 0.f;
        vb[i] = (t < tiles && part_b != nullptr)
                    ? __ldcg(part_b + static_cast<long>(t) * cols + c) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (t0 + i * kWarps < tiles) {
          aw += vw[i];
          ab += vb[i];
        }
      }
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
  __syncthreads();
}

template <typename T, bool kRms, bool kFromY, int NV, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
layer_norm_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ src,
                      const float* __restrict__ mean, const float* __restrict__ rstd,
                      const float* __restrict__ w, const float* __restrict__ b,
                      T* __restrict__ dx, float* __restrict__ part_w, float* __restrict__ part_b,
                      float* __restrict__ dw, float* __restrict__ db, int rows, int cols, int ts,
                      int passes, int vec, int acc_smem) {
  constexpr int kPack = Slot<T>::kPack;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][kWarps][2];
  const bool affine = w != nullptr;
  const bool recip = kFromY && affine;  // xhat = (y - b) * (1 / w)
  const int teams = kThreads / ts, team = threadIdx.x / ts, tt = threadIdx.x % ts;
  const int wpt = ts / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long n_teams = static_cast<long>(gridDim.x) * teams;
  const float inv_cols = 1.f / cols;
  constexpr bool held = !kWide;  // the row stays in registers between the sweeps
  // 1 / w of each column (the row held), then the teams' sums
  float* rw_s = smem;
  float* buf = smem + ((recip && held) ? cols : 0);
  if (recip && held)
    for (int c = threadIdx.x; c < cols; c += kThreads) rw_s[c] = __frcp_rn(w[c]);
  float* pw = affine ? part_w + static_cast<long>(blockIdx.x) * cols : nullptr;
  float* pb = part_b != nullptr ? part_b + static_cast<long>(blockIdx.x) * cols : nullptr;
  // the wide path's accumulators: shared memory, or the partial row itself
  float* qw = (!held && acc_smem) ? smem : pw;
  float* qb = (!held && acc_smem && pb != nullptr) ? smem + cols : pb;
  if (affine && !held) {
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      qw[c] = 0.f;
      if (qb != nullptr) qb[c] = 0.f;
    }
  }
  __syncthreads();

  // a slot's weights (1 without), and under kFromY its biases (0 without)
  // and reciprocal weights
  auto params = [&](int c0, float (&wc)[kPack], float (&bc)[kPack], float (&rc)[kPack]) {
#pragma unroll
    for (int e = 0; e < kPack; ++e) wc[e] = 1.f, bc[e] = 0.f, rc[e] = 1.f;
    if (!affine) return;
    load_cols<true>(w, c0, cols, vec, 1.f, wc);
    if constexpr (kFromY) {
      if (b != nullptr) load_cols<true>(b, c0, cols, vec, 0.f, bc);
      if (held) {
        load_cols<false>(rw_s, c0, cols, vec, 1.f, rc);
      } else {
#pragma unroll
        for (int e = 0; e < kPack; ++e) rc[e] = __frcp_rn(wc[e]);
      }
    }
  };
  auto xhat_of = [&](float v, float mu, float rs, float bc, float rc) {
    if (kFromY) return recip ? (v - bc) * rc : v;
    return kRms ? v * rs : (v - mu) * rs;
  };
  // the wide path: a slot's g * xhat and g into its columns' accumulators,
  // 16 bytes at a time where the slot is whole and aligned
  auto add_slot = [&](int c0, const float (&g)[kPack], const float (&xv)[kPack]) {
    if (vec && c0 + kPack <= cols) {
#pragma unroll
      for (int i = 0; i < kPack / 4; ++i) {
        float4* aw4 = reinterpret_cast<float4*>(qw + c0) + i;
        float4 a = *aw4;
        a.x = fmaf(g[4 * i], xv[4 * i], a.x);
        a.y = fmaf(g[4 * i + 1], xv[4 * i + 1], a.y);
        a.z = fmaf(g[4 * i + 2], xv[4 * i + 2], a.z);
        a.w = fmaf(g[4 * i + 3], xv[4 * i + 3], a.w);
        *aw4 = a;
        if (qb != nullptr) {
          float4* ab4 = reinterpret_cast<float4*>(qb + c0) + i;
          float4 t = *ab4;
          t.x += g[4 * i];
          t.y += g[4 * i + 1];
          t.z += g[4 * i + 2];
          t.w += g[4 * i + 3];
          *ab4 = t;
        }
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < kPack; ++e) {
      if (c0 + e >= cols) continue;
      qw[c0 + e] = fmaf(g[e], xv[e], qw[c0 + e]);
      if (qb != nullptr) qb[c0 + e] += g[e];
    }
  };

  float aw[NV][kPack], ab[NV][kPack];
  uint4 graw[NV];
  float xh[NV][kPack];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < kPack; ++e) aw[j][e] = ab[j][e] = 0.f;

  int parity = 0;
  for (long row = blockIdx.x * static_cast<long>(teams) + team; row < rows; row += n_teams) {
    const T* dyr = dy + row * cols;
    const T* sr = src + row * cols;
    const float mu = (kRms || kFromY) ? 0.f : mean[row];
    const float rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int s = (p * NV + j) * ts + tt, c0 = s * kPack;
        const uint4 gr = load_slot(dyr, s, cols, vec);
        if constexpr (held) graw[j] = gr;
        if (c0 >= cols) {
#pragma unroll
          for (int e = 0; e < kPack; ++e) xh[j][e] = 0.f;
          continue;
        }
        const uint4 xr = load_slot(sr, s, cols, vec);
        float wc[kPack], bc[kPack], rc[kPack];
        params(c0, wc, bc, rc);
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const float wdy = wc[e] * elem<T>(gr, e);
          const float xhat = c0 + e < cols ? xhat_of(elem<T>(xr, e), mu, rs, bc[e], rc[e]) : 0.f;
          s1 = fmaf(xhat, wdy, s1);
          if (!kRms) s2 += wdy;
          if constexpr (held) xh[j][e] = xhat;
        }
      }
    }
    s1 = warp_sum(s1);
    if (!kRms) s2 = warp_sum(s2);
    if (wpt > 1) {
      if (lane == 0) {
        red[parity][warp][0] = s1;
        red[parity][warp][1] = s2;
      }
      team_sync(1 + team, ts);
      s1 = s2 = 0.f;
      for (int i = 0; i < wpt; ++i) {
        s1 += red[parity][team * wpt + i][0];
        s2 += red[parity][team * wpt + i][1];
      }
      parity ^= 1;
    }
    const float c1 = s1 * inv_cols;
    const float c2 = kRms ? 0.f : s2 * inv_cols;
    T* dxr = dx + row * cols;
    for (int p = 0; p < passes; ++p) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int s = (p * NV + j) * ts + tt, c0 = s * kPack;
        if (c0 >= cols) continue;
        uint4 gr = make_uint4(0u, 0u, 0u, 0u), xr = gr;
        float wc[kPack], bc[kPack], rc[kPack];
        if constexpr (held) {
          gr = graw[j];
#pragma unroll
          for (int e = 0; e < kPack; ++e) wc[e] = 1.f;
          if (affine) load_cols<true>(w, c0, cols, vec, 1.f, wc);
        } else {
          gr = load_slot(dyr, s, cols, vec);
          xr = load_slot(sr, s, cols, vec);
          params(c0, wc, bc, rc);
        }
        float out[kPack], gs[kPack], xs[kPack];
#pragma unroll
        for (int e = 0; e < kPack; ++e) {
          const float g = elem<T>(gr, e);
          float xhat = 0.f;
          if constexpr (held)
            xhat = xh[j][e];
          else if (c0 + e < cols)
            xhat = xhat_of(elem<T>(xr, e), mu, rs, bc[e], rc[e]);
          out[e] = (wc[e] * g - xhat * c1 - c2) * rs;
          gs[e] = g;
          xs[e] = xhat;
          if (affine && held) {
            aw[j][e] = fmaf(g, xhat, aw[j][e]);
            ab[j][e] += g;
          }
        }
        if (affine && !held) add_slot(c0, gs, xs);
        store_slot<T>(dxr, s, cols, vec, out);
      }
    }
  }
  if (!affine) return;

  if constexpr (held) {
    // the teams' accumulators into one partial row, in team order
    for (int k = 0; k < teams; ++k) {
      if (team == k) {
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < kPack; ++e) {
            const int c = (j * ts + tt) * kPack + e;
            if (c >= cols) continue;
            if (teams == 1) {
              if (vec) continue;  // whole slots below, 16 bytes at a time
              pw[c] = aw[j][e];
              if (pb != nullptr) pb[c] = ab[j][e];
            } else {
              buf[c] = k == 0 ? aw[j][e] : buf[c] + aw[j][e];
              if (pb != nullptr) buf[cols + c] = k == 0 ? ab[j][e] : buf[cols + c] + ab[j][e];
            }
          }
      }
      if (teams > 1) __syncthreads();
    }
    if (teams == 1 && vec) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c0 = (j * ts + tt) * kPack;
        if (c0 >= cols) continue;
#pragma unroll
        for (int i = 0; i < kPack / 4; ++i) {
          reinterpret_cast<float4*>(pw + c0)[i] =
              make_float4(aw[j][4 * i], aw[j][4 * i + 1], aw[j][4 * i + 2], aw[j][4 * i + 3]);
          if (pb != nullptr)
            reinterpret_cast<float4*>(pb + c0)[i] =
                make_float4(ab[j][4 * i], ab[j][4 * i + 1], ab[j][4 * i + 2], ab[j][4 * i + 3]);
        }
      }
    }
    if (teams > 1) {
      for (int c = threadIdx.x; c < cols; c += kThreads) {
        pw[c] = buf[c];
        if (pb != nullptr) pb[c] = buf[cols + c];
      }
    }
  } else if (acc_smem) {
    // the block's accumulators out of shared memory, as its partial row
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += kThreads) {
      pw[c] = qw[c];
      if (pb != nullptr) pb[c] = qb[c];
    }
  }
  // every block's partial row is written: the grid meets, then sums them
  __shared__ float sw[kWarps][32], sb[kWarps][32];
  __threadfence();
  cg::this_grid().sync();
  for (int chunk = blockIdx.x; chunk < (cols + 31) / 32; chunk += gridDim.x)
    sum_partials(part_w, part_b, dw, db, gridDim.x, cols, chunk, sw, sb);
}

struct Args {
  const void *dy, *src;
  const float *mean, *rstd, *w, *b;
  void* dx;
  float *part_w, *part_b, *dw, *db;
  int rows, cols, ts, passes, vec, blocks, acc_smem;
  size_t smem;
};

template <typename T, bool kRms, bool kFromY, int NV>
cudaError_t launch_nv(const Args& a, cudaStream_t s) {
  auto kernel = layer_norm_bwd_kernel<T, kRms, kFromY, NV, false>;
  if (a.passes > 1) {  // a wide row: 2 slots a pass (ops/layer_norm.py)
    if constexpr (NV == 2)
      kernel = layer_norm_bwd_kernel<T, kRms, kFromY, NV, true>;
    else
      return cudaErrorInvalidValue;
  }
  if (a.smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(a.smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(a.blocks);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = a.smem;
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;  // the grid barrier
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = a.w != nullptr ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(a.dy),
                            static_cast<const T*>(a.src), a.mean, a.rstd, a.w, a.b,
                            static_cast<T*>(a.dx), a.part_w, a.part_b, a.dw, a.db, a.rows, a.cols,
                            a.ts, a.passes, a.vec, a.acc_smem);
}

template <typename T, bool kRms, bool kFromY>
cudaError_t launch_branch(int nv, const Args& a, cudaStream_t s) {
  // the plan's caps (ops/layer_norm.py NORM_BWD_MAX_SLOTS): 16 values a
  // thread, 2 slots of bf16 or 4 of fp32; more spill the accumulators
  switch (nv) {
    case 1: return launch_nv<T, kRms, kFromY, 1>(a, s);
    case 2: return launch_nv<T, kRms, kFromY, 2>(a, s);
    default:
      if constexpr (sizeof(T) == 4) {
        if (nv == 3) return launch_nv<T, kRms, kFromY, 3>(a, s);
        if (nv == 4) return launch_nv<T, kRms, kFromY, 4>(a, s);
      }
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_dtype(int rms, int from_y, int nv, const Args& a, cudaStream_t s) {
  if (rms && from_y) return launch_branch<T, true, true>(nv, a, s);
  if (rms) return launch_branch<T, true, false>(nv, a, s);
  if (from_y) return launch_branch<T, false, true>(nv, a, s);
  return launch_branch<T, false, false>(nv, a, s);
}

}  // namespace

// src: x, or the forward's output y when from_y. mean: null under rms or
// from_y (it is not read). b: the bias, read only under from_y (null: none).
// The tile plan (ops/layer_norm.py::norm_bwd_plan): `ts` threads a row
// (a multiple of 32 dividing 256), `nv` 16-byte slots a thread (1-4; 2
// when `passes` > 1), `passes` over a wide row, `blocks` (at most two an
// SM: with w they are launched cooperatively); `vec`: 16-byte
// loads (cols a multiple of 16 bytes' values, dy/src/dx 16-byte aligned);
// `acc_smem`: with passes > 1, dgamma/dbeta accumulate in 8 * cols bytes of
// shared memory (the plan leaves room for its blocks an SM).
// `part`: 2 * blocks * cols fp32 when w is given (null: no dgamma/dbeta,
// and w null). db null: no dbeta.
extern "C" int apex_layer_norm_bwd(const void* dy, const void* src, const void* mean,
                                   const void* rstd, const void* w, const void* b, void* dx,
                                   void* dw, void* db, void* part, int rows, int cols, int rms,
                                   int from_y, int dtype, int ts, int nv, int passes, int blocks,
                                   int vec, int acc_smem, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (ts < 32 || ts > kThreads || kThreads % ts || nv < 1 || passes < 1 || blocks < 1 ||
      static_cast<long>(passes) * nv * ts * (dtype == APEX_BF16 ? 8 : 4) < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.dy = dy;
  a.src = src;
  a.mean = static_cast<const float*>(mean);
  a.rstd = static_cast<const float*>(rstd);
  a.w = static_cast<const float*>(w);
  a.b = from_y ? static_cast<const float*>(b) : nullptr;
  a.dx = dx;
  a.part_w = a.w != nullptr ? static_cast<float*>(part) : nullptr;
  a.part_b = (a.w != nullptr && db != nullptr) ? a.part_w + static_cast<long>(blocks) * cols
                                                : nullptr;
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.rows = rows;
  a.cols = cols;
  a.ts = ts;
  a.passes = passes;
  a.vec = vec;
  a.blocks = blocks;
  a.acc_smem = passes > 1 && a.w != nullptr && acc_smem;
  const int teams = kThreads / ts;
  a.smem = sizeof(float) * cols *
           (((from_y && a.w != nullptr && passes == 1) ? 1 : 0) +
            ((a.w != nullptr && passes == 1 && teams > 1) ? 2 : 0) + (a.acc_smem ? 2 : 0));
  const cudaError_t err = dtype == APEX_BF16
                              ? launch_dtype<__nv_bfloat16>(rms, from_y, nv, a, s)
                              : launch_dtype<float>(rms, from_y, nv, a, s);
  return static_cast<int>(err);
}
