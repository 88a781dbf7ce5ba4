// LayerNorm forward: y = (x - mean) * rstd * w + b over the last dimension,
// with fp32 statistics, fp32 weight and bias over an fp32 or bf16 x, and y
// in x's dtype. Also writes the per-row fp32 mean and rstd. With `rms` set,
// RMSNorm: mean is 0, var = mean(x^2), y = x * rstd * w (no bias).
//
// Replaces the TPU kernel apex_tpu/ops/layer_norm.py::_ln_fwd_kernel
// (pallas_call in _ln_fwd) in all its branches: affine or not, with a bias
// or none, and rms=True (lines 57-59) as a compile-time flag.
// memory_efficient runs the same forward.
//
// What bounds it on the H100: bytes. It reads x once and writes y once
// (plus 8 bytes of statistics per row) for ~8 FLOPs per element. Rows are
// short (768 values for GPT-2-small, 1024 for BERT, 4096 for Mistral-7B):
// a block a row with block-wide barriers would spend its time in barriers
// and latency, with too few bytes in flight to keep HBM busy.
//
// Design. A row belongs to a team of `ts` threads (a warp up to 1024 bf16
// or fp32 columns, 2-8 warps for wider rows), and a block holds up to
// 256 / ts teams, one row each: fewer while the rows do not cover every SM
// with full blocks, so that a decode step's 8 rows take 8 SMs and not one
// (a block's teams share nothing but its launch). The tile choice lives in
// one place, ops/layer_norm.py::norm_fwd_plan, which the wrapper passes
// here: the team's width and the NV 16-byte slots each thread holds (32
// values a thread, 64 bf16 values at a team of 256), a function of the
// width and the element size alone. So a row is computed alike whatever
// the batch: a decode step's 8 rows, a prefill's and a training step's
// give a row the same bits. Per row:
//  - each thread reads its slots s = j * ts + tt once, with 16-byte loads
//    where the width and the pointers allow (the <kVec> instances; one
//    element at a time otherwise, as the same slots, so the sums and their
//    order are the same), and keeps them in registers;
//  - the mean and the centred variance (the reference's two-pass formula,
//    not E[x^2] - E[x]^2) are both taken from the registers: each thread
//    sums its values in slot order, then the warp by an xor butterfly
//    (every lane ends with the same bits), then, for a team wider than a
//    warp, the warps' sums in warp order through shared memory behind the
//    team's own named barrier. RMSNorm skips the mean;
//  - w and b are read as float4, y written with 16-byte stores, and the
//    team's first thread writes the row's mean and rstd. When the grid is
//    at most a block an SM (few rows: a row's latency is the time), a
//    thread that holds at most 32 values reads its w and b with x
//    (kHoist), so that the two reads overlap; with more rows the registers
//    they would hold cost more warps in flight than the overlap gains.
// A row wider than 256 threads hold (over 16384 bf16 or 8192 fp32 values)
// is walked in `passes` of NV slots a thread (kWide): x is read three
// times, the second and third from L2.

#include "norm_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// slots a thread holds in each pass of a wide row: 32 values (the plan's
// NORM_FWD_SLOTS)
template <typename T>
constexpr int kWideSlots = 32 / Slot<T>::kPack;

// Sum of v over the team's ts threads (whole warps), in a fixed order:
// the warp's xor butterfly, then the team's warps in warp order through
// red[parity] behind the team's barrier. Every thread of the team gets the
// same bits. Two buffers in turn: a team's next sum writes the other one,
// and the barrier between them orders the one after it.
__device__ __forceinline__ float team_sum(float v, int ts, int team, float (*red)[kWarps],
                                          int& parity) {
  v = warp_sum(v);
  if (ts == 32) return v;
  const int wpt = ts / 32, w0 = team * wpt;
  if (threadIdx.x % 32 == 0) red[parity][threadIdx.x / 32] = v;
  team_sync(1 + team, ts);
  float t = red[parity][w0];
  for (int i = 1; i < wpt; ++i) t += red[parity][w0 + i];
  parity ^= 1;
  return t;
}

// kPack values of a per-column fp32 vector from column c0 (`fill` past the
// row's end): float4 loads in the kVec instances
template <bool kVec, int kPack>
__device__ __forceinline__ void load_cols(const float* __restrict__ p, int c0, int cols,
                                          float fill, float (&v)[kPack]) {
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kPack / 4; ++i) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + c0) + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPack; ++e) v[e] = c0 + e < cols ? __ldg(p + c0 + e) : fill;
  }
}

// a held row of at most 32 values a thread may read w and b with x
template <typename T, int NV, bool kWide>
constexpr bool kCanHoist = !kWide && NV * Slot<T>::kPack <= 32;

template <typename T, bool kRms, int NV, bool kVec, bool kWide, bool kHoist>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out, int rows,
                      int cols, int ts, int passes, float eps) {
  constexpr int kPack = Slot<T>::kPack;
  __shared__ float red[2][kWarps];
  const int teams = blockDim.x / ts, team = threadIdx.x / ts, tt = threadIdx.x % ts;
  const long row = static_cast<long>(blockIdx.x) * teams + team;
  if (row >= rows) return;  // a whole team: no barrier waits for it
  const T* xr = x + row * cols;
  T* yr = y + row * cols;
  const int np = kWide ? passes : 1;
  int parity = 0;

  // the thread's slots of pass p: s = (p * NV + j) * ts + tt
  uint4 raw[NV];
  auto load_pass = [&](int p) {
#pragma unroll
    for (int j = 0; j < NV; ++j) raw[j] = load_slot(xr, (p * NV + j) * ts + tt, cols, kVec);
  };
  auto in_row = [&](int c0, int e) { return kVec ? c0 < cols : c0 + e < cols; };
  if (!kWide) load_pass(0);
  float wh[kHoist ? NV : 1][kPack], bh[kHoist ? NV : 1][kPack];
  if constexpr (kHoist) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c0 = (j * ts + tt) * kPack;
      if (c0 >= cols) continue;
      if (w != nullptr) load_cols<kVec>(w, c0, cols, 1.f, wh[j]);
      if (bias != nullptr) load_cols<kVec>(bias, c0, cols, 0.f, bh[j]);
    }
  }

  float mean = 0.f;
  if constexpr (!kRms) {
    float s = 0.f;
    for (int p = 0; p < np; ++p) {
      if (kWide) load_pass(p);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c0 = ((p * NV + j) * ts + tt) * kPack;
#pragma unroll
        for (int e = 0; e < kPack; ++e)
          if (in_row(c0, e)) s += elem<T>(raw[j], e);
      }
    }
    mean = team_sum(s, ts, team, red, parity) / cols;
  }

  float ss = 0.f;
  for (int p = 0; p < np; ++p) {
    if (kWide) load_pass(p);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c0 = ((p * NV + j) * ts + tt) * kPack;
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        if (in_row(c0, e)) {
          const float d = elem<T>(raw[j], e) - mean;
          ss = fmaf(d, d, ss);
        }
      }
    }
  }
  const float var = team_sum(ss, ts, team, red, parity) / cols;
  const float rstd = rsqrtf(var + eps);

  for (int p = 0; p < np; ++p) {
    if (kWide) load_pass(p);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int s = (p * NV + j) * ts + tt, c0 = s * kPack;
      if (c0 >= cols) continue;
      float wc[kPack], bc[kPack], out[kPack];
      if constexpr (kHoist) {
#pragma unroll
        for (int e = 0; e < kPack; ++e) wc[e] = wh[j][e], bc[e] = bh[j][e];
      } else {
        if (w != nullptr) load_cols<kVec>(w, c0, cols, 1.f, wc);
        if (bias != nullptr) load_cols<kVec>(bias, c0, cols, 0.f, bc);
      }
#pragma unroll
      for (int e = 0; e < kPack; ++e) {
        float v = (elem<T>(raw[j], e) - mean) * rstd;
        if (w != nullptr) v *= wc[e];
        if (bias != nullptr) v += bc[e];
        out[e] = v;
      }
      store_slot<T>(yr, s, cols, kVec, out);
    }
  }
  if (tt == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

struct Args {
  const void* x;
  const float *w, *b;
  void* y;
  float *mean, *rstd;
  int rows, cols, ts, passes, teams;
  float eps;
};

template <typename T, bool kRms, int NV, bool kWide>
cudaError_t launch_nv(const Args& a, int vec, int hoist, cudaStream_t s) {
  auto kernel = vec ? layer_norm_fwd_kernel<T, kRms, NV, true, kWide, false>
                    : layer_norm_fwd_kernel<T, kRms, NV, false, kWide, false>;
  if constexpr (kCanHoist<T, NV, kWide>) {
    if (hoist)
      kernel = vec ? layer_norm_fwd_kernel<T, kRms, NV, true, kWide, true>
                   : layer_norm_fwd_kernel<T, kRms, NV, false, kWide, true>;
  }
  const int blocks = static_cast<int>((static_cast<long>(a.rows) + a.teams - 1) / a.teams);
  kernel<<<blocks, a.teams * a.ts, 0, s>>>(static_cast<const T*>(a.x), a.w, a.b,
                                           static_cast<T*>(a.y), a.mean, a.rstd, a.rows, a.cols,
                                           a.ts, a.passes, a.eps);
  return cudaGetLastError();
}

template <typename T, bool kRms>
cudaError_t launch_branch(int nv, int vec, int hoist, const Args& a, cudaStream_t s) {
  if (a.passes > 1) {  // a wide row: kWideSlots a pass (ops/layer_norm.py)
    if (nv != kWideSlots<T> || a.ts != kThreads) return cudaErrorInvalidValue;
    return launch_nv<T, kRms, kWideSlots<T>, true>(a, vec, hoist, s);
  }
  switch (nv) {
    case 1: return launch_nv<T, kRms, 1, false>(a, vec, hoist, s);
    case 2: return launch_nv<T, kRms, 2, false>(a, vec, hoist, s);
    case 3: return launch_nv<T, kRms, 3, false>(a, vec, hoist, s);
    case 4: return launch_nv<T, kRms, 4, false>(a, vec, hoist, s);
    case 5: return launch_nv<T, kRms, 5, false>(a, vec, hoist, s);
    case 6: return launch_nv<T, kRms, 6, false>(a, vec, hoist, s);
    case 7: return launch_nv<T, kRms, 7, false>(a, vec, hoist, s);
    case 8: return launch_nv<T, kRms, 8, false>(a, vec, hoist, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// rms: 0 for LayerNorm, 1 for RMSNorm (b is then ignored). The tile plan
// (ops/layer_norm.py::norm_fwd_plan): `ts` threads a row (32, 64, 128 or
// 256), `nv` 16-byte slots a thread (1-8), `passes` over a wide row (nv is
// then 32 values' slots and ts 256); `teams` rows a block (at most 256 /
// ts) and `hoist`: w and b read with x where a thread holds at most 32
// values (both from ops/layer_norm.py::norm_fwd_grid; neither changes a
// row's arithmetic); `vec`: 16-byte loads and stores (cols a multiple of 16
// bytes' values, x, y, w and b 16-byte aligned).
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                   void* mean, void* rstd, int rows, int cols, float eps,
                                   int rms, int dtype, int ts, int nv, int passes, int teams,
                                   int hoist, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const int pack = dtype == APEX_BF16 ? 8 : 4;
  if (ts < 32 || ts > kThreads || kThreads % ts || nv < 1 || passes < 1 || teams < 1 ||
      teams * ts > kThreads || static_cast<long>(passes) * nv * ts * pack < cols)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.b = rms ? nullptr : static_cast<const float*>(b);
  a.y = y;
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.rows = rows;
  a.cols = cols;
  a.ts = ts;
  a.passes = passes;
  a.teams = teams;
  a.eps = eps;
  cudaError_t err;
  if (dtype == APEX_BF16)
    err = rms ? launch_branch<__nv_bfloat16, true>(nv, vec, hoist, a, s)
              : launch_branch<__nv_bfloat16, false>(nv, vec, hoist, a, s);
  else
    err = rms ? launch_branch<float, true>(nv, vec, hoist, a, s)
              : launch_branch<float, false>(nv, vec, hoist, a, s);
  return static_cast<int>(err);
}
