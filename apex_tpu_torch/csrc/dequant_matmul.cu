// Fused dequant-matmul: y = x @ dequant(w).T with the weights read at their
// narrow width and widened in registers.
//
// Replaces the TPU kernels apex_tpu/ops/quant.py::_fused_wq_kernel (int8 or
// fp8 e4m3 weights (out, in) with fp32 per-channel scales (out,), applied as
// the epilogue) and ::_fused_w4_kernel (int4 nibbles packed group-locally,
// (out, in/2) uint8, fp32 scales (in/gs, out): one scaled partial dot per
// group), both behind pallas_call in fused_dequant_matmul. x is (m, in) in
// fp32 or bf16, accumulation fp32, y (m, out) in x's dtype.
//
// Design: a block of 8 warps owns 8 rows of x and 32 output channels, 4 per
// warp. x is staged in shared memory in K tiles, widened to fp32; for each
// tile every lane first issues the loads of its weight chunks (8 bytes of
// one channel: 8 int8/e4m3 values, or 16 int4 values), so their latency
// overlaps the staging, then widens them in registers and folds them
// against the 8 staged rows. Each weight byte is read once per 8-row tile.
// A lane's chunks are fixed by `in` alone and the lanes' sums are added by a
// fixed butterfly, so an output's value does not depend on m or on its
// row's place in the batch: a prefill, an 8-slot decode step and a 1-row
// decode step compute each row alike. The TPU kernel's m padding to 8 and
// its 128/256-lane output tiles are not carried over.
//
// What bounds it on the H100: bytes at decode (m = 8 slots: 2 FLOPs per
// weight byte per row, far below the ~295 FLOP/byte balance point), so the
// design streams each weight byte once per 8 rows and keeps 8-byte loads of
// neighbouring lanes adjacent. At m = 8 the 768-wide outputs give only 24
// blocks for 132 SMs; splitting K across blocks is the next step. At a
// prefill (m = 128..1024) the fp32 FMAs on the CUDA cores bound it; the
// tensor cores (mma.sync with a widened tile in shared memory) come later.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                      // x rows per block
constexpr int kChans = 4;                     // output channels per warp
constexpr int kBlockChans = kWarps * kChans;  // output channels per block
constexpr int kMaxTileK = 1024;               // x columns staged per tile

enum WeightKind { W_INT8 = 0, W_E4M3 = 1, W_INT4 = 2 };

// the K tile holds 64 chunks of 8 weight bytes, two per lane: 512 values
// of an int8/e4m3 row or 1024 of an int4 row
constexpr int kChunksPerLane = 2;

template <int KIND>
__device__ __forceinline__ float widen(uint32_t byte) {
  if constexpr (KIND == W_INT8) return static_cast<float>(static_cast<int8_t>(byte));
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(v);
}

template <typename T, int KIND>
__device__ __forceinline__ void dequant_matmul(const T* __restrict__ x,
                                               const uint8_t* __restrict__ w,
                                               const float* __restrict__ scale,
                                               T* __restrict__ y, int m, int n_in, int n_out,
                                               int gs) {
  __shared__ __align__(16) float xs[kRows][kMaxTileK];
  constexpr int kTile = KIND == W_INT4 ? kMaxTileK : kMaxTileK / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - m0);
  const int o0 = blockIdx.x * kBlockChans + warp * kChans;
  const long row_bytes = KIND == W_INT4 ? n_in / 2 : n_in;

  float acc[kRows][kChans];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kChans; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < n_in; k0 += kTile) {
    const int tk = min(kTile, n_in - k0);
    const int chunks = (KIND == W_INT4 ? tk / 2 : tk) / 8;
    const long byte0 = KIND == W_INT4 ? k0 / 2 : k0;
    // this tile's weight chunks, loaded before the staging so that their
    // latency overlaps it; absent chunks and channels read as 0
    uint2 raw[kChunksPerLane][kChans];
#pragma unroll
    for (int u = 0; u < kChunksPerLane; ++u) {
      const int c = lane + 32 * u;
#pragma unroll
      for (int j = 0; j < kChans; ++j) {
        raw[u][j] = make_uint2(0u, 0u);
        if (c < chunks && o0 + j < n_out)
          raw[u][j] = __ldg(reinterpret_cast<const uint2*>(
              w + (long)(o0 + j) * row_bytes + byte0 + 8 * c));
      }
    }
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kRows * tk; i += kThreads) {
      const int r = i / tk, col = i - r * tk;
      xs[r][col] = r < rows ? to_f32<T>(x[(long)(m0 + r) * n_in + k0 + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kChunksPerLane; ++u) {
      const int c = lane + 32 * u;
      if (c >= chunks) break;
      if constexpr (KIND != W_INT4) {
        // 8 values k0 + 8c .. k0 + 8c + 7 of each channel
        float wv[kChans][8];
#pragma unroll
        for (int j = 0; j < kChans; ++j)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            wv[j][i] = widen<KIND>(((i < 4 ? raw[u][j].x : raw[u][j].y) >> (8 * (i % 4))) & 0xffu);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 xa = *reinterpret_cast<const float4*>(&xs[r][8 * c]);
          const float4 xb = *reinterpret_cast<const float4*>(&xs[r][8 * c + 4]);
          const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int j = 0; j < kChans; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[r][j] = fmaf(xv[i], wv[j][i], acc[r][j]);
        }
      } else {
        // bytes 8c .. 8c + 7 of the tile's packed row: group gt of the tile
        // at byte offset jj, low nibbles at values gt*gs + jj + i, high
        // nibbles at gt*gs + gs/2 + jj + i (both biased by +8)
        const int half = gs / 2;
        const int gt = (8 * c) / half, jj = (8 * c) % half;
        const int lo0 = gt * gs + jj, hi0 = lo0 + half;
        const int g = k0 / gs + gt;
        float lo[kChans][8], hi[kChans][8], s[kChans];
#pragma unroll
        for (int j = 0; j < kChans; ++j) {
          s[j] = o0 + j < n_out ? scale[(long)g * n_out + o0 + j] : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const uint32_t b = ((i < 4 ? raw[u][j].x : raw[u][j].y) >> (8 * (i % 4))) & 0xffu;
            lo[j][i] = static_cast<float>(static_cast<int>(b & 15u) - 8);
            hi[j][i] = static_cast<float>(static_cast<int>(b >> 4) - 8);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 la = *reinterpret_cast<const float4*>(&xs[r][lo0]);
          const float4 lb = *reinterpret_cast<const float4*>(&xs[r][lo0 + 4]);
          const float4 ha = *reinterpret_cast<const float4*>(&xs[r][hi0]);
          const float4 hb = *reinterpret_cast<const float4*>(&xs[r][hi0 + 4]);
          const float xl[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
          const float xh[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
          for (int j = 0; j < kChans; ++j) {
            float p = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) p = fmaf(xl[i], lo[j][i], p);
#pragma unroll
            for (int i = 0; i < 8; ++i) p = fmaf(xh[i], hi[j][i], p);
            acc[r][j] = fmaf(p, s[j], acc[r][j]);  // this chunk's share of group g
          }
        }
      }
    }
  }

  // lane r * kChans + j writes (row m0 + r, channel o0 + j)
  float mine = 0.f;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < kChans; ++j) {
      const float v = warp_sum(acc[r][j]);
      if (lane == r * kChans + j) mine = v;
    }
  const int r = lane / kChans, o = o0 + lane % kChans;
  if (r < rows && o < n_out) {
    const float v = KIND == W_INT4 ? mine : mine * scale[o];
    y[(long)(m0 + r) * n_out + o] = from_f32<T>(v);
  }
}

static_assert(kRows * kChans == 32, "one output per lane in the epilogue");

// two entry symbols, so that a profile tells the per-channel kernel
// (KIND int8 or e4m3) from the int4 one
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, T* __restrict__ y, int m, int n_in,
                      int n_out) {
  dequant_matmul<T, KIND>(x, w, scale, y, m, n_in, n_out, 0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_w4_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                         const float* __restrict__ scale, T* __restrict__ y, int m, int n_in,
                         int n_out, int gs) {
  dequant_matmul<T, W_INT4>(x, w, scale, y, m, n_in, n_out, gs);
}

template <typename T, int KIND>
void launch(const void* x, const void* w, const void* scale, void* y, int m, int n_in,
            int n_out, int gs, cudaStream_t stream) {
  dim3 grid((n_out + kBlockChans - 1) / kBlockChans, (m + kRows - 1) / kRows);
  auto xp = static_cast<const T*>(x);
  auto wp = static_cast<const uint8_t*>(w);
  auto sp = static_cast<const float*>(scale);
  auto yp = static_cast<T*>(y);
  if constexpr (KIND == W_INT4)
    dequant_matmul_w4_kernel<T><<<grid, kThreads, 0, stream>>>(xp, wp, sp, yp, m, n_in, n_out,
                                                               gs);
  else
    dequant_matmul_kernel<T, KIND><<<grid, kThreads, 0, stream>>>(xp, wp, sp, yp, m, n_in,
                                                                  n_out);
}

template <int KIND>
void launch_for(int dtype, const void* x, const void* w, const void* scale, void* y, int m,
                int n_in, int n_out, int gs, cudaStream_t stream) {
  if (dtype == APEX_BF16)
    launch<__nv_bfloat16, KIND>(x, w, scale, y, m, n_in, n_out, gs, stream);
  else
    launch<float, KIND>(x, w, scale, y, m, n_in, n_out, gs, stream);
}

}  // namespace

// int8 (w_dtype APEX_I8) or e4m3 (APEX_E4M3) weights (n_out, n_in), n_in a
// multiple of 8, per-channel scales (n_out,)
extern "C" int apex_dequant_matmul(const void* x, const void* w, const void* scale, void* y,
                                   int m, int n_in, int n_out, int dtype, int w_dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (w_dtype == APEX_E4M3)
    launch_for<W_E4M3>(dtype, x, w, scale, y, m, n_in, n_out, 0, s);
  else
    launch_for<W_INT8>(dtype, x, w, scale, y, m, n_in, n_out, 0, s);
  return static_cast<int>(cudaGetLastError());
}

// int4 weights packed group-locally (n_out, n_in / 2), scales (n_in / gs,
// n_out), gs a power of two in 16..512 dividing n_in
extern "C" int apex_dequant_matmul_w4(const void* x, const void* w, const void* scale, void* y,
                                      int m, int n_in, int n_out, int gs, int dtype,
                                      void* stream) {
  launch_for<W_INT4>(dtype, x, w, scale, y, m, n_in, n_out, gs,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
