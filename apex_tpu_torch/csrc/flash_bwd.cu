// Flash-attention backward (FA-2 recompute): dq, and dk/dv.
//
// Replaces the TPU kernels apex_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkdv_kernel (the two pallas_calls in _fa_bwd_impl), causal or not, with
// segment ids, attention dropout and a causal sliding window at the default
// diagonal; no bias or causal_offset. q, do
// and dq are [B, H, Sq, D]; k, v, dk and dv are [B, Hkv, Sk, D] with kv head
// h / (H / Hkv); lse and delta = sum(do * o) are fp32 [B, H, Sq]. AttnMask
// (attention_common.cuh) gives the visible pairs and the forward's keep
// factor K (1 without dropout, regenerated from the seed at the global
// position with bh = b * H + h of the QUERY head). With P = exp(scale *
// q k^T - lse) on the visible pairs:
//   dv = (P K)^T do,  dp = do v^T,  ds = P * (dp K - delta) * scale,
//   dq = ds k,        dk = ds^T q.
// fp32 accumulation throughout, I/O in the input dtype (fp32 or bf16).
//
// Design. The TPU kernels carry dq (resp. dk/dv) in VMEM scratch across a
// sequential grid axis over k-blocks (resp. q-blocks). Here that axis is a
// loop inside one block, so nothing crosses blocks and no atomics are used:
//  - flash_bwd_dq_kernel: one block of 8 warps per (32 query rows, head,
//    batch). Each warp owns 4 rows and keeps their dq in registers (lane c
//    holds dims c, c + 32, ...). The block streams the causal key range in
//    tiles of 32 keys (k and v as fp32 in shared memory); lane j scores key j
//    against the row (q.k and do.v), and the warp folds ds_j * k_j into dq
//    through shuffles. Under a window the key range starts at the band
//    floor of the block's first row, rounded down to a key tile
//    (AttnMask::first_key, as the forward), the reference's band-restricted
//    k grid for dq (_fa_bwd_impl).
//  - flash_bwd_dkdv_kernel: one block of 8 warps per (32 keys, kv head,
//    batch). Each warp owns 4 keys and keeps their dk and dv in registers.
//    The block loops over the Hkv group's H / Hkv query heads and, for each,
//    over the tiles of 32 query rows that can see its keys: under causal
//    from the row that sees the block's first key, under a window up to the
//    last row whose band still reaches the block's last key
//    (AttnMask::last_row), the reference's band-restricted q grid for
//    dk/dv. Lane i scores query i, and the warp folds p_i * do_i into dv
//    and ds_i * q_i into dk.
//    So the reference's per-q-head partials summed into the kv head
//    (_fa_bwd_impl's GQA epilogue) are summed here, in registers.
// Tiles that are read by lane index use a row stride of D + 1 floats, so the
// 32 lanes hit 32 banks; tiles read by all lanes at once (broadcast) use D.
// AttnMask::visible masks each row's own band edges inside a tile. So under
// a window both kernels do O(S * window) work, not O(S^2). At D = 128 a
// block takes ~64 KB of shared memory, above the 48 KB static limit: the
// launch opts in with cudaFuncSetAttribute.
//
// What bounds it on the H100: operations. At S = 1024, D = 64 (and at
// Mistral-7B's S = 8192, D = 128, window 4096) the two kernels do ~14 D
// FLOPs per visible (query, key) pair against ~6 D input and output
// elements per row. This first version does them as fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak) with an operand from shared memory for
// each, so it sits far from the tensor cores' bf16 bound; mma.sync / wgmma
// tiles are the next step.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 4;               // rows (dq) or keys (dk/dv) per warp
constexpr int kOwn = kWarps * kPerWarp;   // rows or keys a block owns
constexpr int kTile = 32;                 // keys (dq) or rows (dk/dv) per tile
constexpr int kDims = kMaxHeadDim / 32;   // accumulator dims per lane
constexpr int kStaticSmem = 48 * 1024;

// Copy `rows` rows of `d` elements into a shared fp32 tile of row stride
// `ld`; rows at or past `n_valid` are zero. All threads of the block help.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, int rows,
                                          int n_valid, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = r < n_valid ? to_f32<T>(src[(long)r * d + c]) : 0.f;
  }
}

__device__ __forceinline__ void dot2(const float* a, const float* b, const float* c,
                                     const float* e, int d, float& ab, float& ce) {
  float x = 0.f, y = 0.f;
  for (int i = 0; i < d; ++i) {
    x = fmaf(a[i], b[i], x);
    y = fmaf(c[i], e[i], y);
  }
  ab = x;
  ce = y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, AttnMask mask,
                    int heads, int kv_heads, int sq, int sk, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                 // [kOwn][d], broadcast reads
  float* dos = qs + kOwn * d;       // [kOwn][d], broadcast reads
  float* ks = dos + kOwn * d;       // [kTile][ld], lane-indexed reads
  float* vs = ks + kTile * ld;      // [kTile][ld]

  const int q0 = blockIdx.x * kOwn, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = min(kOwn, sq - q0);
  const uint32_t bh = static_cast<uint32_t>(b * heads + h);
  const long row0 = (long)(b * heads + h) * sq + q0;
  const T* kb = k + (long)(b * kv_heads + hk) * sk * d;
  const T* vb = v + (long)(b * kv_heads + hk) * sk * d;
  load_rows<T>(qs, d, q + row0 * d, kOwn, nq, d);
  load_rows<T>(dos, d, dout + row0 * d, kOwn, nq, d);

  float row_lse[kPerWarp], row_delta[kPerWarp], acc[kPerWarp][kDims];
#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    row_lse[rr] = r < nq ? lse[row0 + r] : 0.f;
    row_delta[rr] = r < nq ? delta[row0 + r] : 0.f;
#pragma unroll
    for (int c4 = 0; c4 < kDims; ++c4) acc[rr][c4] = 0.f;
  }

  // the last key any row of this block may see, exclusive, and the first
  // key tile its first row may see (0 without a window)
  const int k_end = mask.causal ? max(0, min(sk, q0 + nq + sk - sq)) : sk;
  const int k_begin = mask.first_key(sq, sk, q0, kTile);
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    const int nk = min(kTile, k_end - k0);
    __syncthreads();  // previous tile consumed (and qs, dos visible)
    load_rows<T>(ks, ld, kb + (long)k0 * d, kTile, nk, d);
    load_rows<T>(vs, ld, vb + (long)k0 * d, kTile, nk, d);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= nq) continue;  // warp-uniform
      const bool valid = lane < nk && mask.visible(b, sq, sk, q0 + r, k0 + lane);
      float ds = 0.f;
      if (valid) {
        float s, dp;
        dot2(qs + r * d, ks + lane * ld, dos + r * d, vs + lane * ld, d, s, dp);
        const float p = expf(s * scale - row_lse[rr]);
        ds = p * (dp * mask.keep(bh, q0 + r, k0 + lane) - row_delta[rr]) * scale;
      }
      // kept rolled: unrolled, this loop took the kernel to 255 registers a
      // thread (one block per SM); rolled it takes 64-73 (three or more)
#pragma unroll 1
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
        if (dsj == 0.f) continue;  // masked or unloaded keys are never read
        const float* kr = ks + j * ld;
#pragma unroll
        for (int c4 = 0; c4 < kDims; ++c4) {
          const int c = lane + 32 * c4;
          if (c < d) acc[rr][c4] = fmaf(dsj, kr[c], acc[rr][c4]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= nq) continue;
    T* out = dq + (row0 + r) * d;
#pragma unroll
    for (int c4 = 0; c4 < kDims; ++c4) {
      const int c = lane + 32 * c4;
      if (c < d) out[c] = from_f32<T>(acc[rr][c4]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, AttnMask mask, int heads,
                      int kv_heads, int sq, int sk, int d, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* ks = smem;                 // [kOwn][d], broadcast reads
  float* vs = ks + kOwn * d;        // [kOwn][d], broadcast reads
  float* qs = vs + kOwn * d;        // [kTile][ld], lane-indexed reads
  float* dos = qs + kTile * ld;     // [kTile][ld]
  float* ls = dos + kTile * ld;     // [kTile] lse of the tile's rows
  float* dl = ls + kTile;           // [kTile] delta of the tile's rows

  const int k0 = blockIdx.x * kOwn, hk = blockIdx.y, b = blockIdx.z;
  const int rep = heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = min(kOwn, sk - k0);
  const long key0 = (long)(b * kv_heads + hk) * sk + k0;
  load_rows<T>(ks, d, k + key0 * d, kOwn, nk, d);
  load_rows<T>(vs, d, v + key0 * d, kOwn, nk, d);

  float dk_acc[kPerWarp][kDims], dv_acc[kPerWarp][kDims];
#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk)
#pragma unroll
    for (int c4 = 0; c4 < kDims; ++c4) dk_acc[kk][c4] = dv_acc[kk][c4] = 0.f;

  // under causal, rows before q_begin see none of this block's keys; under
  // a window, rows from q_end on see none either
  const int q_begin = mask.causal ? max(0, k0 - (sk - sq)) : 0;
  const int q_end = mask.last_row(sq, sk, k0 + nk - 1);
  for (int g = 0; g < rep; ++g) {
    const int h = hk * rep + g;  // the query head: its index keys the dropout hash
    const uint32_t bh = static_cast<uint32_t>(b * heads + h);
    const long hrow0 = (long)(b * heads + h) * sq;
    for (int q0 = q_begin; q0 < q_end; q0 += kTile) {
      const int nq = min(kTile, q_end - q0);
      __syncthreads();  // previous tile consumed (and ks, vs visible)
      load_rows<T>(qs, ld, q + (hrow0 + q0) * d, kTile, nq, d);
      load_rows<T>(dos, ld, dout + (hrow0 + q0) * d, kTile, nq, d);
      if (threadIdx.x < kTile) {
        const int t = threadIdx.x;
        ls[t] = t < nq ? lse[hrow0 + q0 + t] : 0.f;
        dl[t] = t < nq ? delta[hrow0 + q0 + t] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kPerWarp; ++kk) {
        const int j = warp + kk * kWarps;
        if (j >= nk) continue;  // warp-uniform
        const bool valid = lane < nq && mask.visible(b, sq, sk, q0 + lane, k0 + j);
        float p = 0.f, ds = 0.f;
        if (valid) {
          float s, dp;
          dot2(ks + j * d, qs + lane * ld, vs + j * d, dos + lane * ld, d, s, dp);
          const float pr = expf(s * scale - ls[lane]);
          const float keep = mask.keep(bh, q0 + lane, k0 + j);
          p = pr * keep;  // dv takes the dropped probability
          ds = pr * (dp * keep - dl[lane]) * scale;
        }
        for (int i = 0; i < kTile; ++i) {
          const float pi = __shfl_sync(0xffffffffu, p, i);
          const float dsi = __shfl_sync(0xffffffffu, ds, i);
          if (pi == 0.f && dsi == 0.f) continue;  // masked, dropped or unloaded rows
          const float* qr = qs + i * ld;
          const float* dr = dos + i * ld;
#pragma unroll
          for (int c4 = 0; c4 < kDims; ++c4) {
            const int c = lane + 32 * c4;
            if (c < d) {
              dv_acc[kk][c4] = fmaf(pi, dr[c], dv_acc[kk][c4]);
              dk_acc[kk][c4] = fmaf(dsi, qr[c], dk_acc[kk][c4]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kPerWarp; ++kk) {
    const int j = warp + kk * kWarps;
    if (j >= nk) continue;
    T* dko = dk + (key0 + j) * d;
    T* dvo = dv + (key0 + j) * d;
#pragma unroll
    for (int c4 = 0; c4 < kDims; ++c4) {
      const int c = lane + 32 * c4;
      if (c < d) {
        dko[c] = from_f32<T>(dk_acc[kk][c4]);
        dvo[c] = from_f32<T>(dv_acc[kk][c4]);
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const AttnMask& mask,
                      int batch, int heads, int kv_heads, int sq, int sk, int d, float scale,
                      cudaStream_t s) {
  const size_t smem = (2 * kOwn * d + 2 * kTile * (d + 1)) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kOwn - 1) / kOwn, heads, batch);
  flash_bwd_dq_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), mask, heads, kv_heads, sq, sk,
      d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dk, void* dv,
                        const AttnMask& mask, int batch, int heads, int kv_heads, int sq, int sk,
                        int d, float scale, cudaStream_t s) {
  const size_t smem = (2 * kOwn * d + 2 * kTile * (d + 1) + 2 * kTile) * sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + kOwn - 1) / kOwn, kv_heads, batch);
  flash_bwd_dkdv_kernel<T><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), mask,
      heads, kv_heads, sq, sk, d, scale);
  return cudaGetLastError();
}

}  // namespace

// q_seg/kv_seg: int32 [B, Sq] / [B, Sk], or null; seed, threshold and
// keep_scale are read only when dropout is set (the forward's values);
// window 0 = none (the wrapper passes one only with causal).
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, const void* q_seg,
                                 const void* kv_seg, int causal, int dropout, unsigned seed,
                                 unsigned threshold, float keep_scale, int window, int batch,
                                 int heads, int kv_heads, int sq, int sk, int d, float scale,
                                 int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  const AttnMask mask{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), causal,
                      dropout, seed, threshold, keep_scale, window};
  cudaError_t err =
      dtype == APEX_BF16
          ? launch_dq<__nv_bfloat16>(q, k, v, dout, l, dl, dq, mask, batch, heads, kv_heads, sq,
                                     sk, d, scale, s)
          : launch_dq<float>(q, k, v, dout, l, dl, dq, mask, batch, heads, kv_heads, sq, sk, d,
                             scale, s);
  return static_cast<int>(err);
}

extern "C" int apex_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, const void* q_seg, const void* kv_seg,
                                   int causal, int dropout, unsigned seed, unsigned threshold,
                                   float keep_scale, int window, int batch, int heads,
                                   int kv_heads, int sq, int sk, int d, float scale, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  const AttnMask mask{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), causal,
                      dropout, seed, threshold, keep_scale, window};
  cudaError_t err =
      dtype == APEX_BF16
          ? launch_dkdv<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, mask, batch, heads,
                                       kv_heads, sq, sk, d, scale, s)
          : launch_dkdv<float>(q, k, v, dout, l, dl, dk, dv, mask, batch, heads, kv_heads, sq,
                               sk, d, scale, s);
  return static_cast<int>(err);
}
