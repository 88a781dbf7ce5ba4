// Flash-attention forward (O and LSE): the admission prefill and the
// training forward.
//
// Replaces the TPU kernel apex_tpu/ops/flash_attention.py::_fwd_kernel
// (pallas_call in _fa_fwd), causal or not, with segment ids and attention
// dropout; no bias, no window, no causal_offset. q is [B, H, Sq, D], k and v
// are [B, Hkv, Sk, D] with the kv head read as h / (H / Hkv), never
// repeated. AttnMask (attention_common.cuh) says which keys a row sees and
// regenerates the reference's dropout keep mask at global positions.
//
// Design: one block of 4 warps per (query tile of 16 rows, head, batch). The
// block walks the key range (under causal only up to the tile's last
// visible key) in tiles of 32 keys staged in shared memory as fp32; each
// warp carries the online-softmax state of 4 query rows in registers
// (attention_common.cuh). Nothing crosses blocks, so the TPU kernel's
// sequential k-grid axis becomes the loop inside the block.
//
// What bounds it on the H100: at these lengths (S <= 1024, D = 64) the
// work is ~4*D FLOPs per visible (query, key) pair against ~4*S*D elements
// of I/O per head, so it is bound by operations; this first version does
// them as fp32 FMAs on the CUDA cores (67 TFLOP/s peak) rather than on the
// tensor cores (989 TFLOP/s bf16), so it sits far from that bound. Moving
// QK^T and PV onto mma.sync / wgmma is the next step.

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kQRows = 16;
constexpr int kRowsPerWarp = kQRows / kWarps;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, AttnMask mask, int heads,
                 int kv_heads, int sq, int sk, int d, float scale) {
  __shared__ float qs[kQRows][kMaxHeadDim];
  __shared__ float ks[kTileKeys * kTileStride];
  __shared__ float vs[kTileKeys * kTileStride];

  const int q0 = blockIdx.x * kQRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = min(kQRows, sq - q0);
  const uint32_t bh = static_cast<uint32_t>(b * heads + h);

  const T* qb = q + ((long)(b * heads + h) * sq + q0) * d;
  const T* kb = k + (long)(b * kv_heads + hk) * sk * d;
  const T* vb = v + (long)(b * kv_heads + hk) * sk * d;
  for (int i = threadIdx.x; i < kQRows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    qs[r][c] = r < nq ? to_f32<T>(qb[(long)r * d + c]) : 0.f;
  }

  RowState st[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) row_init(st[rr]);

  // the last key any row of this tile may see, exclusive
  const int k_end = mask.causal ? max(0, min(sk, q0 + nq + sk - sq)) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kTileKeys) {
    const int nk = min(kTileKeys, k_end - k0);
    __syncthreads();  // previous tile fully consumed (and qs visible)
    load_tile<T>(ks, kb + (long)k0 * d, nk, d, d);
    load_tile<T>(vs, vb + (long)k0 * d, nk, d, d);
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= nq) continue;  // warp-uniform
      const int key = k0 + lane;
      const bool valid = lane < nk && mask.visible(b, sq, sk, q0 + r, key);
      const float keep = valid ? mask.keep(bh, q0 + r, key) : 0.f;
      row_fold(st[rr], qs[r], ks, vs, d, valid, scale, lane, keep);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= nq) continue;
    const long row = (long)(b * heads + h) * sq + q0 + r;
    const float l = row_store<T>(st[rr], o + row * d, d, lane);
    if (lane == 0) lse[row] = l;
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            const AttnMask& mask, int batch, int heads, int kv_heads, int sq, int sk, int d,
            float scale, cudaStream_t stream) {
  dim3 grid((sq + kQRows - 1) / kQRows, heads, batch);
  flash_fwd_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, mask, heads, kv_heads, sq, sk, d, scale);
}

}  // namespace

// q_seg/kv_seg: int32 [B, Sq] / [B, Sk], or null; seed, threshold and
// keep_scale are read only when dropout is set.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* q_seg, const void* kv_seg, int causal, int dropout,
                              unsigned seed, unsigned threshold, float keep_scale, int batch,
                              int heads, int kv_heads, int sq, int sk, int d, float scale,
                              int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  const AttnMask mask{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), causal,
                      dropout, seed, threshold, keep_scale};
  if (dtype == APEX_BF16)
    launch<__nv_bfloat16>(q, k, v, o, l, mask, batch, heads, kv_heads, sq, sk, d, scale, s);
  else
    launch<float>(q, k, v, o, l, mask, batch, heads, kv_heads, sq, sk, d, scale, s);
  return static_cast<int>(cudaGetLastError());
}
