// Flash-attention forward (O and LSE): the admission prefill and the
// training forward.
//
// Replaces the TPU kernel apex_tpu/ops/flash_attention.py::_fwd_kernel
// (pallas_call in _fa_fwd), causal or not, with an additive bias, segment
// ids, attention dropout and a causal sliding window, on the default
// diagonal Sk - Sq or an explicit causal_offset, with the dropout hash at
// global origins (ring attention's chunks: _mask_block:211,215,
// _block_live:300-303, _dropout_keep via drop_meta). q is [B, H, Sq, D], k
// and v are [B, Hkv, Sk, D] with the kv head read as h / (H / Hkv), never
// repeated. AttnMask (attention_common.cuh) says which keys a row sees,
// adds the bias to each score (s = scale * q.k + bias, as
// _fwd_kernel:339-343) and regenerates the reference's dropout keep mask at
// global positions. The reference's dynamic offset (an SMEM scalar, zigzag
// ring attention's per-device distances) runs its full grid unbanded; here
// every offset is a launch argument, so the band-restricted loop applies
// to it too, with the same result. Nothing crosses blocks: the TPU
// kernel's sequential k-grid axis is the key loop inside a block, and its
// band-restricted k grid under a window (_fa_fwd) the loop's start (the
// tile's band floor, rounded down to a key tile), so a windowed prefill
// costs O(S * window), not O(S^2); under causal the loop ends at the
// tile's last visible key.
//
// What bounds it on the H100: ~4 D FLOPs per visible (query, key) pair
// against ~4 S D elements of I/O per head, so at every shape the paths run
// (S 114-8192, D 64 and 128) the bound is operations: 989 TFLOP/s on the
// tensor cores in bf16, 67 on the CUDA cores in fp32. The bf16 kernel
// reaches 80-135 TFLOP/s on long rows (PERF.md row 2): mma.sync, not
// wgmma, at 2-3 blocks an SM, with PV done twice (below) and the softmax
// and masks on the CUDA cores between the two products.
//
// Two kernels, routed by dtype:
//
// bf16, flash_fwd_mma_kernel<D> (D = 64 for d <= 64, 128 for d <= 128):
// QK^T and PV on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulators; mma_tile.cuh). A block of 4 warps owns 64 query rows (16 a
// warp) and walks key tiles of 64, so K and V are read Sq / 64 times per
// head. K and V tiles stay bf16 in XOR-swizzled shared memory, copied by
// 16-byte cp.async and double-buffered: tile i + 1 is in flight while tile
// i is used (element loads where d or a pointer is not 16-byte aligned;
// columns d..D and keys past Sk are zero). Q's A fragments come by
// ldmatrix: into registers once at D = 128 (80 KB of shared memory hold
// that instance to 2 blocks an SM anyway), from shared memory each tile at
// D = 64, which keeps it at 168 registers and 3 blocks an SM (18-28%
// faster than 2 on the card). Each score is the reference's
// fp32(q.k) * scale + bias, rounded once each; the masks, the bias (one
// load for a thread's two keys) and the keep factor apply on the
// accumulator fragment, and a tile every row of the warp wholly sees
// skips the per-element test. The online softmax runs per row across the
// quad that holds it (m and l in fp32; l sums the undropped p); p times
// its keep factor, in fp32 as the reference orders it (_fwd_kernel:358-
// 364), is the PV product's A operand straight from registers, as two
// bf16 parts: hi, its rounding, and lo, the rounded remainder. The
// reference rounds p once to bf16 (p.astype(v.dtype)); on the first rows
// of Mistral's prefill, which see a few keys each, that one rounding
// moves O by up to two bf16 ulps from the fp32 twin, past the bar the
// card holds this kernel to, so PV costs two products. V's B fragments
// come by ldmatrix.trans. The epilogue writes O / l as bf16 rows of 16
// bytes through shared memory and the LSE m + log(l) (kMaskValue, and O =
// 0, for a row that saw no key). Under causal the query tiles with the
// most keys launch first. A warp skips a key tile none of its rows sees.
//
// fp32, flash_fwd_kernel<float>: the CUDA cores, as the fp32 paths'
// correctness bars (token identity, 1e-4 training losses) need; tensor
// cores would round the inputs to TF32. One block of 4 warps per (query
// tile of 16 rows, head, batch) walks tiles of 32 keys staged in shared
// memory as fp32; each warp carries the online-softmax state of 4 query
// rows (attention_common.cuh); the bias is read in place, lane j reading
// key j's entry of its row, only for visible pairs. Far from its bound:
// every FMA of the d-long dots runs on the CUDA cores.
//
// A broadcast bias, T5's (1, H, S, S) relative-position table, is never
// expanded in memory in either kernel.

#include "mma_tile.cuh"

namespace {

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBlockM = kMmaWarps * 16;  // query rows per block, 16 a warp
constexpr int kBlockN = 64;              // keys per tile
constexpr int kNTiles = kBlockN / 8;     // 8-key n-tiles of a score tile
constexpr float kLog2e = 1.4426950408889634f;

// Q in registers for the whole key loop at D = 128 (shared memory caps that
// instance at 2 blocks an SM anyway); at D = 64 read from shared memory
// each tile, which frees the registers for 3 blocks an SM
template <int D>
constexpr bool kQInRegs = D > 64;
template <int D>
constexpr int kMinBlocks = kQInRegs<D> ? 2 : 3;

// Q, then two stages of K, then two of V, each tile swizzled (mma_tile.cuh)
template <int D>
constexpr int mma_smem_bytes() {
  return (kBlockM + 4 * kBlockN) * D * static_cast<int>(sizeof(bf16));
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks<D>)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                     AttnMask mask, int heads, int kv_heads, int sq, int sk, int d, float scale,
                     int vec) {
  using namespace mma_tile;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBlockM * D;
  bf16* vs = ks + 2 * kBlockN * D;

  // under causal the last query tiles see the most keys: launch them first
  const int tile = mask.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = min(kBlockM, sq - q0);
  const uint32_t bh = static_cast<uint32_t>(b * heads + h);

  const bf16* qb = q + ((long)(b * heads + h) * sq + q0) * d;
  const bf16* kb = k + (long)(b * kv_heads + hk) * sk * d;
  const bf16* vb = v + (long)(b * kv_heads + hk) * sk * d;

  // the key tiles any row of the block may see (AttnMask::first_key, key_end)
  const int k_begin = mask.first_key(q0, kBlockN);
  const int k_end = mask.key_end(sk, q0 + nq);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBlockN - 1) / kBlockN : 0;

  load_tile_async<D, kBlockM, kMmaThreads>(qs, qb, nq, d, vec);
  if (n_tiles > 0) {
    load_tile_async<D, kBlockN, kMmaThreads>(ks, kb + (long)k_begin * d,
                                             min(kBlockN, sk - k_begin), d, vec);
    load_tile_async<D, kBlockN, kMmaThreads>(vs, vb + (long)k_begin * d,
                                             min(kBlockN, sk - k_begin), d, vec);
  }
  cp_async_commit();

  // this warp's rows: r_lo..r_lo + 15; this thread's: row0 and row0 + 8
  const int r_lo = q0 + warp * 16;
  const int r_hi = min(r_lo + 15, sq - 1);
  const int row0 = r_lo + frag_row(lane, 0);
  int seg0 = 0, seg1 = 0;
  if (mask.q_seg != nullptr) {
    if (row0 < sq) seg0 = mask.q_seg[(long)b * sq + row0];
    if (row0 + 8 < sq) seg1 = mask.q_seg[(long)b * sq + row0 + 8];
  }

  // ldmatrix addresses (shared window, bytes): this lane's row and first
  // column chunk of a K or V tile; the tiles are 128-byte aligned and every
  // row a lane reads has row % 8 == lane % 8, so the swizzle of any chunk
  // it reads is one XOR of the plain address with swz_x (mma_tile.cuh)
  const uint32_t swz_x = (lane & 7) << 4;
  const uint32_t k_lane = smem_addr(ks) + (lane & 7) * D * 2 + (lane >> 3) * 16;
  const uint32_t v_lane =
      smem_addr(vs) + ((lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 + (lane >> 4) * 16;
  // Q's A fragments: this warp's rows, the same row % 8 rule
  const uint32_t q_lane = smem_addr(qs) +
                          (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 +
                          (lane >> 4) * 16;

  uint32_t qf[D / 16][4];  // kQInRegs<D> only
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBlockN;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy flies while this one is used
      const int k1 = k0 + kBlockN;
      const int rows = min(kBlockN, sk - k1);
      load_tile_async<D, kBlockN, kMmaThreads>(ks + (stage ^ 1) * kBlockN * D,
                                               kb + (long)k1 * d, rows, d, vec);
      load_tile_async<D, kBlockN, kMmaThreads>(vs + (stage ^ 1) * kBlockN * D,
                                               vb + (long)k1 * d, rows, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQInRegs<D> && it == 0) {  // (at D = 64 Q stays in shared memory)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], (q_lane + kk * 32) ^ swz_x);
    }
    // a warp whose rows see no key of this tile skips it
    const bool live = r_lo < sq && (!mask.causal || k0 <= r_hi + mask.offset) &&
                      !(mask.window > 0 && k0 + kBlockN - 1 < r_lo + mask.offset - (mask.window - 1));
    if (live) {
      const uint32_t kt = k_lane + stage * kBlockN * D * 2;
      const uint32_t vt = v_lane + stage * kBlockN * D * 2;
      float s[kNTiles][4];
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      // S = Q K^T: K rows are B's columns, so plain ldmatrix gives B
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t qa[2][4];  // Q's fragments of dims kp * 32 .. + 31
        if constexpr (kQInRegs<D>) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            qa[0][i] = qf[2 * kp][i];
            qa[1][i] = qf[2 * kp + 1][i];
          }
        } else {
          ldmatrix_x4(qa[0], (q_lane + kp * 64) ^ swz_x);
          ldmatrix_x4(qa[1], (q_lane + kp * 64 + 32) ^ swz_x);
        }
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          uint32_t kf[4];
          ldmatrix_x4(kf, (kt + nt * 8 * D * 2 + kp * 64) ^ swz_x);
          mma_bf16(s[nt], qa[0], kf[0], kf[1]);
          mma_bf16(s[nt], qa[1], kf[2], kf[3]);
        }
      }
      const bool full = k0 + kBlockN <= sk && r_lo + 15 < sq &&
                        mask.tile_visible(r_lo, r_lo + 15, k0, k0 + kBlockN - 1);
      if (full)
        score_tile<true>(s, mask, b, h, sq, sk, k0, row0, seg0, seg1, scale, lane);
      else
        score_tile<false>(s, mask, b, h, sq, sk, k0, row0, seg0, seg1, scale, lane);

      // online softmax, per row across its quad (lanes 4g..4g+3)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tmax = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt)
          tmax = fmaxf(tmax, fmaxf(s[nt][2 * half], s[nt][2 * half + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[half], tmax);
        // a row that has seen no key yet keeps p = 0 (exp(-inf)) and acc 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f((m[half] - m_use) * kLog2e);
        const float m_log2 = m_use * kLog2e;  // p = 2^(s log2(e) - m log2(e))
        m[half] = m_new;
        const int row = row0 + 8 * half;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[nt][2 * half + e];
            const float p = exp2f(fmaf(x, kLog2e, -m_log2));
            sum += p;  // l sums the undropped p
            x = mask.dropout ? p * mask.keep(bh, row, k0 + nt * 8 + frag_col(lane, e)) : p;
          }
        }
        l[half] = l[half] * alpha + sum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][2 * half] *= alpha;
          acc[j][2 * half + 1] *= alpha;
        }
      }

      // O += P V: the score fragments are PV's A operand, as two bf16
      // parts (p = hi + lo, lo the remainder of hi's rounding), so P keeps
      // ~16 bits and O its fp32 twin's value to within O's own bf16
      // rounding; V rows are B's rows, so ldmatrix.trans gives B
#pragma unroll
      for (int kc = 0; kc < kBlockN / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_a_frag(s[2 * kc], s[2 * kc + 1], hi, lo);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, (vt + kc * 16 * D * 2 + dp * 32) ^ swz_x);
          mma_bf16(acc[2 * dp], hi, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], hi, vf[2], vf[3]);
          mma_bf16(acc[2 * dp], lo, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], lo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next iteration
  }
  cp_async_wait<0>();
  __syncthreads();  // the Q tile has landed and is read: reuse it for O

  // epilogue: O / l through this warp's 16 rows of the Q tile, then rows of
  // 16 bytes to global memory; the LSE from lane 4g
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    inv[half] = l[half] == 0.f ? 0.f : 1.f / l[half];
  }
  bf16* ow = qs + warp * 16 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = frag_row(lane, 2 * half);
      *reinterpret_cast<uint32_t*>(ow + swz<D>(r, j * 8 + frag_col(lane, 0))) =
          pack_bf16(acc[j][2 * half] * inv[half], acc[j][2 * half + 1] * inv[half]);
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  bf16* ob = o + ((long)(b * heads + h) * sq + r_lo) * d;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    if (r_lo + r >= sq || c * 8 >= d) continue;
    const bf16* src = ow + swz<D>(r, c * 8);
    if (vec) {
      *reinterpret_cast<uint4*>(ob + (long)r * d + c * 8) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < d; ++e) ob[(long)r * d + c * 8 + e] = src[e];
    }
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < sq)
        lse[(long)(b * heads + h) * sq + row] =
            l[half] == 0.f ? kMaskValue : m[half] + logf(l[half]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
               const AttnMask& mask, int batch, int heads, int kv_heads, int sq, int sk, int d,
               float scale, cudaStream_t stream) {
  constexpr int kSmem = mma_smem_bytes<D>();
  if (kSmem > 48 * 1024) {  // above 48 KB only after opting in, once per device
    static int opted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64 && !opted[dev]) {
      err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      opted[dev] = 1;
    }
  }
  // cp.async and the 16-byte epilogue need rows of whole 16-byte chunks
  const int vec = d % 8 == 0 &&
                  ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                    reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  dim3 grid((sq + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, mask, heads, kv_heads, sq, sk, d, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

// ---- fp32 on the CUDA cores -------------------------------------------------

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

  // the last key any row of this tile may see, exclusive, and the first
  // key tile the tile's first row may see (0 without a window)
  const int k_end = mask.key_end(sk, q0 + nq);
  const int k_begin = mask.first_key(q0, kTileKeys);
  for (int k0 = k_begin; k0 < k_end; k0 += kTileKeys) {
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
      const float bias = valid ? mask.bias_at(b, h, q0 + r, key) : 0.f;
      row_fold(st[rr], qs[r], ks, vs, d, valid, scale, lane, keep, bias);
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

// q_seg/kv_seg: int32 [B, Sq] / [B, Sk], or null; seed (with the dropout
// origins folded in, AttnMask::keep), threshold and keep_scale are read
// only when dropout is set;
// window 0 = none (the wrapper passes one only with causal); offset: the
// causal diagonal (Sk - Sq unless the caller gave one); bias: null, or fp32
// / bf16 (bias_bf16) read at b * sb + h * sh + row * sq + key * sk
// (AttnMask). bf16 takes the tensor-core kernel (d <= 128), fp32 the
// CUDA-core one.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* q_seg, const void* kv_seg, int causal, int dropout,
                              unsigned seed, unsigned threshold, float keep_scale, int window,
                              int offset, const void* bias, int bias_bf16, long long bias_sb,
                              long long bias_sh, long long bias_sq, long long bias_sk,
                              int batch, int heads, int kv_heads, int sq, int sk, int d,
                              float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  const AttnMask mask{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), causal,
                      dropout, seed, threshold, keep_scale, window, bias, bias_bf16, bias_sb,
                      bias_sh, bias_sq, bias_sk, offset};
  if (dtype == APEX_BF16) {
    if (d > 128) return static_cast<int>(cudaErrorInvalidValue);
    return d <= 64 ? launch_mma<64>(q, k, v, o, l, mask, batch, heads, kv_heads, sq, sk, d,
                                    scale, s)
                   : launch_mma<128>(q, k, v, o, l, mask, batch, heads, kv_heads, sq, sk, d,
                                     scale, s);
  }
  launch<float>(q, k, v, o, l, mask, batch, heads, kv_heads, sq, sk, d, scale, s);
  return static_cast<int>(cudaGetLastError());
}
