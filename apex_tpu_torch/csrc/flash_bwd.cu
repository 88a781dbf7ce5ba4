// Flash-attention backward (FA-2 recompute): dq, and dk/dv.
//
// Replaces the TPU kernels apex_tpu/ops/flash_attention.py::_dq_kernel and
// ::_dkdv_kernel (the two pallas_calls in _fa_bwd_impl), causal or not, with
// an additive bias, segment ids, attention dropout and a causal sliding
// window, on the default diagonal or an explicit causal_offset, with the
// dropout hash at global origins (ring attention's chunks, as the
// forward; the reference's dynamic offset is a launch argument here and
// keeps the band-restricted loops). q, do
// and dq are [B, H, Sq, D]; k, v, dk and dv are [B, Hkv, Sk, D] with kv head
// h / (H / Hkv); lse and delta = sum(do * o) are fp32 [B, H, Sq]. AttnMask
// (attention_common.cuh) gives the visible pairs and the forward's keep
// factor K (1 without dropout, regenerated from the seed at the global
// position with bh = b * H + h of the QUERY head) and the additive bias B
// (read in place through its broadcast strides, as _recompute_p:514-515
// adds it). With P = exp(scale * q k^T + B - lse) on the visible pairs:
//   dv = (P K)^T do,  dp = do v^T,  ds = P * (dp K - delta) * scale,
//   dq = ds k,        dk = ds^T q.
// fp32 accumulation throughout, I/O in the input dtype (fp32 or bf16). The
// bias gets no gradient here: the reference does not differentiate it
// (_flash_bwd returns zeros for it), and neither does the wrapper.
//
// The TPU kernels carry dq (resp. dk/dv) in VMEM scratch across a
// sequential grid axis over k-blocks (resp. q-blocks). Here that axis is a
// loop inside one block, so nothing crosses blocks, no atomics are used and
// the result is deterministic. Both loops walk only the band: dq's keys
// from the band floor of the block's first row (AttnMask::first_key) to
// the last key its last row sees (key_end), the reference's
// band-restricted k grid for dq; dk/dv's rows from the first row that sees
// the block's first key (first_row) to the last whose band still reaches
// its last key (last_row), the q grid for dk/dv. So under a window both do
// O(S * window) work, not O(S^2). dk/dv loops over the GQA group's H / Hkv
// query heads too, so the reference's per-q-head partials summed into the
// kv head (_fa_bwd_impl's GQA epilogue) are summed here, in registers.
//
// What bounds them on the H100: operations. At every shape the paths run
// (S 114-8192, D 64 and 128) dq does 6 D FLOPs and dk/dv 8 D per visible
// (query, key) pair against ~5-6 S D elements of I/O per head: 989
// TFLOP/s on the tensor cores in bf16, 67 on the CUDA cores in fp32. The
// bf16 kernels reach 130-206 TFLOP/s on long rows (PERF.md rows 5, 6):
// mma.sync, not wgmma, with the second products done twice (below), a
// shared-memory read (ldmatrix) for every two to four products, and the
// masks and exponentials on the CUDA cores between them.
//
// Two kernels each, routed by dtype:
//
// bf16, flash_bwd_dq_mma_kernel<D> and flash_bwd_dkdv_mma_kernel<D> (D =
// 64 for d <= 64, 128 for d <= 128): every product on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulators; mma_tile.cuh), a block
// of 4 warps, 16 rows (dq) or keys (dk/dv) a warp.
//  - dq: the forward's structure without the online softmax. A block owns
//    64 query rows, Q and dO stay in shared memory, and it walks key tiles
//    of 64, K and V double-buffered by 16-byte cp.async (element loads
//    where d or a pointer is not 16-byte aligned; columns d..D and keys
//    past Sk are zero). A warp takes a tile in two parts of 32 keys: S = Q
//    K^T and dP = dO V^T with Q's and dO's A fragments from shared memory
//    and K's and V's rows as B by ldmatrix; the scale, bias and masks on
//    the accumulator fragment (mma_tile::score_tile, as the forward's); P
//    = exp(S - lse) with the row's lse and delta in registers; dS = P (dP
//    K - delta) scale; dQ += dS K, dS straight from the registers as A and
//    K by ldmatrix.trans. Under causal the last query tiles, which see the
//    most keys, launch first; the epilogue writes dQ as rows of 16 bytes
//    through shared memory.
//  - dk/dv: a block owns 64 keys of one kv head (K and V in shared memory
//    for its life) and walks the group's query heads and, for each, tiles
//    of 64 query rows (Q, dO, lse, delta and the segment ids
//    double-buffered by cp.async). A warp holds its score tile transposed,
//    keys x rows, 16 rows at a time: S^T = K_w Q^T and dP^T = V_w dO^T,
//    K's and V's A fragments read from shared memory each time (kept in
//    registers beside the dK and dV accumulators they would pass 255 at D =
//    128); then the masks, bias and keep factor per element (the bias read
//    in fragment order: 8 lanes read 8 consecutive keys of one row, not
//    down a column), P^T and dS^T; and dV += (P K)^T dO and dK += dS^T Q,
//    the A operands from the registers and dO's and Q's rows as B by
//    ldmatrix.trans. Under causal the key tiles that see the most rows (the
//    first) launch first.
//  A warp skips a part none of its (row, key) pairs sees, and a part every
//  pair sees skips the per-element test. Each second product's A operand
//  (P K for dv, dS for dq and dk) goes in as two bf16 parts, hi and the
//  rounded remainder lo (two products): the reference rounds it once to
//  bf16 (ds.astype(k.dtype), p_dropped.astype(do.dtype)), which moves dq,
//  dk and dv past the bar the card holds these kernels to on the first
//  rows of Mistral-7B's causal prefill, where a row sees a few keys
//  (tests/test_torch_flash_bwd_bf16.py pins it).
//  Registers (ptxas, sm_90a): dq 168 at D = 64 (3 blocks an SM; 20 bytes
//  of spill, 12 stored and 8 loaded a thread) and 245 at D = 128 (2; its
//  96 KB of shared memory allow no more); dk/dv 165 and 250, no spill. The
//  parts of 32 keys (dq) and 16 rows (dk/dv) are what fits: parts of 64
//  keys and 32 rows spilled 48-220 bytes in every instance and ran up to
//  11% slower (Mistral-7B's and BERT's rows; T5's bias rows within 2%),
//  and dq's D = 64 instance sheds its 20 bytes only with its dimension
//  loop rolled, 3-7% slower (H100; PERF.md rows 5 and 6).
//
// fp32, flash_bwd_dq_kernel<float> and flash_bwd_dkdv_kernel<float>: the
// CUDA cores, as the fp32 paths' bars (1e-4 training losses, gradients
// within atol 1e-4 / rtol 1e-3) need; tensor cores would round the
// operands to TF32. One block of 8 warps per (32 query rows, head, batch)
// for dq: each warp owns 4 rows and keeps their dq in registers (lane c
// holds dims c, c + 32, ...); the block streams the key range in tiles of
// 32 keys (k and v as fp32 in shared memory); lane j scores key j against
// the row (q.k and do.v), and the warp folds ds_j * k_j into dq through
// shuffles. dk/dv: one block of 8 warps per (32 keys, kv head, batch),
// each warp owning 4 keys, over tiles of 32 query rows; lane i scores
// query i, and the warp folds p_i * do_i into dv and ds_i * q_i into dk.
// Tiles read by lane index use a row stride of D + 1 floats, so the 32
// lanes hit 32 banks; tiles read by all lanes at once (broadcast) use D.
// At D = 128 a block takes ~64 KB of shared memory: the launch opts in
// with cudaFuncSetAttribute. Far from its bound: every FMA of the d-long
// dots runs on the CUDA cores with an operand from shared memory.

#include "mma_tile.cuh"

namespace {

// ---- bf16 on the tensor cores ----------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kBlockRows = 64;  // dq: rows a block owns; dk/dv: rows of a Q/dO tile
constexpr int kBlockKeys = 64;  // dq: keys of a K/V tile; dk/dv: keys a block owns
// A warp holds part of its score tile at a time, S and dP both in fp32
// accumulators: dq 32 of a tile's 64 keys, dk/dv 16 of its 64 rows. That
// keeps the dQ (or dK and dV) accumulators, the scores and the fragments
// in flight under the register caps below (see the header).
constexpr int kSubKeys = 32;              // dq
constexpr int kSubRows = 16;              // dk/dv
constexpr int kSubTiles = kSubKeys / 8;   // dq: 8-key n-tiles of a part
constexpr int kSubRowTiles = kSubRows / 8;  // dk/dv: 8-row n-tiles of a part
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr int kMinBlocks = D > 64 ? 2 : 3;

// dq: Q, dO, then two stages of K and two of V; dk/dv: K, V, then two
// stages of Q and two of dO, and two of the rows' lse, delta and segment id
template <int D>
constexpr int dq_smem_bytes() {
  return (2 * kBlockRows + 4 * kBlockKeys) * D * static_cast<int>(sizeof(bf16));
}
template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * kBlockKeys + 4 * kBlockRows) * D * static_cast<int>(sizeof(bf16)) +
         3 * 2 * kBlockRows * 4;
}

// P = exp(s - lse) as 2^((s - lse) log2(e)): the difference first, as the
// reference takes it. Folding lse into one FMA, s log2(e) - lse log2(e),
// would round lse log2(e) on its own, and where a bias of -1e9 hides a
// row's keys (s and lse near -1e9, an fp32 ulp of 64) that moves P by up
// to 2^64. A hidden pair's s is -inf, so its P is 0, also in a row that
// sees no key (lse the mask value).
__device__ __forceinline__ float prob(float s, float lse) { return exp2f((s - lse) * kLog2e); }

// The recompute on a warp's transposed score tile (dk/dv): keys x rows,
// accumulators of S^T = K Q^T in s and of dP^T = V dO^T in dp; this
// thread's keys key_a and key_a + 8 (segment ids kseg_a, kseg_b), its rows
// rs + nt * 8 + frag_col, whose lse, delta and segment ids sit at local
// index rl + nt * 8 + frag_col of the staged tile. Out: s holds P K (the
// dropped probability, dv's operand), dp holds dS. kFull: every pair is
// visible.
template <bool kFull>
__device__ __forceinline__ void recompute_t(float (&s)[kSubRowTiles][4],
                                            float (&dp)[kSubRowTiles][4],
                                            const AttnMask& mask, int b, int h, uint32_t bh,
                                            int sq, int sk, int rs, int rl, int key_a,
                                            int kseg_a, int kseg_b, const float* lst,
                                            const float* dlt, const int* sgt, float scale,
                                            int lane) {
#pragma unroll
  for (int nt = 0; nt < kSubRowTiles; ++nt) {
    const int c = nt * 8 + mma_tile::frag_col(lane, 0);  // even: 8-byte pairs
    const float2 l2 = *reinterpret_cast<const float2*>(lst + rl + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + rl + c);
    int2 g2 = make_int2(0, 0);
    if (!kFull && mask.q_seg != nullptr) g2 = *reinterpret_cast<const int2*>(sgt + rl + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = i & 1;
      const int key = key_a + (i >= 2 ? 8 : 0);
      const int row = rs + c + e;
      bool in = true;
      if (!kFull) {
        in = row < sq && key < sk && mask.in_band(row, key);
        if (mask.q_seg != nullptr) in = in && (e ? g2.y : g2.x) == (i >= 2 ? kseg_b : kseg_a);
      }
      float x = __fmul_rn(s[nt][i], scale);
      if (mask.bias != nullptr) x = __fadd_rn(x, in ? mask.bias_at(b, h, row, key) : 0.f);
      const float p = in ? prob(x, e ? l2.y : l2.x) : 0.f;
      const float keep = mask.keep(bh, row, key);
      dp[nt][i] = p * (dp[nt][i] * keep - (e ? d2.y : d2.x)) * scale;
      s[nt][i] = p * keep;
    }
  }
}

// Write a warp's 16 x D fp32 accumulator tile as bf16: through its 16 rows
// of the swizzled shared tile `stage`, then rows of 16 bytes (element
// stores unless vec) to out, rows [r0, r0 + 16) of [n, d], those < n.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], bf16* stage, bf16* out,
                                           int r0, int n, int d, int vec, int lane) {
  using namespace mma_tile;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = frag_row(lane, 2 * half);
      *reinterpret_cast<uint32_t*>(stage + swz<D>(r, j * 8 + frag_col(lane, 0))) =
          pack_bf16(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / kChunks, c = i % kChunks;
    if (r0 + r >= n || c * 8 >= d) continue;
    const bf16* src = stage + swz<D>(r, c * 8);
    bf16* dst = out + (long)(r0 + r) * d + c * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && c * 8 + e < d; ++e) dst[e] = src[e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks<D>)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, AttnMask mask, int heads, int kv_heads, int sq,
                        int sk, int d, float scale, int vec) {
  using namespace mma_tile;
  // (named apart from the fp32 kernels' `float smem[]`: one extern array a type)
  extern __shared__ __align__(128) unsigned char tiles[];
  bf16* qs = reinterpret_cast<bf16*>(tiles);
  bf16* dos = qs + kBlockRows * D;
  bf16* ks = dos + kBlockRows * D;
  bf16* vs = ks + 2 * kBlockKeys * D;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // under causal the last query tiles see the most keys: launch them first
  const int tile = mask.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = tile * kBlockRows;
  const int hk = h / (heads / kv_heads);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = min(kBlockRows, sq - q0);
  const uint32_t bh = static_cast<uint32_t>(b * heads + h);
  const long row_base = (long)(b * heads + h) * sq + q0;
  const bf16* kb = k + (long)(b * kv_heads + hk) * sk * d;
  const bf16* vb = v + (long)(b * kv_heads + hk) * sk * d;

  // the key tiles any row of the block may see (AttnMask::first_key, key_end)
  const int k_begin = mask.first_key(q0, kBlockKeys);
  const int k_end = mask.key_end(sk, q0 + nq);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBlockKeys - 1) / kBlockKeys : 0;

  load_tile_async<D, kBlockRows, kMmaThreads>(qs, q + row_base * d, nq, d, vec);
  load_tile_async<D, kBlockRows, kMmaThreads>(dos, dout + row_base * d, nq, d, vec);
  if (n_tiles > 0) {
    const int rows = min(kBlockKeys, sk - k_begin);
    load_tile_async<D, kBlockKeys, kMmaThreads>(ks, kb + (long)k_begin * d, rows, d, vec);
    load_tile_async<D, kBlockKeys, kMmaThreads>(vs, vb + (long)k_begin * d, rows, d, vec);
  }
  cp_async_commit();

  // this warp's rows: r_lo..r_lo + 15; this thread's: row0 and row0 + 8
  const int r_lo = q0 + warp * 16;
  const int r_hi = min(r_lo + 15, sq - 1);
  const int row0 = r_lo + frag_row(lane, 0);
  int seg[2] = {0, 0};
  float lse_r[2] = {0.f, 0.f}, dlt[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= sq) continue;
    lse_r[half] = lse[row_base - q0 + row];
    dlt[half] = delta[row_base - q0 + row];
    if (mask.q_seg != nullptr) seg[half] = mask.q_seg[(long)b * sq + row];
  }

  // ldmatrix addresses (shared window, bytes), as the forward's: every
  // row a lane reads has row % 8 == lane % 8, so the swizzle is one XOR
  const uint32_t swz_x = (lane & 7) << 4;
  // B of S = Q K^T and dP = dO V^T: K and V rows are B's columns (plain)
  const uint32_t k_lane = smem_addr(ks) + (lane & 7) * D * 2 + (lane >> 3) * 16;
  const uint32_t v_lane = smem_addr(vs) + (lane & 7) * D * 2 + (lane >> 3) * 16;
  // B of dQ = dS K: K rows are B's rows (transposed)
  const uint32_t kt_lane =
      smem_addr(ks) + ((lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 + (lane >> 4) * 16;
  // A of S and dP: this warp's rows of Q and dO
  const uint32_t a_row = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 + (lane >> 4) * 16;
  const uint32_t q_lane = smem_addr(qs) + a_row;
  const uint32_t o_lane = smem_addr(dos) + a_row;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBlockKeys;
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy flies while this one is used
      const int k1 = k0 + kBlockKeys;
      const int rows = min(kBlockKeys, sk - k1);
      load_tile_async<D, kBlockKeys, kMmaThreads>(ks + (stage ^ 1) * kBlockKeys * D,
                                                  kb + (long)k1 * d, rows, d, vec);
      load_tile_async<D, kBlockKeys, kMmaThreads>(vs + (stage ^ 1) * kBlockKeys * D,
                                                  vb + (long)k1 * d, rows, d, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 1  // one part's scores live at a time
    for (int part = 0; part < kBlockKeys / kSubKeys; ++part) {
      const int kp0 = k0 + part * kSubKeys;  // keys kp0..kp0 + 31
      // a warp whose rows see none of these keys skips them
      const bool live =
          r_lo < sq && (!mask.causal || kp0 <= r_hi + mask.offset) &&
          !(mask.window > 0 && kp0 + kSubKeys - 1 < r_lo + mask.offset - (mask.window - 1));
      if (!live) continue;
      const uint32_t st = (stage * kBlockKeys + part * kSubKeys) * D * 2;
      float s[kSubTiles][4], dp[kSubTiles][4];
#pragma unroll
      for (int nt = 0; nt < kSubTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
      }
      // S = Q K^T and dP = dO V^T
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t qa[2][4], oa[2][4];  // Q's and dO's fragments of dims kp * 32 .. + 31
        ldmatrix_x4(qa[0], (q_lane + kp * 64) ^ swz_x);
        ldmatrix_x4(qa[1], (q_lane + kp * 64 + 32) ^ swz_x);
        ldmatrix_x4(oa[0], (o_lane + kp * 64) ^ swz_x);
        ldmatrix_x4(oa[1], (o_lane + kp * 64 + 32) ^ swz_x);
#pragma unroll
        for (int nt = 0; nt < kSubTiles; ++nt) {
          uint32_t f[4];
          ldmatrix_x4(f, (k_lane + st + nt * 8 * D * 2 + kp * 64) ^ swz_x);
          mma_bf16(s[nt], qa[0], f[0], f[1]);
          mma_bf16(s[nt], qa[1], f[2], f[3]);
          ldmatrix_x4(f, (v_lane + st + nt * 8 * D * 2 + kp * 64) ^ swz_x);
          mma_bf16(dp[nt], oa[0], f[0], f[1]);
          mma_bf16(dp[nt], oa[1], f[2], f[3]);
        }
      }
      const bool full = kp0 + kSubKeys <= sk && r_lo + 15 < sq &&
                        mask.tile_visible(r_lo, r_lo + 15, kp0, kp0 + kSubKeys - 1);
      if (full)
        score_tile<true>(s, mask, b, h, sq, sk, kp0, row0, seg[0], seg[1], scale, lane);
      else
        score_tile<false>(s, mask, b, h, sq, sk, kp0, row0, seg[0], seg[1], scale, lane);
      // P = exp(S - lse) (0 where hidden: S is -inf there), dS in dp
#pragma unroll
      for (int nt = 0; nt < kSubTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int half = i >> 1;
          const float p = prob(s[nt][i], lse_r[half]);
          const float keep = mask.keep(bh, row0 + 8 * half, kp0 + nt * 8 + frag_col(lane, i));
          dp[nt][i] = p * (dp[nt][i] * keep - dlt[half]) * scale;
        }
      }
      // dQ += dS K, dS as two bf16 parts
#pragma unroll
      for (int kc = 0; kc < kSubKeys / 16; ++kc) {
        uint32_t hi[4], lo[4];
        split_a_frag(dp[2 * kc], dp[2 * kc + 1], hi, lo);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, (kt_lane + st + kc * 16 * D * 2 + dd * 32) ^ swz_x);
          mma_bf16(acc[2 * dd], hi, f[0], f[1]);
          mma_bf16(acc[2 * dd + 1], hi, f[2], f[3]);
          mma_bf16(acc[2 * dd], lo, f[0], f[1]);
          mma_bf16(acc[2 * dd + 1], lo, f[2], f[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next iteration
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed: this warp's Q rows take its dQ
  store_rows<D>(acc, qs + warp * 16 * D, dq + (row_base - q0) * d, r_lo, sq, d, vec, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks<D>)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, AttnMask mask, int heads,
                          int kv_heads, int sq, int sk, int d, float scale, int vec) {
  using namespace mma_tile;
  extern __shared__ __align__(128) unsigned char tiles[];
  bf16* ks = reinterpret_cast<bf16*>(tiles);
  bf16* vs = ks + kBlockKeys * D;
  bf16* qs = vs + kBlockKeys * D;        // two stages
  bf16* dos = qs + 2 * kBlockRows * D;   // two stages
  float* ls = reinterpret_cast<float*>(dos + 2 * kBlockRows * D);  // two stages each
  float* dl = ls + 2 * kBlockRows;
  int* sg = reinterpret_cast<int*>(dl + 2 * kBlockRows);

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockKeys;  // under causal the first key tiles see the most rows
  const int rep = heads / kv_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nk = min(kBlockKeys, sk - k0);
  const long key_base = (long)(b * kv_heads + hk) * sk + k0;
  load_tile_async<D, kBlockKeys, kMmaThreads>(ks, k + key_base * d, nk, d, vec);
  load_tile_async<D, kBlockKeys, kMmaThreads>(vs, v + key_base * d, nk, d, vec);

  // under causal, rows before q_begin see none of this block's keys; under
  // a window, rows from q_end on see none either; tiles of 64 rows over
  // each query head of the group
  const int q_begin = mask.first_row(k0);
  const int q_end = mask.last_row(sq, k0 + nk - 1);
  const int n_qt = q_end > q_begin ? (q_end - q_begin + kBlockRows - 1) / kBlockRows : 0;
  const int n_tiles = rep * n_qt;
  // stage the rows of tile t: Q, dO, and the rows' lse, delta, segment ids
  auto stage_rows = [&](int t, int stage) {
    const int g = t / n_qt;
    const int q0 = q_begin + (t - g * n_qt) * kBlockRows;
    const int rows = min(kBlockRows, sq - q0);
    const long row_base = (long)(b * heads + hk * rep + g) * sq + q0;
    load_tile_async<D, kBlockRows, kMmaThreads>(qs + stage * kBlockRows * D, q + row_base * d,
                                                rows, d, vec);
    load_tile_async<D, kBlockRows, kMmaThreads>(dos + stage * kBlockRows * D,
                                                dout + row_base * d, rows, d, vec);
    const int i = threadIdx.x % kBlockRows;
    const bool in = i < rows;
    const float* src = threadIdx.x < kBlockRows ? lse : delta;
    float* dst = threadIdx.x < kBlockRows ? ls : dl;
    cp_async_4(dst + stage * kBlockRows + i, src + row_base + (in ? i : 0), in ? 4 : 0);
    if (mask.q_seg != nullptr && threadIdx.x < kBlockRows)
      cp_async_4(sg + stage * kBlockRows + i, mask.q_seg + (long)b * sq + q0 + (in ? i : 0),
                 in ? 4 : 0);
  };
  if (n_tiles > 0) stage_rows(0, 0);
  cp_async_commit();

  // this warp's keys: k_lo..k_lo + 15; this thread's: key_a and key_a + 8
  const int k_lo = k0 + warp * 16;
  const int key_a = k_lo + frag_row(lane, 0);
  int kseg_a = 0, kseg_b = 0;
  if (mask.q_seg != nullptr) {
    if (key_a < sk) kseg_a = mask.kv_seg[(long)b * sk + key_a];
    if (key_a + 8 < sk) kseg_b = mask.kv_seg[(long)b * sk + key_a + 8];
  }

  // ldmatrix addresses (shared window, bytes), the same row % 8 rule
  const uint32_t swz_x = (lane & 7) << 4;
  // A of S^T = K_w Q^T and dP^T = V_w dO^T: this warp's keys
  const uint32_t a_row = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 + (lane >> 4) * 16;
  const uint32_t k_lane = smem_addr(ks) + a_row;
  const uint32_t v_lane = smem_addr(vs) + a_row;
  // B of S^T and dP^T: Q and dO rows are B's columns (plain)
  const uint32_t b_row = (lane & 7) * D * 2 + (lane >> 3) * 16;
  const uint32_t q_lane = smem_addr(qs) + b_row;
  const uint32_t o_lane = smem_addr(dos) + b_row;
  // B of dV = P^T dO and dK = dS^T Q: dO and Q rows are B's rows (transposed)
  const uint32_t t_row = ((lane & 7) + ((lane >> 3) & 1) * 8) * D * 2 + (lane >> 4) * 16;
  const uint32_t qt_lane = smem_addr(qs) + t_row;
  const uint32_t ot_lane = smem_addr(dos) + t_row;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy flies while this one is used
      stage_rows(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int g = it / n_qt;
    const int q0 = q_begin + (it - g * n_qt) * kBlockRows;
    const int h = hk * rep + g;  // the query head: its index keys the bias and the dropout hash
    const uint32_t bh = static_cast<uint32_t>(b * heads + h);
    const float* lst = ls + stage * kBlockRows;
    const float* dlt = dl + stage * kBlockRows;
    const int* sgt = sg + stage * kBlockRows;
#pragma unroll 1  // one part's scores live at a time
    for (int sub = 0; sub < kBlockRows / kSubRows; ++sub) {
      const int rs = q0 + sub * kSubRows;  // rows rs..rs + 15
      const int re = rs + kSubRows - 1;
      // skip rows none of this warp's keys is visible to
      const bool live = rs < q_end && k_lo < sk &&
                        (!mask.causal || re + mask.offset >= k_lo) &&
                        !(mask.window > 0 && rs + mask.offset - (mask.window - 1) > k_lo + 15);
      if (!live) continue;
      const uint32_t st = (stage * kBlockRows + sub * kSubRows) * D * 2;
      float s[kSubRowTiles][4], dp[kSubRowTiles][4];
#pragma unroll
      for (int nt = 0; nt < kSubRowTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
      }
      // S^T = K_w Q^T and dP^T = V_w dO^T
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t ka[2][4], va[2][4];  // K_w's and V_w's fragments of dims kp * 32 .. + 31
        ldmatrix_x4(ka[0], (k_lane + kp * 64) ^ swz_x);
        ldmatrix_x4(ka[1], (k_lane + kp * 64 + 32) ^ swz_x);
        ldmatrix_x4(va[0], (v_lane + kp * 64) ^ swz_x);
        ldmatrix_x4(va[1], (v_lane + kp * 64 + 32) ^ swz_x);
#pragma unroll
        for (int nt = 0; nt < kSubRowTiles; ++nt) {
          uint32_t f[4];
          ldmatrix_x4(f, (q_lane + st + nt * 8 * D * 2 + kp * 64) ^ swz_x);
          mma_bf16(s[nt], ka[0], f[0], f[1]);
          mma_bf16(s[nt], ka[1], f[2], f[3]);
          ldmatrix_x4(f, (o_lane + st + nt * 8 * D * 2 + kp * 64) ^ swz_x);
          mma_bf16(dp[nt], va[0], f[0], f[1]);
          mma_bf16(dp[nt], va[1], f[2], f[3]);
        }
      }
      const bool full = re < sq && k_lo + 15 < sk && mask.tile_visible(rs, re, k_lo, k_lo + 15);
      const int rl = sub * kSubRows;
      if (full)
        recompute_t<true>(s, dp, mask, b, h, bh, sq, sk, rs, rl, key_a, kseg_a, kseg_b, lst, dlt,
                          sgt, scale, lane);
      else
        recompute_t<false>(s, dp, mask, b, h, bh, sq, sk, rs, rl, key_a, kseg_a, kseg_b, lst,
                           dlt, sgt, scale, lane);
      // dV += (P K)^T dO and dK += dS^T Q, each A operand as two bf16 parts
#pragma unroll
      for (int kc = 0; kc < kSubRows / 16; ++kc) {
        uint32_t phi[4], plo[4], shi[4], slo[4];
        split_a_frag(s[2 * kc], s[2 * kc + 1], phi, plo);
        split_a_frag(dp[2 * kc], dp[2 * kc + 1], shi, slo);
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, (ot_lane + st + kc * 16 * D * 2 + dd * 32) ^ swz_x);
          mma_bf16(dv_acc[2 * dd], phi, f[0], f[1]);
          mma_bf16(dv_acc[2 * dd + 1], phi, f[2], f[3]);
          mma_bf16(dv_acc[2 * dd], plo, f[0], f[1]);
          mma_bf16(dv_acc[2 * dd + 1], plo, f[2], f[3]);
          ldmatrix_x4_trans(f, (qt_lane + st + kc * 16 * D * 2 + dd * 32) ^ swz_x);
          mma_bf16(dk_acc[2 * dd], shi, f[0], f[1]);
          mma_bf16(dk_acc[2 * dd + 1], shi, f[2], f[3]);
          mma_bf16(dk_acc[2 * dd], slo, f[0], f[1]);
          mma_bf16(dk_acc[2 * dd + 1], slo, f[2], f[3]);
        }
      }
    }
    __syncthreads();  // this stage is free for the copy issued next iteration
  }
  cp_async_wait<0>();
  __syncthreads();  // every copy has landed: this warp's K and V rows take its dK and dV
  const long out0 = (long)(b * kv_heads + hk) * sk;
  store_rows<D>(dk_acc, ks + warp * 16 * D, dk + out0 * d, k_lo, sk, d, vec, lane);
  store_rows<D>(dv_acc, vs + warp * 16 * D, dv + out0 * d, k_lo, sk, d, vec, lane);
}

// cp.async and the 16-byte epilogue need rows of whole 16-byte chunks
int rows_vec(int d, const void* a, const void* b, const void* c, const void* e, const void* f,
             const void* g) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(e) |
                         reinterpret_cast<uintptr_t>(f) | reinterpret_cast<uintptr_t>(g);
  return d % 8 == 0 && (bits & 15) == 0;
}

// ---- fp32 on the CUDA cores -------------------------------------------------

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

// The minimum blocks per SM cap the registers at the budget that keeps
// four dq blocks (64 a thread) and three dk/dv blocks (85) resident: left
// free, ptxas moved both kernels' counts between builds of near-equal
// sources (dq 62-80, dk/dv 80-100), and one block fewer per SM cost up to
// 15% (8 x 12 x 1024 x 64, on the H100, measured when these kernels also
// served bf16).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
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
  const int k_end = mask.key_end(sk, q0 + nq);
  const int k_begin = mask.first_key(q0, kTile);
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
        const float p = expf(mask.score(s, scale, b, h, q0 + r, k0 + lane) - row_lse[rr]);
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
__global__ void __launch_bounds__(kThreads, 3)
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
  const int q_begin = mask.first_row(k0);
  const int q_end = mask.last_row(sq, k0 + nk - 1);
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
          const float pr = expf(mask.score(s, scale, b, h, q0 + lane, k0 + j) - ls[lane]);
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

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, const AttnMask& mask,
                          int batch, int heads, int kv_heads, int sq, int sk, int d, float scale,
                          cudaStream_t s) {
  constexpr int kSmem = dq_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_mma_kernel<D>, kSmem);
  if (err != cudaSuccess) return err;
  const int vec = rows_vec(d, q, k, v, dout, dq, dq);
  dim3 grid(heads, batch, (sq + kBlockRows - 1) / kBlockRows);
  flash_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), mask, heads, kv_heads,
      sq, sk, d, scale, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkdv_mma(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            const AttnMask& mask, int batch, int heads, int kv_heads, int sq,
                            int sk, int d, float scale, cudaStream_t s) {
  constexpr int kSmem = dkdv_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_mma_kernel<D>, kSmem);
  if (err != cudaSuccess) return err;
  const int vec = rows_vec(d, q, k, v, dout, dk, dv);
  dim3 grid(kv_heads, batch, (sk + kBlockKeys - 1) / kBlockKeys);
  flash_bwd_dkdv_mma_kernel<D><<<grid, kMmaThreads, kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      mask, heads, kv_heads, sq, sk, d, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// q_seg/kv_seg: int32 [B, Sq] / [B, Sk], or null; seed, threshold and
// keep_scale are read only when dropout is set (the forward's values, the
// origins folded into the seed); window 0 = none (the wrapper passes one only with
// causal); offset and bias as the forward's (apex_flash_fwd). bf16 takes
// the tensor-core kernels (d <= 128), fp32 the CUDA-core ones.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, const void* q_seg,
                                 const void* kv_seg, int causal, int dropout, unsigned seed,
                                 unsigned threshold, float keep_scale, int window,
                                 int offset, const void* bias, int bias_bf16,
                                 long long bias_sb,
                                 long long bias_sh, long long bias_sq, long long bias_sk,
                                 int batch, int heads, int kv_heads, int sq, int sk, int d,
                                 float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  const AttnMask mask{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), causal,
                      dropout, seed, threshold, keep_scale, window, bias, bias_bf16, bias_sb,
                      bias_sh, bias_sq, bias_sk, offset};
  if (dtype == APEX_BF16) {
    if (d > 128) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        d <= 64 ? launch_dq_mma<64>(q, k, v, dout, l, dl, dq, mask, batch, heads, kv_heads, sq,
                                    sk, d, scale, s)
                : launch_dq_mma<128>(q, k, v, dout, l, dl, dq, mask, batch, heads, kv_heads, sq,
                                     sk, d, scale, s));
  }
  return static_cast<int>(launch_dq<float>(q, k, v, dout, l, dl, dq, mask, batch, heads,
                                           kv_heads, sq, sk, d, scale, s));
}

extern "C" int apex_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dk, void* dv, const void* q_seg, const void* kv_seg,
                                   int causal, int dropout, unsigned seed, unsigned threshold,
                                   float keep_scale, int window, int offset,
                                   const void* bias,
                                   int bias_bf16, long long bias_sb, long long bias_sh,
                                   long long bias_sq, long long bias_sk, int batch, int heads,
                                   int kv_heads, int sq, int sk, int d, float scale, int dtype,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  const AttnMask mask{static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), causal,
                      dropout, seed, threshold, keep_scale, window, bias, bias_bf16, bias_sb,
                      bias_sh, bias_sq, bias_sk, offset};
  if (dtype == APEX_BF16) {
    if (d > 128) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        d <= 64 ? launch_dkdv_mma<64>(q, k, v, dout, l, dl, dk, dv, mask, batch, heads,
                                      kv_heads, sq, sk, d, scale, s)
                : launch_dkdv_mma<128>(q, k, v, dout, l, dl, dk, dv, mask, batch, heads,
                                       kv_heads, sq, sk, d, scale, s));
  }
  return static_cast<int>(launch_dkdv<float>(q, k, v, dout, l, dl, dk, dv, mask, batch, heads,
                                             kv_heads, sq, sk, d, scale, s));
}
