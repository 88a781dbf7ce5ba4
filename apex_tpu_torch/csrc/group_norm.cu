// NHWC GroupNorm with an optional fused SiLU: forward (y, and the mean and
// rstd of each (sample, group) slab) and backward (dx, dweight, dbias).
//
// Replaces the TPU kernels apex_tpu/ops/group_norm.py::_gn_fwd_kernel (:56,
// the pallas_call in _gn_fwd) and ::_gn_bwd_kernel (:153, in _gn_bwd). x is
// [n, hw, c] contiguous (NHWC), fp32, bf16 or fp16, in g groups of cg = c / g
// channels; slab (i, j) is x[i, :, j cg : (j + 1) cg], m = hw cg values.
// In fp32, with w and b fp32 (or no affine: w = 1, b = 0):
//   mean = sum x / m;  var = sum (x - mean)^2 / m   (centred, as the
//        reference's group_norm_reference, which serves every shape whose
//        cg is not a multiple of 128: all of Stable Diffusion's)
//   rstd = rsqrt(var + eps);  xhat = (x - mean) rstd
//   y    = xhat w + b, then silu(y) = y sigmoid(y)            (x's dtype)
// and backward, from the saved mean and rstd, with y' = xhat w + b:
//   d    = dy, or under SiLU dy sig(y') (1 + y' (1 - sig(y')))
//   dw   = sum_{samples, rows} d xhat, db = sum d             (fp32, [c])
//   dyw  = d w;  A = sum_slab dyw / m;  B = sum_slab dyw xhat / m
//   dx   = rstd ((dyw - A) - xhat B)                           (x's dtype)
//
// What bounds it on the H100: bytes. The forward reads x once and writes y
// once (the second launch reads x again, partly from L2); the backward
// reads x and dy and writes dx, ~20 operations an element. At Stable Diffusion v1.5's (8, 320, 64, 64) in bf16 that is 42 MB
// and 63 MB: 0.0125 ms and 0.0188 ms at 3.35 TB/s. A (sample, group) slab
// is no unit to tile by: at cg = 10 its rows are 20-byte runs 640 bytes
// apart, and its statistics gate every one of its outputs.
//
// Design: tile NHWC as it lies, and split the statistics over blocks.
//  - A thread holds a vector column: 8 channels of a row, one 16-byte load
//    (bf16, fp16) or two (fp32). A block is `tr` thread rows of `ct` vector
//    columns: whole rows of c channels (a row wider than 320 vectors is cut
//    into `tiles` of ct columns, gridDim.y), so a warp reads 512 contiguous
//    bytes a load and each thread's channels, weight and bias stay fixed.
//  - Block (k, q, i) takes chunk k of sample i's rows: thread row r walks
//    rows r, r + tr, ..., `rows` of them, in steps (64 bytes of x, 32 each
//    of x and dy in the backward) with the next step's loads in flight.
//    Two blocks of up to 320 threads stay resident an SM. The cut,
//    ops/group_norm.py::group_norm_split_plan, depends on (hw, c, cg,
//    dtype, direction) alone, so a sample's y, mean, rstd and dx have the
//    same bits alone and in a batch.
//  - Forward, two launches. group_norm_fwd_stats_kernel: each thread keeps
//    per channel (mean, M2) over its rows from sums shifted by its first
//    value (over n rows M2 = S2 - S1^2 / n loses at most ~(n + 1) ulps);
//    a channel's thread rows, neighbouring lanes, merge in two passes by a
//    xor butterfly (their counted mean, then their M2s plus each count
//    times its squared distance from that mean); then, per group, a
//    segment of lanes folds its channels the same way into one (count,
//    mean, M2) partial of (sample, chunk, tile, group) in fp32 scratch. No
//    E[x^2] - mean^2 over more than a thread's rows anywhere. The last
//    block of a sample to finish (a per-sample count, atomically) folds
//    the sample's partials over its chunks the same way (each lane's items
//    loaded kHeld at a time) and writes its mean and rstd.
//    group_norm_fwd_apply_kernel is launched to start while the first
//    launch's last blocks run (programmatic dependent launch): it loads its
//    first rows, weight and bias, waits for the first launch, and writes y
//    with 16-byte stores, in the reverse block order, so that the chunks
//    the first launch read last come first, from L2.
//  - Backward, two launches. group_norm_bwd_sums_kernel: per channel sum d
//    and d xhat (the SiLU's sigmoid once an element), a channel's thread
//    rows summed by the butterfly into the chunk's per-channel dw/db
//    partials, and from them per group sum dyw = sum_ch w db and sum dyw
//    xhat = sum_ch w dw; a sample's last block sums those over its chunks
//    into A and B. group_norm_bwd_dx_kernel, launched the same way, writes
//    dx; its first blocks also finish dw and db on the card (per sample
//    over the chunks, then over the samples in a fixed order), so the
//    wrapper sums nothing.
//  - Which block of a sample finishes last varies from run to run; what it
//    computes does not: it reads every partial in a fixed order.
//  - A c that is not whole vectors, or a view off a 16-byte boundary,
//    takes the kRagged instances: the same vectors by element loads and
//    stores (channels past c read as 0 and never counted). Any cg works in
//    every instance: a group's statistics are folded from its channels',
//    wherever the vectors cut it.
// Every sum runs in an order fixed by the shape: the same bits in every run.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kVec = 8;           // channels a thread holds
constexpr int kMaxThreads = 320;  // the plan's largest block
// resident blocks an SM at kMaxThreads: 2, which bounds each kernel's
// registers to 102 (at 3 the forward's 64 spilled 116-172 bytes and ran
// slower; the backward's 105-117 had left one block an SM)
constexpr int kBlocksPerSm = 2;
constexpr unsigned kFull = 0xffffffffu;

// the cut of a call: ops/group_norm.py::group_norm_split_plan
struct Plan {
  int ct;          // vector columns of a tile, one thread each
  int tiles;       // column tiles of a row (gridDim.y)
  int tr;          // thread rows
  int rows;        // rows a thread holds: chunk_rows = tr rows
  int chunk_rows;  // rows of a chunk
  int chunks;      // chunks of a sample (gridDim.x)
};

// the rows a thread loads at once, a step of its walk down its rows: 64
// bytes (4 rows of 16-bit values, 2 of fp32), with the next step's loads
// in flight while it works on this one
template <typename T>
constexpr int kStep = 8 / sizeof(T);
// the backward's step: 32 bytes each of x and dy, the next step's in flight
template <typename T>
constexpr int kBwdStep = 4 / sizeof(T);

// 8 values of T: one 16-byte word (bf16, fp16) or two (fp32)
template <typename T>
struct Pack {
  static constexpr int kWords = sizeof(T) / 2;
  uint4 w[kWords];
};

template <typename T>
__device__ __forceinline__ void clear(Pack<T>& p) {
#pragma unroll
  for (int k = 0; k < Pack<T>::kWords; ++k) p.w[k] = make_uint4(0u, 0u, 0u, 0u);
}

// the 8 values at row[c0 ..]: 16-byte loads (streamed: kLast, a last read),
// or element loads with the channels past c left 0 (kRagged)
template <typename T, bool kRagged, bool kLast>
__device__ __forceinline__ void load8(Pack<T>& p, const T* __restrict__ row, int c0, int c) {
  if constexpr (!kRagged) {
    const uint4* src = reinterpret_cast<const uint4*>(row + c0);
#pragma unroll
    for (int k = 0; k < Pack<T>::kWords; ++k) p.w[k] = kLast ? __ldcs(src + k) : __ldg(src + k);
  } else {
    clear(p);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if (c0 + e >= c) continue;
      if constexpr (sizeof(T) == 4) {
        (&p.w[e / 4].x)[e % 4] = __float_as_uint(__ldg(reinterpret_cast<const float*>(row) + c0 + e));
      } else {
        const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(row) + c0 + e);
        (&p.w[0].x)[e / 2] |= h << (16 * (e & 1));
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void unpack8(const Pack<T>& p, float (&v)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if constexpr (sizeof(T) == 4) {
      v[e] = __uint_as_float((&p.w[e / 4].x)[e % 4]);
    } else {
      const uint32_t u = (&p.w[0].x)[e / 2];
      if constexpr (std::is_same<T, __nv_bfloat16>::value)
        v[e] = __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
      else
        v[e] = __half2float(__ushort_as_half(static_cast<unsigned short>((e & 1) ? u >> 16 : u)));
    }
  }
}

// row[c0 ..] = v in T (round to nearest): 16-byte stores, or element stores
// of the channels below c (kRagged)
template <typename T, bool kRagged>
__device__ __forceinline__ void store8(T* __restrict__ row, int c0, int c, const float (&v)[kVec]) {
  if constexpr (kRagged) {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (c0 + e < c) row[c0 + e] = from_f32<T>(v[e]);
  } else {
    Pack<T> p;
#pragma unroll
    for (int k = 0; k < 4 * Pack<T>::kWords; ++k) {
      uint32_t& u = (&p.w[k / 4].x)[k % 4];
      if constexpr (sizeof(T) == 4) {
        u = __float_as_uint(v[k]);
      } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        u = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __half2 h = __floats2half2_rn(v[2 * k], v[2 * k + 1]);
        u = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(row + c0);
#pragma unroll
    for (int k = 0; k < Pack<T>::kWords; ++k) dst[k] = p.w[k];
  }
}

// a block's dynamic shared memory
extern __shared__ float gn_smem[];

// griddepcontrol: a call's second launch starts while the first one's last
// blocks finish (programmatic dependent launch), loads what needs nothing
// of the first, then waits for all of the first and its writes
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_first() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// One block of a sample's `total`: true for the block that finishes last,
// which then sees every partial the others wrote (they fence before they
// count), and resets the sample's count for the next call. Every block
// lets the call's second launch start here.
__device__ __forceinline__ bool last_of_sample(int* count, int i, int total) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(count + i, 1) == total - 1;
  __syncthreads();
  launch_dependents();
  if (!s_last) return false;
  __threadfence();
  if (threadIdx.x == 0) count[i] = 0;
  return true;
}

// A block's place: chunk k, tile q, sample i (in reverse launch order for
// the second launch of a call); its thread's row r and vector column (the
// thread rows of a column are `tr` neighbouring lanes of one warp), first
// channel and its place lc in the tile; the tile's channels and groups
struct Place {
  int k, q, i, r, c0, lc, len, ch_lo, ch_hi, g_lo, g_hi;
  bool active;
  __device__ Place(const Plan& p, int hw, int c, int cg, bool reverse) {
    k = reverse ? p.chunks - 1 - blockIdx.x : blockIdx.x;
    q = reverse ? p.tiles - 1 - blockIdx.y : blockIdx.y;
    i = reverse ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
    r = threadIdx.x % p.tr;
    const int j = threadIdx.x / p.tr;
    ch_lo = q * p.ct * kVec;
    lc = j * kVec;
    c0 = ch_lo + lc;
    len = min(p.chunk_rows, hw - k * p.chunk_rows);
    ch_hi = min(c, ch_lo + p.ct * kVec);
    g_lo = ch_lo / cg;
    g_hi = (ch_hi - 1) / cg;
    active = j < p.ct && c0 < c;
  }
  // the chunk's first row of a [n, hw, c] tensor
  template <typename U>
  __device__ U* chunk(U* t, int hw, int c, const Plan& p) const {
    return t + (static_cast<long long>(i) * hw + static_cast<long long>(k) * p.chunk_rows) * c;
  }
};

// the tiles of row channels group g spans
__device__ __forceinline__ void group_tiles(int g, int cg, const Plan& p, int& qa, int& nq) {
  const int span = p.ct * kVec;
  qa = g * cg / span;
  nq = ((g + 1) * cg - 1) / span - qa + 1;
}

// The n_groups groups, each folded by a segment of `seg` lanes of one
// warp (seg: the largest power of 2 up to 32 that puts every group in one
// round, when they fit; rounds of blockDim / seg groups otherwise).
// body(gi, live, lane, seg) runs on every thread of the block in every
// round: group gi (live: gi < n_groups), the thread's lane in its segment.
// The segment sizes and the rounds depend on the shape alone.
template <typename Body>
__device__ __forceinline__ void by_group(int n_groups, Body body) {
  const int nt = blockDim.x;
  int seg = 32;
  while (seg > 1 && n_groups * seg > nt) seg >>= 1;
  for (int g0 = 0; g0 < n_groups; g0 += nt / seg) {
    const int gi = g0 + static_cast<int>(threadIdx.x) / seg;
    body(gi, gi < n_groups, static_cast<int>(threadIdx.x) % seg, seg);
  }
}

// a sum over an aligned segment of `seg` lanes (a power of 2: a group's
// segment, or a vector column's thread rows), a xor butterfly: every lane
// of the segment gets the same bits; every lane of the warp takes part
template <int kN>
__device__ __forceinline__ void seg_sum(float (&v)[kN], int seg) {
  for (int o = seg / 2; o > 0; o >>= 1)
#pragma unroll
    for (int a = 0; a < kN; ++a) v[a] += __shfl_xor_sync(kFull, v[a], o);
}

// The thread's rows r + (u0 + u) tr (u0 + u < p.rows) of the chunk, as
// Pack<T>s, those past the chunk's end 0: returns how many are in it (a
// prefix)
template <typename T, bool kRagged, bool kLast, int R>
__device__ __forceinline__ int load_rows(Pack<T> (&raw)[R], const T* __restrict__ xs,
                                         const Place& at, const Plan& p, int c, int u0 = 0) {
  int nv = 0;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int row = at.r + (u0 + u) * p.tr;
    if (u0 + u < p.rows && row < at.len) {
      load8<T, kRagged, kLast>(raw[u], xs + static_cast<long long>(row) * c, at.c0, c);
      ++nv;
    } else {
      clear(raw[u]);
    }
  }
  return nv;
}

// partials a lane of a merge holds at once (their loads in flight together)
constexpr int kHeld = 8;

// A sample's partials of group g, `w` floats each, laid out [chunk][tile]
// [group]: item it is chunk it / nq of tile qa + it % nq (the tiles the
// group spans)
struct SampleItems {
  const float* base;  // the sample's first partial
  int tiles, groups, w, g, qa, nq, items;
  __device__ SampleItems(const float* sample, const Plan& p, int groups_, int w_, int g_, int cg,
                         bool live)
      : base(sample), tiles(p.tiles), groups(groups_), w(w_), g(g_), qa(0), nq(1), items(0) {
    if (live) {
      group_tiles(g, cg, p, qa, nq);
      items = p.chunks * nq;
    }
  }
  __device__ const float* at(int it) const {
    const long long kq = nq == 1 ? static_cast<long long>(it) * tiles + qa
                                 : static_cast<long long>(it / nq) * tiles + qa + it % nq;
    return base + (kq * groups + g) * w;
  }
};

// the chunk's per-thread sums of its thread's rows, shifted by the thread's
// first value of each channel: (count, mean, M2) per channel; over n rows
// M2 = S2 - S1^2 / n loses at most ~(n + 1) ulps relative
template <typename T, bool kRagged>
__device__ __forceinline__ float thread_stats(const T* __restrict__ xs, const Place& at,
                                              const Plan& p, int c, float (&mean)[kVec],
                                              float (&m2)[kVec]) {
  constexpr int R = kStep<T>;
  Pack<T> raw[R];
  int nv = load_rows<T, kRagged, false>(raw, xs, at, p, c, 0);
  if (nv == 0) return 0.f;
  float k[kVec], s1[kVec] = {}, s2[kVec] = {};
  unpack8(raw[0], k);
  int n = 0;
  for (int u0 = 0; nv > 0; u0 += R) {
    // the next step's rows fly while this one is summed
    Pack<T> nxt[R];
    const int nn = u0 + R < p.rows ? load_rows<T, kRagged, false>(nxt, xs, at, p, c, u0 + R) : 0;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (u >= nv) continue;
      float v[kVec];
      unpack8(raw[u], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float d = v[e] - k[e];
        s1[e] += d;
        s2[e] = fmaf(d, d, s2[e]);
      }
    }
    n += nv;
#pragma unroll
    for (int u = 0; u < R; ++u) raw[u] = nxt[u];
    nv = nn;
  }
  const float inv = __fdividef(1.f, static_cast<float>(n));
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float d = s1[e] * inv;
    mean[e] = k[e] + d;
    m2[e] = fmaxf(fmaf(-d, s1[e], s2[e]), 0.f);
  }
  return static_cast<float>(n);
}

template <typename T, bool kRagged>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
group_norm_fwd_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                            int* __restrict__ count, float* __restrict__ mean_out,
                            float* __restrict__ rstd_out, Plan p, int hw, int c, int cg,
                            float eps) {
  float* s_mean = gn_smem;                  // per channel of the tile
  float* s_m2 = gn_smem + p.ct * kVec;
  const Place at(p, hw, c, cg, false);
  float mean[kVec] = {}, m2[kVec] = {}, n = 0.f;
  if (at.active) n = thread_stats<T, kRagged>(at.chunk(x, hw, c, p), at, p, c, mean, m2);
  // a channel over the chunk: its thread rows' (count, mean, M2) in two
  // passes over the column's lanes, a xor butterfly (their counted mean,
  // then their M2s plus each count times its squared distance from it)
  const float inv_len = 1.f / static_cast<float>(at.len);
  float cm[kVec], cq[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) cm[e] = n * mean[e];
  seg_sum(cm, p.tr);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    cm[e] *= inv_len;
    const float d = mean[e] - cm[e];
    cq[e] = fmaf(n * d, d, m2[e]);
  }
  seg_sum(cq, p.tr);
  if (at.active && at.r == 0)
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s_mean[at.lc + e] = cm[e];
      s_m2[at.lc + e] = cq[e];
    }
  __syncthreads();
  // per group of the tile, its channels (each of the chunk's len rows),
  // lane l of the segment taking channels a + l, a + l + seg, ..., in the
  // same two passes: the chunk's partial (count, mean, M2) of the group
  const int groups = c / cg;
  const float len = static_cast<float>(at.len);
  by_group(at.g_hi - at.g_lo + 1, [&](int gi, bool live, int lane, int seg) {
    const int g = at.g_lo + gi;
    const int a = live ? max(g * cg, at.ch_lo) - at.ch_lo : 0;
    const int bnd = live ? min((g + 1) * cg, at.ch_hi) - at.ch_lo : 0;
    float sm[1] = {};
    for (int ch = a + lane; ch < bnd; ch += seg) sm[0] += s_mean[ch];
    seg_sum(sm, seg);
    const float mg = bnd > a ? sm[0] / static_cast<float>(bnd - a) : 0.f;
    float q[1] = {};
    for (int ch = a + lane; ch < bnd; ch += seg) {
      const float d = s_mean[ch] - mg;
      q[0] = fmaf(len * d, d, q[0] + s_m2[ch]);
    }
    seg_sum(q, seg);
    if (live && lane == 0) {
      float* dst = part + (((static_cast<long long>(at.i) * p.chunks + at.k) * p.tiles + at.q) *
                               groups + g) * 3;
      dst[0] = len * static_cast<float>(bnd - a);
      dst[1] = mg;
      dst[2] = q[0];
    }
  });
  if (!last_of_sample(count, at.i, p.chunks * p.tiles)) return;
  // the sample's last block: per group, its partials over the chunks (and
  // the tiles it spans), lane l of the segment taking items l, l + seg,
  // ..., kHeld at a time, in the same two passes; its mean and rstd
  const float* sample = part + static_cast<long long>(at.i) * p.chunks * p.tiles * groups * 3;
  by_group(groups, [&](int g, bool live, int lane, int seg) {
    const SampleItems src(sample, p, groups, 3, g, cg, live);
    float hn[kHeld] = {}, hm[kHeld] = {}, hq[kHeld] = {}, sn[2] = {};
    for (int it0 = lane; it0 < src.items; it0 += seg * kHeld) {
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int it = it0 + h * seg;
        const bool in = it < src.items;
        hn[h] = in ? __ldcg(src.at(it)) : 0.f;
        hm[h] = in ? __ldcg(src.at(it) + 1) : 0.f;
        hq[h] = in ? __ldcg(src.at(it) + 2) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        sn[0] += hn[h];
        sn[1] = fmaf(hn[h], hm[h], sn[1]);
      }
    }
    seg_sum(sn, seg);
    const float mg = sn[0] > 0.f ? sn[1] / sn[0] : 0.f;
    float q[1] = {};
    if (src.items <= seg * kHeld) {  // the one round of items, still held
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const float d = hm[h] - mg;
        q[0] = fmaf(hn[h] * d, d, q[0] + hq[h]);
      }
    } else {
      for (int it = lane; it < src.items; it += seg) {
        const float d = __ldcg(src.at(it) + 1) - mg;
        q[0] = fmaf(__ldcg(src.at(it)) * d, d, q[0] + __ldcg(src.at(it) + 2));
      }
    }
    seg_sum(q, seg);
    if (live && lane == 0) {
      mean_out[static_cast<long long>(at.i) * groups + g] = mg;
      rstd_out[static_cast<long long>(at.i) * groups + g] = rsqrtf(q[0] / sn[0] + eps);
    }
  });
}

__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

template <typename T, bool kSilu, bool kRagged>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
group_norm_fwd_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                            const float* __restrict__ b, const float* __restrict__ mean,
                            const float* __restrict__ rstd, T* __restrict__ y, Plan p, int hw,
                            int c, int cg) {
  const Place at(p, hw, c, cg, true);
  if (!at.active) return;
  constexpr int R = kStep<T>;
  const T* xs = at.chunk(x, hw, c, p);
  // the first step's rows, the weight and the bias need nothing of the
  // first launch
  Pack<T> raw[R];
  int nv = load_rows<T, kRagged, true>(raw, xs, at, p, c, 0);
  float sc[kVec], sh[kVec], mu[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const int ch = min(at.c0 + e, c - 1);
    sc[e] = w != nullptr ? w[ch] : 1.f;
    sh[e] = w != nullptr ? b[ch] : 0.f;
  }
  wait_for_first();
  const long long stats = static_cast<long long>(at.i) * (c / cg);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long g = stats + min(at.c0 + e, c - 1) / cg;
    mu[e] = mean[g];
    sc[e] *= rstd[g];
  }
  T* ys = at.chunk(y, hw, c, p);
  for (int u0 = 0; nv > 0; u0 += R) {
    Pack<T> nxt[R];
    const int nn = u0 + R < p.rows ? load_rows<T, kRagged, true>(nxt, xs, at, p, c, u0 + R) : 0;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (u >= nv) continue;
      float v[kVec];
      unpack8(raw[u], v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float t = fmaf(v[e] - mu[e], sc[e], sh[e]);
        v[e] = kSilu ? silu(t) : t;
      }
      store8<T, kRagged>(ys + static_cast<long long>(at.r + (u0 + u) * p.tr) * c, at.c0, c, v);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) raw[u] = nxt[u];
    nv = nn;
  }
}

// d of one element: dy, through the SiLU's derivative when fused
template <bool kSilu>
__device__ __forceinline__ float upstream(float dy, float xhat, float wj, float bj) {
  if (!kSilu) return dy;
  const float pre = fmaf(xhat, wj, bj);
  const float sig = __fdividef(1.f, 1.f + __expf(-pre));
  return dy * sig * fmaf(pre, 1.f - sig, 1.f);
}

// the per-channel constants of a thread's 8 channels: the slab's mean and
// rstd, the weight and bias (1 and 0 without affine)
struct Channels {
  float mu[kVec], rs[kVec], w[kVec], b[kVec];
  __device__ Channels(const Place& at, const float* __restrict__ mean,
                      const float* __restrict__ rstd, const float* __restrict__ wt,
                      const float* __restrict__ bt, int c, int cg) {
    const long long row = static_cast<long long>(at.i) * (c / cg);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const int ch = min(at.c0 + e, c - 1);
      mu[e] = mean[row + ch / cg];
      rs[e] = rstd[row + ch / cg];
      w[e] = wt != nullptr ? wt[ch] : 1.f;
      b[e] = wt != nullptr ? bt[ch] : 0.f;
    }
  }
};

template <typename T, bool kSilu, bool kRagged>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
group_norm_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                           const float* __restrict__ w, const float* __restrict__ b,
                           const float* __restrict__ mean, const float* __restrict__ rstd,
                           float* __restrict__ gpart, float* __restrict__ cpart,
                           float* __restrict__ ab, int* __restrict__ count, Plan p, int hw, int c,
                           int cg) {
  float* s_dw = gn_smem;                    // per channel of the tile
  float* s_db = gn_smem + p.ct * kVec;
  const Place at(p, hw, c, cg, false);
  constexpr int R = kBwdStep<T>;
  float dw[kVec] = {}, db[kVec] = {};
  if (at.active) {
    const T* xs = at.chunk(x, hw, c, p);
    const T* gs = at.chunk(dy, hw, c, p);
    const Channels ch(at, mean, rstd, w, b, c, cg);
    Pack<T> rx[R], rg[R];
    int nv = load_rows<T, kRagged, false>(rx, xs, at, p, c, 0);
    load_rows<T, kRagged, false>(rg, gs, at, p, c, 0);
    for (int u0 = 0; nv > 0; u0 += R) {
      // the next step's rows fly while this one is summed
      Pack<T> nx[R], ng[R];
      int nn = 0;
      if (u0 + R < p.rows) {
        nn = load_rows<T, kRagged, false>(nx, xs, at, p, c, u0 + R);
        load_rows<T, kRagged, false>(ng, gs, at, p, c, u0 + R);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (u >= nv) continue;
        float xv[kVec], gv[kVec];
        unpack8(rx[u], xv);
        unpack8(rg[u], gv);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xh = (xv[e] - ch.mu[e]) * ch.rs[e];
          const float d = upstream<kSilu>(gv[e], xh, ch.w[e], ch.b[e]);
          db[e] += d;
          dw[e] = fmaf(d, xh, dw[e]);
        }
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        rx[u] = nx[u];
        rg[u] = ng[u];
      }
      nv = nn;
    }
  }
  // a channel over the chunk: its thread rows summed over the column's
  // lanes, into the chunk's dw/db partials
  seg_sum(dw, p.tr);
  seg_sum(db, p.tr);
  if (at.active && at.r == 0) {
    const long long at_c = (static_cast<long long>(at.i) * p.chunks + at.k) * c + at.c0;
    const long long plane = static_cast<long long>(gridDim.z) * p.chunks * c;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s_dw[at.lc + e] = dw[e];
      s_db[at.lc + e] = db[e];
      if (w != nullptr && at.c0 + e < c) {
        cpart[at_c + e] = dw[e];
        cpart[plane + at_c + e] = db[e];
      }
    }
  }
  __syncthreads();
  // per group of the tile: sum dyw = sum_ch w db, sum dyw xhat = sum_ch w
  // dw, lane l of the segment taking channels a + l, a + l + seg, ...
  const int groups = c / cg;
  by_group(at.g_hi - at.g_lo + 1, [&](int gi, bool live, int lane, int seg) {
    const int g = at.g_lo + gi;
    const int a = live ? max(g * cg, at.ch_lo) : 0;
    const int bnd = live ? min((g + 1) * cg, at.ch_hi) : 0;
    float sums[2] = {};
    for (int ch = a + lane; ch < bnd; ch += seg) {
      const float wv = w != nullptr ? w[ch] : 1.f;
      sums[0] = fmaf(wv, s_db[ch - at.ch_lo], sums[0]);
      sums[1] = fmaf(wv, s_dw[ch - at.ch_lo], sums[1]);
    }
    seg_sum(sums, seg);
    if (live && lane == 0) {
      float* dst = gpart + (((static_cast<long long>(at.i) * p.chunks + at.k) * p.tiles + at.q) *
                                groups + g) * 2;
      dst[0] = sums[0];
      dst[1] = sums[1];
    }
  });
  if (!last_of_sample(count, at.i, p.chunks * p.tiles)) return;
  // the sample's last block: per group, its sums over the chunks (and the
  // tiles it spans), lane l of the segment taking items l, l + seg, ...,
  // kHeld at a time; A = sum dyw / m, B = sum dyw xhat / m
  const float m = static_cast<float>(hw) * static_cast<float>(cg);
  const float* sample = gpart + static_cast<long long>(at.i) * p.chunks * p.tiles * groups * 2;
  by_group(groups, [&](int g, bool live, int lane, int seg) {
    const SampleItems src(sample, p, groups, 2, g, cg, live);
    float sums[2] = {};
    for (int it0 = lane; it0 < src.items; it0 += seg * kHeld) {
      float ha[kHeld], hb[kHeld];
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        const int it = it0 + h * seg;
        ha[h] = it < src.items ? __ldcg(src.at(it)) : 0.f;
        hb[h] = it < src.items ? __ldcg(src.at(it) + 1) : 0.f;
      }
#pragma unroll
      for (int h = 0; h < kHeld; ++h) {
        sums[0] += ha[h];
        sums[1] += hb[h];
      }
    }
    seg_sum(sums, seg);
    if (live && lane == 0) {
      ab[(static_cast<long long>(at.i) * groups + g) * 2] = sums[0] / m;
      ab[(static_cast<long long>(at.i) * groups + g) * 2 + 1] = sums[1] / m;
    }
  });
}

// dw and db of 32 channels a round: a warp's lanes take the channels, the
// warps stripes of samples (each sample's chunks summed in order), then the
// stripes in order
__device__ __forceinline__ void finish_dw_db(const float* __restrict__ cpart,
                                             float* __restrict__ dw, float* __restrict__ db,
                                             int n, int chunks, int c, float* s_fin) {
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = static_cast<long long>(n) * chunks * c;
  const int blocks = gridDim.x * gridDim.y * gridDim.z;
  const int id = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  for (int t = id; t < (c + 31) / 32; t += blocks) {
    const int ch = t * 32 + lane;
    float a = 0.f, z = 0.f;
    if (ch < c)
      for (int i = warp; i < n; i += nw) {
        float sa = 0.f, sz = 0.f;
        const float* src = cpart + static_cast<long long>(i) * chunks * c + ch;
#pragma unroll 8
        for (int k = 0; k < chunks; ++k) {
          sa += __ldcg(src + static_cast<long long>(k) * c);
          sz += __ldcg(src + plane + static_cast<long long>(k) * c);
        }
        a += sa;
        z += sz;
      }
    s_fin[threadIdx.x] = a;
    s_fin[kMaxThreads + threadIdx.x] = z;
    __syncthreads();
    if (warp == 0 && ch < c) {
      float ta = 0.f, tz = 0.f;
      for (int s = 0; s < nw; ++s) {
        ta += s_fin[s * 32 + lane];
        tz += s_fin[kMaxThreads + s * 32 + lane];
      }
      dw[ch] = ta;
      db[ch] = tz;
    }
    __syncthreads();
  }
}

template <typename T, bool kSilu, bool kRagged>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm)
group_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const float* __restrict__ w, const float* __restrict__ b,
                         const float* __restrict__ mean, const float* __restrict__ rstd,
                         const float* __restrict__ ab, const float* __restrict__ cpart,
                         T* __restrict__ dx, float* __restrict__ dw_out,
                         float* __restrict__ db_out, Plan p, int hw, int c, int cg) {
  __shared__ float s_fin[kMaxThreads * 2];
  const Place at(p, hw, c, cg, true);
  constexpr int R = kBwdStep<T>;
  const T* xs = at.chunk(x, hw, c, p);
  const T* gs = at.chunk(dy, hw, c, p);
  // the first step's rows of x and dy need nothing of the first launch
  Pack<T> rx[R], rg[R];
  int nv = 0;
  if (at.active) {
    nv = load_rows<T, kRagged, true>(rx, xs, at, p, c, 0);
    load_rows<T, kRagged, true>(rg, gs, at, p, c, 0);
  }
  wait_for_first();
  if (w != nullptr) finish_dw_db(cpart, dw_out, db_out, gridDim.z, p.chunks, c, s_fin);
  if (!at.active) return;
  const Channels ch(at, mean, rstd, w, b, c, cg);
  float sa[kVec], sb[kVec];
  const long long stats = static_cast<long long>(at.i) * (c / cg);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long g = stats + min(at.c0 + e, c - 1) / cg;
    sa[e] = ab[2 * g];
    sb[e] = ab[2 * g + 1];
  }
  T* ds = at.chunk(dx, hw, c, p);
  for (int u0 = 0; nv > 0; u0 += R) {
    Pack<T> nx[R], ng[R];
    int nn = 0;
    if (u0 + R < p.rows) {
      nn = load_rows<T, kRagged, true>(nx, xs, at, p, c, u0 + R);
      load_rows<T, kRagged, true>(ng, gs, at, p, c, u0 + R);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      if (u >= nv) continue;
      float xv[kVec], gv[kVec];
      unpack8(rx[u], xv);
      unpack8(rg[u], gv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xh = (xv[e] - ch.mu[e]) * ch.rs[e];
        const float dyw = upstream<kSilu>(gv[e], xh, ch.w[e], ch.b[e]) * ch.w[e];
        xv[e] = ch.rs[e] * fmaf(-xh, sb[e], dyw - sa[e]);
      }
      store8<T, kRagged>(ds + static_cast<long long>(at.r + (u0 + u) * p.tr) * c, at.c0, c, xv);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      rx[u] = nx[u];
      rg[u] = ng[u];
    }
    nv = nn;
  }
}

bool plan_ok(const Plan& p, int threads, int most_rows, int hw, int c, int n) {
  return threads > 0 && threads <= kMaxThreads && threads % 32 == 0 && p.ct > 0 &&
         p.tr > 0 && p.tr <= 32 && (p.tr & (p.tr - 1)) == 0 && p.tr * p.ct <= threads &&
         p.rows > 0 && p.rows <= most_rows &&
         p.chunk_rows == p.tr * p.rows &&
         static_cast<long long>(p.chunks) * p.chunk_rows >= hw &&
         static_cast<long long>(p.chunks - 1) * p.chunk_rows < hw &&
         static_cast<long long>(p.tiles) * p.ct * kVec >= c &&
         static_cast<long long>(p.tiles - 1) * p.ct * kVec < c && p.tiles <= 65535 &&
         n <= 65535;
}

// a call's second launch, allowed to start as the first one's blocks
// finish (programmatic dependent launch): it waits for the first inside
template <typename... Params, typename... Args>
cudaError_t launch_second(void (*kernel)(Params...), dim3 grid, int threads, cudaStream_t s,
                          Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

template <typename T, bool kRagged>
cudaError_t fwd_ragged(const void* x, const float* w, const float* b, void* y, float* mean,
                       float* rstd, float* part, int* count, int n, int hw, int c, int cg,
                       float eps, int silu, const Plan& p, int threads, cudaStream_t s) {
  const dim3 grid(p.chunks, p.tiles, n);
  const size_t smem = sizeof(float) * 2 * kVec * p.ct;
  auto* xt = static_cast<const T*>(x);
  group_norm_fwd_stats_kernel<T, kRagged>
      <<<grid, threads, smem, s>>>(xt, part, count, mean, rstd, p, hw, c, cg, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* yt = static_cast<T*>(y);
  const float* mc = mean;
  const float* rc = rstd;
  if (silu)
    return launch_second(group_norm_fwd_apply_kernel<T, true, kRagged>, grid, threads, s, xt, w,
                         b, mc, rc, yt, p, hw, c, cg);
  return launch_second(group_norm_fwd_apply_kernel<T, false, kRagged>, grid, threads, s, xt, w, b,
                       mc, rc, yt, p, hw, c, cg);
}

template <typename T>
cudaError_t fwd_dtype(int ragged, const void* x, const float* w, const float* b, void* y,
                      float* mean, float* rstd, float* part, int* count, int n, int hw, int c,
                      int cg, float eps, int silu, const Plan& p, int threads, cudaStream_t s) {
  if (ragged)
    return fwd_ragged<T, true>(x, w, b, y, mean, rstd, part, count, n, hw, c, cg, eps, silu, p,
                               threads, s);
  return fwd_ragged<T, false>(x, w, b, y, mean, rstd, part, count, n, hw, c, cg, eps, silu, p,
                              threads, s);
}

// the backward's pointers, as the entry point takes them
struct BwdArgs {
  const void *x, *dy;
  const float *w, *b, *mean, *rstd;
  void* dx;
  float *dw, *db, *gpart, *cpart, *ab;
  int* count;
};

template <typename T, bool kSilu, bool kRagged>
cudaError_t bwd_branch(const BwdArgs& a, int n, int hw, int c, int cg, const Plan& p,
                       int threads, cudaStream_t s) {
  const dim3 grid(p.chunks, p.tiles, n);
  const size_t smem = sizeof(float) * 2 * kVec * p.ct;
  auto* xt = static_cast<const T*>(a.x);
  auto* gt = static_cast<const T*>(a.dy);
  group_norm_bwd_sums_kernel<T, kSilu, kRagged><<<grid, threads, smem, s>>>(
      xt, gt, a.w, a.b, a.mean, a.rstd, a.gpart, a.cpart, a.ab, a.count, p, hw, c, cg);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* abc = a.ab;
  const float* cpc = a.cpart;
  return launch_second(group_norm_bwd_dx_kernel<T, kSilu, kRagged>, grid, threads, s, xt, gt,
                       a.w, a.b, a.mean, a.rstd, abc, cpc, static_cast<T*>(a.dx), a.dw, a.db, p,
                       hw, c, cg);
}

template <typename T>
cudaError_t bwd_dtype(int silu, int ragged, const BwdArgs& a, int n, int hw, int c, int cg,
                      const Plan& p, int threads, cudaStream_t s) {
  if (silu && ragged) return bwd_branch<T, true, true>(a, n, hw, c, cg, p, threads, s);
  if (silu) return bwd_branch<T, true, false>(a, n, hw, c, cg, p, threads, s);
  if (ragged) return bwd_branch<T, false, true>(a, n, hw, c, cg, p, threads, s);
  return bwd_branch<T, false, false>(a, n, hw, c, cg, p, threads, s);
}

}  // namespace

// x, y: [n, hw, c] (dtype code); w, b: fp32 [c] or both null (no affine);
// mean, rstd: fp32 [n, c / cg]; part: fp32 scratch [n, chunks, tiles,
// c / cg, 3]; count: int32 [n], zero (each sample's last block sets it
// back to zero). ragged: element loads (c % 8 != 0, or x or y off a
// 16-byte boundary). The plan (ct .. chunks) is group_norm_split_plan's;
// `rows` must be 8 / the element size. Two launches.
extern "C" int apex_group_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                   void* mean, void* rstd, void* part, void* count, int n,
                                   int hw, int c, int cg, float eps, int silu, int dtype,
                                   int ragged, int ct, int tiles, int tr, int threads, int rows,
                                   int chunk_rows, int chunks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Plan p{ct, tiles, tr, rows, chunk_rows, chunks};
  const int elt = dtype == APEX_F32 ? 4 : 2;
  if (n <= 0 || hw <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_ok(p, threads, 32 / elt, hw, c, n) || cg <= 0 || c % cg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* wf = static_cast<const float*>(w);
  auto* bf = static_cast<const float*>(b);
  auto* mf = static_cast<float*>(mean);
  auto* rf = static_cast<float*>(rstd);
  auto* pf = static_cast<float*>(part);
  auto* cn = static_cast<int*>(count);
  cudaError_t err;
  if (dtype == APEX_BF16)
    err = fwd_dtype<__nv_bfloat16>(ragged, x, wf, bf, y, mf, rf, pf, cn, n, hw, c, cg, eps, silu,
                                   p, threads, s);
  else if (dtype == APEX_F16)
    err = fwd_dtype<__half>(ragged, x, wf, bf, y, mf, rf, pf, cn, n, hw, c, cg, eps, silu, p,
                            threads, s);
  else
    err = fwd_dtype<float>(ragged, x, wf, bf, y, mf, rf, pf, cn, n, hw, c, cg, eps, silu, p,
                           threads, s);
  return static_cast<int>(err);
}

// x, dy, dx: [n, hw, c] (dtype code); w, b: fp32 [c] or null; mean, rstd:
// the forward's; dw, db: fp32 [c] outputs (null without affine); gpart:
// fp32 scratch [n, chunks, tiles, c / cg, 2]; cpart: fp32 scratch [2, n,
// chunks, c] (null without affine); ab: fp32 scratch [n, c / cg, 2];
// count: int32 [n], zero (each sample's last block sets it back to zero).
// Two launches.
extern "C" int apex_group_norm_bwd(const void* x, const void* dy, const void* w, const void* b,
                                   const void* mean, const void* rstd, void* dx, void* dw,
                                   void* db, void* gpart, void* cpart, void* ab, void* count,
                                   int n, int hw, int c, int cg, int silu, int dtype, int ragged,
                                   int ct, int tiles, int tr, int threads, int rows,
                                   int chunk_rows, int chunks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Plan p{ct, tiles, tr, rows, chunk_rows, chunks};
  const int elt = dtype == APEX_F32 ? 4 : 2;
  if (n <= 0 || hw <= 0) return static_cast<int>(cudaGetLastError());
  if (!plan_ok(p, threads, 32 / elt, hw, c, n) || cg <= 0 || c % cg != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x,
                  dy,
                  static_cast<const float*>(w),
                  static_cast<const float*>(b),
                  static_cast<const float*>(mean),
                  static_cast<const float*>(rstd),
                  dx,
                  static_cast<float*>(dw),
                  static_cast<float*>(db),
                  static_cast<float*>(gpart),
                  static_cast<float*>(cpart),
                  static_cast<float*>(ab),
                  static_cast<int*>(count)};
  cudaError_t err;
  if (dtype == APEX_BF16)
    err = bwd_dtype<__nv_bfloat16>(silu, ragged, a, n, hw, c, cg, p, threads, s);
  else if (dtype == APEX_F16)
    err = bwd_dtype<__half>(silu, ragged, a, n, hw, c, cg, p, threads, s);
  else
    err = bwd_dtype<float>(silu, ragged, a, n, hw, c, cg, p, threads, s);
  return static_cast<int>(err);
}
