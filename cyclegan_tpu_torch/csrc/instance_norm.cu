// Instance norm + activation (+ residual add), forward and VJP, for Hopper
// (sm_90a), one launch each.
//
// Replaces: cyclegan_tpu/kernels/instance_norm.py, the forward Pallas kernel
// (_pallas_fwd -> _fwd_kernel / _fwd_kernel_skip, TPU kernel #1) and the VJP
// (_pallas_bwd -> _bwd_kernel, #2) behind instance_norm_act. Per (sample n,
// channel c) over the H*W positions of an NHWC tensor:
//   forward  y = act((x - mean) * rsqrt(var + eps)) [+ skip]
//   VJP      dx = rstd * (g - mean_hw(g) - xhat * mean_hw(g * xhat)),
//            xhat = (x - mean) * rstd,  g = act'(xhat) * dy,
// with float32 statistics and the biased variance; act is none | relu |
// leaky(0.2). The VJP takes the forward's own mean and rstd and recomputes
// xhat from x; dx has x's type.
//
// What bounds it on the H100: bytes. Either direction does at most ~8-12
// flops an element, far below the ~295 flop/byte at which the tensor cores,
// not HBM, would limit. The least traffic is one read of x (and skip, or
// dy) and one write of y (or dx).
//
// What the design does about that. The TPU kernel held a whole (H*W,
// C-tile) plane in VMEM and made one pass. No Hopper block holds a plane
// (the 256x256x64 bf16 stem plane is 8 MB a sample), so the reduction is
// split over H*W and merged across blocks. Three launches (partials,
// merge, apply) with scratch allocated a call would cost the host more
// than the card at the train shapes, where these calls are host-bound.
// This design:
//   - One cooperative launch a call. A persistent grid (as many blocks as
//     can be resident, cudaOccupancyMaxActiveBlocksPerMultiprocessor x the
//     SMs, never more than the work) walks virtual tiles in three phases
//     split by grid barriers: (1) each tile's per-channel partials (forward:
//     count, mean, M2 by Chan's merge; VJP: sums of g and g * xhat), (2) one
//     warp per (sample, channel) merges the tiles' partials in tile order
//     into mean and rstd (or the two VJP means), (3) the apply pass. The
//     partials live in the caller's per-stream scratch: no allocation but
//     the outputs. With y == NULL (the residual block's recompute) the
//     launch stops after phase 2.
//   - 16-byte loads: a thread owns vec channels (8 bf16 or 4 float32) of
//     a row, a warp reads whole 128-byte lines (four rows at C = 64); C
//     that is no multiple of vec takes one channel a thread.
//   - The second read hits cache where the card allows it: phase 3 walks a
//     block's tiles in the reverse order of phase 1, so the tiles it read
//     last, most likely still in its L1 or the 50 MB L2, come first. At the
//     train shapes (batch <= 2) every plane fits the L2. The merged
//     statistics reach phase 3 through shared memory, one read a block.
//   - Phase 1's cost is latency, not bytes, at the trunk's small planes: a
//     sample gets 128 tiles, so at batch 2 each block takes one tile and
//     each thread has its rows' loads in flight at once, and the merges of
//     a thread's channels share one division.
//   - Determinism: the tiling (kernels/instance_norm.py::in_plan) depends
//     on the sample's (H*W, C) and the element size only, never on N or on
//     the grid; each tile is reduced in a fixed order whichever block takes
//     it, and the merge runs in tile order. No float atomics: a second
//     call is bitwise equal, and a sample's result is the same whether it
//     is served alone or in a batch.
//
// Input and output types are separate template parameters: the residual
// block normalises its float32 convolution output into the bf16 activation
// type with this same code, and feeds the VJP bf16 or float32 cotangents.
// The VJP of its float32 convolution outputs can write dx as the two or
// three bf16 parts that its gradient convolutions multiply (store_parts):
// the bytes of a float32 dx, written once, and no split pass after it.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMergeBatch = 8;  // partials a lane loads at once in the merge

// The tiling of one sample (kernels/instance_norm.py::in_plan): tiles of
// `rows` rows x (vec * lanes) channels; `lanes` threads a row, kThreads /
// lanes rows at a time; groups channel groups, row_tiles tiles of rows.
struct Plan {
  int N, HW, C, rows, lanes, groups, row_tiles;
};

// V contiguous elements of T moved as 32-bit words, in one aligned access
// of V * sizeof(T) bytes (two of 16 bytes above that): a struct of bf16
// members would be copied element by element, 2 bytes an access.
__device__ __forceinline__ void words_to_f(const unsigned* w, int n, float* v, float) {
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = __uint_as_float(w[i]);
}
__device__ __forceinline__ void words_to_f(const unsigned* w, int n, float* v, bf16) {
#pragma unroll
  for (int i = 0; i < n; ++i) {  // bf16 -> float is exact: the bits shifted up
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void f_to_words(const float* v, int n, unsigned* w, float) {
#pragma unroll
  for (int i = 0; i < n; ++i) w[i] = __float_as_uint(v[i]);
}
__device__ __forceinline__ void f_to_words(const float* v, int n, unsigned* w, bf16) {
#pragma unroll
  for (int i = 0; i < n; ++i)
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float* v) {
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B > 16) {
    store_vec<T, V / 2>(p, v);
    store_vec<T, V / 2>(p + V / 2, v + V / 2);
  } else if constexpr (B == 16) {
    unsigned w[4];
    f_to_words(v, 4, w, T{});
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (B == 8) {
    unsigned w[2];
    f_to_words(v, 2, w, T{});
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = cg_from_f<T>(v[j]);
  }
}

// V elements of T held as the 32-bit words they were loaded as (a lone
// bf16 in the low half of one): half the registers of bf16 values as
// float, so twice the rows can be in flight; converted where used.
template <typename T, int V>
struct Raw {
  static constexpr int kWords = (V * (int)sizeof(T) + 3) / 4;
  unsigned w[kWords];
};

template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* __restrict__ p, Raw<T, V>& r) {
  constexpr int B = V * (int)sizeof(T);
  if constexpr (B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[i];
      r.w[4 * i] = q.x;
      r.w[4 * i + 1] = q.y;
      r.w[4 * i + 2] = q.z;
      r.w[4 * i + 3] = q.w;
    }
  } else if constexpr (B == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    r.w[0] = q.x;
    r.w[1] = q.y;
  } else if constexpr (B == 4) {
    r.w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {  // one bf16
    r.w[0] = (unsigned)__bfloat16_as_ushort(p[0]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void zero_raw(Raw<T, V>& r) {
#pragma unroll
  for (int i = 0; i < Raw<T, V>::kWords; ++i) r.w[i] = 0u;  // converts to 0.0f
}

template <typename T, int V>
__device__ __forceinline__ void raw_to_f(const Raw<T, V>& r, float* v) {
  if constexpr (V * sizeof(T) == 2)
    v[0] = __uint_as_float(r.w[0] << 16);
  else
    words_to_f(r.w, Raw<T, V>::kWords, v, T{});
}

// Chan et al.'s pairwise merge of (count, mean, M2) summaries, a <- a + b,
// for V channels that share their counts: one division for all of them.
template <int V>
__device__ __forceinline__ void chan_merge(float& na, float* ma, float* m2a, float nb,
                                           const float* mb, const float* m2b) {
  const float n = na + nb;
  // Counts are whole (n is 0 only where nb is); the fast division (2 ulp)
  // keeps the long chains of merges short, and is the same on every call.
  const float r = __fdividef(nb, fmaxf(n, 1.f));
  const float w = na * r;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float d = mb[j] - ma[j];
    ma[j] += d * r;
    m2a[j] += m2b[j] + d * d * w;
  }
  na = n;
}

// d act / d xhat at xhat (the JAX package's _act_grad_from_z): relu takes
// xhat > 0, leaky takes xhat >= 0 -> 1, else 0.2.
__device__ __forceinline__ float act_grad(float xh, int act) {
  if (act == 1) return xh > 0.f ? 1.f : 0.f;
  if (act == 2) return xh >= 0.f ? 1.f : 0.2f;
  return 1.f;
}

__device__ __forceinline__ float act_fwd(float z, int act) {
  if (act == 1) return fmaxf(z, 0.f);
  if (act == 2) return z >= 0.f ? z : z * 0.2f;
  return z;
}

// Where virtual tile vt = (n * groups + g) * row_tiles + t of the plan lies
// for this thread: sample n, row tile t (rows r0 .. r1), the group's first
// channel g0, the first channel c0 of the thread's vec channels (c0 >= C:
// idle lane), its row lane rl.
template <int V>
struct Tile {
  int n, t, r0, r1, g0, c0, rl, row_lanes;
  __device__ __forceinline__ Tile(const Plan& p, int vt) {
    t = vt % p.row_tiles;
    const int ng = vt / p.row_tiles;
    n = ng / p.groups;
    const int g = ng % p.groups;
    r0 = t * p.rows;
    r1 = min(r0 + p.rows, p.HW);
    row_lanes = kThreads / p.lanes;
    rl = threadIdx.x / p.lanes;
    g0 = g * p.lanes * V;
    c0 = g0 + (int)threadIdx.x % p.lanes * V;
  }
  __device__ __forceinline__ size_t offset(const Plan& p, int r) const {
    return ((size_t)n * p.HW + r) * p.C + c0;
  }
};

// Rows a thread loads before using any, of T and (the second stream: skip,
// the output or dy) U: 8 rows of 16 bytes of each, 4 where U is twice as
// wide as T (bf16 x, float32 dy), 16 of one element each.
template <typename T, typename U, int V>
__host__ __device__ constexpr int chunk_rows() {
  return V == 1 ? 16 : (sizeof(U) > sizeof(T) ? 4 : 8);
}

// A barrier of the whole (cooperative) grid: cooperative groups' sync
// fences, so writes before it are visible to every block after it (those
// reads bypass L1: __ldcg).
__device__ __forceinline__ void grid_barrier() { cgrp::this_grid().sync(); }

// The tile group's channels of two (N, C) float32 arrays (at src and at
// src + N * C), written by other blocks before the last grid barrier, into
// shared memory (sh[0 .. cg) and sh[cg .. 2 cg)): one L2 read a channel a
// block. Every thread of every block reading its own would queue on the
// same few L2 lines. `staged` (n * C + g0 of the last staging, -1 before
// any) skips a tile of the same sample and group.
template <int V>
__device__ __forceinline__ void stage_stats(const float* __restrict__ src, const Plan& p,
                                            const Tile<V>& tl, float* sh, int& staged) {
  const int cg = p.lanes * V;
  const size_t NC = (size_t)p.N * p.C, base = (size_t)tl.n * p.C + tl.g0;
  if ((int)base == staged) return;  // the same for every thread of the block
  staged = (int)base;
  __syncthreads();  // the previous tile's readers are done
  for (int i = threadIdx.x; i < cg && tl.g0 + i < p.C; i += kThreads) {
    sh[i] = __ldcg(src + base + i);
    sh[cg + i] = __ldcg(src + NC + base + i);
  }
  __syncthreads();
}

// ------------------------------------------------------------------ forward

// Phase 1 for one tile: the thread's (count, mean, M2) of each of its vec
// channels over its rows (exact chunk statistics from registers, one Chan
// merge a chunk), then the row lanes merged in a fixed tree order through
// shared memory; row lane 0 writes the tile's partials.
template <typename TIn, int V>
__device__ __forceinline__ void fwd_partial(const TIn* __restrict__ x, float* __restrict__ part,
                                            const Plan& p, int vt, float* sh) {
  constexpr int K = chunk_rows<TIn, TIn, V>();
  const Tile<V> tl(p, vt);
  float cnt = 0.f, mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
  if (tl.c0 < p.C) {
    for (int base = tl.r0 + tl.rl; base < tl.r1; base += tl.row_lanes * K) {
      Raw<TIn, V> raw[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = base + k * tl.row_lanes;
        if (r < tl.r1)
          load_raw<TIn, V>(x + tl.offset(p, r), raw[k]);
        else
          zero_raw(raw[k]);
      }
      const int nk = min(K, (tl.r1 - base + tl.row_lanes - 1) / tl.row_lanes);
      const float inv = __fdividef(1.f, (float)nk);
      float mc[V], m2c[V];
#pragma unroll
      for (int j = 0; j < V; ++j) mc[j] = m2c[j] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {  // rows past r1 hold 0
        float v[V];
        raw_to_f(raw[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) mc[j] += v[j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) mc[j] *= inv;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k >= nk) break;
        float v[V];
        raw_to_f(raw[k], v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float d = v[j] - mc[j];
          m2c[j] += d * d;
        }
      }
      chan_merge<V>(cnt, mean, m2, (float)nk, mc, m2c);
    }
  }
  // Row lanes rl and rl + s merge, s = row_lanes / 2, ..., 1.
  float* shn = sh;
  float* shm = sh + kThreads;
  float* sh2 = sh + kThreads * (V + 1);
  shn[threadIdx.x] = cnt;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    shm[j * kThreads + threadIdx.x] = mean[j];
    sh2[j * kThreads + threadIdx.x] = m2[j];
  }
  __syncthreads();
  for (int s = tl.row_lanes / 2; s > 0; s >>= 1) {
    if (tl.rl < s) {
      const int o = threadIdx.x + s * p.lanes;
      float mb[V], m2b[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mb[j] = shm[j * kThreads + o];
        m2b[j] = sh2[j * kThreads + o];
      }
      chan_merge<V>(cnt, mean, m2, shn[o], mb, m2b);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        shm[j * kThreads + threadIdx.x] = mean[j];
        sh2[j * kThreads + threadIdx.x] = m2[j];
      }
      shn[threadIdx.x] = cnt;
    }
    __syncthreads();
  }
  if (tl.rl == 0 && tl.c0 < p.C) {
    const size_t NCT = (size_t)p.N * p.C * p.row_tiles;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const size_t o = ((size_t)tl.n * p.C + tl.c0 + j) * p.row_tiles + tl.t;
      part[o] = mean[j];
      part[NCT + o] = m2[j];
    }
  }
}

// Phase 3 for one tile. stage(tile) puts the group's mean and rstd into
// sh[0 .. cg) and sh[cg .. 2 cg), cg = lanes * vec, for every thread of the
// block (it ends in a barrier); the tile's first loads are in flight
// meanwhile.
template <typename TIn, typename TOut, int V, typename Stage>
__device__ __forceinline__ void fwd_apply(const TIn* __restrict__ x,
                                          const TOut* __restrict__ skip, TOut* __restrict__ y,
                                          const Plan& p, int vt, int act, const float* sh,
                                          Stage&& stage) {
  constexpr int K = chunk_rows<TIn, TOut, V>();
  const Tile<V> tl(p, vt);
  const bool live = tl.c0 < p.C;
  Raw<TIn, V> v[K];
  Raw<TOut, V> sk[K];
  auto load = [&](int base) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = base + k * tl.row_lanes;
      if (live && r < tl.r1) {
        load_raw<TIn, V>(x + tl.offset(p, r), v[k]);
        if (skip != nullptr) load_raw<TOut, V>(skip + tl.offset(p, r), sk[k]);
      }
    }
  };
  int base = tl.r0 + tl.rl;
  load(base);  // in flight while the statistics are staged
  stage(tl);
  if (!live) return;
  float mu[V], rs[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mu[j] = sh[tl.c0 - tl.g0 + j];
    rs[j] = sh[p.lanes * V + tl.c0 - tl.g0 + j];
  }
  for (; base < tl.r1; base += tl.row_lanes * K) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = base + k * tl.row_lanes;
      if (r >= tl.r1) break;
      float z[V], s[V];
      raw_to_f(v[k], z);
      if (skip != nullptr) raw_to_f(sk[k], s);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        z[j] = act_fwd((z[j] - mu[j]) * rs[j], act);
        if (skip != nullptr) z[j] += s[j];
      }
      store_vec<TOut, V>(y + tl.offset(p, r), z);
    }
    if (base + tl.row_lanes * K < tl.r1) load(base + tl.row_lanes * K);
  }
}

// Slot `index` of S in an (S, N * C, k) float32 exchange buffer: lane 0's
// k values v[] of (sample, channel) i go into it, zeros into the others.
struct Slot {
  float* buf = nullptr;
  int S = 0, index = 0;
  template <int kK>
  __device__ __forceinline__ void put(size_t NC, size_t i, const float (&v)[kK]) const {
    for (int q = 0; q < S; ++q)
#pragma unroll
      for (int j = 0; j < kK; ++j) buf[((size_t)q * NC + i) * kK + j] = q == index ? v[j] : 0.f;
  }
};

// One warp per (sample, channel) pair i: lane l merges the partials of row
// tiles l, l + 32, ... in order, then the lanes merge in a fixed tree into
// stats = mean (N * C), then rstd (N * C); or, given a slot (a slab's
// partials; stats NULL), into its (count, mean, M2).
__device__ __forceinline__ void fwd_merge(const float* __restrict__ part,
                                          float* __restrict__ stats, const Plan& p, float eps,
                                          const Slot& slot = Slot{}) {
  const size_t NC = (size_t)p.N * p.C, NCT = NC * p.row_tiles;
  const int lane = threadIdx.x % 32;
  for (size_t i = (size_t)blockIdx.x * kWarps + threadIdx.x / 32; i < NC;
       i += (size_t)gridDim.x * kWarps) {
    float n = 0.f, m = 0.f, m2 = 0.f;
    for (int t0 = lane; t0 < p.row_tiles; t0 += 32 * kMergeBatch) {
      float mb[kMergeBatch], m2b[kMergeBatch];  // all of a batch's loads in flight
#pragma unroll
      for (int b = 0; b < kMergeBatch; ++b) {
        const int t = t0 + 32 * b;
        mb[b] = t < p.row_tiles ? __ldcg(part + i * p.row_tiles + t) : 0.f;
        m2b[b] = t < p.row_tiles ? __ldcg(part + NCT + i * p.row_tiles + t) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kMergeBatch; ++b) {
        const int t = t0 + 32 * b;
        const float nb = t < p.row_tiles ? (float)min(p.rows, p.HW - t * p.rows) : 0.f;
        chan_merge<1>(n, &m, &m2, nb, &mb[b], &m2b[b]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, m, off);
      const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
      if (lane < off) chan_merge<1>(n, &m, &m2, nb, &mb, &m2b);
    }
    if (lane == 0 && slot.buf != nullptr) {
      slot.put<3>(NC, i, {n, m, m2});
    } else if (lane == 0) {
      stats[i] = m;
      stats[NC + i] = rsqrtf(m2 / (float)p.HW + eps);
    }
  }
}

// Tiles of this block: blockIdx.x, blockIdx.x + gridDim.x, ...
__device__ __forceinline__ int block_tiles(int tiles) {
  return (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
}

template <typename TIn, typename TOut, int V>
__global__ void __launch_bounds__(kThreads, 2)
in_fwd(const TIn* __restrict__ x, const TOut* __restrict__ skip, TOut* __restrict__ y,
       float* __restrict__ stats, float* __restrict__ part, Plan p, float eps, int act) {
  __shared__ float sh[(2 * V + 1) * kThreads];
  const int tiles = p.N * p.groups * p.row_tiles;
  const int mine = block_tiles(tiles);
  for (int k = 0; k < mine; ++k)
    fwd_partial<TIn, V>(x, part, p, blockIdx.x + k * gridDim.x, sh);
  grid_barrier();
  fwd_merge(part, stats, p, eps);
  if (y == nullptr) return;  // the same for every block
  grid_barrier();
  int staged = -1;
  auto stage = [&](const Tile<V>& tl) { stage_stats<V>(stats, p, tl, sh, staged); };
  for (int k = mine - 1; k >= 0; --k)
    fwd_apply<TIn, TOut, V>(x, skip, y, p, blockIdx.x + k * gridDim.x, act, sh, stage);
}

// ---------------------------------------------------------------------- VJP

// Phase 1 for one tile: the thread's sums of g and g * xhat over its rows
// in order, the row lanes added in a fixed tree order; row lane 0 writes
// the tile's two partial sums.
template <typename TX, typename TDY, int V>
__device__ __forceinline__ void bwd_partial(const TX* __restrict__ x, const TDY* __restrict__ dy,
                                            const float* __restrict__ mean,
                                            const float* __restrict__ rstd,
                                            float* __restrict__ part, const Plan& p, int vt,
                                            int act, float* sh) {
  constexpr int K = chunk_rows<TX, TDY, V>();
  const Tile<V> tl(p, vt);
  float sg[V], sgx[V];
#pragma unroll
  for (int j = 0; j < V; ++j) sg[j] = sgx[j] = 0.f;
  if (tl.c0 < p.C) {
    float mu[V], rs[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      mu[j] = mean[(size_t)tl.n * p.C + tl.c0 + j];
      rs[j] = rstd[(size_t)tl.n * p.C + tl.c0 + j];
    }
    for (int base = tl.r0 + tl.rl; base < tl.r1; base += tl.row_lanes * K) {
      Raw<TX, V> xr[K];
      Raw<TDY, V> gr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int r = base + k * tl.row_lanes;
        if (r < tl.r1) {
          load_raw<TX, V>(x + tl.offset(p, r), xr[k]);
          load_raw<TDY, V>(dy + tl.offset(p, r), gr[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (base + k * tl.row_lanes >= tl.r1) break;
        float xv[V], gv[V];
        raw_to_f(xr[k], xv);
        raw_to_f(gr[k], gv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = (xv[j] - mu[j]) * rs[j];
          const float g = gv[j] * act_grad(xh, act);
          sg[j] += g;
          sgx[j] += g * xh;
        }
      }
    }
  }
  float* sh1 = sh;
  float* sh2 = sh + V * kThreads;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sh1[j * kThreads + threadIdx.x] = sg[j];
    sh2[j * kThreads + threadIdx.x] = sgx[j];
  }
  __syncthreads();
  for (int s = tl.row_lanes / 2; s > 0; s >>= 1) {
    if (tl.rl < s) {
      const int o = threadIdx.x + s * p.lanes;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sg[j] += sh1[j * kThreads + o];
        sgx[j] += sh2[j * kThreads + o];
        sh1[j * kThreads + threadIdx.x] = sg[j];
        sh2[j * kThreads + threadIdx.x] = sgx[j];
      }
    }
    __syncthreads();
  }
  if (tl.rl == 0 && tl.c0 < p.C) {
    const size_t NCT = (size_t)p.N * p.C * p.row_tiles;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const size_t o = ((size_t)tl.n * p.C + tl.c0 + j) * p.row_tiles + tl.t;
      part[o] = sg[j];
      part[NCT + o] = sgx[j];
    }
  }
}

// One warp per (sample, channel): lane l adds row tiles l, l + 32, ... in
// order, the lanes add in a fixed tree; the sums become means over H*W, or,
// given a slot (a slab's partials; gm NULL), go into it as they are.
__device__ __forceinline__ void bwd_merge(const float* __restrict__ part, float* __restrict__ gm,
                                          const Plan& p, const Slot& slot = Slot{}) {
  const size_t NC = (size_t)p.N * p.C, NCT = NC * p.row_tiles;
  const int lane = threadIdx.x % 32;
  for (size_t i = (size_t)blockIdx.x * kWarps + threadIdx.x / 32; i < NC;
       i += (size_t)gridDim.x * kWarps) {
    float a = 0.f, b = 0.f;
    for (int t0 = lane; t0 < p.row_tiles; t0 += 32 * kMergeBatch) {
      float pa[kMergeBatch], pb[kMergeBatch];  // all of a batch's loads in flight
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) {
        const int t = t0 + 32 * k;
        pa[k] = t < p.row_tiles ? __ldcg(part + i * p.row_tiles + t) : 0.f;
        pb[k] = t < p.row_tiles ? __ldcg(part + NCT + i * p.row_tiles + t) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kMergeBatch; ++k) {
        a += pa[k];
        b += pb[k];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ab = __shfl_down_sync(0xffffffffu, a, off);
      const float bb = __shfl_down_sync(0xffffffffu, b, off);
      if (lane < off) {
        a += ab;
        b += bb;
      }
    }
    if (lane == 0 && slot.buf != nullptr) {
      slot.put<2>(NC, i, {a, b});
    } else if (lane == 0) {
      gm[i] = a / (float)p.HW;
      gm[NC + i] = b / (float)p.HW;
    }
  }
}

// dx's element type: x's (P = 0), or bf16 for the P bf16 parts of a
// float32 dx.
template <typename TX, int P>
using DxT = std::conditional_t<P == 0, TX, bf16>;

// The P bf16 parts of V float32 values into P planes `plane` elements
// apart: part 0 = bf16(v), each next part the bf16 rounding of what the
// parts before it left, the split of conv_dw.cu's bf16_parts (whose
// tensor-core operands these are), value for value.
template <int V, int P>
__device__ __forceinline__ void store_parts(bf16* __restrict__ p, size_t plane, const float* v) {
  float rest[V];
#pragma unroll
  for (int j = 0; j < V; ++j) rest[j] = v[j];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    store_vec<bf16, V>(p + k * plane, rest);  // rounds each to bf16
#pragma unroll
    for (int j = 0; j < V; ++j) rest[j] -= __bfloat162float(__float2bfloat16_rn(rest[j]));
  }
}

// Phase 3 of the VJP for one tile; stage(tile) puts the group's two means
// (of g and of g * xhat) into sh as fwd_apply's stage does mean and rstd.
// dx is written in x's type (P = 0) or as its P bf16 parts.
template <typename TX, typename TDY, int V, int P, typename Stage>
__device__ __forceinline__ void bwd_apply(const TX* __restrict__ x, const TDY* __restrict__ dy,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ rstd,
                                          DxT<TX, P>* __restrict__ dx, const Plan& p, int vt,
                                          int act, const float* sh, Stage&& stage) {
  constexpr int K = chunk_rows<TX, TDY, V>();
  const Tile<V> tl(p, vt);
  const bool live = tl.c0 < p.C;
  Raw<TX, V> xr[K];
  Raw<TDY, V> gr[K];
  auto load = [&](int base) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = base + k * tl.row_lanes;
      if (live && r < tl.r1) {
        load_raw<TX, V>(x + tl.offset(p, r), xr[k]);
        load_raw<TDY, V>(dy + tl.offset(p, r), gr[k]);
      }
    }
  };
  int base = tl.r0 + tl.rl;
  load(base);  // in flight while the means are staged
  stage(tl);
  if (!live) return;
  float mu[V], rs[V], gmu[V], gxm[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const size_t i = (size_t)tl.n * p.C + tl.c0 + j;
    mu[j] = mean[i];
    rs[j] = rstd[i];
    gmu[j] = sh[tl.c0 - tl.g0 + j];
    gxm[j] = sh[p.lanes * V + tl.c0 - tl.g0 + j];
  }
  for (; base < tl.r1; base += tl.row_lanes * K) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = base + k * tl.row_lanes;
      if (r >= tl.r1) break;
      float d[V], gv[V];
      raw_to_f(xr[k], d);
      raw_to_f(gr[k], gv);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (d[j] - mu[j]) * rs[j];
        const float g = gv[j] * act_grad(xh, act);
        d[j] = rs[j] * (g - gmu[j] - xh * gxm[j]);
      }
      if constexpr (P == 0)
        store_vec<TX, V>(dx + tl.offset(p, r), d);
      else
        store_parts<V, P>(dx + tl.offset(p, r), (size_t)p.N * p.HW * p.C, d);
    }
    if (base + tl.row_lanes * K < tl.r1) load(base + tl.row_lanes * K);
  }
}

template <typename TX, typename TDY, int V, int P>
__global__ void __launch_bounds__(kThreads, 2)
in_bwd(const TX* __restrict__ x, const TDY* __restrict__ dy, const float* __restrict__ mean,
       const float* __restrict__ rstd, DxT<TX, P>* __restrict__ dx, float* __restrict__ part,
       Plan p, int act) {
  __shared__ float sh[2 * V * kThreads];
  const int tiles = p.N * p.groups * p.row_tiles;
  const int mine = block_tiles(tiles);
  for (int k = 0; k < mine; ++k)
    bwd_partial<TX, TDY, V>(x, dy, mean, rstd, part, p, blockIdx.x + k * gridDim.x, act, sh);
  grid_barrier();
  float* gm = part + 2 * (size_t)p.N * p.C * p.row_tiles;
  bwd_merge(part, gm, p);
  grid_barrier();
  int staged = -1;
  auto stage = [&](const Tile<V>& tl) { stage_stats<V>(gm, p, tl, sh, staged); };
  for (int k = mine - 1; k >= 0; --k)
    bwd_apply<TX, TDY, V, P>(x, dy, mean, rstd, dx, p, blockIdx.x + k * gridDim.x, act, sh,
                             stage);
}

// ------------------------------------------------------ slabs (spatial axis)
//
// A sample whose H axis is split over S ranks (the spatial axis of the mesh,
// cyclegan_tpu_torch/parallel/spatial.py) has its statistics over the whole
// plane. Each direction takes two launches with one all-reduce of the
// spatial group between them (the wrapper's):
//   partials: phase 1 and the tile-order merge of this slab (one cooperative
//             launch, as the whole-plane kernels' phases 1 and 2), written
//             as (count, mean, M2) (forward) or (sum g, sum g * xhat) (VJP)
//             into this slab's slot of the (S, N, C, k) exchange buffer,
//             zeros into the other slots: the buffer goes to the all-reduce
//             as it is, and the sum over the ranks is the gather.
//   apply:    an ordinary launch of one CTA a tile, no grid barrier: each
//             CTA merges the S slots of its channel group in rank order into
//             shared memory (the forward's Chan merges, the VJP's sums over
//             the plane's count), then runs phase 3 on its tile. CTAs take
//             the tiles in the reverse of the partials' order, so the part of
//             x (and dy) the partials read last, most likely still in the
//             50 MB L2, is read first.
// What bounds them: bytes at the stem's slab (8.4 MB of bf16 x at config 3,
// batch 1), latency at the trunk's (2.1 MB). The partials keep their grid
// barrier: the merge of a (sample, channel group)'s 128 tiles right after
// it takes one warp a channel on every SM, and every barrier-free variant
// measured (a tree of last-block tickets; a thread-block cluster of 8 tiles
// and a ticket) leaves that merge to a few CTAs and took 1.5-3 µs longer
// (PERF.md §6, rows 1″/2″). The applies' merge is S items a channel, which
// every CTA does for itself faster than a grid waits at a barrier.
// Determinism: every rank merges the same all-reduced buffer in the same
// order with the same code in every CTA, so each gets bitwise the same mean
// and rstd (and VJP means); the CTA of a group's tile 0 writes them out.
// Slabs of uneven height weigh by their counts.

template <typename TIn, int V>
__global__ void __launch_bounds__(kThreads, 2)
in_fwd_partials(const TIn* __restrict__ x, Slot slot, float* __restrict__ part, Plan p) {
  __shared__ float sh[(2 * V + 1) * kThreads];
  const int mine = block_tiles(p.N * p.groups * p.row_tiles);
  for (int k = 0; k < mine; ++k)
    fwd_partial<TIn, V>(x, part, p, blockIdx.x + k * gridDim.x, sh);
  grid_barrier();
  fwd_merge(part, nullptr, p, 0.f, slot);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
in_bwd_partials(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ mean, const float* __restrict__ rstd, Slot slot,
                float* __restrict__ part, Plan p, int act) {
  __shared__ float sh[2 * V * kThreads];
  const int mine = block_tiles(p.N * p.groups * p.row_tiles);
  for (int k = 0; k < mine; ++k)
    bwd_partial<T, T, V>(x, dy, mean, rstd, part, p, blockIdx.x + k * gridDim.x, act, sh);
  grid_barrier();
  bwd_merge(part, nullptr, p, slot);
}

// slots: the all-reduced (S, N, C, 3) partials; stats: mean (N * C), rstd
// (N * C), then the plane's count (one float, read by the VJP's apply).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
in_fwd_slab_apply(const T* __restrict__ x, const T* __restrict__ skip, T* __restrict__ y,
                  float* __restrict__ stats, const float* __restrict__ slots, int S, Plan p,
                  float eps, int act) {
  __shared__ float sh[2 * 32 * V];
  const int cg = p.lanes * V;
  const size_t NC = (size_t)p.N * p.C;
  auto stage = [&](const Tile<V>& tl) {
    for (int i = threadIdx.x; i < cg && tl.g0 + i < p.C; i += kThreads) {
      const size_t nc = (size_t)tl.n * p.C + tl.g0 + i;
      float n = 0.f, m = 0.f, m2 = 0.f;
      for (int q = 0; q < S; ++q) {
        const float* r = slots + ((size_t)q * NC + nc) * 3;
        chan_merge<1>(n, &m, &m2, __ldg(r), r + 1, r + 2);
      }
      const float rs = rsqrtf(m2 / n + eps);
      sh[i] = m;
      sh[cg + i] = rs;
      if (tl.t == 0) {
        stats[nc] = m;
        stats[NC + nc] = rs;
        if (nc == 0) stats[2 * NC] = n;
      }
    }
    __syncthreads();
  };
  const int tiles = p.N * p.groups * p.row_tiles;
  fwd_apply<T, T, V>(x, skip, y, p, tiles - 1 - (int)blockIdx.x, act, sh, stage);
}

// slots: the all-reduced (S, N, C, 2) sums; count: the plane's count
// (stats[2 N C] of the forward's apply).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
in_bwd_slab_apply(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  T* __restrict__ dx, const float* __restrict__ slots, int S,
                  const float* __restrict__ count, Plan p, int act) {
  __shared__ float sh[2 * 32 * V];
  const int cg = p.lanes * V;
  const size_t NC = (size_t)p.N * p.C;
  auto stage = [&](const Tile<V>& tl) {
    const float n = __ldg(count);
    for (int i = threadIdx.x; i < cg && tl.g0 + i < p.C; i += kThreads) {
      const size_t nc = (size_t)tl.n * p.C + tl.g0 + i;
      float a = 0.f, b = 0.f;
      for (int q = 0; q < S; ++q) {
        const float* r = slots + ((size_t)q * NC + nc) * 2;
        a += __ldg(r);
        b += __ldg(r + 1);
      }
      sh[i] = a / n;
      sh[cg + i] = b / n;
    }
    __syncthreads();
  };
  const int tiles = p.N * p.groups * p.row_tiles;
  bwd_apply<T, T, V, 0>(x, dy, mean, rstd, dx, p, tiles - 1 - (int)blockIdx.x, act, sh, stage);
}

// ------------------------------------------------------------------- host

// The plan the wrapper passed, checked: it must cover every row and every
// channel of a sample exactly once with vec-channel accesses.
bool plan_ok(int N, int HW, int C, int rows, int vec, int lanes, int tiles, Plan* p) {
  if (N <= 0 || HW <= 0 || C <= 0 || rows <= 0 || vec <= 0 || C % vec != 0) return false;
  if (lanes <= 0 || lanes > 32 || (lanes & (lanes - 1)) != 0) return false;
  if (rows % (kThreads / lanes) != 0) return false;
  const int groups = (C / vec + lanes - 1) / lanes, row_tiles = (HW + rows - 1) / rows;
  if (tiles != groups * row_tiles || (long long)N * tiles > (1LL << 30)) return false;
  *p = Plan{N, HW, C, rows, lanes, groups, row_tiles};
  return true;
}

// Blocks of `kernel` that the card holds at once (occupancy x SMs), found
// once a device; `cache` is the calling instantiation's own.
template <typename Kernel>
cudaError_t coresident(Kernel kernel, int (&cache)[CG_MAX_DEVICES], int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < CG_MAX_DEVICES && cache[dev] > 0) {
    *blocks = cache[dev];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  if (per_sm * sms <= 0) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  if (dev < CG_MAX_DEVICES) cache[dev] = *blocks;
  return cudaSuccess;
}

// The grid: every block resident (the barriers need it), no more blocks
// than tiles or (sample, channel) warps to take.
int grid_of(const Plan& p, int max_blocks) {
  const long long tiles = (long long)p.N * p.groups * p.row_tiles;
  const long long warps = ((long long)p.N * p.C + kWarps - 1) / kWarps;
  const long long work = tiles > warps ? tiles : warps;
  return (int)(work < max_blocks ? work : max_blocks);
}

template <typename TIn, typename TOut, int V>
cudaError_t launch_fwd(const void* x, const void* skip, void* y, float* stats, float* part,
                       const Plan& p, float eps, int act, cudaStream_t stream) {
  static int cache[CG_MAX_DEVICES] = {};
  auto kernel = in_fwd<TIn, TOut, V>;
  int max_blocks = 0;
  cudaError_t e = coresident(kernel, cache, &max_blocks);
  if (e != cudaSuccess) return e;
  auto xp = static_cast<const TIn*>(x);
  auto sp = static_cast<const TOut*>(skip);
  auto yp = static_cast<TOut*>(y);
  Plan plan = p;
  void* args[] = {&xp, &sp, &yp, &stats, &part, &plan, &eps, &act};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid_of(p, max_blocks), kThreads,
                                     args, 0, stream);
}

template <typename TIn, typename TOut>
cudaError_t fwd_vec(int vec, const void* x, const void* skip, void* y, float* stats,
                    float* part, const Plan& p, float eps, int act, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TIn);
  if (vec == kVec) return launch_fwd<TIn, TOut, kVec>(x, skip, y, stats, part, p, eps, act, s);
  if (vec == 1) return launch_fwd<TIn, TOut, 1>(x, skip, y, stats, part, p, eps, act, s);
  return cudaErrorInvalidValue;
}

template <typename TX, typename TDY, int V, int P>
cudaError_t launch_bwd(const void* x, const void* dy, const float* mean, const float* rstd,
                       void* dx, float* part, const Plan& p, int act, cudaStream_t stream) {
  static int cache[CG_MAX_DEVICES] = {};
  auto kernel = in_bwd<TX, TDY, V, P>;
  int max_blocks = 0;
  cudaError_t e = coresident(kernel, cache, &max_blocks);
  if (e != cudaSuccess) return e;
  auto xp = static_cast<const TX*>(x);
  auto dyp = static_cast<const TDY*>(dy);
  auto dxp = static_cast<DxT<TX, P>*>(dx);
  Plan plan = p;
  void* args[] = {&xp, &dyp, &mean, &rstd, &dxp, &part, &plan, &act};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid_of(p, max_blocks), kThreads,
                                     args, 0, stream);
}

// dx_parts 0: dx in x's type; 2 or 3: dx as that many bf16 parts, of a
// float32 x read 16 bytes a thread only.
template <typename TX, typename TDY>
cudaError_t bwd_vec(int vec, int dx_parts, const void* x, const void* dy, const float* mean,
                    const float* rstd, void* dx, float* part, const Plan& p, int act,
                    cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  if (dx_parts != 0) {
    if constexpr (std::is_same_v<TX, float>) {
      if (vec == kVec && dx_parts == 2)
        return launch_bwd<TX, TDY, kVec, 2>(x, dy, mean, rstd, dx, part, p, act, s);
      if (vec == kVec && dx_parts == 3)
        return launch_bwd<TX, TDY, kVec, 3>(x, dy, mean, rstd, dx, part, p, act, s);
    }
    return cudaErrorInvalidValue;
  }
  if (vec == kVec) return launch_bwd<TX, TDY, kVec, 0>(x, dy, mean, rstd, dx, part, p, act, s);
  if (vec == 1) return launch_bwd<TX, TDY, 1, 0>(x, dy, mean, rstd, dx, part, p, act, s);
  return cudaErrorInvalidValue;
}

// One cooperative launch of `kernel` (each instantiation its own cache).
template <typename Kernel>
cudaError_t coop(Kernel kernel, int (&cache)[CG_MAX_DEVICES], const Plan& p, void** args,
                 cudaStream_t stream) {
  int max_blocks = 0;
  cudaError_t e = coresident(kernel, cache, &max_blocks);
  if (e != cudaSuccess) return e;
  return cudaLaunchCooperativeKernel((const void*)kernel, grid_of(p, max_blocks), kThreads,
                                     args, 0, stream);
}

template <typename T, int V>
cudaError_t launch_fwd_partials(const void* x, Slot slot, float* part, const Plan& p,
                                cudaStream_t s) {
  static int cache[CG_MAX_DEVICES] = {};
  auto xp = static_cast<const T*>(x);
  Plan plan = p;
  void* args[] = {&xp, &slot, &part, &plan};
  return coop(in_fwd_partials<T, V>, cache, p, args, s);
}

template <typename T, int V>
cudaError_t launch_bwd_partials(const void* x, const void* dy, const float* mean,
                                const float* rstd, Slot slot, float* part, const Plan& p,
                                int act, cudaStream_t s) {
  static int cache[CG_MAX_DEVICES] = {};
  auto xp = static_cast<const T*>(x);
  auto dyp = static_cast<const T*>(dy);
  Plan plan = p;
  void* args[] = {&xp, &dyp, &mean, &rstd, &slot, &part, &plan, &act};
  return coop(in_bwd_partials<T, V>, cache, p, args, s);
}

template <typename T, int V>
cudaError_t launch_fwd_slab_apply(const void* x, const void* skip, void* y, float* stats,
                                  const float* slots, int S, const Plan& p, float eps, int act,
                                  cudaStream_t s) {
  in_fwd_slab_apply<T, V><<<p.N * p.groups * p.row_tiles, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(skip), static_cast<T*>(y), stats, slots,
      S, p, eps, act);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd_slab_apply(const void* x, const void* dy, const float* mean,
                                  const float* rstd, void* dx, const float* slots, int S,
                                  const float* count, const Plan& p, int act, cudaStream_t s) {
  in_bwd_slab_apply<T, V><<<p.N * p.groups * p.row_tiles, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, rstd, static_cast<T*>(dx),
      slots, S, count, p, act);
  return cudaGetLastError();
}

// The slab entries take one element type for every tensor (float32 or
// bf16) and a vec of 16 bytes or 1; `F` is called with the instantiation.
template <typename F>
cudaError_t by_type(int dtype, int vec, F&& f) {
  if (dtype == CG_F32) {
    if (vec == 4) return f(float{}, std::integral_constant<int, 4>{});
    if (vec == 1) return f(float{}, std::integral_constant<int, 1>{});
  } else if (dtype == CG_BF16) {
    if (vec == 8) return f(bf16{}, std::integral_constant<int, 8>{});
    if (vec == 1) return f(bf16{}, std::integral_constant<int, 1>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (N, HW, C) of in_dtype; skip (or NULL) and y (or NULL: statistics
// only): (N, HW, C) of out_dtype; stats: (2, N, C) float32 output, mean
// then rstd; part: scratch of 2 * N * C * ceil(HW / rows) float32. The
// plan (rows, vec, lanes, tiles a sample) is in_plan's. act: 0 none, 1
// relu, 2 leaky(0.2). One cooperative launch; returns its CUDA error code
// (0 on success).
extern "C" int cg_instance_norm_act(const void* x, const void* skip, void* y, void* stats,
                                    void* part, int N, int HW, int C, int rows, int vec,
                                    int lanes, int tiles, float eps, int act, int in_dtype,
                                    int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<float*>(stats), pt = static_cast<float*>(part);
  Plan p;
  if (!plan_ok(N, HW, C, rows, vec, lanes, tiles, &p) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (in_dtype == CG_F32 && out_dtype == CG_F32)
    return (int)fwd_vec<float, float>(vec, x, skip, y, st, pt, p, eps, act, s);
  if (in_dtype == CG_BF16 && out_dtype == CG_BF16)
    return (int)fwd_vec<bf16, bf16>(vec, x, skip, y, st, pt, p, eps, act, s);
  if (in_dtype == CG_F32 && out_dtype == CG_BF16)
    return (int)fwd_vec<float, bf16>(vec, x, skip, y, st, pt, p, eps, act, s);
  if (in_dtype == CG_BF16 && out_dtype == CG_F32)
    return (int)fwd_vec<bf16, float>(vec, x, skip, y, st, pt, p, eps, act, s);
  return (int)cudaErrorInvalidValue;
}

// The VJP. x: (N, HW, C) of x_dtype (the forward's input); dy: (N, HW, C)
// of dy_dtype; mean, rstd: (N, C) float32 from the forward; dx: (N, HW, C)
// of x_dtype with dx_parts 0, else (dx_parts, N, HW, C) bf16, the 2 or 3
// bf16 parts of dx that the gradient convolutions multiply (float32 x and
// vec 4 only); part: scratch of 2 * N * C * (ceil(HW / rows) + 1) float32.
// The plan is in_plan's for x. act: 0 none, 1 relu, 2 leaky(0.2). One
// cooperative launch; returns its CUDA error code (0 on success).
extern "C" int cg_instance_norm_act_bwd(const void* x, const void* dy, const void* mean,
                                        const void* rstd, void* dx, void* part, int N, int HW,
                                        int C, int rows, int vec, int lanes, int tiles, int act,
                                        int x_dtype, int dy_dtype, int dx_parts,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto mu = static_cast<const float*>(mean), rs = static_cast<const float*>(rstd);
  auto pt = static_cast<float*>(part);
  Plan p;
  if (!plan_ok(N, HW, C, rows, vec, lanes, tiles, &p) || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == CG_F32 && dy_dtype == CG_F32)
    return (int)bwd_vec<float, float>(vec, dx_parts, x, dy, mu, rs, dx, pt, p, act, s);
  if (x_dtype == CG_F32 && dy_dtype == CG_BF16)
    return (int)bwd_vec<float, bf16>(vec, dx_parts, x, dy, mu, rs, dx, pt, p, act, s);
  if (x_dtype == CG_BF16 && dy_dtype == CG_BF16)
    return (int)bwd_vec<bf16, bf16>(vec, dx_parts, x, dy, mu, rs, dx, pt, p, act, s);
  if (x_dtype == CG_BF16 && dy_dtype == CG_F32)
    return (int)bwd_vec<bf16, float>(vec, dx_parts, x, dy, mu, rs, dx, pt, p, act, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------- slab entries
// A sample split over S ranks' H slabs (see "slabs" above). x, skip (or
// NULL), y, dy, dx: this slab's (N, HW, C), all of `dtype`; the plan is
// in_plan's for the slab. One launch each (the partials' cooperative, the
// applies' not); each returns its CUDA error code (0 on success).

// slots: the (S, N, C, 3) float32 exchange buffer: this slab's (count, mean,
// M2) into slot `index`, zeros into the others; part: scratch of 2 * N * C *
// ceil(HW / rows) float32.
extern "C" int cg_instance_norm_partials(const void* x, void* slots, int S, int index,
                                         void* part, int N, int HW, int C, int rows, int vec,
                                         int lanes, int tiles, int dtype, void* stream) {
  Plan p;
  if (!plan_ok(N, HW, C, rows, vec, lanes, tiles, &p) || S < 1 || index < 0 || index >= S)
    return (int)cudaErrorInvalidValue;
  const Slot slot{static_cast<float*>(slots), S, index};
  auto pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)by_type(dtype, vec, [&](auto t, auto v) {
    return launch_fwd_partials<decltype(t), decltype(v)::value>(x, slot, pt, p, s);
  });
}

// slots: the S slabs' (S, N, C, 3) float32 partials, all-reduced; stats:
// (2 * N * C + 1) float32 output, mean, rstd, then the plane's count.
extern "C" int cg_instance_norm_slab_apply(const void* x, const void* skip, void* y,
                                           void* stats, const void* slots, int S, int N,
                                           int HW, int C, int rows, int vec, int lanes,
                                           int tiles, float eps, int act, int dtype,
                                           void* stream) {
  Plan p;
  if (!plan_ok(N, HW, C, rows, vec, lanes, tiles, &p) || act < 0 || act > 2 || S < 1 ||
      y == nullptr)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<float*>(stats);
  auto sl = static_cast<const float*>(slots);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)by_type(dtype, vec, [&](auto t, auto v) {
    return launch_fwd_slab_apply<decltype(t), decltype(v)::value>(x, skip, y, st, sl, S, p,
                                                                  eps, act, s);
  });
}

// mean, rstd: (N, C) float32 of the forward's apply; slots: the (S, N, C, 2)
// float32 exchange buffer: this slab's (sum g, sum g * xhat) into slot
// `index`, zeros into the others; part as cg_instance_norm_partials'.
extern "C" int cg_instance_norm_bwd_partials(const void* x, const void* dy, const void* mean,
                                             const void* rstd, void* slots, int S, int index,
                                             void* part, int N, int HW, int C, int rows,
                                             int vec, int lanes, int tiles, int act, int dtype,
                                             void* stream) {
  Plan p;
  if (!plan_ok(N, HW, C, rows, vec, lanes, tiles, &p) || act < 0 || act > 2 || S < 1 ||
      index < 0 || index >= S)
    return (int)cudaErrorInvalidValue;
  auto mu = static_cast<const float*>(mean), rs = static_cast<const float*>(rstd);
  const Slot slot{static_cast<float*>(slots), S, index};
  auto pt = static_cast<float*>(part);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)by_type(dtype, vec, [&](auto t, auto v) {
    return launch_bwd_partials<decltype(t), decltype(v)::value>(x, dy, mu, rs, slot, pt, p,
                                                                act, s);
  });
}

// slots: the S slabs' (S, N, C, 2) float32 sums, all-reduced; count: the
// plane's count (one float32 on the device).
extern "C" int cg_instance_norm_bwd_slab_apply(const void* x, const void* dy, const void* mean,
                                               const void* rstd, void* dx, const void* slots,
                                               int S, const void* count, int N, int HW, int C,
                                               int rows, int vec, int lanes, int tiles, int act,
                                               int dtype, void* stream) {
  Plan p;
  if (!plan_ok(N, HW, C, rows, vec, lanes, tiles, &p) || act < 0 || act > 2 || S < 1)
    return (int)cudaErrorInvalidValue;
  auto mu = static_cast<const float*>(mean), rs = static_cast<const float*>(rstd);
  auto sl = static_cast<const float*>(slots), n = static_cast<const float*>(count);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)by_type(dtype, vec, [&](auto t, auto v) {
    return launch_bwd_slab_apply<decltype(t), decltype(v)::value>(x, dy, mu, rs, dx, sl, S, n,
                                                                  p, act, s);
  });
}
