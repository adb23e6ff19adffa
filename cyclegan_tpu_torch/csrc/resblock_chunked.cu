// Row-chunked residual block: the instance-norm halves of the forward and
// of the VJP from saved residuals, for Hopper (sm_90a), one launch each.
//
// Replaces: cyclegan_tpu/kernels/resblock_chunked.py, the two Pallas
// kernels behind residual_block_chunked:
//   _forward_chunked_impl (_fwd_kernel): u = conv1(rpad x) + b1, sum/sumsq
//     statistics of u per row chunk, u stored in x's type, vhat = IN(u),
//     a = relu(vhat), s = conv2(rpad a) + b2, its statistics, s stored in
//     x's type, y = IN(s) + x; returns y, vhat, s and stats = [mu1, r1,
//     mu2, r2] per (sample, channel).
//   _backward_chunked (_bwd_kernel): the VJP from (x, vhat, s, stats) with
//     no recompute of the forward convolutions: P0 the sums of dy and
//     dy*shat, P1 ds, da = conv2^T ds (folded), dv = da*(vhat > 0) stored
//     in x's type, the sums of dv and dv*vhat, P2 du from the stored dv,
//     dx = dy + conv1^T du (folded), dw2 = wgrad(relu(vhat), ds) and
//     dw1 = wgrad(x, du).
// kernels/resblock_chunked.py composes the block on Hopper from this file
// and the convolutions of resblock.cu (cg_conv3x3_reflect for conv1 and
// conv2, written in float32 and rounded here; cg_conv3x3_reflect_dgrad and
// the weight gradient of conv_dw.cu for the VJP):
//   cg_chunked_in_fwd  which=1: stats of u -> mu1, r1; vhat, a   (x's type)
//                      which=2: stats of s -> mu2, r2; s, y      (x's type)
//   cg_chunked_in_vjp  which=2: sums of dy, dy*shat -> ds (float32)
//                      which=1: dv, a (x's type), sums of dv, dv*vhat -> du
//
// Statistics as in the Pallas kernel: float32 sum and sum of squares of the
// float32 values before they are rounded, taken per row chunk (hc rows of W
// pixels) and added in chunk order, var = E[v^2] - E[v]^2.
//
// What bounds it on the H100: bytes. Each call is a reduction and an
// elementwise pass over (N, H, W, C) planes, a few flops an element against
// 2-4 bytes read; the least traffic is each input read once and each output
// written once (at the trunk's (2, 64, 64, 256) bf16 planes ~11 us forward
// and ~14 us VJP for the two halves at 3.35 TB/s). At those 4-8 MB planes a
// call is also short enough that launches and barriers cost as much as the
// bytes.
//
// The design: one launch a call, a thread-block cluster per (sample, 32
// channels). The cluster's CTAs split the sample's K = H / hc chunks in
// order (kernels/resblock_chunked.py::chunk_plan: the largest cluster of at
// most 8 that divides K, so one chunk a CTA at the trunk's hc 8). Each CTA
//   1. copies its chunks' tiles of every input (16-byte cp.async, 8
//      channels a thread) into shared memory, where they fit (else it reads
//      them from memory, and again from L2 in step 4);
//   2. reduces each chunk to its two per-channel partial sums in a fixed
//      order (64 pixel lanes, each over its pixels in order; a butterfly
//      over a warp's 8 lanes; the 8 warps in order), writing its phase-1
//      outputs (s; dv and a) as it goes;
//   3. writes its partials into the shared memory of every CTA of the
//      cluster (distributed shared memory: stores, no round trip) and,
//      after one cluster barrier, adds all K in chunk order from its own
//      copy: every CTA forms the same statistics, rank 0 stores them, and
//      no CTA reads another's memory, so none waits to exit;
//   4. applies the normalisation to the tile it holds and stores the
//      outputs with 16-byte stores.
// No grid barrier, no global scratch, no float atomics: the order of every
// sum depends on (H, W, C, hc) only, never on N or on the grid, so a second
// call is bitwise equal and a sample run alone equals its place in a batch.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cgrp = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 32;                    // channels of a cluster
constexpr int kVec = 8;                       // channels of a thread
constexpr int kLanes = kGroup / kVec;         // threads a pixel
constexpr int kPixLanes = kThreads / kLanes;  // pixels a CTA takes at once
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;                // the portable cluster size
// Dynamic shared memory of a CTA at most (kernels/resblock_chunked.py::
// CHUNK_SMEM_MAX): the chunks' partials, and the tiles where they fit.
constexpr int kSmemMax = 200 * 1024;

// The four calls. FWD1: u (float32) -> vhat, a; stats slots 0-1. FWD2: s32
// (float32), x -> s, y; slots 2-3. VJP2: dy, s -> ds (float32). VJP1: da
// (float32), vhat -> dv, a, du (float32).
enum Kind { FWD1, FWD2, VJP2, VJP1 };

struct Args {
  const void* in0;     // u, s32 or da (float32); dy (T) for VJP2
  const void* in1;     // x, s or vhat (T); unused for FWD1
  float* stats;        // (N, 4, C): written by FWD1/FWD2, read by the VJPs
  void* out0;          // vhat, s, ds or dv
  void* out1;          // a, y, unused or a
  void* out2;          // du (VJP1)
  int HW, C, chunk_px, per_cta, cluster;
  float eps;
};

// Bytes of 8 channels of E as 16-byte pieces: 2 for float32, 1 for bf16.
template <typename E>
__host__ __device__ constexpr int pieces() { return kVec * (int)sizeof(E) / 16; }

__device__ __forceinline__ void to_f8(const uint4* q, float* v, float) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[4 * i] = __uint_as_float(q[i].x);
    v[4 * i + 1] = __uint_as_float(q[i].y);
    v[4 * i + 2] = __uint_as_float(q[i].z);
    v[4 * i + 3] = __uint_as_float(q[i].w);
  }
}
__device__ __forceinline__ void to_f8(const uint4* q, float* v, bf16) {
  const unsigned w[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> float is exact: the bits shifted up
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 floats stored as 8 channels of E (rounded to nearest for bf16), in
// 16-byte stores.
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float* v) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return cg_to_f(cg_from_f<T>(v)); }

// The 8 channels (c0 .. c0 + 7) of one input at the CTA's local pixel lp:
// from the shared-memory tile (RES: plane q of the pieces, [pixel][lane]
// uint4, so a warp reads 512 contiguous bytes) or from memory.
template <typename E, bool RES>
struct Src {
  const uint4* p;  // RES: plane 0 at this thread's lane; else the CTA's first pixel at c0
  size_t px;       // uint4s between pixels
  size_t plane;    // uint4s between pieces (RES: between planes)
  __device__ __forceinline__ void load(int lp, float* v) const {
    uint4 q[pieces<E>()];
#pragma unroll
    for (int i = 0; i < pieces<E>(); ++i) {
      const uint4* a = p + (size_t)lp * px + (size_t)i * plane;
      q[i] = RES ? *a : __ldcg(a);
    }
    to_f8(q, v, E{});
  }
};

// Starts copying the CTA's npx pixels (from pixel pix of the sample) x 32
// channels (from gc0) of `g` into `tile`, as the planes Src<E, true> reads.
template <typename E>
__device__ __forceinline__ void load_tile(uint4* tile, const E* __restrict__ g, size_t pix,
                                          int gc0, int C, int npx) {
  constexpr int P = pieces<E>();
  const char* base = reinterpret_cast<const char*>(g + pix * C + gc0);
  const size_t row = (size_t)C * sizeof(E);
  for (int i = threadIdx.x; i < npx * kLanes * P; i += kThreads) {
    const int lp = i / (kLanes * P), pc = i % (kLanes * P);
    cp_async16(tile + ((size_t)(pc % P) * npx + lp) * kLanes + pc / P,
               base + (size_t)lp * row + pc * 16, 16);
  }
}


template <typename E, bool RES>
__device__ __forceinline__ Src<E, RES> make_src(const E* __restrict__ g, uint4* tile,
                                                size_t pix, int c0, int C, int npx, int tc) {
  if constexpr (RES)
    return {tile + tc, (size_t)kLanes, (size_t)npx * kLanes};
  else
    return {reinterpret_cast<const uint4*>(g + pix * C + c0), (size_t)C * sizeof(E) / 16, 1};
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T, int KIND, bool RES>
__device__ __forceinline__ void chunked_in(const Args& a) {
  using E0 = std::conditional_t<KIND == VJP2, T, float>;
  constexpr bool kHas1 = KIND != FWD1;
  __shared__ float red[kWarps][2][kGroup];
  __shared__ float st[2][kGroup];
  extern __shared__ __align__(16) uint4 smem[];

  cgrp::cluster_group cluster = cgrp::this_cluster();
  cluster_arrive_relaxed();  // this CTA runs: the others may write to it
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.z, gc0 = blockIdx.y * kGroup;
  const int tc = threadIdx.x % kLanes, pl = threadIdx.x / kLanes;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = gc0 + tc * kVec, C = a.C;
  const int K = a.cluster * a.per_cta, npx = a.per_cta * a.chunk_px;
  const size_t pix = (size_t)n * a.HW + (size_t)rank * npx;  // the CTA's first pixel

  float* part = reinterpret_cast<float*>(smem);  // [K][2][32], every chunk of the sample
  uint4* tile0 = smem + K * 2 * kGroup / 4;
  uint4* tile1 = tile0 + (size_t)npx * kLanes * pieces<E0>();
  const E0* in0 = static_cast<const E0*>(a.in0);
  const T* in1 = static_cast<const T*>(a.in1);
  if constexpr (RES) {
    load_tile<E0>(tile0, in0, pix, gc0, C, npx);
    if constexpr (kHas1) load_tile<T>(tile1, in1, pix, gc0, C, npx);
    cp_async_commit();
  }
  const Src<E0, RES> src0 = make_src<E0, RES>(in0, tile0, pix, c0, C, npx, tc);
  const Src<T, RES> src1 = make_src<T, RES>(in1, tile1, pix, c0, C, npx, tc);

  // The VJPs' forward statistics of the thread's channels.
  float sm[kVec], sr[kVec];
  if constexpr (KIND == VJP2 || KIND == VJP1) {
    const float* mu = a.stats + ((size_t)n * 4 + (KIND == VJP2 ? 2 : 0)) * C + c0;
    const float* r = a.stats + ((size_t)n * 4 + (KIND == VJP2 ? 3 : 1)) * C + c0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      sm[j] = __ldg(mu + j);
      sr[j] = __ldg(r + j);
    }
  }
  T* o0 = static_cast<T*>(a.out0) + pix * C + c0;
  T* o1 = static_cast<T*>(a.out1) + pix * C + c0;
  if constexpr (RES) {
    cp_async_wait<0>();
    __syncthreads();
  }

  // Phase 1: the partials of each chunk, and the outputs that need no
  // statistics.
  for (int k = 0; k < a.per_cta; ++k) {
    float s0[kVec], s1[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) s0[j] = s1[j] = 0.f;
#pragma unroll 4
    for (int p = pl; p < a.chunk_px; p += kPixLanes) {
      const int lp = k * a.chunk_px + p;
      float v0[kVec], v1[kVec];
      src0.load(lp, v0);
      if constexpr (KIND == VJP2 || KIND == VJP1) src1.load(lp, v1);
      float w0[kVec], w1[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if constexpr (KIND == FWD1 || KIND == FWD2) {
          s0[j] += v0[j];
          s1[j] += v0[j] * v0[j];
          w0[j] = v0[j];  // s, stored in T (FWD2)
        } else if constexpr (KIND == VJP2) {
          const float sh = (v1[j] - sm[j]) * sr[j];
          s0[j] += v0[j];
          s1[j] += v0[j] * sh;
        } else {
          const float g = v1[j] > 0.f ? v0[j] : 0.f;
          s0[j] += g;
          s1[j] += g * v1[j];
          w0[j] = g;                   // dv
          w1[j] = fmaxf(v1[j], 0.f);   // a
        }
      }
      if constexpr (KIND == FWD2) store8(o0 + (size_t)lp * C, w0);
      if constexpr (KIND == VJP1) {
        store8(o0 + (size_t)lp * C, w0);
        store8(o1 + (size_t)lp * C, w1);
      }
    }
    // The warp's 8 pixel lanes (lane bits 2-4) by a butterfly, then the 8
    // warps in order.
#pragma unroll
    for (int off = kLanes; off < 32; off <<= 1) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s0[j] += __shfl_xor_sync(0xffffffffu, s0[j], off);
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
      }
    }
    if (lane < kLanes) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        red[warp][0][lane * kVec + j] = s0[j];
        red[warp][1][lane * kVec + j] = s1[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kGroup) {
      const int s = threadIdx.x / kGroup, c = threadIdx.x % kGroup;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += red[w][s][c];
      part[((rank * a.per_cta + k) * 2 + s) * kGroup + c] = acc;
    }
    __syncthreads();
  }

  // Phase 2: each CTA writes its chunks' partials into every other CTA of
  // the cluster (distributed shared memory, once all have started); after
  // the cluster barrier every CTA adds all K in chunk order from its own
  // copy, so no CTA reads another's memory and none waits to exit.
  cluster_wait();
  const int mine = a.per_cta * 2 * kGroup;
  const float* own = part + rank * mine;
  for (int i = threadIdx.x; i < (a.cluster - 1) * mine; i += kThreads) {
    const int r = i / mine + (i / mine >= rank ? 1 : 0), j = i % mine;
    *cluster.map_shared_rank(part + rank * mine + j, r) = own[j];
  }
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x < kGroup) {
    const int c = threadIdx.x;
    float t0 = 0.f, t1 = 0.f;
    for (int q = 0; q < K; ++q) {
      t0 += part[(q * 2) * kGroup + c];
      t1 += part[(q * 2 + 1) * kGroup + c];
    }
    const float m1 = t0 / (float)a.HW, m2 = t1 / (float)a.HW;
    if constexpr (KIND == FWD1 || KIND == FWD2) {
      const float r = rsqrtf(m2 - m1 * m1 + a.eps);
      st[0][c] = m1;
      st[1][c] = r;
      if (rank == 0) {
        float* dst = a.stats + ((size_t)n * 4 + (KIND == FWD1 ? 0 : 2)) * C + gc0 + c;
        dst[0] = m1;
        dst[C] = r;
      }
    } else {
      st[0][c] = m1;
      st[1][c] = m2;
    }
  }
  __syncthreads();

  // Phase 3: the normalisation of the CTA's pixels.
  float e0[kVec], e1[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    e0[j] = st[0][tc * kVec + j];
    e1[j] = st[1][tc * kVec + j];
  }
#pragma unroll 4
  for (int lp = pl; lp < npx; lp += kPixLanes) {
    float v0[kVec], v1[kVec], w0[kVec], w1[kVec];
    src0.load(lp, v0);
    if constexpr (kHas1) src1.load(lp, v1);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if constexpr (KIND == FWD1) {
        const float vh = (round_to<T>(v0[j]) - e0[j]) * e1[j];
        w0[j] = vh;                // vhat
        w1[j] = fmaxf(vh, 0.f);    // a
      } else if constexpr (KIND == FWD2) {
        w1[j] = (round_to<T>(v0[j]) - e0[j]) * e1[j] + v1[j];  // y
      } else if constexpr (KIND == VJP2) {
        const float sh = (v1[j] - sm[j]) * sr[j];
        w0[j] = sr[j] * (v0[j] - e0[j] - sh * e1[j]);  // ds
      } else {
        const float dv = round_to<T>(v1[j] > 0.f ? v0[j] : 0.f);
        w0[j] = sr[j] * (dv - e0[j] - v1[j] * e1[j]);  // du
      }
    }
    if constexpr (KIND == FWD1) {
      store8(o0 + (size_t)lp * C, w0);
      store8(o1 + (size_t)lp * C, w1);
    } else if constexpr (KIND == FWD2) {
      store8(o1 + (size_t)lp * C, w1);
    } else {
      float* o = static_cast<float*>(KIND == VJP2 ? a.out0 : a.out2) + pix * C + c0;
      store8(o + (size_t)lp * C, w0);
    }
  }
}

template <typename T, int WHICH, bool RES>
__global__ void __launch_bounds__(kThreads) chunked_in_fwd(Args a) {
  chunked_in<T, WHICH == 1 ? FWD1 : FWD2, RES>(a);
}

template <typename T, int WHICH, bool RES>
__global__ void __launch_bounds__(kThreads) chunked_in_vjp(Args a) {
  chunked_in<T, WHICH == 2 ? VJP2 : VJP1, RES>(a);
}

// Bytes a pixel and channel of the inputs a call reads (the resident tile).
int in_bytes(int kind, int elt) {
  return kind == FWD1 ? 4 : kind == VJP2 ? 2 * elt : 4 + elt;
}

// The plan the wrapper passed (chunk_plan), checked: the cluster divides
// the chunks, and the CTA's shared memory is what the plan says.
bool plan_ok(int N, int H, int W, int C, int hc, int cluster, int per_cta, int resident,
             int kind, int elt, int* smem) {
  if (N <= 0 || N > 65535 || H < 2 || W < 2 || C <= 0 || C % kGroup != 0 || hc <= 0 ||
      H % hc != 0 || C / kGroup > 65535)
    return false;
  if (cluster < 1 || cluster > kMaxCluster || per_cta < 1 || cluster * per_cta != H / hc)
    return false;
  const long long part = (long long)cluster * per_cta * 2 * kGroup * 4;
  const long long tiles = (long long)per_cta * hc * W * kGroup * in_bytes(kind, elt);
  const long long need = part + (resident ? tiles : 0);
  if (need > kSmemMax || (!resident && part + tiles <= kSmemMax)) return false;
  *smem = (int)need;
  return true;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, bool (&done)[CG_MAX_DEVICES], const Args& a, int N,
                   int smem, cudaStream_t s) {
  cudaError_t e = cg_smem_limit(kernel, kSmemMax, done);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.C / kGroup, N);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T, int WHICH>
cudaError_t launch_fwd(const Args& a, int N, int smem, int resident, cudaStream_t s) {
  static bool done[2][CG_MAX_DEVICES] = {};
  if (resident) return launch(chunked_in_fwd<T, WHICH, true>, done[1], a, N, smem, s);
  return launch(chunked_in_fwd<T, WHICH, false>, done[0], a, N, smem, s);
}

template <typename T, int WHICH>
cudaError_t launch_vjp(const Args& a, int N, int smem, int resident, cudaStream_t s) {
  static bool done[2][CG_MAX_DEVICES] = {};
  if (resident) return launch(chunked_in_vjp<T, WHICH, true>, done[1], a, N, smem, s);
  return launch(chunked_in_vjp<T, WHICH, false>, done[0], a, N, smem, s);
}

}  // namespace

// Forward instance norm of the chunked block, after a convolution, one
// launch. v32: (N, H, W, C) float32 convolution output; stats: (N, 4, C)
// float32, slots 0-1 written by which=1, 2-3 by which=2. which=1: out0 =
// vhat, out1 = a (x unused); which=2: x = the block's input, out0 = s,
// out1 = y. x, out0, out1 of dtype (0 f32, 1 bf16). The plan (cluster,
// per_cta, resident) is chunk_plan's; needs C % 32 == 0, H % hc == 0, H, W
// >= 2. Returns the launch's CUDA error code (0 on success).
extern "C" int cg_chunked_in_fwd(const void* v32, void* stats, const void* x, void* out0,
                                 void* out1, int N, int H, int W, int C, int hc, int cluster,
                                 int per_cta, int resident, float eps, int which, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int elt = dtype == CG_BF16 ? 2 : 4;
  int smem = 0;
  if ((which != 1 && which != 2) || (dtype != CG_BF16 && dtype != CG_F32) ||
      !plan_ok(N, H, W, C, hc, cluster, per_cta, resident, which == 1 ? FWD1 : FWD2, elt,
               &smem))
    return (int)cudaErrorInvalidValue;
  const Args a{v32, x, static_cast<float*>(stats), out0, out1, nullptr, H * W, C, hc * W,
               per_cta, cluster, eps};
  if (dtype == CG_BF16)
    return (int)(which == 1 ? launch_fwd<bf16, 1>(a, N, smem, resident, s)
                            : launch_fwd<bf16, 2>(a, N, smem, resident, s));
  return (int)(which == 1 ? launch_fwd<float, 1>(a, N, smem, resident, s)
                          : launch_fwd<float, 2>(a, N, smem, resident, s));
}

// VJP of one instance norm of the chunked block, from saved values, one
// launch. which=2: g = dy and src = s (dtype), out = ds (float32); dv, a
// unused. which=1: g = da (float32), src = vhat (dtype); writes dv and a
// (dtype) and out = du (float32) from the stored dv. stats: the forward's
// (N, 4, C). The plan as for cg_chunked_in_fwd.
extern "C" int cg_chunked_in_vjp(const void* g, const void* src, const void* stats, void* dv,
                                 void* a, void* out, int N, int H, int W, int C, int hc,
                                 int cluster, int per_cta, int resident, int which, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int elt = dtype == CG_BF16 ? 2 : 4;
  int smem = 0;
  if ((which != 1 && which != 2) || (dtype != CG_BF16 && dtype != CG_F32) ||
      !plan_ok(N, H, W, C, hc, cluster, per_cta, resident, which == 2 ? VJP2 : VJP1, elt,
               &smem))
    return (int)cudaErrorInvalidValue;
  auto st = const_cast<float*>(static_cast<const float*>(stats));
  const Args args = which == 2
      ? Args{g, src, st, out, nullptr, nullptr, H * W, C, hc * W, per_cta, cluster, 0.f}
      : Args{g, src, st, dv, a, out, H * W, C, hc * W, per_cta, cluster, 0.f};
  if (dtype == CG_BF16)
    return (int)(which == 2 ? launch_vjp<bf16, 2>(args, N, smem, resident, s)
                            : launch_vjp<bf16, 1>(args, N, smem, resident, s));
  return (int)(which == 2 ? launch_vjp<float, 2>(args, N, smem, resident, s)
                          : launch_vjp<float, 1>(args, N, smem, resident, s));
}
