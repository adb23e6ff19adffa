// Instance norm + activation (+ residual add), forward, for Hopper (sm_90a).
//
// Replaces: cyclegan_tpu/kernels/instance_norm.py, the forward Pallas kernel
// (_pallas_fwd -> _fwd_kernel / _fwd_kernel_skip) behind instance_norm_act.
// Computes, per (sample n, channel c) over the H*W positions of an NHWC
// tensor:  y = act((x - mean) * rsqrt(var + eps)) [+ skip],  with float32
// statistics and the biased variance; act is none | relu | leaky(0.2).
//
// What bounds it on the H100: bytes. It does a handful of flops per element,
// far below the ~295 flop/byte at which the tensor cores, not HBM, would
// limit. The least traffic is one read of x (and skip) and one write of y.
//
// What the design does about that: the TPU kernel held a whole (H*W, C-tile)
// plane in VMEM and made one pass. No Hopper block holds a plane (the
// 256x256x64 bf16 stem plane is 8 MB; a block has 227 KB of shared memory),
// so the reduction is split over H*W:
//   1. in_partial: each block takes one row tile of H*W for 32 channels and
//      writes a per-tile (mean, M2) pair (exact chunk statistics from
//      registers, Chan's merge across chunks and across the block's 8 row
//      lanes, in a fixed order).
//   2. in_merge: one block per (n, 32 channels) merges the tiles, in a
//      fixed order, into mean and rstd. No atomics: the result is
//      deterministic and does not use E[x^2] - mean^2. The tile size depends
//      on H*W and C only, so a sample's result does not depend on the batch
//      it is served in.
//   3. in_apply: the same grid as 1 normalises, applies the activation, adds
//      skip and writes the output type.
// Neighbouring threads read neighbouring channels (NHWC), so each warp load
// is one contiguous 32-channel run, and each thread keeps 8 loads in
// flight. The cost is a second read of x (three passes' worth of bytes
// where two are the bound); fusing the statistics into the producer's
// epilogue is later work.
//
// Input and output types are separate template parameters: the residual
// block normalises its float32 convolution output into the bf16 activation
// type with this same code.

#include "common.cuh"

namespace {

constexpr int kLanesC = 32;  // channels per block (threadIdx.x)
constexpr int kLanesR = 8;   // row lanes per block (threadIdx.y)
constexpr int kChunk = 8;    // rows a thread loads before using any of them

struct Stats {
  float n, mean, m2;
};

// Chan et al.'s pairwise merge of two (count, mean, M2) summaries.
__device__ __forceinline__ void chan_merge(Stats& a, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  float n = a.n + nb;
  float d = mb - a.mean;
  a.mean += d * (nb / n);
  a.m2 += m2b + d * d * (a.n * nb / n);
  a.n = n;
}

// Merge the kLanesR row lanes' summaries of one channel in lane order.
__device__ __forceinline__ Stats merge_lanes(Stats s, float (*sh)[kLanesR][kLanesC]) {
  sh[0][threadIdx.y][threadIdx.x] = s.n;
  sh[1][threadIdx.y][threadIdx.x] = s.mean;
  sh[2][threadIdx.y][threadIdx.x] = s.m2;
  __syncthreads();
  if (threadIdx.y == 0)
    for (int j = 1; j < kLanesR; ++j)
      chan_merge(s, sh[0][j][threadIdx.x], sh[1][j][threadIdx.x], sh[2][j][threadIdx.x]);
  return s;
}

// Grid (tiles, ceil(C / 32), N). Thread (x, y) reads channel c at rows
// r0 + y, r0 + y + 8, ... of its tile, kChunk rows at a time: the chunk's
// loads are all in flight together, its mean and M2 are taken exactly from
// registers, and one Chan merge folds it in.
template <typename TIn>
__global__ void __launch_bounds__(kLanesC * kLanesR)
in_partial(const TIn* __restrict__ x, float* __restrict__ pmean,
           float* __restrict__ pm2, int HW, int C, int tile_rows, int tiles) {
  const int n = blockIdx.z, t = blockIdx.x;
  const int c = blockIdx.y * kLanesC + threadIdx.x;
  const int r0 = t * tile_rows;
  const int r1 = min(r0 + tile_rows, HW);
  Stats s = {0.f, 0.f, 0.f};
  if (c < C) {
    const TIn* xp = x + (size_t)n * HW * C + c;
    for (int base = r0 + threadIdx.y; base < r1; base += kLanesR * kChunk) {
      float v[kChunk];
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int r = base + j * kLanesR;
        v[j] = r < r1 ? cg_to_f(xp[(size_t)r * C]) : 0.f;
        cnt += r < r1;  // the valid rows are the first cnt
      }
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) sum += v[j];
      const float mc = sum / (float)cnt;
      float m2c = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float d = v[j] - mc;
        if (j < cnt) m2c += d * d;
      }
      chan_merge(s, (float)cnt, mc, m2c);
    }
  }
  __shared__ float sh[3][kLanesR][kLanesC];
  s = merge_lanes(s, sh);
  if (threadIdx.y == 0 && c < C) {
    const size_t o = ((size_t)n * tiles + t) * C + c;
    pmean[o] = s.mean;
    pm2[o] = s.m2;
  }
}

// Grid (ceil(C / 32), N). Row lane y merges tiles y, y + 8, ... in order,
// then the lanes are merged in lane order: a fixed order, no atomics.
__global__ void __launch_bounds__(kLanesC * kLanesR)
in_merge(const float* __restrict__ pmean, const float* __restrict__ pm2,
         float* __restrict__ mean, float* __restrict__ rstd, int HW, int C,
         int tile_rows, int tiles, float eps) {
  const int n = blockIdx.y;
  const int c = blockIdx.x * kLanesC + threadIdx.x;
  Stats s = {0.f, 0.f, 0.f};
  if (c < C) {
#pragma unroll 4
    for (int t = threadIdx.y; t < tiles; t += kLanesR) {
      const size_t o = ((size_t)n * tiles + t) * C + c;
      chan_merge(s, (float)min(tile_rows, HW - t * tile_rows), pmean[o], pm2[o]);
    }
  }
  __shared__ float sh[3][kLanesR][kLanesC];
  s = merge_lanes(s, sh);
  if (threadIdx.y == 0 && c < C) {
    mean[n * C + c] = s.mean;
    rstd[n * C + c] = rsqrtf(s.m2 / (float)HW + eps);
  }
}

// Same grid and row assignment as in_partial.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kLanesC * kLanesR)
in_apply(const TIn* __restrict__ x, const TOut* __restrict__ skip, TOut* __restrict__ y,
         const float* __restrict__ mean, const float* __restrict__ rstd, int HW, int C,
         int tile_rows, int act) {
  const int n = blockIdx.z, t = blockIdx.x;
  const int c = blockIdx.y * kLanesC + threadIdx.x;
  if (c >= C) return;
  const float mu = mean[n * C + c], rs = rstd[n * C + c];
  const int r0 = t * tile_rows;
  const int r1 = min(r0 + tile_rows, HW);
  const size_t base_o = (size_t)n * HW * C + c;
  for (int base = r0 + threadIdx.y; base < r1; base += kLanesR * kChunk) {
    float v[kChunk], sk[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = base + j * kLanesR;
      const size_t o = base_o + (size_t)r * C;
      v[j] = r < r1 ? cg_to_f(x[o]) : 0.f;
      sk[j] = (r < r1 && skip != nullptr) ? cg_to_f(skip[o]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = base + j * kLanesR;
      if (r >= r1) break;
      float z = (v[j] - mu) * rs;
      if (act == 1) z = fmaxf(z, 0.f);
      else if (act == 2) z = z >= 0.f ? z : z * 0.2f;
      y[base_o + (size_t)r * C] = cg_from_f<TOut>(z + sk[j]);
    }
  }
}

template <typename TIn, typename TOut>
cudaError_t launch(const void* x, const void* skip, void* y, float* pmean, float* pm2,
                   float* mean, float* rstd, int N, int HW, int C, int tile_rows,
                   float eps, int act, cudaStream_t stream) {
  const int tiles = (HW + tile_rows - 1) / tile_rows;
  const int cgroups = (C + kLanesC - 1) / kLanesC;
  const dim3 block(kLanesC, kLanesR);
  in_partial<TIn><<<dim3(tiles, cgroups, N), block, 0, stream>>>(
      static_cast<const TIn*>(x), pmean, pm2, HW, C, tile_rows, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  in_merge<<<dim3(cgroups, N), block, 0, stream>>>(pmean, pm2, mean, rstd, HW, C,
                                                   tile_rows, tiles, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  in_apply<TIn, TOut><<<dim3(tiles, cgroups, N), block, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TOut*>(skip), static_cast<TOut*>(y),
      mean, rstd, HW, C, tile_rows, act);
  return cudaGetLastError();
}

}  // namespace

// x: (N, HW, C) of in_dtype; skip (or NULL) and y: (N, HW, C) of out_dtype;
// pmean, pm2: (N, ceil(HW / tile_rows), C) float32 scratch; mean, rstd:
// (N, C) float32 outputs. act: 0 none, 1 relu, 2 leaky(0.2).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int cg_instance_norm_act(const void* x, const void* skip, void* y, void* pmean,
                                    void* pm2, void* mean, void* rstd, int N, int HW,
                                    int C, int tile_rows, float eps, int act,
                                    int in_dtype, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto pm = static_cast<float*>(pmean), p2 = static_cast<float*>(pm2);
  auto mu = static_cast<float*>(mean), rs = static_cast<float*>(rstd);
  if (N <= 0 || HW <= 0 || C <= 0 || tile_rows <= 0) return (int)cudaErrorInvalidValue;
  if (in_dtype == CG_F32 && out_dtype == CG_F32)
    return (int)launch<float, float>(x, skip, y, pm, p2, mu, rs, N, HW, C, tile_rows, eps, act, s);
  if (in_dtype == CG_BF16 && out_dtype == CG_BF16)
    return (int)launch<bf16, bf16>(x, skip, y, pm, p2, mu, rs, N, HW, C, tile_rows, eps, act, s);
  if (in_dtype == CG_F32 && out_dtype == CG_BF16)
    return (int)launch<float, bf16>(x, skip, y, pm, p2, mu, rs, N, HW, C, tile_rows, eps, act, s);
  if (in_dtype == CG_BF16 && out_dtype == CG_F32)
    return (int)launch<bf16, float>(x, skip, y, pm, p2, mu, rs, N, HW, C, tile_rows, eps, act, s);
  return (int)cudaErrorInvalidValue;
}
