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
// type with this same code. With y == NULL only the statistics are made
// (the residual block's backward recomputes them that way).
//
// The backward (cg_instance_norm_act_bwd) replaces the VJP Pallas kernel
// (_pallas_bwd -> _bwd_kernel):
//   dx = rstd * (g - mean_hw(g) - xhat * mean_hw(g * xhat)),
//   xhat = (x - mean) * rstd,  g = act'(xhat) * dy,
// from the forward's own float32 mean and rstd; xhat is recomputed from x.
// Bytes bound it too (one read of x and dy, one write of dx; two more reads
// than that here). Same split as the forward, with the same tile size, so
// a sample's result does not depend on its batch: per-tile sums of g and
// g * xhat (in_bwd_partial), a fixed-order merge into their means
// (in_bwd_merge; no atomics), then the apply pass (in_bwd_apply).

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
  if (e != cudaSuccess || y == nullptr) return e;
  in_apply<TIn, TOut><<<dim3(tiles, cgroups, N), block, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TOut*>(skip), static_cast<TOut*>(y),
      mean, rstd, HW, C, tile_rows, act);
  return cudaGetLastError();
}


// d act / d xhat at xhat (the JAX package's _act_grad_from_z): relu takes
// xhat > 0, leaky takes xhat >= 0 -> 1, else 0.2.
__device__ __forceinline__ float act_grad(float xh, int act) {
  if (act == 1) return xh > 0.f ? 1.f : 0.f;
  if (act == 2) return xh >= 0.f ? 1.f : 0.2f;
  return 1.f;
}

// Grid (tiles, ceil(C / 32), N), the forward's row assignment. Each thread
// sums g and g * xhat over its rows in order; the 8 row lanes are added in
// lane order and one (sum g, sum g*xhat) pair per tile is written.
template <typename TX, typename TDY>
__global__ void __launch_bounds__(kLanesC * kLanesR)
in_bwd_partial(const TX* __restrict__ x, const TDY* __restrict__ dy,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               float* __restrict__ psg, float* __restrict__ psgx, int HW, int C,
               int tile_rows, int tiles, int act) {
  const int n = blockIdx.z, t = blockIdx.x;
  const int c = blockIdx.y * kLanesC + threadIdx.x;
  const int r0 = t * tile_rows;
  const int r1 = min(r0 + tile_rows, HW);
  float sg = 0.f, sgx = 0.f;
  if (c < C) {
    const float mu = mean[n * C + c], rs = rstd[n * C + c];
    const size_t base_o = (size_t)n * HW * C + c;
    for (int base = r0 + threadIdx.y; base < r1; base += kLanesR * kChunk) {
      float xv[kChunk], gv[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int r = base + j * kLanesR;
        const size_t o = base_o + (size_t)r * C;
        xv[j] = r < r1 ? cg_to_f(x[o]) : 0.f;
        gv[j] = r < r1 ? cg_to_f(dy[o]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float xh = (xv[j] - mu) * rs;
        const float g = gv[j] * act_grad(xh, act);  // 0 on the rows past r1
        sg += g;
        sgx += g * xh;
      }
    }
  }
  __shared__ float sh[2][kLanesR][kLanesC];
  sh[0][threadIdx.y][threadIdx.x] = sg;
  sh[1][threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int j = 1; j < kLanesR; ++j) {
      sg += sh[0][j][threadIdx.x];
      sgx += sh[1][j][threadIdx.x];
    }
    const size_t o = ((size_t)n * tiles + t) * C + c;
    psg[o] = sg;
    psgx[o] = sgx;
  }
}

// Grid (ceil(C / 32), N). Row lane y adds tiles y, y + 8, ... in order,
// then the lanes are added in lane order; the sums become means over H*W.
__global__ void __launch_bounds__(kLanesC * kLanesR)
in_bwd_merge(const float* __restrict__ psg, const float* __restrict__ psgx,
             float* __restrict__ gmean, float* __restrict__ gxmean, int HW, int C,
             int tiles) {
  const int n = blockIdx.y;
  const int c = blockIdx.x * kLanesC + threadIdx.x;
  float sg = 0.f, sgx = 0.f;
  if (c < C) {
    for (int t = threadIdx.y; t < tiles; t += kLanesR) {
      const size_t o = ((size_t)n * tiles + t) * C + c;
      sg += psg[o];
      sgx += psgx[o];
    }
  }
  __shared__ float sh[2][kLanesR][kLanesC];
  sh[0][threadIdx.y][threadIdx.x] = sg;
  sh[1][threadIdx.y][threadIdx.x] = sgx;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int j = 1; j < kLanesR; ++j) {
      sg += sh[0][j][threadIdx.x];
      sgx += sh[1][j][threadIdx.x];
    }
    gmean[n * C + c] = sg / (float)HW;
    gxmean[n * C + c] = sgx / (float)HW;
  }
}

// Same grid and row assignment as in_bwd_partial; dx has x's type.
template <typename TX, typename TDY>
__global__ void __launch_bounds__(kLanesC * kLanesR)
in_bwd_apply(const TX* __restrict__ x, const TDY* __restrict__ dy,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ gmean, const float* __restrict__ gxmean,
             TX* __restrict__ dx, int HW, int C, int tile_rows, int act) {
  const int n = blockIdx.z, t = blockIdx.x;
  const int c = blockIdx.y * kLanesC + threadIdx.x;
  if (c >= C) return;
  const float mu = mean[n * C + c], rs = rstd[n * C + c];
  const float gm = gmean[n * C + c], gxm = gxmean[n * C + c];
  const int r0 = t * tile_rows;
  const int r1 = min(r0 + tile_rows, HW);
  const size_t base_o = (size_t)n * HW * C + c;
  for (int base = r0 + threadIdx.y; base < r1; base += kLanesR * kChunk) {
    float xv[kChunk], gv[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = base + j * kLanesR;
      const size_t o = base_o + (size_t)r * C;
      xv[j] = r < r1 ? cg_to_f(x[o]) : 0.f;
      gv[j] = r < r1 ? cg_to_f(dy[o]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int r = base + j * kLanesR;
      if (r >= r1) break;
      const float xh = (xv[j] - mu) * rs;
      const float g = gv[j] * act_grad(xh, act);
      dx[base_o + (size_t)r * C] = cg_from_f<TX>(rs * (g - gm - xh * gxm));
    }
  }
}

template <typename TX, typename TDY>
cudaError_t launch_bwd(const void* x, const void* dy, const float* mean, const float* rstd,
                       void* dx, float* psg, float* psgx, float* gmean, float* gxmean,
                       int N, int HW, int C, int tile_rows, int act, cudaStream_t stream) {
  const int tiles = (HW + tile_rows - 1) / tile_rows;
  const int cgroups = (C + kLanesC - 1) / kLanesC;
  const dim3 block(kLanesC, kLanesR);
  auto xp = static_cast<const TX*>(x);
  auto dyp = static_cast<const TDY*>(dy);
  in_bwd_partial<TX, TDY><<<dim3(tiles, cgroups, N), block, 0, stream>>>(
      xp, dyp, mean, rstd, psg, psgx, HW, C, tile_rows, tiles, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  in_bwd_merge<<<dim3(cgroups, N), block, 0, stream>>>(psg, psgx, gmean, gxmean, HW, C,
                                                       tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  in_bwd_apply<TX, TDY><<<dim3(tiles, cgroups, N), block, 0, stream>>>(
      xp, dyp, mean, rstd, gmean, gxmean, static_cast<TX*>(dx), HW, C, tile_rows, act);
  return cudaGetLastError();
}

}  // namespace

// x: (N, HW, C) of in_dtype; skip (or NULL) and y (or NULL: statistics
// only) : (N, HW, C) of out_dtype;
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

// The VJP. x: (N, HW, C) of x_dtype (the forward's input); dy: (N, HW, C)
// of dy_dtype; mean, rstd: (N, C) float32 from the forward; dx: (N, HW, C)
// of x_dtype; psg, psgx: (N, ceil(HW / tile_rows), C) float32 scratch;
// gmean, gxmean: (N, C) float32 scratch. act: 0 none, 1 relu, 2 leaky(0.2).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int cg_instance_norm_act_bwd(const void* x, const void* dy, const void* mean,
                                        const void* rstd, void* dx, void* psg, void* psgx,
                                        void* gmean, void* gxmean, int N, int HW, int C,
                                        int tile_rows, int act, int x_dtype, int dy_dtype,
                                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto mu = static_cast<const float*>(mean), rs = static_cast<const float*>(rstd);
  auto p1 = static_cast<float*>(psg), p2 = static_cast<float*>(psgx);
  auto gm = static_cast<float*>(gmean), gxm = static_cast<float*>(gxmean);
  if (N <= 0 || HW <= 0 || C <= 0 || tile_rows <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == CG_F32 && dy_dtype == CG_F32)
    return (int)launch_bwd<float, float>(x, dy, mu, rs, dx, p1, p2, gm, gxm, N, HW, C, tile_rows, act, s);
  if (x_dtype == CG_F32 && dy_dtype == CG_BF16)
    return (int)launch_bwd<float, bf16>(x, dy, mu, rs, dx, p1, p2, gm, gxm, N, HW, C, tile_rows, act, s);
  if (x_dtype == CG_BF16 && dy_dtype == CG_BF16)
    return (int)launch_bwd<bf16, bf16>(x, dy, mu, rs, dx, p1, p2, gm, gxm, N, HW, C, tile_rows, act, s);
  if (x_dtype == CG_BF16 && dy_dtype == CG_F32)
    return (int)launch_bwd<bf16, float>(x, dy, mu, rs, dx, p1, p2, gm, gxm, N, HW, C, tile_rows, act, s);
  return (int)cudaErrorInvalidValue;
}
