// Row-chunked residual block: the instance-norm halves of the forward and
// of the VJP from saved residuals, for Hopper (sm_90a).
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
// conv2, written in float32 to scratch and rounded here;
// cg_conv3x3_reflect_dgrad and cg_conv3x3_reflect_wgrad for the VJP):
//   cg_chunked_in_fwd  which=1: stats of u -> mu1, r1; vhat, a   (x's type)
//                      which=2: stats of s -> mu2, r2; s, y      (x's type)
//   cg_chunked_in_vjp  which=2: sums of dy, dy*shat -> ds (float32)
//                      which=1: dv, a (x's type), sums of dv, dv*vhat -> du
//
// Statistics as in the Pallas kernel: float32 sum and sum of squares of the
// float32 values before they are rounded, var = E[v^2] - E[v]^2. The row
// chunk (hc rows of W pixels) is the tile of the partial-sum kernels: one
// block per (chunk, sample, 32 channels), its 8 pixel lanes reduced in lane
// order; a second kernel adds the chunks in chunk order. The order of every
// sum depends on the shapes and hc only, so two runs agree bitwise.
//
// What bounds it on the H100: bytes. Each kernel here is an elementwise pass
// or a reduction over (N, H, W, C) planes, a few flops per element against
// 2-4 bytes read per element; the block's time is in the convolutions of
// resblock.cu. The design reads each plane once per pass, with the 32
// channels of a warp on neighbouring addresses; fusing the statistics into
// the convolution's epilogue is later work.

#include "common.cuh"

namespace {

constexpr int CH = 32;    // channels of a partial-sum block (threadIdx.x)
constexpr int LANES = 8;  // pixel lanes of a partial-sum block (threadIdx.y)

// Reduce (s0, s1) over the block's pixel lanes in lane order and store them
// as part[0, n, k, c] and part[1, n, k, c] (part: (2, N, K, C) float32).
__device__ __forceinline__ void store_partials(float s0, float s1, float* __restrict__ part,
                                               int n, int k, int K, int C, size_t NKC, int c) {
  __shared__ float red[2][LANES][CH];
  red[0][threadIdx.y][threadIdx.x] = s0;
  red[1][threadIdx.y][threadIdx.x] = s1;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int l = 0; l < LANES; ++l) {
      a += red[0][l][threadIdx.x];
      b += red[1][l][threadIdx.x];
    }
    const size_t o = ((size_t)n * K + k) * C + c;
    part[o] = a;
    part[NKC + o] = b;
  }
}

// Grid (K, N, ceil(C / 32)), block (32, 8): sums of v and v*v over the
// chunk's chunk_px pixels (forward statistics of u or s).
__global__ void __launch_bounds__(CH * LANES)
fwd_partials(const float* __restrict__ v, float* __restrict__ part, int N, int HW, int C,
             int chunk_px, int K) {
  const int k = blockIdx.x, n = blockIdx.y, c = blockIdx.z * CH + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (c < C) {
    const float* base = v + ((size_t)n * HW + (size_t)k * chunk_px) * C + c;
    for (int p = threadIdx.y; p < chunk_px; p += LANES) {
      const float x = base[(size_t)p * C];
      s0 += x;
      s1 += x * x;
    }
  }
  store_partials(s0, s1, part, n, k, K, C, (size_t)N * K * C, c);
}

// P0 of the VJP: sums of dy and dy * shat, shat = (s - mu2) * r2.
template <typename T>
__global__ void __launch_bounds__(CH * LANES)
vjp_partials_s(const T* __restrict__ dy, const T* __restrict__ s, const float* __restrict__ stats,
               float* __restrict__ part, int N, int HW, int C, int chunk_px, int K) {
  const int k = blockIdx.x, n = blockIdx.y, c = blockIdx.z * CH + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (c < C) {
    const float mu2 = stats[((size_t)n * 4 + 2) * C + c], r2 = stats[((size_t)n * 4 + 3) * C + c];
    const size_t base = ((size_t)n * HW + (size_t)k * chunk_px) * C + c;
    for (int p = threadIdx.y; p < chunk_px; p += LANES) {
      const size_t o = base + (size_t)p * C;
      const float g = cg_to_f(dy[o]);
      const float sh = (cg_to_f(s[o]) - mu2) * r2;
      s0 += g;
      s1 += g * sh;
    }
  }
  store_partials(s0, s1, part, n, k, K, C, (size_t)N * K * C, c);
}

// P1 of the VJP: dv = da * (vhat > 0), stored in T, with a = relu(vhat)
// (the input of dw2); sums of the float32 dv and dv * vhat.
template <typename T>
__global__ void __launch_bounds__(CH * LANES)
vjp_partials_v(const float* __restrict__ da, const T* __restrict__ vhat, T* __restrict__ dv,
               T* __restrict__ a, float* __restrict__ part, int N, int HW, int C, int chunk_px,
               int K) {
  const int k = blockIdx.x, n = blockIdx.y, c = blockIdx.z * CH + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (c < C) {
    const size_t base = ((size_t)n * HW + (size_t)k * chunk_px) * C + c;
    for (int p = threadIdx.y; p < chunk_px; p += LANES) {
      const size_t o = base + (size_t)p * C;
      const float vh = cg_to_f(vhat[o]);
      const float g = vh > 0.f ? da[o] : 0.f;
      dv[o] = cg_from_f<T>(g);
      a[o] = cg_from_f<T>(fmaxf(vh, 0.f));
      s0 += g;
      s1 += g * vh;
    }
  }
  store_partials(s0, s1, part, n, k, K, C, (size_t)N * K * C, c);
}

// Grid over N*C: the chunks' partials added in chunk order, divided by HW.
// rstd = 1: out[n, slot, c] = mean, out[n, slot + 1, c] =
// rsqrt(E[v^2] - mean^2 + eps) (out: the (N, 4, C) stats). rstd = 0:
// out[n, 0, c] = E[g], out[n, 1, c] = E[g * xhat] (out: (N, 2, C) means).
__global__ void __launch_bounds__(256)
merge_partials(const float* __restrict__ part, float* __restrict__ out, int N, int K, int C,
               int HW, int rows, int slot, float eps, int rstd) {
  const size_t NKC = (size_t)N * K * C;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < (size_t)N * C;
       i += (size_t)gridDim.x * blockDim.x) {
    const int n = (int)(i / C), c = (int)(i % C);
    float a = 0.f, b = 0.f;
    for (int k = 0; k < K; ++k) {
      const size_t o = ((size_t)n * K + k) * C + c;
      a += part[o];
      b += part[NKC + o];
    }
    const float m1 = a / (float)HW, m2 = b / (float)HW;
    float* dst = out + ((size_t)n * rows + slot) * C + c;
    dst[0] = m1;
    dst[C] = rstd ? rsqrtf(m2 - m1 * m1 + eps) : m2;
  }
}

// Forward apply of IN1: u rounded to T as the Pallas kernel stores it,
// vhat = (u - mu1) * r1 in T, a = relu(vhat) in T.
template <typename T>
__global__ void __launch_bounds__(256)
fwd_apply_in1(const float* __restrict__ u, const float* __restrict__ stats, T* __restrict__ vhat,
              T* __restrict__ a, size_t total, int HW, int C) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t n = i / ((size_t)HW * C);
    const float mu = stats[(n * 4 + 0) * C + c], r = stats[(n * 4 + 1) * C + c];
    const float vh = (cg_to_f(cg_from_f<T>(u[i])) - mu) * r;
    vhat[i] = cg_from_f<T>(vh);
    a[i] = cg_from_f<T>(fmaxf(vh, 0.f));
  }
}

// Forward apply of IN2: s stored in T, y = (s - mu2) * r2 + x in T.
template <typename T>
__global__ void __launch_bounds__(256)
fwd_apply_in2(const float* __restrict__ s32, const float* __restrict__ stats,
              const T* __restrict__ x, T* __restrict__ s, T* __restrict__ y, size_t total, int HW,
              int C) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t n = i / ((size_t)HW * C);
    const float mu = stats[(n * 4 + 2) * C + c], r = stats[(n * 4 + 3) * C + c];
    const T sq = cg_from_f<T>(s32[i]);
    s[i] = sq;
    y[i] = cg_from_f<T>((cg_to_f(sq) - mu) * r + cg_to_f(x[i]));
  }
}

// VJP apply of IN2: ds = r2 * (dy - E[dy] - shat * E[dy * shat]), float32.
template <typename T>
__global__ void __launch_bounds__(256)
vjp_apply_s(const T* __restrict__ dy, const T* __restrict__ s, const float* __restrict__ stats,
            const float* __restrict__ means, float* __restrict__ ds, size_t total, int HW, int C) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t n = i / ((size_t)HW * C);
    const float mu2 = stats[(n * 4 + 2) * C + c], r2 = stats[(n * 4 + 3) * C + c];
    const float m0 = means[(n * 2) * C + c], m1 = means[(n * 2 + 1) * C + c];
    const float sh = (cg_to_f(s[i]) - mu2) * r2;
    ds[i] = r2 * (cg_to_f(dy[i]) - m0 - sh * m1);
  }
}

// VJP apply of IN1 from the stored dv: du = r1 * (dv - E[dv] - vhat *
// E[dv * vhat]), float32.
template <typename T>
__global__ void __launch_bounds__(256)
vjp_apply_v(const T* __restrict__ dv, const T* __restrict__ vhat, const float* __restrict__ stats,
            const float* __restrict__ means, float* __restrict__ du, size_t total, int HW, int C) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    const size_t n = i / ((size_t)HW * C);
    const float r1 = stats[(n * 4 + 1) * C + c];
    const float m0 = means[(n * 2) * C + c], m1 = means[(n * 2 + 1) * C + c];
    du[i] = r1 * (cg_to_f(dv[i]) - m0 - cg_to_f(vhat[i]) * m1);
  }
}

bool bad_shape(int N, int H, int W, int C, int hc) {
  return N <= 0 || H < 2 || W < 2 || C <= 0 || hc <= 0 || H % hc != 0;
}

template <typename T>
cudaError_t launch_fwd(const float* v32, float* stats, const void* x, void* out0, void* out1,
                       float* part, int N, int H, int W, int C, int hc, float eps, int which,
                       cudaStream_t s) {
  const int HW = H * W, K = H / hc, chunk_px = hc * W;
  dim3 grid(K, N, (C + CH - 1) / CH), block(CH, LANES);
  fwd_partials<<<grid, block, 0, s>>>(v32, part, N, HW, C, chunk_px, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_partials<<<cg_grid_1d((size_t)N * C), 256, 0, s>>>(part, stats, N, K, C, HW, 4,
                                                         which == 1 ? 0 : 2, eps, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t total = (size_t)N * HW * C;
  if (which == 1)
    fwd_apply_in1<T><<<cg_grid_1d(total), 256, 0, s>>>(v32, stats, static_cast<T*>(out0),
                                                    static_cast<T*>(out1), total, HW, C);
  else
    fwd_apply_in2<T><<<cg_grid_1d(total), 256, 0, s>>>(v32, stats, static_cast<const T*>(x),
                                                    static_cast<T*>(out0), static_cast<T*>(out1),
                                                    total, HW, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vjp(const void* g, const void* src, const float* stats, void* dv, void* a,
                       float* out, float* part, float* means, int N, int H, int W, int C, int hc,
                       int which, cudaStream_t s) {
  const int HW = H * W, K = H / hc, chunk_px = hc * W;
  dim3 grid(K, N, (C + CH - 1) / CH), block(CH, LANES);
  if (which == 2)
    vjp_partials_s<T><<<grid, block, 0, s>>>(static_cast<const T*>(g), static_cast<const T*>(src),
                                             stats, part, N, HW, C, chunk_px, K);
  else
    vjp_partials_v<T><<<grid, block, 0, s>>>(static_cast<const float*>(g),
                                             static_cast<const T*>(src), static_cast<T*>(dv),
                                             static_cast<T*>(a), part, N, HW, C, chunk_px, K);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_partials<<<cg_grid_1d((size_t)N * C), 256, 0, s>>>(part, means, N, K, C, HW, 2, 0,
                                                           0.f, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t total = (size_t)N * HW * C;
  if (which == 2)
    vjp_apply_s<T><<<cg_grid_1d(total), 256, 0, s>>>(static_cast<const T*>(g),
                                                  static_cast<const T*>(src), stats, means, out,
                                                  total, HW, C);
  else
    vjp_apply_v<T><<<cg_grid_1d(total), 256, 0, s>>>(static_cast<const T*>(dv),
                                                  static_cast<const T*>(src), stats, means, out,
                                                  total, HW, C);
  return cudaGetLastError();
}

}  // namespace

// Forward instance norm of the chunked block, after a convolution.
// v32: (N, H, W, C) float32 convolution output; stats: (N, 4, C) float32,
// slots 0-1 written by which=1, 2-3 by which=2 (which=2 reads none of 0-1);
// part: (2, N, H/hc, C) float32 scratch. which=1: out0 = vhat, out1 = a
// (x unused); which=2: x = the block's input, out0 = s, out1 = y. x, out0,
// out1 of dtype (0 f32, 1 bf16). Needs H % hc == 0, H, W >= 2.
extern "C" int cg_chunked_in_fwd(const void* v32, void* stats, const void* x, void* out0,
                                 void* out1, void* part, int N, int H, int W, int C, int hc,
                                 float eps, int which, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, H, W, C, hc) || (which != 1 && which != 2)) return (int)cudaErrorInvalidValue;
  auto v = static_cast<const float*>(v32);
  auto st = static_cast<float*>(stats);
  auto p = static_cast<float*>(part);
  if (dtype == CG_BF16)
    return (int)launch_fwd<bf16>(v, st, x, out0, out1, p, N, H, W, C, hc, eps, which, s);
  if (dtype == CG_F32)
    return (int)launch_fwd<float>(v, st, x, out0, out1, p, N, H, W, C, hc, eps, which, s);
  return (int)cudaErrorInvalidValue;
}

// VJP of one instance norm of the chunked block, from saved values.
// which=2: g = dy and src = s (dtype), out = ds (float32); dv, a unused.
// which=1: g = da (float32), src = vhat (dtype); writes dv and a (dtype),
// out = du (float32) from the stored dv. stats: the forward's (N, 4, C);
// part: (2, N, H/hc, C) and means: (N, 2, C) float32 scratch.
extern "C" int cg_chunked_in_vjp(const void* g, const void* src, const void* stats, void* dv,
                                 void* a, void* out, void* part, void* means, int N, int H, int W,
                                 int C, int hc, int which, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, H, W, C, hc) || (which != 1 && which != 2)) return (int)cudaErrorInvalidValue;
  auto st = static_cast<const float*>(stats);
  auto o = static_cast<float*>(out);
  auto p = static_cast<float*>(part);
  auto m = static_cast<float*>(means);
  if (dtype == CG_BF16)
    return (int)launch_vjp<bf16>(g, src, st, dv, a, o, p, m, N, H, W, C, hc, which, s);
  if (dtype == CG_F32)
    return (int)launch_vjp<float>(g, src, st, dv, a, o, p, m, N, H, W, C, hc, which, s);
  return (int)cudaErrorInvalidValue;
}
