// Weight gradient of a VALID stride-1 k x k convolution over an input that
// is already padded, for Hopper (sm_90a).
//
// Replaces: cyclegan_tpu/kernels/conv_dw.py, the Pallas kernel conv_dw
// (_dw_kernel), which keeps one batch cell's padded input and output
// gradient in VMEM and accumulates
//   dw[s, t] = sum_n xp[n, s:s+H, t:t+W, :]^T dy[n]        (k, k, Cin, Cout)
// over its sequential batch grid in float32. The JAX package routes the
// weight gradient of the trunk's reflect-padded 3x3 convolutions through it
// (ops/functional.py::conv2d_valid_dw_fused); the port does the same for the
// --use_dropout trunk, whose blocks are not fused.
//
// The design is that of cg_conv3x3_reflect_wgrad in resblock.cu without the
// reflect logic: an implicit GEMM with M = k*k*Cin rows (tap, cin) like the
// HWIO weight, N = Cout, K = N*H*W pixels, split along K into chunks fixed
// by the shapes; each block writes float32 partials of its chunk and a
// second pass adds them in chunk order (no atomics: two runs give
// bitwise-equal dw). Operands are read in their own type (bf16 on the main
// path) and multiplied in float32 FFMA.
//
// What bounds it on the H100: operations. 2 * 9 * 256 * 256 * 8192 = 9.7
// GFLOP per batch-2 trunk call against ~11 MB moved, ~900 flop/byte; at the
// bf16 tensor-core rate the least time is ~10 us, at the 67 TFLOP/s rate of
// the float32 FFMA products used here ~145 us. Moving the products onto
// bf16 mma (the operands are already bf16) is later work.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int FBM = 64, FBN = 64, FBK = 16;

// Grid (ceil(k*k*Cin / 64), ceil(Cout / 64), splits), 256 threads, 4 x 4
// outputs each. part[s, m, co] = sum over the pixels q of chunk s of
//   xp[n, i + ky, j + kx, ci] * dy[n, i, j, co],
// m = (ky * k + kx) * Cin + ci, q = (n * H + i) * W + j.
// Needs Cin % 4 == 0 (a thread's 4 rows share one tap).
template <typename T>
__global__ void __launch_bounds__(256)
conv_dw_partial(const T* __restrict__ xp, const T* __restrict__ dy, float* __restrict__ part,
                int N, int H, int W, int Cin, int Cout, int k, int kchunk) {
  __shared__ float As[FBK][FBM + 4];  // [pixel][m]
  __shared__ float Bs[FBK][FBN + 4];  // [pixel][co]
  const int tid = threadIdx.x;
  const int Hp = H + k - 1, Wp = W + k - 1;
  const int M = k * k * Cin, K = N * H * W, HWp = H * W;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN, sp = blockIdx.z;
  const int kbeg = sp * kchunk, kend = min(K, kbeg + kchunk);

  // A and B loads: pixel k0 + (tid >> 4); rows (tid & 15) * 4 .. +3 of m
  // (A) and of co (B).
  const int l_k = tid >> 4, l_c = (tid & 15) * 4;
  const int am = m0 + l_c;
  const bool m_ok = am < M;
  const int tap = m_ok ? am / Cin : 0, ci = m_ok ? am - tap * Cin : 0;
  const int ky = tap / k, kx = tap % k;
  const int bco = n0 + l_c;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += FBK) {
    const int q = k0 + l_k;
    const bool q_ok = q < kend;
    const bool a_ok = q_ok && m_ok;
    const int qq = q_ok ? q : kbeg;
    const int n = qq / HWp, rem = qq - n * HWp;
    const int i = rem / W, j = rem - i * W;
    const T* asrc = xp + (((size_t)n * Hp + i + ky) * Wp + j + kx) * Cin + ci;
#pragma unroll
    for (int e = 0; e < 4; ++e) As[l_k][l_c + e] = a_ok ? cg_to_f(asrc[e]) : 0.f;
    const T* bsrc = dy + (size_t)qq * Cout + bco;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Bs[l_k][l_c + e] = (q_ok && bco + e < Cout) ? cg_to_f(bsrc[e]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FBK; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = As[r][ty * 4 + e];
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = Bs[r][tx * 4 + e];
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[e][f] = fmaf(a[e], b[f], acc[e][f]);
    }
    __syncthreads();
  }
  float* dst = part + (size_t)sp * M * Cout;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = m0 + ty * 4 + e;
    if (row >= M) continue;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int col = n0 + tx * 4 + f;
      if (col < Cout) dst[(size_t)row * Cout + col] = acc[e][f];
    }
  }
}

// dw[i] = sum_s part[s, i] in chunk order.
__global__ void __launch_bounds__(256)
dw_reduce(const float* __restrict__ part, float* __restrict__ dw, int splits, size_t MN) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * MN + i];
    dw[i] = s;
  }
}

template <typename T>
cudaError_t launch(const void* xp, const void* dy, float* dw, float* part, int N, int H, int W,
                   int Cin, int Cout, int k, int splits, int kchunk, cudaStream_t s) {
  dim3 grid((k * k * Cin + FBM - 1) / FBM, (Cout + FBN - 1) / FBN, splits);
  conv_dw_partial<T><<<grid, 256, 0, s>>>(static_cast<const T*>(xp), static_cast<const T*>(dy),
                                          part, N, H, W, Cin, Cout, k, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t MN = (size_t)k * k * Cin * Cout;
  const int blocks = (int)std::min<size_t>((MN + 255) / 256, 132 * 16);
  dw_reduce<<<blocks, 256, 0, s>>>(part, dw, splits, MN);
  return cudaGetLastError();
}

}  // namespace

// xp: (N, H+k-1, W+k-1, Cin) and dy: (N, H, W, Cout), both of dtype (0 f32,
// 1 bf16); dw: (k, k, Cin, Cout) float32, summed over the batch. part:
// (splits, k*k*Cin, Cout) float32 scratch; chunk s covers pixels
// [s*kchunk, (s+1)*kchunk) of N*H*W. Needs Cin % 4 == 0. Returns the CUDA
// error code (0 on success).
extern "C" int cg_conv_dw(const void* xp, const void* dy, void* dw, void* part, int N, int H,
                          int W, int Cin, int Cout, int k, int splits, int kchunk, int dtype,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<float*>(dw);
  auto p = static_cast<float*>(part);
  if (N <= 0 || H <= 0 || W <= 0 || k <= 0 || Cin % 4 != 0 || Cout <= 0 || splits <= 0 ||
      kchunk <= 0 || (long long)splits * kchunk < (long long)N * H * W)
    return (int)cudaErrorInvalidValue;
  if (dtype == CG_BF16)
    return (int)launch<bf16>(xp, dy, d, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  if (dtype == CG_F32)
    return (int)launch<float>(xp, dy, d, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  return (int)cudaErrorInvalidValue;
}
