// 3x3 reflect-padded convolution for the residual block, for Hopper (sm_90a).
//
// Replaces: cyclegan_tpu/kernels/resblock.py, the forward Pallas kernel
// (_forward_pallas -> _kernel) behind residual_block_fused, which computes
//   y = x + IN(conv3(rpad(relu(IN(conv3(rpad x) + b1)))) + b2)
// for one whole sample in VMEM. kernels/resblock.py composes the same
// function on Hopper from this file's convolution and the instance-norm
// kernels of instance_norm.cu:
//   conv3x3_reflect(x, w1, b1) -> u (f32) -> IN apply + relu -> a (x's type)
//   conv3x3_reflect(a, w2, b2) -> s (f32) -> IN apply + skip x -> y
//
// What bounds it on the H100: operations. One 256-channel 64x64 plane costs
// 2 * 4096 * 256 * 2304 = 4.8 GFLOP per convolution against ~2 MB of bf16
// activations, i.e. ~2,300 flop/byte, far above the ~295 flop/byte where
// HBM would bind. The convolutions are the block's time.
//
// What the design does about that: the TPU kernel kept the sample's plane in
// VMEM; a Hopper block cannot hold a 2 MB plane, so the convolution is a
// tiled implicit GEMM: M = N*H*W output pixels, N = Cout, K = 9*Cin ordered
// (tap, cin) like the HWIO weight. Each 128x128 output tile walks K in
// 32-deep steps; a step reads one tap of 32 input channels, with the reflect
// padding applied as index arithmetic on the load (no padded copy in
// memory). bf16 inputs run on the tensor cores through mma.sync
// m16n8k16 (f32 accumulation) fed by ldmatrix from a 3-stage cp.async ring
// in shared memory. float32 inputs take a SIMT FMA kernel so that the f32
// result stays full precision (no TF32). The bias is added to the f32
// accumulator in the epilogue, which writes the f32 result the instance
// norm reads. wgmma, TMA and fusing the statistics into this epilogue are
// later work.
//
// The backward replaces the two VJP Pallas kernels behind
// residual_block_fused: _bwd_dx_kernel (dx) and _bwd_dw_kernel (dw1, dw2).
// kernels/resblock.py recomputes the forward with the kernels above and
// chains the instance-norm VJP of instance_norm.cu with the two kernels
// here, as _rb_bwd does:
//   cg_conv3x3_reflect_dgrad: the input gradient of conv3x3(rpad1(.), w)
//     for a float32 output gradient g, with the reflect fold. A full
//     correlation writes the gradient of the padded input (N, H+2, W+2, Cin)
//     into float32 scratch (implicit GEMM, M = padded pixels, N = Cin,
//     K = 9 * Cout, B = w[tap] transposed, cast to float32 as the Pallas
//     kernel does); a second pass folds pad rows and columns 0 and H+1 back
//     onto rows and columns 1 and H-2 (_fold_pad1), adds an optional
//     residual (dy, for dx = dy + dgrad) and writes the output type.
//   cg_conv3x3_reflect_wgrad: dw[s,t] = sum_n sum_pixels
//     rpad1(inp)[n, i+s, j+t, :]^T g[n, i, j, :] as (3, 3, Cin, Cout),
//     summed over the batch inside the kernel (as _bwd_dw_kernel
//     accumulates across its grid): an implicit GEMM with M = 9 * Cin,
//     N = Cout and K = N*H*W pixels, split along K into a number of chunks
//     fixed by the shapes; the float32 partials are added in chunk order by
//     a second pass (no atomics: two runs give bitwise-equal dw).
// What bounds them: operations. The cotangents are float32, as in the
// Pallas kernels, so both are float32 FFMA GEMMs (the SIMT tiling of the
// float32 forward below): four 2*M*9*C*C convolutions per block backward,
// at the 67 TFLOP/s float32 rate. Rounding the cotangent to bf16 for the
// tensor cores is a later decision that must keep the parity bars.

#include <algorithm>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // +16 B per row: conflict-free ldmatrix rows
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BF16 = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (ceil(M / BM), ceil(Cout / BN)); 8 warps as 2 (M) x 4 (N), each
// warp owning a 64 x 32 piece of the tile (4 x 4 mma tiles of 16 x 8).
__global__ void __launch_bounds__(THREADS)
conv3x3_reflect_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const bf16* __restrict__ bias, float* __restrict__ out, int N, int H,
                     int W, int Cin, int Cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = N * H * W, HWp = H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // A tile: BM rows x BK bf16 = 512 chunks of 16 B; this thread loads rows
  // (tid >> 2) and (tid >> 2) + 64, chunk (tid & 3) of each.
  const int a_kc = tid & 3;
  int a_n[2], a_h[2], a_w[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int m = m0 + (tid >> 2) + i * 64;
    a_ok[i] = m < M;
    int mm = a_ok[i] ? m : 0;
    a_n[i] = mm / HWp;
    int rem = mm - a_n[i] * HWp;
    a_h[i] = rem / W;
    a_w[i] = rem - a_h[i] * W;
  }
  // B tile: BK rows x BN bf16 = 512 chunks; rows (tid >> 4) and +16,
  // columns (tid & 15) * 8.
  const int b_col = (tid & 15) * 8;
  const bool b_ok = n0 + b_col < Cout;

  const int KT = 9 * Cin / BK;
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * BK;
    const int tap = k0 / Cin, ci0 = k0 - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + i * 64;
      const int ih = cg_reflect1(a_h[i] + dy, H), iw = cg_reflect1(a_w[i] + dx, W);
      const bf16* src = x + (((size_t)a_n[i] * H + ih) * W + iw) * Cin + ci0 + a_kc * 8;
      cp_async16(as + row * A_LD + a_kc * 8, src, a_ok[i] ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = (tid >> 4) + i * 16;
      const bf16* src = b_ok ? w + (size_t)(k0 + k) * Cout + n0 + b_col : w;
      cp_async16(bs + k * B_LD + b_col, src, b_ok ? 16 : 0);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const bf16* as = As + (kt % STAGES) * A_STAGE;
    const bf16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], as + (wm + mt * 16 + (lane & 15)) * A_LD + kk + (lane >> 4) * 8);
      uint32_t bfr[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bfr[np], bs + (kk + (lane & 15)) * B_LD + wn + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + wn + nt * 8 + tig * 2;
    if (col >= Cout) continue;
    const float b0 = __bfloat162float(bias[col]), b1 = __bfloat162float(bias[col + 1]);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int row = m0 + wm + mt * 16 + g;
      if (row < M)
        *reinterpret_cast<float2*>(out + (size_t)row * Cout + col) =
            make_float2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * Cout + col) =
            make_float2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int FBM = 64, FBN = 64, FBK = 16;

// Grid (ceil(M / 64), ceil(Cout / 64)), 256 threads, 4 x 4 outputs each.
__global__ void __launch_bounds__(256)
conv3x3_reflect_f32(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ out, int N, int H,
                    int W, int Cin, int Cout) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int M = N * H * W, HWp = H * W;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;

  // A loads: row tid >> 2, channels (tid & 3) * 4 .. +3.
  const int a_row = tid >> 2, a_k = (tid & 3) * 4;
  const int am = m0 + a_row;
  const bool a_ok = am < M;
  const int amm = a_ok ? am : 0;
  const int an = amm / HWp, arem = amm - an * HWp;
  const int ah = arem / W, aw = arem - ah * W;
  // B loads: row tid >> 4, columns (tid & 15) * 4 .. +3.
  const int b_k = tid >> 4, b_n = (tid & 15) * 4;
  // Compute: rows ty * 4 .. +3, columns tx * 4 .. +3.
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4] = {};
  const int KT = 9 * Cin / FBK;
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * FBK;
    const int tap = k0 / Cin, ci0 = k0 - tap * Cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int ih = cg_reflect1(ah + dy, H), iw = cg_reflect1(aw + dx, W);
    const float* asrc = x + (((size_t)an * H + ih) * W + iw) * Cin + ci0 + a_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) As[a_k + j][a_row] = a_ok ? asrc[j] : 0.f;
    const float* bsrc = w + (size_t)(k0 + b_k) * Cout + n0 + b_n;
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[b_k][b_n + j] = (n0 + b_n + j < Cout) ? bsrc[j] : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Cout) out[(size_t)row * Cout + col] = acc[i][j] + bias[col];
    }
  }
}


// ---------------------------------------------------------------- backward
// Grid (ceil(N*(H+2)*(W+2) / 64), ceil(Cin / 64)), 256 threads, 4 x 4 each.
// dpad[n, i, j, ci] = sum_{ky, kx, co} g[n, i-ky, j-kx, co] * w[ky, kx, ci, co]
// for i in [0, H+2), j in [0, W+2), with g zero outside [0, H) x [0, W).
// Needs Cout % 16 == 0 (a 16-deep K step stays inside one tap).
template <typename TW>
__global__ void __launch_bounds__(256)
conv3x3_dgrad_full(const float* __restrict__ g, const TW* __restrict__ w,
                   float* __restrict__ dpad, int N, int H, int W, int Cin, int Cout) {
  __shared__ float As[FBK][FBM + 4];
  __shared__ float Bs[FBK][FBN + 4];
  const int tid = threadIdx.x;
  const int Hp = H + 2, Wp = W + 2;
  const int M = N * Hp * Wp, HWp = Hp * Wp;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN;

  // A loads: padded pixel m0 + (tid >> 2), output channels (tid & 3) * 4 .. +3.
  const int a_row = tid >> 2, a_k = (tid & 3) * 4;
  const int am = m0 + a_row;
  const bool a_ok = am < M;
  const int amm = a_ok ? am : 0;
  const int an = amm / HWp, arem = amm - an * HWp;
  const int ai = arem / Wp, aj = arem - ai * Wp;
  // B loads: input channel n0 + (tid >> 2), output channels (tid & 3) * 4 .. +3.
  const int b_n = tid >> 2, b_k = (tid & 3) * 4;
  const int b_ci = n0 + b_n;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4] = {};
  const int KT = 9 * Cout / FBK;
  for (int kt = 0; kt < KT; ++kt) {
    const int k0 = kt * FBK;
    const int tap = k0 / Cout, co0 = k0 - tap * Cout;
    const int h = ai - tap / 3, ww = aj - tap % 3;
    const bool ok = a_ok && h >= 0 && h < H && ww >= 0 && ww < W;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok)
      av = *reinterpret_cast<const float4*>(g + (((size_t)an * H + h) * W + ww) * Cout + co0 + a_k);
    As[a_k + 0][a_row] = av.x;
    As[a_k + 1][a_row] = av.y;
    As[a_k + 2][a_row] = av.z;
    As[a_k + 3][a_row] = av.w;
    const TW* bsrc = w + ((size_t)tap * Cin + b_ci) * Cout + co0 + b_k;
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[b_k + j][b_n] = b_ci < Cin ? cg_to_f(bsrc[j]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Cin) dpad[(size_t)row * Cin + col] = acc[i][j];
    }
  }
}

// out[n, p, q, c] = sum of dpad over the padded positions that reflect onto
// (p, q) (+ add[n, p, q, c]): padded row p + 1, and row 0 when p == 1, and
// row H + 1 when p == H - 2; the same for columns. A fixed order per element.
template <typename TOut>
__global__ void __launch_bounds__(256)
fold_pad1(const float* __restrict__ dpad, const TOut* __restrict__ add,
          TOut* __restrict__ out, int N, int H, int W, int C) {
  const size_t total = (size_t)N * H * W * C;
  const int Hp = H + 2, Wp = W + 2;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    size_t rest = idx / C;
    const int q = (int)(rest % W);
    rest /= W;
    const int p = (int)(rest % H);
    const int n = (int)(rest / H);
    int rows[3] = {p + 1, 0, 0}, cols[3] = {q + 1, 0, 0};
    int nr = 1, nc = 1;
    if (p == 1) rows[nr++] = 0;
    if (p == H - 2) rows[nr++] = H + 1;
    if (q == 1) cols[nc++] = 0;
    if (q == W - 2) cols[nc++] = W + 1;
    float s = 0.f;
    for (int a = 0; a < nr; ++a)
      for (int b = 0; b < nc; ++b)
        s += dpad[(((size_t)n * Hp + rows[a]) * Wp + cols[b]) * C + c];
    if (add != nullptr) s += cg_to_f(add[idx]);
    out[idx] = cg_from_f<TOut>(s);
  }
}

// Grid (ceil(9*Cin / 64), ceil(Cout / 64), splits), 256 threads, 4 x 4 each.
// part[s, m, co] = sum over the pixels k of chunk s of
//   rpad1(inp)[pixel k shifted by tap(m), ci(m)] * g[k, co],  m = tap*Cin + ci.
// Needs Cin % 4 == 0 (a thread's 4 rows share one tap).
template <typename TIn>
__global__ void __launch_bounds__(256)
conv3x3_wgrad_partial(const TIn* __restrict__ inp, const float* __restrict__ g,
                      float* __restrict__ part, int N, int H, int W, int Cin, int Cout,
                      int kchunk) {
  __shared__ float As[FBK][FBM + 4];  // [pixel][m]
  __shared__ float Bs[FBK][FBN + 4];  // [pixel][co]
  const int tid = threadIdx.x;
  const int M = 9 * Cin, K = N * H * W, HWp = H * W;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * FBN, sp = blockIdx.z;
  const int kbeg = sp * kchunk, kend = min(K, kbeg + kchunk);

  // A and B loads: pixel k0 + (tid >> 4); rows (tid & 15) * 4 .. +3 of m
  // (A) and of co (B).
  const int l_k = tid >> 4, l_c = (tid & 15) * 4;
  const int am = m0 + l_c;
  const bool m_ok = am < M;
  const int tap = m_ok ? am / Cin : 0, ci = m_ok ? am - tap * Cin : 0;
  const int ky = tap / 3 - 1, kx = tap % 3 - 1;
  const int bco = n0 + l_c;
  const int ty = tid >> 4, tx = tid & 15;

  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += FBK) {
    const int k = k0 + l_k;
    const bool k_ok = k < kend;
    const bool a_ok = k_ok && m_ok;
    const int kk = a_ok ? k : kbeg;
    const int n = kk / HWp, rem = kk - n * HWp;
    const int h = rem / W, ww = rem - h * W;
    const TIn* asrc = inp + (((size_t)n * H + cg_reflect1(h + ky, H)) * W +
                             cg_reflect1(ww + kx, W)) * Cin + ci;
#pragma unroll
    for (int j = 0; j < 4; ++j) As[l_k][l_c + j] = a_ok ? cg_to_f(asrc[j]) : 0.f;
    const float* bsrc = g + (size_t)(k_ok ? k : kbeg) * Cout + bco;
#pragma unroll
    for (int j = 0; j < 4; ++j) Bs[l_k][l_c + j] = (k_ok && bco + j < Cout) ? bsrc[j] : 0.f;
    __syncthreads();
#pragma unroll
    for (int q = 0; q < FBK; ++q) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[q][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[q][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dst = part + (size_t)sp * M * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < Cout) dst[(size_t)row * Cout + col] = acc[i][j];
    }
  }
}

// dw[i] = sum_s part[s, i] in chunk order, written as TOut.
template <typename TOut>
__global__ void __launch_bounds__(256)
wgrad_reduce(const float* __restrict__ part, TOut* __restrict__ dw, int splits, size_t MN) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * MN + i];
    dw[i] = cg_from_f<TOut>(s);
  }
}

int grid_1d(size_t total) {
  return (int)std::min<size_t>((total + 255) / 256, 132 * 16);
}

template <typename TW, typename TOut>
cudaError_t launch_dgrad(const float* g, const void* w, const void* add, void* out, float* dpad,
                         int N, int H, int W, int Cin, int Cout, cudaStream_t s) {
  const int M = N * (H + 2) * (W + 2);
  dim3 grid((M + FBM - 1) / FBM, (Cin + FBN - 1) / FBN);
  conv3x3_dgrad_full<TW><<<grid, 256, 0, s>>>(g, static_cast<const TW*>(w), dpad, N, H, W,
                                              Cin, Cout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fold_pad1<TOut><<<grid_1d((size_t)N * H * W * Cin), 256, 0, s>>>(
      dpad, static_cast<const TOut*>(add), static_cast<TOut*>(out), N, H, W, Cin);
  return cudaGetLastError();
}

template <typename TIn, typename TOut>
cudaError_t launch_wgrad(const void* inp, const float* g, void* dw, float* part, int N, int H,
                         int W, int Cin, int Cout, int splits, int kchunk, cudaStream_t s) {
  dim3 grid((9 * Cin + FBM - 1) / FBM, (Cout + FBN - 1) / FBN, splits);
  conv3x3_wgrad_partial<TIn><<<grid, 256, 0, s>>>(static_cast<const TIn*>(inp), g, part, N, H,
                                                  W, Cin, Cout, kchunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t MN = (size_t)9 * Cin * Cout;
  wgrad_reduce<TOut><<<grid_1d(MN), 256, 0, s>>>(part, static_cast<TOut*>(dw), splits, MN);
  return cudaGetLastError();
}

}  // namespace

// x: (N, H, W, Cin) and w: (3, 3, Cin, Cout) HWIO and bias: (Cout,), all of
// dtype (0 f32, 1 bf16); out: (N, H, W, Cout) float32 = conv(rpad1(x), w) + b.
// Needs H, W >= 2, Cin % 32 == 0, Cout % 8 == 0 and 16-byte aligned x and w
// (checked by the Python wrapper). Returns the CUDA error code (0 on success).
extern "C" int cg_conv3x3_reflect(const void* x, const void* w, const void* bias, void* out,
                                  int N, int H, int W, int Cin, int Cout, int dtype,
                                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H < 2 || W < 2 || Cin % 32 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int M = N * H * W;
  if (dtype == CG_BF16) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_reflect_bf16,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
    conv3x3_reflect_bf16<<<grid, THREADS, SMEM_BF16, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const bf16*>(bias), static_cast<float*>(out), N, H, W, Cin, Cout);
    return (int)cudaGetLastError();
  }
  if (dtype == CG_F32) {
    dim3 grid((M + FBM - 1) / FBM, (Cout + FBN - 1) / FBN);
    conv3x3_reflect_f32<<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), N, H, W, Cin, Cout);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// Input gradient of conv3x3(rpad1(x), w) with the reflect fold.
// g: (N, H, W, Cout) float32 output gradient; w: (3, 3, Cin, Cout) of
// w_dtype; add (or NULL) and out: (N, H, W, Cin) of out_dtype;
// out = fold(full correlation of g with w) [+ add]. dpad: (N, H+2, W+2, Cin)
// float32 scratch. Needs H, W >= 2, Cout % 16 == 0 and a 16-byte aligned g.
extern "C" int cg_conv3x3_reflect_dgrad(const void* g, const void* w, const void* add, void* out,
                                        void* dpad, int N, int H, int W, int Cin, int Cout,
                                        int w_dtype, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const float*>(g);
  auto dp = static_cast<float*>(dpad);
  if (N <= 0 || H < 2 || W < 2 || Cin <= 0 || Cout % 16 != 0) return (int)cudaErrorInvalidValue;
  if (w_dtype == CG_BF16 && out_dtype == CG_BF16)
    return (int)launch_dgrad<bf16, bf16>(gp, w, add, out, dp, N, H, W, Cin, Cout, s);
  if (w_dtype == CG_BF16 && out_dtype == CG_F32)
    return (int)launch_dgrad<bf16, float>(gp, w, add, out, dp, N, H, W, Cin, Cout, s);
  if (w_dtype == CG_F32 && out_dtype == CG_F32)
    return (int)launch_dgrad<float, float>(gp, w, add, out, dp, N, H, W, Cin, Cout, s);
  if (w_dtype == CG_F32 && out_dtype == CG_BF16)
    return (int)launch_dgrad<float, bf16>(gp, w, add, out, dp, N, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}

// Weight gradient of conv3x3(rpad1(inp), w) for the float32 output gradient
// g: (N, H, W, Cout); inp: (N, H, W, Cin) of in_dtype; dw: (3, 3, Cin, Cout)
// of out_dtype, summed over the batch. part: (splits, 9*Cin, Cout) float32
// scratch; chunk s covers pixels [s*kchunk, (s+1)*kchunk) of N*H*W. Needs
// H, W >= 2 and Cin % 4 == 0.
extern "C" int cg_conv3x3_reflect_wgrad(const void* inp, const void* g, void* dw, void* part,
                                        int N, int H, int W, int Cin, int Cout, int splits,
                                        int kchunk, int in_dtype, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const float*>(g);
  auto pp = static_cast<float*>(part);
  if (N <= 0 || H < 2 || W < 2 || Cin % 4 != 0 || Cout <= 0 || splits <= 0 || kchunk <= 0 ||
      (long long)splits * kchunk < (long long)N * H * W)
    return (int)cudaErrorInvalidValue;
  if (in_dtype == CG_BF16 && out_dtype == CG_BF16)
    return (int)launch_wgrad<bf16, bf16>(inp, gp, dw, pp, N, H, W, Cin, Cout, splits, kchunk, s);
  if (in_dtype == CG_BF16 && out_dtype == CG_F32)
    return (int)launch_wgrad<bf16, float>(inp, gp, dw, pp, N, H, W, Cin, Cout, splits, kchunk, s);
  if (in_dtype == CG_F32 && out_dtype == CG_F32)
    return (int)launch_wgrad<float, float>(inp, gp, dw, pp, N, H, W, Cin, Cout, splits, kchunk, s);
  if (in_dtype == CG_F32 && out_dtype == CG_BF16)
    return (int)launch_wgrad<float, bf16>(inp, gp, dw, pp, N, H, W, Cin, Cout, splits, kchunk, s);
  return (int)cudaErrorInvalidValue;
}
