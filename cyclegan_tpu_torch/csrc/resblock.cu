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
// chains the instance-norm VJP of instance_norm.cu with two gradient
// convolutions, as _rb_bwd does:
//   cg_conv3x3_reflect_dgrad (here): the input gradient of
//     conv3x3(rpad1(.), w) for a float32 output gradient g, with the
//     reflect fold. A full correlation writes the gradient of the padded
//     input (N, H+2, W+2, Cin) into float32 scratch (implicit GEMM, M =
//     padded pixels, N = Cin, K = 9 * Cout, A = g zero outside the plane,
//     B = w[tap] transposed); a second pass folds pad rows and columns 0 and
//     H+1 back onto rows and columns 1 and H-2 (_fold_pad1), adds an
//     optional residual (dy, for dx = dy + dgrad) and writes the output type.
//   the weight gradient: conv_dw.cu's cg_conv_dw on the reflect-padded input
//     (the VALID case on rpad1(inp)), split-K, bitwise repeatable.
// What bounds them: operations, 2 * M * 9 * C * C per convolution, four per
// block backward. The cotangents are float32, as in the Pallas kernels, so
// the tensor cores see them as two bf16 parts, hi = bf16(g) and lo =
// bf16(g - hi) (cg_bf16_parts; |g - hi - lo| <= 2^-16 |g|): a bf16 weight
// costs two bf16 passes (g_hi w + g_lo w), within the float32 bars of
// chip_smoke.py. A float32 weight (the float32 train step) takes three
// parts of both operands and six passes, products exact to float32
// rounding as the FFMA kernel's were (conv_dw.cu says why). No TF32.
// What the design does about that: dgrad_mma is the forward's mma.sync
// m16n8k16 loop with zero instead of reflect padding, on a 64 x 128 tile
// (8 warps of 32 x 32) so that batch 1 (4,356 padded pixels x 256) gives
// 138 blocks for the 132 SMs where 128 x 128 gave 70; A is stored [m][k]
// and B [ci][k], both read by plain ldmatrix, from a 3-stage cp.async ring.
// The output is too small for wider warp tiles: 4 warps of 32 x 64 (fewer
// ldmatrix per mma) and a wgmma version with one warpgroup a 64 x 128 tile
// were both slower at batch 2 on an H100, with too few warps an SM to hide
// their loads. A wgmma tiling that fills the card at batch 1 is the next
// step for this loop and the forward's. The fold reads dpad as float4 with 32-bit
// index arithmetic.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // +16 B per row: conflict-free ldmatrix rows
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BF16 = STAGES * (A_STAGE + B_STAGE) * (int)sizeof(bf16);

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
// The input gradient on the tensor cores: a full correlation of the
// cotangent's bf16 parts with w[tap] transposed, written to padded float32
// scratch, then the reflect fold.
constexpr int DBM = 64, DBN = 128, DBK = 32, DSTAGES = 3;
constexpr int D_LD = DBK + 8;  // [row][k] rows of 80 B: conflict-free ldmatrix
constexpr int DA_TILE = DBM * D_LD;
constexpr int DB_TILE = DBN * D_LD;

constexpr int dgrad_smem(int ng, int nw) {
  return DSTAGES * (ng * DA_TILE + nw * DB_TILE) * (int)sizeof(bf16);
}

// Grid (ceil(N*(H+2)*(W+2) / DBM), ceil(Cin / DBN)); 8 warps as 2 (M) x 4
// (N), each owning 32 x 32 of the tile (2 x 4 mma tiles of 16 x 8).
// dpad[n, i, j, ci] = sum_{ky, kx, co} sum_{(a, b) in passes}
//   g_a[n, i-ky, j-kx, co] * w_b[ky, kx, ci, co]
// for i in [0, H+2), j in [0, W+2), with g zero outside [0, H) x [0, W);
// g_a = g + a * g_part, w_b = w + b * w_part; the passes are the (a, b)
// with a + b < max(NG, NW). Needs Cout % 32 == 0 (a 32-deep K step stays
// inside one tap), Cin % 8 == 0 and 16-byte aligned planes.
template <int NG, int NW>
__global__ void __launch_bounds__(THREADS, 2)
dgrad_mma(const bf16* __restrict__ g, size_t g_part, const bf16* __restrict__ w,
          size_t w_part, float* __restrict__ dpad, int N, int H, int W, int Cin, int Cout) {
  constexpr int PASSES = NG > NW ? NG : NW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + DSTAGES * NG * DA_TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hp = H + 2, Wp = W + 2;
  const int M = N * Hp * Wp, HWp = Hp * Wp;
  const int m0 = blockIdx.x * DBM, n0 = blockIdx.y * DBN;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;

  // A: padded pixel row (tid >> 2), 16-byte chunk (tid & 3) of the 32 co.
  // B: input channels (tid >> 2) and (tid >> 2) + 64, the same chunk.
  const int chunk = (tid & 3) * 8;
  const int a_row = tid >> 2;
  const int am = m0 + a_row;
  const bool a_ok = am < M;
  const int amm = a_ok ? am : 0;
  const int an = amm / HWp, arem = amm - an * HWp;
  const int ai = arem / Wp, aj = arem - ai * Wp;

  const int KT = 9 * Cout / DBK;
  auto load_stage = [&](int stage, int kt) {
    const int k0 = kt * DBK;
    const int tap = k0 / Cout, co0 = k0 - tap * Cout;
    const int h = ai - tap / 3, ww = aj - tap % 3;
    const bool ok = a_ok && h >= 0 && h < H && ww >= 0 && ww < W;
    const size_t a_off = (((size_t)an * H + h) * W + ww) * Cout + co0 + chunk;
#pragma unroll
    for (int p = 0; p < NG; ++p)
      cp_async16(As + (stage * NG + p) * DA_TILE + a_row * D_LD + chunk,
                 ok ? g + p * g_part + a_off : g, ok ? 16 : 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = a_row + i * 64, ci = n0 + row;
      const bool b_ok = ci < Cin;
      const size_t b_off = ((size_t)tap * Cin + ci) * Cout + co0 + chunk;
#pragma unroll
      for (int p = 0; p < NW; ++p)
        cp_async16(Bs + (stage * NW + p) * DB_TILE + row * D_LD + chunk,
                   b_ok ? w + p * w_part + b_off : w, b_ok ? 16 : 0);
    }
  };

  // acc[0] takes the main pass (0, 0), acc[1] the correction passes: the
  // tensor cores' float32 accumulation truncates, with an error that grows
  // with the steps into one accumulator, and the corrections (~2^-8 of the
  // main terms) add theirs ~2^8 times smaller when kept apart.
  float acc[2][2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  // ldmatrix lane addresses: A stored [m][k] (row fragments as stored), B
  // stored [ci][k] (col fragments as stored).
  const int a_lm = lane & 15, a_lk = (lane >> 4) * 8;
  const int b_ln = ((lane >> 4) << 3) + (lane & 7), b_lk = ((lane >> 3) & 1) * 8;
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();
    const int nk = kt + DSTAGES - 1;
    if (nk < KT) load_stage(nk % DSTAGES, nk);
    cp_async_commit();

    const int st = kt % DSTAGES;
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 16) {
      uint32_t bfr[NW][2][4];
#pragma unroll
      for (int p = 0; p < NW; ++p) {
        const bf16* bs = Bs + (st * NW + p) * DB_TILE;
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4(bfr[p][np], bs + (wn + np * 16 + b_ln) * D_LD + kk + b_lk);
      }
#pragma unroll
      for (int pa = 0; pa < NG; ++pa) {
        const bf16* as = As + (st * NG + pa) * DA_TILE;
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(af[mt], as + (wm + mt * 16 + a_lm) * D_LD + kk + a_lk);
#pragma unroll
        for (int pb = 0; pb < NW && pa + pb < PASSES; ++pb)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[pa + pb > 0][mt][nt], af[mt], bfr[pb][nt >> 1][(nt & 1) * 2],
                       bfr[pb][nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn + nt * 8 + tig * 2;
    if (c >= Cin) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int row = m0 + wm + mt * 16 + gq;
      if (row < M)
        *reinterpret_cast<float2*>(dpad + (size_t)row * Cin + c) =
            make_float2(acc[0][mt][nt][0] + acc[1][mt][nt][0],
                        acc[0][mt][nt][1] + acc[1][mt][nt][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(dpad + (size_t)(row + 8) * Cin + c) =
            make_float2(acc[0][mt][nt][2] + acc[1][mt][nt][2],
                        acc[0][mt][nt][3] + acc[1][mt][nt][3]);
    }
  }
}

// out[n, p, q, c] = sum of dpad over the padded positions that reflect onto
// (p, q) (+ add[n, p, q, c]): padded row p + 1, and row 0 when p == 1, and
// row H + 1 when p == H - 2; the same for columns. A fixed order per element.
// One thread per 4 channels, 32-bit index arithmetic (the caller keeps
// N*H*W*C under 2^31); needs C % 4 == 0.
template <typename TOut>
__global__ void __launch_bounds__(256)
fold_pad1(const float* __restrict__ dpad, const TOut* __restrict__ add,
          TOut* __restrict__ out, int N, int H, int W, int C) {
  const int C4 = C / 4, total = N * H * W * C4;
  const int Hp = H + 2, Wp = W + 2;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int c = (idx % C4) * 4;
    int rest = idx / C4;
    const int q = rest % W;
    rest /= W;
    const int p = rest % H;
    const int n = rest / H;
    int rows[3] = {p + 1, 0, 0}, cols[3] = {q + 1, 0, 0};
    int nr = 1, nc = 1;
    if (p == 1) rows[nr++] = 0;
    if (p == H - 2) rows[nr++] = H + 1;
    if (q == 1) cols[nc++] = 0;
    if (q == W - 2) cols[nc++] = W + 1;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int a = 0; a < nr; ++a)
      for (int b = 0; b < nc; ++b) {
        const float4 v = *reinterpret_cast<const float4*>(
            dpad + ((size_t)(n * Hp + rows[a]) * Wp + cols[b]) * C + c);
        s[0] += v.x;
        s[1] += v.y;
        s[2] += v.z;
        s[3] += v.w;
      }
    const size_t o = (size_t)idx * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (add != nullptr) s[e] += cg_to_f(add[o + e]);
      out[o + e] = cg_from_f<TOut>(s[e]);
    }
  }
}

template <int NG, int NW>
cudaError_t launch_dgrad_mma(const bf16* g, const bf16* w, float* dpad, int N, int H, int W,
                             int Cin, int Cout, cudaStream_t s) {
  constexpr int smem = dgrad_smem(NG, NW);
  static bool sized[CG_MAX_DEVICES] = {};
  const cudaError_t e = cg_smem_limit(dgrad_mma<NG, NW>, smem, sized);
  if (e != cudaSuccess) return e;
  const int M = N * (H + 2) * (W + 2);
  dim3 grid((M + DBM - 1) / DBM, (Cin + DBN - 1) / DBN);
  dgrad_mma<NG, NW><<<grid, THREADS, smem, s>>>(g, (size_t)N * H * W * Cout, w,
                                                (size_t)9 * Cin * Cout, dpad, N, H, W, Cin,
                                                Cout);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_fold(const float* dpad, const void* add, void* out, int N, int H, int W,
                        int C, cudaStream_t s) {
  fold_pad1<TOut><<<cg_grid_1d((size_t)N * H * W * C / 4), 256, 0, s>>>(
      dpad, static_cast<const TOut*>(add), static_cast<TOut*>(out), N, H, W, C);
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
// g: (ng, N, H, W, Cout), the bf16 parts of the float32 output gradient
// (cg_bf16_parts of conv_dw.cu); w: (nw, 3, 3, Cin, Cout), the bf16 parts of
// the weight; (ng, nw) is (2, 1) for bf16 weights, (3, 3) for float32 ones;
// add (or NULL) and out:
// (N, H, W, Cin) of out_dtype; out = fold(full correlation of g with w)
// [+ add]. dpad: (N, H+2, W+2, Cin) float32 scratch. Needs H, W >= 2,
// Cout % 32 == 0, Cin % 8 == 0 and 16-byte aligned g and w.
extern "C" int cg_conv3x3_reflect_dgrad(const void* g, const void* w, const void* add, void* out,
                                        void* dpad, int N, int H, int W, int Cin, int Cout,
                                        int ng, int nw, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const bf16*>(g);
  auto wp = static_cast<const bf16*>(w);
  auto dp = static_cast<float*>(dpad);
  if (N <= 0 || H < 2 || W < 2 || Cin <= 0 || Cin % 8 != 0 || Cout <= 0 || Cout % 32 != 0 ||
      (long long)N * H * W * Cin >= (1LL << 31) || (out_dtype != CG_F32 && out_dtype != CG_BF16))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (ng == 2 && nw == 1)
    e = launch_dgrad_mma<2, 1>(gp, wp, dp, N, H, W, Cin, Cout, s);
  else if (ng == 3 && nw == 3)
    e = launch_dgrad_mma<3, 3>(gp, wp, dp, N, H, W, Cin, Cout, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  if (out_dtype == CG_BF16) return (int)launch_fold<bf16>(dp, add, out, N, H, W, Cin, s);
  return (int)launch_fold<float>(dp, add, out, N, H, W, Cin, s);
}
