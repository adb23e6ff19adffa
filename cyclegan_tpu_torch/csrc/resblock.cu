// 3x3 reflect-padded convolution for the residual block, for Hopper (sm_90a).
//
// Replaces: cyclegan_tpu/kernels/resblock.py, the forward Pallas kernel
// (_forward_pallas -> _kernel) behind residual_block_fused (TPU kernel #3),
// which computes
//   y = x + IN(conv3(rpad(relu(IN(conv3(rpad x) + b1)))) + b2)
// for one whole sample in VMEM. kernels/resblock.py composes the same
// function on Hopper from this file's convolution and the instance-norm
// kernels of instance_norm.cu:
//   conv3x3_reflect(x, w1, b1) -> u (f32) -> IN apply + relu -> a (x's type)
//   conv3x3_reflect(a, w2, b2) -> s (f32) -> IN apply + skip x -> y
// The same convolution is the forward of the chunked block (#6,
// kernels/resblock_chunked.py) and the recompute of #4's backward below.
//
// What bounds it on the H100: operations. One 256-channel 64x64 plane costs
// 2 * 4096 * 256 * 2304 = 4.8 GFLOP per convolution against ~2 MB of bf16
// activations, i.e. ~2,300 flop/byte, far above the ~295 flop/byte where
// HBM would bind: 4.9 us a sample at the 989 TFLOP/s bf16 rate.
//
// What the design does about that: an implicit GEMM on wgmma, Hopper's
// warpgroup product, with both operands in shared memory (conv3x3_wgmma):
// M = N*H*W output pixels, N = Cout, K = 9*Cin in the HWIO weight's order
// (tap, cin), walked in steps of one tap and 64 input channels (36 steps at
// Cin 256), one warpgroup a 64-pixel row of the tile, m64nBNk16. That order
// is the one the mma.sync kernel this replaced walked, and its float32 sums
// come out bitwise equal to that kernel's on an H100 (the recompute of #4's
// backward holds its bf16 bars with the same rounding as before). A is
// K-major, 64 channels = 128 B a pixel with the 128-byte swizzle, B the
// step's 64 weight rows, Cout-contiguous, so MN-major like conv_dw.cu's
// operands, in a ring of 4 steps; cp.async writes every 16-byte chunk to
// its swizzled slot, with the reflect padding as index arithmetic on the
// load (no padded copy in memory). Two ways to feed A:
//   - halo tiles own a patch of 2 image rows x 64 columns and keep, for
//     every chunk of 64 input channels, the 4 x 66 reflect-padded pixels
//     around it in shared memory (135 KB at Cin 256; the first steps carry
//     them in). Tap (ky, kx)'s im2col rows for row g are then the 64 halo
//     pixels from halo row g + ky, column kx: one descriptor at any start
//     row (the swizzle follows the address bits, base offset 0), and each
//     input pixel crosses from L2 once instead of nine times.
//   - row tiles own 128 consecutive pixels of N*H*W and copy their im2col
//     rows into each step's ring stage: any Cin (no halo to fit), and the
//     widest tile (128 x 256) when the batch gives enough blocks.
// Channels past a Cin that is a multiple of 32 but not of 64, weight
// columns past a ragged Cout and pixels past the padded plane are
// zero-filled, and the stores are masked. The copies run 2 steps ahead
// with one wgmma group in flight. The tile is the plan of kernels/
// resblock.py::conv_plan, from the shapes alone: the first tile that fits
// and whose grid gives 128 of the 132 SMs a block. At the trunk shape
// (64x64x256 -> 256): halo 2 rows x 64 channels at batch 1 (32 patches x
// 4 = 128 blocks; the mma.sync kernel had 64 blocks there), halo 2 rows x
// 128 at batch 2 (128 blocks), rows 128 x 256 at batch 8 (256 blocks). On
// the card a step costs far more than its tensor-core time (about 5x at
// batch 1): per-step overhead and the traffic from L2 bound it, not the
// products; deeper rings (6-10 steps) did not help, and a prologue unrolled
// over 4 or more steps made ptxas serialise the wgmmas (C7515). One writer
// for each output and no atomics: two calls are bitwise equal. The bias is
// added to the f32 accumulator in the epilogue, which writes the f32
// result the instance norm reads. float32 inputs take a SIMT FMA kernel so
// that the f32 result stays full precision (no TF32). A producer warp with
// TMA and mbarriers, weight multicast across a cluster and the
// instance-norm statistics in this epilogue are later work.
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
// What the design does about that: dgrad_mma is the forward's row-tile
// design on wgmma for the main path's (2, 1) parts: M = N*(H+2)*(W+2)
// padded pixels, N = Cin, K = 9 * Cout walked tap by tap in chunks of 64
// output channels. A is the cotangent's two parts, a padded pixel's 64
// channels = 128 B, K-major with the 128-byte swizzle, zero outside the
// plane (and past a Cout that is no multiple of 64); B is w[tap] as
// stored, a row an input channel's 64 output channels, so K-major too and
// no transpose. cp.async writes each 16-byte chunk to its swizzled slot, a
// ring of 4 steps, copies 2 steps ahead, one wgmma group in flight, a
// prologue of 2 steps (4 or more made ptxas serialise the forward's
// wgmmas, C7515). Every k16 multiplies both A parts against the same B
// stage, so the weight tile crosses from L2 once for both passes; hi and lo
// sum into float32 accumulators of their own until the epilogue adds them
// and writes float32 dpad, as the mma.sync kernel's acc[0] and acc[1] did:
// the tensor cores' float32 accumulation truncates, and the corrections
// (~2^-8 of the main terms) add an error ~2^8 times smaller kept apart.
// Two m64n256 accumulators a thread would not fit in 255 registers, so the
// tile is 128 pixels x 128 input channels: warpgroup wg owns rows 64 wg ..
// 64 wg + 63 and both parts (two m64n128k16 a k16, 128 accumulator
// registers, 200 in all, no spill). kernels/resblock.py::dgrad_plan picks
// the tile from the shapes by conv_plan's rule (one wgmma tile today).
// Measured on an H100 (700 W, CUDA events, 20 calls, the entry with its
// fold) at (b, 64, 64, 256) -> 256, b = 1 / 2 / 8 / 16: the mma.sync kernel
// this replaced 0.090 / 0.151 / 0.416 / 0.770 ms; this tile 0.055 / 0.100
// / 0.268 / 0.488 ms (158 TFLOP/s of the function's work at 16 rows, 337
// of the two passes over the padded plane); hi and lo on two warpgroups of
// a 64 x 256 tile sharing the B stage (an exchange through shared memory
// in the epilogue) 0.056 / 0.102 / 0.269 / 0.490; a 64 x 128 tile of that
// kind 0.065 / 0.099 / 0.304 / 0.565. At batch 1 the 128 x 128 tile's 70
// blocks beat every tile that fills the card (138 blocks: two waves on
// 132 SMs). Per-step overhead and the traffic from L2 bound it, as they
// bound the forward above: a step moves 48 KB from L2 into an SM for
// 1,024 cycles of tensor-core work. The results are bitwise those of the
// mma.sync kernel (the same products in the same order into the same two
// accumulators). The float32 weight's
// (3, 3) case (six passes) stays on the mma.sync kernel: an implicit GEMM
// on mma.sync m16n8k16 with zero padding, on a 64 x 128 tile (8 warps of
// 32 x 32), A stored [m][k] and B [ci][k], both read by plain ldmatrix,
// from a 3-stage cp.async ring. It runs in no benchmark cell, and ptxas
// serialises a float32 wgmma ring of six passes (conv_dw.cu's
// wgrad_wgmma<3, 3>, C7515).
// The fold reads dpad as float4 with 32-bit index arithmetic.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path
// conv3x3_wgmma<HALO, WM, BN, STAGES>: WM warpgroups, each one m64nBNk16
// product a k16 into 64 output pixels x BN channels; K steps of one tap x 64
// input channels (a chunk), tap by tap and, in a tap, chunk by chunk. HALO:
// the block owns a patch of WM image rows x 64 columns and keeps every
// chunk's halo; else 64 WM consecutive pixels, im2col rows copied a step.
constexpr int CK = 64;               // input channels a chunk
constexpr int PW = 64;               // output columns of a patch: one m64
constexpr int HALO_W = PW + 2;       // halo columns
constexpr int B_BLOCK = CK * 128;    // one 64-wide block of B: 64 rows of 128 B
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block can have
constexpr int SMEM_SM = 233472;      // shared memory of an SM (1 KB of it per block is reserved)

template <bool HALO, int WM, int BN, int STAGES_>
struct ConvTile {
  static constexpr int THREADS = 128 * WM, STAGES = STAGES_;
  static constexpr int HALO_ROWS = (WM + 2) * HALO_W;
  static constexpr int HALO_BYTES = (HALO_ROWS * 128 + 1023) / 1024 * 1024;  // one chunk's
  static constexpr int A_STAGE = HALO ? 0 : 64 * WM * 128;
  static constexpr int STAGE = A_STAGE + BN / 64 * B_BLOCK;
  // The ring and 1 KB to align; a HALO tile adds its halos (Cin / 64 of them).
  static constexpr int RING = STAGES * STAGE + 1024;
  static constexpr int MIN_BLOCKS = !HALO && 2 * (RING + 1024) <= SMEM_SM ? 2 : 1;
  static_assert(STAGES >= 3 && RING <= SMEM_MAX, "tile does not fit");
  static int smem(int Cin) { return RING + (HALO ? (Cin + CK - 1) / CK * HALO_BYTES : 0); }
};

// Grid (HALO: N * ceil(H / WM) * ceil(W / 64), else ceil(N*H*W / (64 WM));
// ceil(Cout / BN)):
//   out[n, h, w, co] = bias[co] + sum_{ky, kx, ci} xp[n, h + ky, w + kx, ci]
//                      * w[ky, kx, ci, co],
// xp[n, i, j] = x[n, reflect(i - 1), reflect(j - 1)] the padded plane. Needs
// H, W >= 2, Cin % 32 == 0 (channels past Cin in a chunk are zero-filled),
// Cout % 8 == 0, 16-byte aligned x and w and T::smem(Cin) <= SMEM_MAX.
template <bool HALO, int WM, int BN, int STAGES_>
__global__ void __launch_bounds__(ConvTile<HALO, WM, BN, STAGES_>::THREADS,
                                  ConvTile<HALO, WM, BN, STAGES_>::MIN_BLOCKS)
conv3x3_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const bf16* __restrict__ bias, float* __restrict__ out, int N, int H, int W,
              int Cin, int Cout) {
  using T = ConvTile<HALO, WM, BN, STAGES_>;
  constexpr int THREADS = T::THREADS, STAGES = T::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u, halos = base + STAGES * T::STAGE;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int M = N * H * W, chunks = (Cin + CK - 1) / CK, KT = 9 * chunks;
  const int n0 = blockIdx.y * BN;
  // HALO: the patch, image n, rows h0 .. h0 + WM - 1, columns w0 .. w0 + 63;
  // else pixels m0 .. m0 + 64 WM - 1.
  const int m0 = blockIdx.x * 64 * WM;
  int n = 0, h0 = 0, w0 = 0;
  if constexpr (HALO) {
    const int patch_rows = (H + WM - 1) / WM, patch_cols = (W + PW - 1) / PW;
    int p = blockIdx.x;
    n = p / (patch_rows * patch_cols);
    p -= n * patch_rows * patch_cols;
    h0 = p / patch_cols * WM;
    w0 = p % patch_cols * PW;
  }

  // Halo row q = r * HALO_W + j of chunk c holds xp[n, h0 + r, w0 + j] for
  // channels 64 c .. 64 c + 63, zero past the padded plane and past Cin.
  auto load_halo = [&](int c) {
    unsigned char* hb = smem + (halos - base) + c * T::HALO_BYTES;
    const int c0 = c * CK;
    for (int i = tid; i < T::HALO_ROWS * 8; i += THREADS) {
      const int q = i >> 3, ch = i & 7;
      const int r = q / HALO_W, j = q - r * HALO_W;
      const int pi = h0 + r, pj = w0 + j;
      const bool ok = pi <= H + 1 && pj <= W + 1 && c0 + ch * 8 < Cin;
      const bf16* src = x;
      if (ok)
        src = x + (((size_t)n * H + cg_reflect1(pi - 1, H)) * W + cg_reflect1(pj - 1, W)) * Cin +
              c0 + ch * 8;
      cp_async16(hb + q * 128 + ((ch ^ (q & 7)) << 4), src, ok ? 16 : 0);
    }
  };
  // Else A: 16-byte chunk (tid & 7) of pixel rows (tid >> 3) + i * A_ROWS;
  // the pixel of each, a_n < 0 past M.
  constexpr int A_ROWS = THREADS / 8, A_PASSES = 64 * WM / A_ROWS;
  const int a_c = tid & 7;
  int a_n[A_PASSES], a_h[A_PASSES], a_w[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const int m = m0 + (tid >> 3) + i * A_ROWS;
    a_n[i] = m < M ? m / (H * W) : -1;
    const int rem = m < M ? m - a_n[i] * H * W : 0;
    a_h[i] = rem / W;
    a_w[i] = rem - a_h[i] * W;
  }
  // B: chunk (tid % B_CHUNKS) of weight rows tid / B_CHUNKS + i * B_ROWS.
  constexpr int B_CHUNKS = BN / 8, B_ROWS = THREADS / B_CHUNKS, B_PASSES = CK / B_ROWS;
  const int b_c = tid % B_CHUNKS, b_r = tid / B_CHUNKS;
  const bool b_col_ok = n0 + b_c * 8 < Cout;

  // Step kt = tap * chunks + chunk (HALO: steps 0 .. chunks - 1 also carry
  // the halos).
  auto load_step = [&](int kt) {
    const int tap = kt / chunks, c0 = (kt - tap * chunks) * CK;
    unsigned char* as = smem + (kt % STAGES) * T::STAGE;
    unsigned char* bs = as + T::A_STAGE;
    if constexpr (HALO) {
      if (kt < chunks) load_halo(kt);
    } else {
      const int dy = tap / 3 - 1, dx = tap % 3 - 1;
      const bool a_ch_ok = c0 + a_c * 8 < Cin;
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) {
        const int row = (tid >> 3) + i * A_ROWS;
        const bool ok = a_n[i] >= 0 && a_ch_ok;
        const bf16* src = x;
        if (ok) {
          const int ih = cg_reflect1(a_h[i] + dy, H), iw = cg_reflect1(a_w[i] + dx, W);
          src = x + (((size_t)a_n[i] * H + ih) * W + iw) * Cin + c0 + a_c * 8;
        }
        cp_async16(as + row * 128 + ((a_c ^ (row & 7)) << 4), src, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const int k = b_r + i * B_ROWS;
      const bool ok = b_col_ok && c0 + k < Cin;
      const bf16* src = ok ? w + ((size_t)tap * Cin + c0 + k) * Cout + n0 + b_c * 8 : w;
      cp_async16(bs + cg_swz(k, b_c, B_BLOCK), src, ok ? 16 : 0);
    }
  };

  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

  // Copies run STAGES - 2 steps ahead, and one step's wgmma group stays in
  // flight while the next is issued; a stage is refilled only after the
  // group that read it has completed. The halos are written once. (An
  // unrolled prologue of 4 or more steps made ptxas serialise the wgmmas.)
#pragma unroll 1
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load_step(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();
    cg_fence_async_smem();  // copies -> wgmma
    __syncthreads();
    const int nk = kt + STAGES - 2;
    if (nk < KT) load_step(nk);
    cp_async_commit();

    const int tap = kt / chunks, c = kt - tap * chunks;
    const uint32_t st = base + (kt % STAGES) * T::STAGE;
    uint32_t a;
    if constexpr (HALO)
      a = halos + c * T::HALO_BYTES + ((wg + tap / 3) * HALO_W + tap % 3) * 128;
    else
      a = st + wg * 64 * 128;
    const uint32_t b = st + T::A_STAGE;
    cg_fence_operand(d);
    cg_wgmma_fence();
#pragma unroll
    for (int j = 0; j < CK / 16; ++j)
      cg_wgmma<BN, 0, 1>(d, cg_desc_k_sw128(a + j * 32), cg_desc_mn_sw128(b + j * 2048, B_BLOCK));
    cg_wgmma_commit();
    cg_wgmma_wait<1>();
    cg_fence_operand(d);
  }
  cg_wgmma_wait<0>();
  cg_fence_operand(d);
  cp_async_wait<0>();

  // Accumulator row r of this warpgroup: its output pixel, or -1.
  const int lane = tid & 31, r = ((tid >> 5) & 3) * 16 + (lane >> 2);
  auto pixel = [&](int rr) -> long long {
    if constexpr (HALO) {
      const int h = h0 + wg, col = w0 + rr;
      return h < H && col < W ? ((long long)n * H + h) * W + col : -1;
    } else {
      const int m = m0 + wg * 64 + rr;
      return m < M ? m : -1;
    }
  };
  const long long p0 = pixel(r), p1 = pixel(r + 8);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane & 3) * 2;
    if (c >= Cout) continue;
    const float b0 = __bfloat162float(bias[c]), b1 = __bfloat162float(bias[c + 1]);
    if (p0 >= 0)
      *reinterpret_cast<float2*>(out + p0 * Cout + c) = make_float2(d[4 * j] + b0, d[4 * j + 1] + b1);
    if (p1 >= 0)
      *reinterpret_cast<float2*>(out + p1 * Cout + c) =
          make_float2(d[4 * j + 2] + b0, d[4 * j + 3] + b1);
  }
}

template <bool HALO, int WM, int BN, int STAGES>
cudaError_t launch_conv(const bf16* x, const bf16* w, const bf16* bias, float* out, int N, int H,
                        int W, int Cin, int Cout, cudaStream_t s) {
  using T = ConvTile<HALO, WM, BN, STAGES>;
  const int smem = T::smem(Cin);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  static bool sized[CG_MAX_DEVICES] = {};
  const cudaError_t e = cg_smem_limit(conv3x3_wgmma<HALO, WM, BN, STAGES>, SMEM_MAX, sized);
  if (e != cudaSuccess) return e;
  const unsigned blocks =
      HALO ? N * ((H + WM - 1) / WM) * ((W + PW - 1) / PW) : (N * H * W + 64 * WM - 1) / (64 * WM);
  dim3 grid(blocks, (Cout + BN - 1) / BN);
  conv3x3_wgmma<HALO, WM, BN, STAGES><<<grid, T::THREADS, smem, s>>>(x, w, bias, out, N, H, W,
                                                                      Cin, Cout);
  return cudaGetLastError();
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
// scratch, then the reflect fold. A tile (kernels/resblock.py::
// DGRAD_TILES, DGRAD_SYNC) is (WGMMA, WM, BN, STAGES): 64 WM padded pixels
// x BN input channels a block, a ring of STAGES steps.
constexpr int DBM = 64, DBN = 128, DBK = 32, DSTAGES = 3, DTHREADS = 256;
constexpr int D_LD = DBK + 8;  // [row][k] rows of 80 B: conflict-free ldmatrix
constexpr int DA_TILE = DBM * D_LD;
constexpr int DB_TILE = DBN * D_LD;

// The wgmma tile: a stage holds both parts' 128 pixel rows of one tap x 64
// output channels (128 B a row, 128-byte swizzle), then B's BN rows of
// w[tap] (an input channel's 64 output channels, 128 B: K-major as stored).
template <int BN, int STAGES>
struct DgradWgmma {
  static constexpr int A_PART = 128 * 128, STAGE = 2 * A_PART + BN * 128;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + room to align to 1 KB
  static_assert(STAGES >= 3 && SMEM <= SMEM_MAX, "tile does not fit");
};

template <int NG, int NW, bool WGMMA, int BN, int STAGES>
constexpr int dgrad_smem() {
  if constexpr (WGMMA)
    return DgradWgmma<BN, STAGES>::SMEM;
  else
    return DSTAGES * (NG * DA_TILE + NW * DB_TILE) * (int)sizeof(bf16);
}

// The main path's (2, 1) case on wgmma: two warpgroups, warpgroup wg owns
// pixel rows 64 wg .. 64 wg + 63 of the 128 x BN tile and both parts: one
// m64nBNk16 product a k16 and part, hi into d[0] and lo into d[1], both
// against the same B stage. K steps of one tap x 64 output channels, tap by
// tap.
template <int BN, int STAGES>
__device__ __forceinline__ void dgrad_wgmma_tile(const bf16* __restrict__ g, size_t g_part,
                                                 const bf16* __restrict__ w,
                                                 float* __restrict__ dpad, int N, int H, int W,
                                                 int Cin, int Cout) {
  using T = DgradWgmma<BN, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const int Hp = H + 2, Wp = W + 2, M = N * Hp * Wp;
  const int chunks = (Cout + CK - 1) / CK, KT = 9 * chunks;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN;

  // Loads: 16-byte chunk c8 of A's pixel rows (tid >> 3) + 32 i (both
  // parts) and of B's rows (tid >> 3) + 32 i. Padded pixel (n, i, j) reads
  // g at (n, i - ky, j - kx), whose index n H W + (i - ky) W + j - kx is
  // a_pix - ky W - kx with a_pix = (n H + i) W + j; a_i < 0 past M.
  constexpr int A_PASSES = 128 / 32, B_PASSES = BN / 32;
  const int c8 = tid & 7, row0 = tid >> 3;
  int a_pix[A_PASSES], a_i[A_PASSES], a_j[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const int m = m0 + row0 + 32 * i;
    const int n = m / (Hp * Wp), rem = m - n * Hp * Wp;
    a_i[i] = m < M ? rem / Wp : -4;
    a_j[i] = rem - rem / Wp * Wp;
    a_pix[i] = (n * H + a_i[i]) * W + a_j[i];
  }
  auto load_step = [&](int kt) {
    const int tap = kt / chunks, co = (kt - tap * chunks) * CK + c8 * 8;
    const int ky = tap / 3, kx = tap - ky * 3;
    unsigned char* as = smem + (kt % STAGES) * T::STAGE;
    const bool co_ok = co < Cout;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const int h = a_i[i] - ky, ww = a_j[i] - kx, row = row0 + 32 * i;
      const bool ok = co_ok && h >= 0 && h < H && ww >= 0 && ww < W;
      const bf16* src = ok ? g + (size_t)(a_pix[i] - ky * W - kx) * Cout + co : g;
      unsigned char* dst = as + row * 128 + ((c8 ^ (row & 7)) << 4);
      cp_async16(dst, src, ok ? 16 : 0);
      cp_async16(dst + T::A_PART, ok ? src + g_part : g, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < B_PASSES; ++i) {
      const int row = row0 + 32 * i, ci = n0 + row;
      const bool ok = co_ok && ci < Cin;
      cp_async16(as + 2 * T::A_PART + row * 128 + ((c8 ^ (row & 7)) << 4),
                 ok ? w + ((size_t)tap * Cin + ci) * Cout + co : w, ok ? 16 : 0);
    }
  };

  float d[2][BN / 2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[p][i] = 0.f;

  // The forward's ring: copies STAGES - 2 steps ahead, one wgmma group in
  // flight, a stage refilled only after the group that read it completed.
#pragma unroll 1
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load_step(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();
    cg_fence_async_smem();  // copies -> wgmma
    __syncthreads();
    const int nk = kt + STAGES - 2;
    if (nk < KT) load_step(nk);
    cp_async_commit();

    const uint32_t st = base + (kt % STAGES) * T::STAGE, b = st + 2 * T::A_PART;
    const uint32_t a = st + wg * 64 * 128;
    cg_fence_operand(d[0]);
    cg_fence_operand(d[1]);
    cg_wgmma_fence();
#pragma unroll
    for (int j = 0; j < CK / 16; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        cg_wgmma<BN, 0, 0>(d[p], cg_desc_k_sw128(a + p * T::A_PART + j * 32),
                           cg_desc_k_sw128(b + j * 32));
    cg_wgmma_commit();
    cg_wgmma_wait<1>();
    cg_fence_operand(d[0]);
    cg_fence_operand(d[1]);
  }
  cg_wgmma_wait<0>();
  cg_fence_operand(d[0]);
  cg_fence_operand(d[1]);
  cp_async_wait<0>();

  // Accumulator row r of the warpgroup's 64; d[p][4 j ..] holds columns 8 j ..
  const int lane = tid & 31, r = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int row = m0 + wg * 64 + r;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane & 3) * 2;
    if (c >= Cin) continue;
    if (row < M)
      *reinterpret_cast<float2*>(dpad + (size_t)row * Cin + c) =
          make_float2(d[0][4 * j] + d[1][4 * j], d[0][4 * j + 1] + d[1][4 * j + 1]);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(dpad + (size_t)(row + 8) * Cin + c) =
          make_float2(d[0][4 * j + 2] + d[1][4 * j + 2], d[0][4 * j + 3] + d[1][4 * j + 3]);
  }
}

// The mma.sync tile: 8 warps as 2 (M) x 4 (N), each owning 32 x 32 of a
// 64 x 128 tile (2 x 4 mma tiles of 16 x 8), any (NG, NW).
template <int NG, int NW>
__device__ __forceinline__ void dgrad_sync_tile(const bf16* __restrict__ g, size_t g_part,
                                                const bf16* __restrict__ w, size_t w_part,
                                                float* __restrict__ dpad, int N, int H, int W,
                                                int Cin, int Cout) {
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

// Grid (ceil(N*(H+2)*(W+2) / (64 WM)), ceil(Cin / BN)):
// dpad[n, i, j, ci] = sum_{ky, kx, co} sum_{(a, b) in passes}
//   g_a[n, i-ky, j-kx, co] * w_b[ky, kx, ci, co]
// for i in [0, H+2), j in [0, W+2), with g zero outside [0, H) x [0, W);
// g_a = g + a * g_part, w_b = w + b * w_part; the passes are the (a, b)
// with a + b < max(NG, NW), the main pass (0, 0) summed apart from the
// others until the end. WGMMA takes (NG, NW) = (2, 1) alone. Needs
// Cout % 32 == 0, Cin % 8 == 0 and 16-byte aligned planes.
template <int NG, int NW, bool WGMMA, int WM, int BN, int STAGES>
__global__ void __launch_bounds__(DTHREADS, WGMMA ? 1 : 2)
dgrad_mma(const bf16* __restrict__ g, size_t g_part, const bf16* __restrict__ w,
          size_t w_part, float* __restrict__ dpad, int N, int H, int W, int Cin, int Cout) {
  if constexpr (WGMMA) {
    static_assert(NG == 2 && NW == 1 && WM == 2, "the wgmma tile: 128 rows, parts (2, 1)");
    dgrad_wgmma_tile<BN, STAGES>(g, g_part, w, dpad, N, H, W, Cin, Cout);
  } else {
    static_assert(WM == 1 && BN == DBN && STAGES == DSTAGES, "the mma.sync tile is 64 x 128");
    dgrad_sync_tile<NG, NW>(g, g_part, w, w_part, dpad, N, H, W, Cin, Cout);
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

template <int NG, int NW, bool WGMMA, int WM, int BN, int STAGES>
cudaError_t launch_dgrad(const bf16* g, const bf16* w, float* dpad, int N, int H, int W, int Cin,
                         int Cout, cudaStream_t s) {
  constexpr int smem = dgrad_smem<NG, NW, WGMMA, BN, STAGES>();
  static bool sized[CG_MAX_DEVICES] = {};
  const cudaError_t e = cg_smem_limit(dgrad_mma<NG, NW, WGMMA, WM, BN, STAGES>, smem, sized);
  if (e != cudaSuccess) return e;
  const int M = N * (H + 2) * (W + 2);
  dim3 grid((M + 64 * WM - 1) / (64 * WM), (Cin + BN - 1) / BN);
  dgrad_mma<NG, NW, WGMMA, WM, BN, STAGES><<<grid, DTHREADS, smem, s>>>(
      g, (size_t)N * H * W * Cout, w, (size_t)9 * Cin * Cout, dpad, N, H, W, Cin, Cout);
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
// bf16 runs conv3x3_wgmma on the tile (halo, rows, tile_n, stages) that
// kernels/resblock.py::conv_plan chose; float32 ignores it. Needs H, W >= 2,
// Cin % 32 == 0, Cout % 8 == 0 and 16-byte aligned x and w (checked by the
// Python wrapper). Returns the CUDA error code (0 on success).
extern "C" int cg_conv3x3_reflect(const void* x, const void* w, const void* bias, void* out,
                                  int N, int H, int W, int Cin, int Cout, int dtype, int halo,
                                  int rows, int tile_n, int stages, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H < 2 || W < 2 || Cin % 32 != 0 || Cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == CG_BF16) {
    auto xp = static_cast<const bf16*>(x);
    auto wp = static_cast<const bf16*>(w);
    auto bp = static_cast<const bf16*>(bias);
    auto op = static_cast<float*>(out);
    // The tiles of kernels/resblock.py::CONV_TILES: (halo, rows, tile_n, stages).
#define CG_CONV_TILE(HL, WM, TN, ST)                                     \
  if (halo == HL && rows == WM && tile_n == TN && stages == ST)          \
    return (int)launch_conv<HL, WM, TN, ST>(xp, wp, bp, op, N, H, W, Cin, Cout, s);
    CG_CONV_TILE(false, 2, 256, 4)
    CG_CONV_TILE(true, 2, 128, 4)
    CG_CONV_TILE(true, 2, 64, 4)
    CG_CONV_TILE(false, 2, 64, 4)
#undef CG_CONV_TILE
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == CG_F32) {
    const int M = N * H * W;
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
// [+ add]. dpad: (N, H+2, W+2, Cin) float32 scratch. (wgmma, rows, tile_n,
// stages): the tile kernels/resblock.py::dgrad_plan chose for (2, 1), or
// the mma.sync tile for (3, 3). Needs H, W >= 2, Cout % 32 == 0,
// Cin % 8 == 0 and 16-byte aligned g and w.
extern "C" int cg_conv3x3_reflect_dgrad(const void* g, const void* w, const void* add, void* out,
                                        void* dpad, int N, int H, int W, int Cin, int Cout,
                                        int ng, int nw, int wgmma, int rows, int tile_n,
                                        int stages, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto gp = static_cast<const bf16*>(g);
  auto wp = static_cast<const bf16*>(w);
  auto dp = static_cast<float*>(dpad);
  if (N <= 0 || H < 2 || W < 2 || Cin <= 0 || Cin % 8 != 0 || Cout <= 0 || Cout % 32 != 0 ||
      (long long)N * H * W * Cin >= (1LL << 31) || (out_dtype != CG_F32 && out_dtype != CG_BF16))
    return (int)cudaErrorInvalidValue;
  // kernels/resblock.py's DGRAD_TILES for (2, 1) and DGRAD_SYNC for (3, 3).
  cudaError_t e;
  if (ng == 2 && nw == 1 && wgmma && rows == 2 && tile_n == 128 && stages == 4)
    e = launch_dgrad<2, 1, true, 2, 128, 4>(gp, wp, dp, N, H, W, Cin, Cout, s);
  else if (ng == 3 && nw == 3 && !wgmma && rows == 1 && tile_n == 128 && stages == 3)
    e = launch_dgrad<3, 3, false, 1, 128, 3>(gp, wp, dp, N, H, W, Cin, Cout, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  if (out_dtype == CG_BF16) return (int)launch_fold<bf16>(dp, add, out, N, H, W, Cin, s);
  return (int)launch_fold<float>(dp, add, out, N, H, W, Cin, s);
}
