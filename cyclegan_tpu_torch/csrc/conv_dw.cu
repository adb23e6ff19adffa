// Weight gradient of a VALID stride-1 k x k convolution over an input that
// is already padded, on the bf16 tensor cores of Hopper (sm_90a).
//
// Replaces: cyclegan_tpu/kernels/conv_dw.py, the Pallas kernel conv_dw
// (_dw_kernel), which keeps one batch cell's padded input and output
// gradient in VMEM and accumulates
//   dw[s, t] = sum_n xp[n, s:s+H, t:t+W, :]^T dy[n]        (k, k, Cin, Cout)
// over its sequential batch grid in float32. The JAX package routes the
// weight gradient of the trunk's reflect-padded 3x3 convolutions through it
// (ops/functional.py::conv2d_valid_dw_fused); the port does the same for the
// --use_dropout trunk. The same kernel is the weight half of the residual
// blocks' VJPs (cyclegan_tpu/kernels/resblock.py::_bwd_dw_kernel and the
// chunked _backward_chunked): kernels/resblock.py calls it with k = 3 on
// their unpadded input, which it reads through reflect indexing (REFLECT),
// and on the bf16 parts of the cotangent that the norm VJP wrote.
//
// The GEMM: dw[(tap, ci), co] = sum over pixels q of
//   xp[pixel q shifted by tap, ci] * dy[q, co],
// M = k*k*Cin rows ordered like the HWIO weight, N = Cout, K = N*H*W
// pixels. Operands are bf16 "parts": a bf16 tensor is one part; cg_bf16_parts
// splits a float32 tensor t into hi = bf16(t), mid = bf16(t - hi) and, where
// asked, lo = bf16(t - hi - mid) (|t - hi - mid| <= 2^-16 |t|, |t - hi - mid
// - lo| <= 2^-24 |t|). The products (a, b) of the parts with a + b < max(na,
// nb) go into one float32 accumulator. A bf16 x with a float32 cotangent of
// two parts costs two passes and errs by ~2^-16 of the product's terms,
// well inside the float32 bars; float32 on both sides uses three parts
// each and six passes, products exact to float32 rounding like the FFMA it
// replaces, which the float32 train step's loss check needs (two parts
// there moved d_total by 1.04% at step 3 on path A, past its 1% bar). The
// bf16 operands of conv_dw's main path cost one pass; a channel count that
// is not a multiple of 8 (the tiles' 16-byte rows) goes through
// cg_bf16_parts, which zero-fills it up to one, and kernels/conv_dw.py cuts
// dw back to the real channels, so any count runs here. No TF32. All passes
// share one accumulator (its 128 registers a thread leave no room for a
// second); the tensor cores' truncating float32 accumulation then costs the
// six-pass float32 case under 0.75 of its bar (resblock.cu's input
// gradient keeps its correction passes apart).
//
// What bounds it on the H100: operations. 2 * 9 * 256 * 256 * 8192 = 9.7
// GFLOP per pass at the batch-2 trunk shape against ~11 MB moved, ~900
// flop/byte, far above the ~295 where HBM would bind: ~10 us a pass at the
// 989 TFLOP/s bf16 rate.
//
// What the design does about that: wgmma, Hopper's warpgroup product, which
// reads both operands from shared memory, so no register round trip bounds
// it. A 128 x 256 output tile per block, two warpgroups of 64 x 256, one
// m64n256k16 per 16 pixels and pass. Both operands are pixel-major in
// memory, so the tiles are stored MN-major ([pixel][64 channels] rows of
// 128 B) with the 128-byte swizzle that wgmma's descriptors name; cp.async
// writes each 16-byte chunk to its swizzled place, a 4-stage ring runs the
// copies two stages ahead and keeps one wgmma group in flight (an mma.sync
// version with ldmatrix, bitwise equal, was slower at every pass count on
// an H100). 2304 x 256 has only 18 output tiles, so the
// pixels are split into a number of chunks fixed by the shapes
// (kernels/conv_dw.py::_wgrad_split, one block an SM); each block writes
// float32 partials of its chunk and dw_reduce adds them in chunk order (no
// atomics: two runs give bitwise-equal dw). TMA loads and a persistent,
// warp-specialised schedule are the next steps.

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 32, THREADS = 256;
constexpr int BLOCK_BYTES = BK * 128;  // a 64-wide block: BK rows of 128 B
constexpr int A_TILE = BM / 64 * BLOCK_BYTES;
constexpr int B_TILE = BN / 64 * BLOCK_BYTES;

// Ring depth: 4 tiles, 3 when six parts of 24 KB a stage would not fit.
__host__ __device__ constexpr int stages(int na, int nb) { return na + nb > 4 ? 3 : 4; }
constexpr int smem_bytes(int na, int nb) {
  return stages(na, nb) * (na * A_TILE + nb * B_TILE) + 1024;  // + room to align to 1 KB
}

// Grid (ceil(k*k*Cin / BM), ceil(Cout / BN), splits); two warpgroups, each
// owning 64 rows x 256 columns of the tile (one m64n256k16 per 16 pixels and
// pass). part[s, m, co] = sum over the pixels q of chunk s (q = (n*H + i)*W
// + j) of sum_{(a, b) in passes} xp_a[n, i + ky, j + kx, ci] * dy_b[n, i, j,
// co], m = (ky*k + kx)*Cin + ci. xp_a = xp + a * xp_part, dy_b = dy + b *
// dy_part; the passes are the (a, b) with a + b < max(NA, NB). Needs
// Cin % 8 == 0, Cout % 8 == 0 and 16-byte aligned planes.
// REFLECT (k = 3): xp is the unpadded (N, H, W, Cin) input, and A reads
// xp[n, reflect1(i + ky - 1, H), reflect1(j + kx - 1, W), ci], the value a
// reflect-padded copy holds at (n, i + ky, j + kx): the same bytes reach
// shared memory, and no padded copy is made (the residual blocks' dw).
template <int NA, int NB, bool REFLECT>
__global__ void __launch_bounds__(THREADS, 1)
wgrad_wgmma(const bf16* __restrict__ xp, size_t xp_part, const bf16* __restrict__ dy,
            size_t dy_part, float* __restrict__ part, int N, int H, int W, int Cin, int Cout,
            int k, int kchunk) {
  constexpr int STAGES = stages(NA, NB), PASSES = NA > NB ? NA : NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t As = (raw + 1023) & ~1023u, Bs = As + STAGES * NA * A_TILE;
  unsigned char* a_smem = smem_raw + (As - raw);
  unsigned char* b_smem = a_smem + STAGES * NA * A_TILE;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int Hp = H + k - 1, Wp = W + k - 1;
  const int M = k * k * Cin, K = N * H * W, HW = H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, sp = blockIdx.z;
  const int kbeg = sp * kchunk, kend = min(K, kbeg + kchunk);

  // Loads: A's 16-byte chunk (tid & 15) of pixel rows (tid >> 4) and
  // (tid >> 4) + 16; B's chunk (tid & 31) of rows (tid >> 5) + 8 i.
  const int a_c = tid & 15;
  const int am = m0 + a_c * 8;
  const bool a_col_ok = am < M;
  const int tap = a_col_ok ? am / Cin : 0;
  const size_t a_col_off =
      ((size_t)(tap / k) * Wp + tap % k) * Cin + (a_col_ok ? am - tap * Cin : 0);
  const int a_ky = tap / k, a_kx = tap % k, a_ci = a_col_ok ? am - tap * Cin : 0;  // REFLECT
  const int b_c = tid & 31;
  const bool b_col_ok = n0 + b_c * 8 < Cout;

  auto load_stage = [&](int stage, int kt) {
    const int q0 = kbeg + kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 4) + i * 16;
      const int q = q0 + row;
      const bool ok = q < kend && a_col_ok;
      const int qq = ok ? q : 0;
      const int n = qq / HW, rem = qq - n * HW;
      const int pi = rem / W, pj = rem - pi * W;
      size_t off;
      if constexpr (REFLECT)
        off = (((size_t)n * H + cg_reflect1(pi + a_ky - 1, H)) * W +
               cg_reflect1(pj + a_kx - 1, W)) * Cin + a_ci;
      else
        off = (((size_t)n * Hp + pi) * Wp + pj) * Cin + a_col_off;
#pragma unroll
      for (int p = 0; p < NA; ++p)
        cp_async16(a_smem + (stage * NA + p) * A_TILE + cg_swz(row, a_c, BLOCK_BYTES),
                   ok ? xp + p * xp_part + off : xp, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = (tid >> 5) + i * 8;
      const int q = q0 + row;
      const bool ok = q < kend && b_col_ok;
      const size_t off = (size_t)(ok ? q : 0) * Cout + n0 + b_c * 8;
#pragma unroll
      for (int p = 0; p < NB; ++p)
        cp_async16(b_smem + (stage * NB + p) * B_TILE + cg_swz(row, b_c, BLOCK_BYTES),
                   ok ? dy + p * dy_part + off : dy, ok ? 16 : 0);
    }
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;

  // A ring of STAGES tiles: copies run STAGES - 2 stages ahead, and one
  // stage's wgmma group stays in flight while the next is issued; a stage
  // is refilled only after the group that read it has completed.
  const int KT = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 3>();
    cg_fence_async_smem();  // copies -> wgmma
    __syncthreads();
    const int nk = kt + STAGES - 2;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const int st = kt % STAGES;
    cg_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
#pragma unroll
      for (int pa = 0; pa < NA; ++pa) {
        const uint64_t da =
            cg_desc_mn_sw128(As + (st * NA + pa) * A_TILE + wg * BLOCK_BYTES + kk * 128,
                             BLOCK_BYTES);
#pragma unroll
        for (int pb = 0; pb < NB && pa + pb < PASSES; ++pb)
          cg_wgmma<256, 1, 1>(
              d, da, cg_desc_mn_sw128(Bs + (st * NB + pb) * B_TILE + kk * 128, BLOCK_BYTES));
      }
    }
    cg_wgmma_commit();
    cg_wgmma_wait<1>();
  }
  cg_wgmma_wait<0>();
  cp_async_wait<0>();

  // The accumulator layout of m64nNk16: warp w of the warpgroup owns rows
  // 16 w .. 16 w + 15; d[4 j .. 4 j + 3] is the m16n8 fragment of columns
  // 8 j .. 8 j + 7 (rows lane / 4 and lane / 4 + 8).
  const int lane = tid & 31;
  float* dst = part + (size_t)sp * M * Cout;
  const int row = m0 + wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane & 3) * 2;
    if (c >= Cout) continue;
    if (row < M)
      *reinterpret_cast<float2*>(dst + (size_t)row * Cout + c) =
          make_float2(d[4 * j], d[4 * j + 1]);
    if (row + 8 < M)
      *reinterpret_cast<float2*>(dst + (size_t)(row + 8) * Cout + c) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// dw[i] = sum_s part[s, i] in chunk order, written as TOut.
template <typename TOut>
__global__ void __launch_bounds__(256)
dw_reduce(const float* __restrict__ part, TOut* __restrict__ dw, int splits, size_t MN) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += part[(size_t)sp * MN + i];
    dw[i] = cg_from_f<TOut>(s);
  }
}

// dst[p, n, i, j, c8..c8+7] = part p of src[n, reflect(i - pad), reflect(j -
// pad), c8..] for the padded plane (H + 2 pad, W + 2 pad), with C rounded
// up to a multiple of 8 and the channels past C zero; part 0 = bf16(v),
// part 1 = bf16(v - part 0), part 2 = bf16(v - part 0 - part 1). One thread
// per 8 channels.
template <typename T>
__global__ void __launch_bounds__(256)
bf16_parts(const T* __restrict__ src, bf16* __restrict__ dst, int N, int H, int W, int C,
           int pad, int parts) {
  const int Hp = H + 2 * pad, Wp = W + 2 * pad, C8 = (C + 7) / 8;
  const int total = N * Hp * Wp * C8;
  const size_t plane = (size_t)total * 8;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int c8 = idx % C8;
    int rest = idx / C8;
    const int j = rest % Wp;
    rest /= Wp;
    const int i = rest % Hp;
    const int n = rest / Hp;
    const int si = pad ? cg_reflect1(i - pad, H) : i, sj = pad ? cg_reflect1(j - pad, W) : j;
    const T* s = src + ((size_t)(n * H + si) * W + sj) * C + c8 * 8;
    __align__(16) bf16 part_of[3][8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = c8 * 8 + e < C ? cg_to_f(s[e]) : 0.f;
#pragma unroll
      for (int p = 0; p < 3; ++p) {  // each part rounds what the ones before left
        part_of[p][e] = __float2bfloat16_rn(v);
        v -= __bfloat162float(part_of[p][e]);
      }
    }
    for (int p = 0; p < parts; ++p)
      *reinterpret_cast<uint4*>(dst + p * plane + (size_t)idx * 8) =
          *reinterpret_cast<const uint4*>(part_of[p]);
  }
}

template <int NA, int NB, bool REFLECT>
cudaError_t launch_wgrad(const bf16* xp, const bf16* dy, float* part, int N, int H, int W,
                         int Cin, int Cout, int k, int splits, int kchunk, cudaStream_t s) {
  constexpr int smem = smem_bytes(NA, NB);
  static bool sized[CG_MAX_DEVICES] = {};
  const cudaError_t e = cg_smem_limit(wgrad_wgmma<NA, NB, REFLECT>, smem, sized);
  if (e != cudaSuccess) return e;
  const size_t xp_part =
      REFLECT ? (size_t)N * H * W * Cin : (size_t)N * (H + k - 1) * (W + k - 1) * Cin;
  const size_t dy_part = (size_t)N * H * W * Cout;
  dim3 grid((k * k * Cin + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  wgrad_wgmma<NA, NB, REFLECT><<<grid, THREADS, smem, s>>>(xp, xp_part, dy, dy_part, part, N,
                                                           H, W, Cin, Cout, k, kchunk);
  return cudaGetLastError();
}

}  // namespace

// The bf16 parts of src (N, H, W, C) of src_dtype (0 f32, 1 bf16), reflect
// padded by pad (0 or 1): dst (parts, N, H + 2 pad, W + 2 pad, C8) bf16,
// C8 = C rounded up to a multiple of 8, zero past C. parts is 1, 2 or 3 (2
// and 3 only for a float32 src). Needs H, W >= 2 when pad is 1, a padded
// plane under 2^31 elements and a 16-byte aligned dst.
extern "C" int cg_bf16_parts(const void* src, void* dst, int N, int H, int W, int C, int pad,
                             int parts, int src_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || pad < 0 || pad > 1 ||
      (pad && (H < 2 || W < 2)) || parts < 1 || parts > 3 ||
      (parts > 1 && src_dtype != CG_F32) ||
      (long long)N * (H + 2 * pad) * (W + 2 * pad) * ((C + 7) / 8 * 8) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int grid = cg_grid_1d((size_t)N * (H + 2 * pad) * (W + 2 * pad) * ((C + 7) / 8));
  auto d = static_cast<bf16*>(dst);
  if (src_dtype == CG_F32)
    bf16_parts<float><<<grid, 256, 0, s>>>(static_cast<const float*>(src), d, N, H, W, C, pad,
                                           parts);
  else if (src_dtype == CG_BF16)
    bf16_parts<bf16><<<grid, 256, 0, s>>>(static_cast<const bf16*>(src), d, N, H, W, C, pad,
                                          parts);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// xp: (na, N, H+k-1, W+k-1, Cin) and dy: (nb, N, H, W, Cout), the bf16
// parts of the padded input and of the output gradient ((na, nb) is (1, 1),
// (1, 2) or (3, 3)); with reflect 1 (k = 3, H, W >= 2, (na, nb) (1, 2) or
// (3, 3)) xp is the unpadded (na, N, H, W, Cin), read through reflect
// padding of 1;
// dw: (k, k, Cin, Cout) of out_dtype (0 f32, 1 bf16), summed over the batch.
// part: (splits, k*k*Cin, Cout) float32 scratch; chunk s covers pixels
// [s*kchunk, (s+1)*kchunk) of N*H*W. Needs Cin % 8 == 0, Cout % 8 == 0 and
// 16-byte aligned xp and dy. Returns the CUDA error code (0 on success).
extern "C" int cg_conv_dw(const void* xp, const void* dy, void* dw, void* part, int N, int H,
                          int W, int Cin, int Cout, int k, int splits, int kchunk, int na,
                          int nb, int reflect, int out_dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const bf16*>(xp);
  auto g = static_cast<const bf16*>(dy);
  auto p = static_cast<float*>(part);
  if (N <= 0 || H <= 0 || W <= 0 || k <= 0 || Cin % 8 != 0 || Cout % 8 != 0 || Cin <= 0 ||
      Cout <= 0 || splits <= 0 || kchunk <= 0 ||
      (long long)splits * kchunk < (long long)N * H * W || reflect < 0 || reflect > 1 ||
      (reflect && (k != 3 || H < 2 || W < 2)))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (!reflect && na == 1 && nb == 1)
    e = launch_wgrad<1, 1, false>(x, g, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  else if (!reflect && na == 1 && nb == 2)
    e = launch_wgrad<1, 2, false>(x, g, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  else if (!reflect && na == 3 && nb == 3)
    e = launch_wgrad<3, 3, false>(x, g, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  else if (reflect && na == 1 && nb == 2)
    e = launch_wgrad<1, 2, true>(x, g, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  else if (reflect && na == 3 && nb == 3)
    e = launch_wgrad<3, 3, true>(x, g, p, N, H, W, Cin, Cout, k, splits, kchunk, s);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const size_t MN = (size_t)k * k * Cin * Cout;
  if (out_dtype == CG_F32)
    dw_reduce<float><<<cg_grid_1d(MN), 256, 0, s>>>(p, static_cast<float*>(dw), splits, MN);
  else if (out_dtype == CG_BF16)
    dw_reduce<bf16><<<cg_grid_1d(MN), 256, 0, s>>>(p, static_cast<bf16*>(dw), splits, MN);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
