// Shared helpers for the Hopper kernels of cyclegan_tpu_torch.
//
// Element types cross the C interface as integer codes (see
// kernels/_build.py::DTYPE_CODES): 0 = float32, 1 = bfloat16. The
// cp.async wrappers below feed the tensor-core kernels of resblock.cu and
// conv_dw.cu; the ldmatrix and mma.sync ones resblock.cu's.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CG_F32 0
#define CG_BF16 1

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float cg_to_f(float v) { return v; }
__device__ __forceinline__ float cg_to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T cg_from_f(float v);
template <> __device__ __forceinline__ float cg_from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 cg_from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// torch.nn.ReflectionPad2d index for a pad of 1 (needs n >= 2).
__device__ __forceinline__ int cg_reflect1(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros.
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
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` bytes on the
// current device, once a device: the attribute belongs to a device, and one
// process may launch on several (`done` holds a flag per device ordinal).
constexpr int CG_MAX_DEVICES = 64;
template <typename Kernel>
inline cudaError_t cg_smem_limit(Kernel kernel, int smem, bool (&done)[CG_MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < CG_MAX_DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && dev < CG_MAX_DEVICES) done[dev] = true;
  return e;
}

// Threads of a grid-stride loop over `total` items, 256 a block, at most
// 16 blocks an SM of an H100.
inline int cg_grid_1d(size_t total) {
  size_t blocks = (total + 255) / 256;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}
