// Shared helpers for the Hopper kernels of cyclegan_tpu_torch.
//
// Element types cross the C interface as integer codes (see
// kernels/_build.py::DTYPE_CODES): 0 = float32, 1 = bfloat16.

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
