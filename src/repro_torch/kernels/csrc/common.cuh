// Shared helpers of the port's kernels: element conversion for the two
// element types every kernel is instantiated for, the dtype codes of the C
// interface, warp reductions, and the finite softmax sentinel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// dtype codes passed through the C interface (kernels/_build.py callers)
#define REPRO_DTYPE_F32 0
#define REPRO_DTYPE_BF16 1

// Finite "-inf" of the online softmax: a fully masked row keeps m = NEG_INF,
// its p's are zeroed by the mask, l stays 0, and the clamp max(l, 1e-30)
// turns 0/0 into an exact 0 (a true -inf would give NaN).
#define REPRO_NEG_INF (-1e30f)
#define REPRO_L_MIN (1e-30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
