// Shared helpers for the port's hand-written Hopper kernels.
//
// Every source in this directory is compiled on its own into a shared
// library with a plain C interface (see ops/_build.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu
// Each exported function launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>
#include <type_traits>

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<bf16>(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions for a block of NT threads (NT a multiple of 32).
// ``red`` holds NT/32 floats of shared memory. Both barriers are inside:
// the result is visible to every thread, and ``red`` may be reused at once.
template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) r += red[w];
  __syncthreads();
  return r;
}
