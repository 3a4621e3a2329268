// Shared helpers for the hand-written Hopper kernels of tell_tpu_torch.
//
// Every kernel takes fp32 or bf16 storage and computes in fp32. The C entry
// points take a dtype code (kFloat32 / kBFloat16) and the caller's stream,
// and return cudaGetLastError() after the launch so the Python wrapper can
// raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tt {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// bf16 storage rounds an fp32 value as it would be stored; fp32 keeps it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// A two's-complement nibble (0..15) as a signed int in [-8, 7]; packed
// int4 K/V hold row d in a byte's low nibble and row d + hd/2 in its high.
__device__ __forceinline__ int nibble(int n) { return n - ((n & 8) << 1); }

// Opt a kernel into more than 48 KB of dynamic shared memory when a launch
// needs it (Hopper allows up to 227 KB per block).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tt
