// Shared helpers for the kernels in this directory: element conversion
// between the storage types the kernels accept (f32, bf16) and f32 math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace reprotorch {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// VEC consecutive elements as one load/store: 16 bytes when VEC * sizeof(T)
// is 16 (the caller guarantees the alignment), one element when VEC is 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(T* dst, const T* __restrict__ src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ dst, const T* src) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = src[e];
  }
}

// Elements per 16-byte load of a storage type.
template <typename T>
constexpr int vec16() { return 16 / static_cast<int>(sizeof(T)); }

constexpr int kElementwiseThreads = 256;
constexpr int kMaxElementwiseBlocks = 132 * 8;  // 8 blocks per H100 SM, grid-stride beyond

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks for a grid-stride loop over `work` items.
inline unsigned elementwise_blocks(long long work) {
  long long b = (work + kElementwiseThreads - 1) / kElementwiseThreads;
  if (b < 1) b = 1;
  if (b > kMaxElementwiseBlocks) b = kMaxElementwiseBlocks;
  return static_cast<unsigned>(b);
}

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB),
// then report whether the launch that follows was accepted.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

constexpr size_t kMaxSmemPerBlock = 232448;  // Hopper: 227 KB per block

}  // namespace reprotorch
