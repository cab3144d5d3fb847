// Helpers shared by the port's CUDA sources: the f32/bf16 conversions that
// every kernel uses to sum in f32 and store in x's dtype, the launch
// geometry (one warp per output row or chunk, kWarpsPerBlock a block).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

namespace sgnn {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Blocks for `rows` warps, capped; kernels stride over the rest.
inline unsigned warp_blocks(int64_t rows) {
  const int64_t want = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(want, int64_t{1} << 30)));
}

}  // namespace sgnn
