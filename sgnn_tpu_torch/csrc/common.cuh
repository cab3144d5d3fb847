// Helpers shared by the port's CUDA sources: the f32/bf16 conversions that
// every kernel uses to sum in f32 and store in x's dtype, the launch
// geometry (one warp per output row, kWarpsPerBlock rows per block) and the
// segment lookup of split long rows.
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

// The row of segment s: the first r in [0, num_rows) with seg_ptr[r] > s,
// where seg_ptr is the inclusive running count of each row's segments of a
// split long row (spmm.cu, gat_bwd.cu).
__device__ __forceinline__ int64_t segment_row(const int64_t* seg_ptr,
                                               int64_t num_rows, int64_t s) {
  int64_t lo = 0, hi = num_rows - 1;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (seg_ptr[mid] > s) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// Blocks for `rows` warps, capped; kernels stride over the rest.
inline unsigned warp_blocks(int64_t rows) {
  const int64_t want = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(want, int64_t{1} << 30)));
}

}  // namespace sgnn
