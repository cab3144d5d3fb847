// CSR SpMM for the port's exact serving passes:
//
//     out[d, :] = sum over e in [rowptr[d], rowptr[d+1]) of w[e] * x[col[e], :]
//
// Replaces sgnn_tpu/ops/pallas/mxu_spmm.py::_kernel (launched by _apply,
// reached through mxu_spmm_fwd).  That kernel computes the same function as
// one-hot masked matmuls only because Mosaic has no usable in-kernel
// gather; Hopper gathers rows natively, so this is a plain gather-and-sum
// with no planner, no tile geometry and no edge padding.
//
// What bounds it on an H100: device-memory bytes.  It does 2*E*F flops on
// E*(4+4) + 8*(V+1) + (V_src + V)*F*b bytes when every input is read once
// (b = width of x's dtype), about 0.1 ms of HBM time for the F=128 f32
// layer of GCN 602-128-41 on the Reddit-shaped graph (V = 232,965,
// E = 11.9M).  A row gather reads x once per edge, though, and x (119 MB at
// F=128 f32) does not fit the 50 MB L2, so the traffic the gathers really
// cause is nearer E*(4+4) + 8*(V+1) + E*F*b + V*F*b: about 6 GB, 1.9 ms at
// 3.35 TB/s, for that layer.
//
// Design, simple first:
//  * one warp per destination row, kWarpsPerBlock rows per block, a grid-
//    stride loop over rows;
//  * the lanes stride the feature columns, COLS columns per lane (a template
//    parameter picked from F), and a loop over column tiles takes any F;
//  * each edge's col and w are loaded once per column tile by one lane and
//    broadcast across the warp with __shfl_sync, so for F <= 256 they are
//    read exactly once;
//  * the sum is kept in f32 registers, in CSR edge order, and each output
//    element is written exactly once: no atomics, so the result is
//    deterministic, and a row with no edges writes zeros;
//  * x is f32 or bf16, w is f32, out has x's dtype (bf16 rounds once, at
//    the store); row*F and rowptr are 64-bit.
// Staging rows with cp.async/TMA and scheduling hub rows by degree are left
// for later work.

#include "common.cuh"

namespace {

using sgnn::from_float;
using sgnn::kFullMask;
using sgnn::kWarpsPerBlock;
using sgnn::to_float;

template <typename T, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_csr_kernel(const T* __restrict__ x, const int64_t* __restrict__ rowptr,
                const int32_t* __restrict__ col, const float* __restrict__ w,
                T* __restrict__ out, int64_t num_rows, int64_t feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // every branch below depends only on the row, so it is warp-uniform and
  // the full-mask shuffles see all 32 lanes
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    T* out_row = out + row * feat;
    for (int64_t c0 = 0; c0 < feat; c0 += 32 * COLS) {
      float acc[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[j] = 0.0f;
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
        int my_col = 0;
        float my_w = 0.0f;
        if (lane < n) {
          my_col = col[e0 + lane];
          my_w = w[e0 + lane];
        }
        for (int k = 0; k < n; ++k) {
          const int src = __shfl_sync(kFullMask, my_col, k);
          const float wk = __shfl_sync(kFullMask, my_w, k);
          const T* x_row = x + static_cast<int64_t>(src) * feat;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int64_t c = c0 + lane + 32 * j;
            if (c < feat) acc[j] = fmaf(wk, to_float(x_row[c]), acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        if (c < feat) out_row[c] = from_float<T>(acc[j]);
      }
    }
  }
}

template <typename T>
void launch(const void* x, const void* rowptr, const void* col, const void* w,
            void* out, int64_t num_rows, int64_t feat, cudaStream_t stream) {
  const dim3 grid(sgnn::warp_blocks(num_rows)), block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int32_t* cp = static_cast<const int32_t*>(col);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  if (feat <= 32) {
    spmm_csr_kernel<T, 1><<<grid, block, 0, stream>>>(xp, rp, cp, wp, op,
                                                      num_rows, feat);
  } else if (feat <= 64) {
    spmm_csr_kernel<T, 2><<<grid, block, 0, stream>>>(xp, rp, cp, wp, op,
                                                      num_rows, feat);
  } else if (feat <= 128) {
    spmm_csr_kernel<T, 4><<<grid, block, 0, stream>>>(xp, rp, cp, wp, op,
                                                      num_rows, feat);
  } else {
    spmm_csr_kernel<T, 8><<<grid, block, 0, stream>>>(xp, rp, cp, wp, op,
                                                      num_rows, feat);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of x and out).  The caller
// checks shapes, dtypes, devices and index bounds, and passes num_rows >= 1
// and feat >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int sgnn_spmm_csr(const void* x, const void* rowptr,
                             const void* col, const void* w, void* out,
                             long long num_rows, long long feat, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, rowptr, col, w, out, num_rows, feat, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, rowptr, col, w, out, num_rows, feat, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
