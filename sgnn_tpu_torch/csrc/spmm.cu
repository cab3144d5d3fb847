// CSR SpMM for the port's exact serving passes and the whole-graph
// forward, and, over the transposed CSR, K2's backward in whole-graph
// training:
//
//     out[d, :] = sum over e in [rowptr[d], rowptr[d+1]) of w[e] * x[col[e], :]
//
// Replaces sgnn_tpu/ops/pallas/mxu_spmm.py::_kernel (launched by _apply,
// reached through mxu_spmm_fwd, and on the transposed plan by _mxu_bwd).
// That kernel computes the same function as one-hot masked matmuls only
// because Mosaic has no usable in-kernel gather; Hopper gathers rows
// natively, so this is a gather-and-sum with no planner, no tile geometry
// and no edge padding.
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
// Two designs, each where it is faster on the card (PERF.md, section 6):
//  * csr_sum.cuh's edge-balanced sum, equal edges per warp, long rows in
//    pieces combined by a fixed two-level tree (sgnn_spmm_csr_sum): K2's
//    backward, over the transposed CSR (hub rows of ~1e6 edges), and the
//    forward over any CSR with a row longer than the caller's bound; K1's
//    dx shares it;
//  * a warp per row (sgnn_spmm_csr), kWarpsPerBlock rows a block, lanes
//    striding the feature columns (COLS per lane, a loop over column tiles
//    for any F), each edge's col and w loaded once per tile by one lane and
//    broadcast by __shfl_sync: the forward over a CSR whose every row fits
//    one warp (the serving CSR, keyed by destination, ~51 edges a row),
//    where it beats the edge-balanced sum.  The caller checks the rows'
//    lengths once per CSR.
// Both keep f32 sums in edge order within a row or piece and one rounding
// at the store, write each output element once (no atomics: bit-identical
// from run to run; a row with no edges writes zeros), take f32 or bf16 x
// with f32 w, and use 64-bit offsets.  Staging rows with cp.async/TMA is
// left for later work.

#include "csr_sum.cuh"

namespace {

using sgnn::from_float;
using sgnn::kFullMask;
using sgnn::kWarpsPerBlock;
using sgnn::to_float;

// Sum of w[e] * x[col[e], c0 + lane + 32 j] over edges [beg, end), in edge
// order, into acc (f32).  Warp-uniform: every lane calls it with the same
// beg, end and c0.
template <typename T, int COLS>
__device__ __forceinline__ void sum_edges(const T* __restrict__ x,
                                          const int32_t* __restrict__ col,
                                          const float* __restrict__ w,
                                          int64_t beg, int64_t end,
                                          int64_t feat, int64_t c0, int lane,
                                          float (&acc)[COLS]) {
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
}

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
      sum_edges<T, COLS>(x, col, w, beg, end, feat, c0, lane, acc);
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
  const T* xp = static_cast<const T*>(x);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int32_t* cp = static_cast<const int32_t*>(col);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  const dim3 grid(sgnn::warp_blocks(num_rows)), block(kWarpsPerBlock * 32);
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

// dtype: 0 = float32, 1 = bfloat16 (the dtype of x and out).  The row
// kernel, for a CSR whose every row fits one warp (the caller's check,
// made once per CSR).  The caller checks shapes, dtypes, devices and index
// bounds, and passes num_rows >= 1 and feat >= 1.  Returns
// cudaGetLastError() after the launch.
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

// csr_sum.cuh's sum: K2's backward, and the forward over a CSR with a row
// too long for one warp.  carry is an f32 [2 * max(1,
// ceil(max_edges / chunk)), feat] scratch and carry_row an int32 scratch
// of its rows; vec != 0 when feat % 4 == 0 and x is 16-byte aligned.  The
// caller checks shapes, dtypes, devices and index bounds, and passes
// num_rows >= 1, feat >= 1, chunk >= 1 and max_edges >= rowptr[num_rows].
// Returns cudaGetLastError() after the launches.
extern "C" int sgnn_spmm_csr_sum(const void* x, const void* rowptr,
                             const void* col, const void* w, void* out,
                             void* carry, void* carry_row, long long num_rows,
                             long long max_edges, long long chunk,
                             long long feat, int vec, int dtype,
                             void* stream) {
  return sgnn::csr_sum_dispatch(x, rowptr, col, w, out, carry, carry_row,
                                num_rows, max_edges, chunk, feat, vec, dtype,
                                static_cast<cudaStream_t>(stream));
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
