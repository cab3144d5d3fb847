// CSR SpMM for the port's exact serving passes and, over the transposed
// CSR, for K2's backward in whole-graph training:
//
//     out[d, :] = sum over e in [rowptr[d], rowptr[d+1]) of w[e] * x[col[e], :]
//
// Replaces sgnn_tpu/ops/pallas/mxu_spmm.py::_kernel (launched by _apply,
// reached through mxu_spmm_fwd, and on the transposed plan by _mxu_bwd).
// That kernel computes the same function as one-hot masked matmuls only
// because Mosaic has no usable in-kernel gather; Hopper gathers rows
// natively, so this is a plain gather-and-sum with no planner, no tile
// geometry and no edge padding.
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
//    the store); row*F and rowptr are 64-bit;
//  * a row of more than `long_row` edges (a hub source of the transposed
//    CSR: the Reddit-shaped graph's largest has ~8% of all edges) would
//    keep one warp busy while the rest of the card idles, and one f32 sum
//    over ~1e6 terms strays by ~sqrt(n) roundings.  Such rows are split:
//    the main kernel skips them, spmm_segment_kernel gives each segment of
//    `long_row` edges its own warp and partial row (seg_ptr, the running
//    count of segments per row, is computed by the caller), and
//    spmm_combine_kernel sums each long row's partials in segment order.
//    No atomics: still deterministic.
// Staging rows with cp.async/TMA is left for later work.

#include "common.cuh"

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
                T* __restrict__ out, int64_t num_rows, int64_t feat,
                int64_t long_row) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // every branch below depends only on the row, so it is warp-uniform and
  // the full-mask shuffles see all 32 lanes
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    if (end - beg > long_row) continue;  // spmm_segment_kernel's
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

// One warp per segment of `long_row` edges of a long row; segment s's f32
// partial row goes to partial[s].  seg_ptr[r] counts the segments of rows
// 0..r, so segment s belongs to the first row r with seg_ptr[r] > s.
template <typename T, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_segment_kernel(const T* __restrict__ x,
                    const int64_t* __restrict__ rowptr,
                    const int32_t* __restrict__ col,
                    const float* __restrict__ w,
                    const int64_t* __restrict__ seg_ptr,
                    float* __restrict__ partial, int64_t num_rows,
                    int64_t feat, int64_t long_row) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t n_seg = seg_ptr[num_rows - 1];
  for (int64_t s = first; s < n_seg; s += stride) {
    const int64_t row = sgnn::segment_row(seg_ptr, num_rows, s);
    const int64_t k = s - (row > 0 ? seg_ptr[row - 1] : 0);
    const int64_t beg = rowptr[row] + k * long_row;
    const int64_t end = min(beg + long_row, rowptr[row + 1]);
    for (int64_t c0 = 0; c0 < feat; c0 += 32 * COLS) {
      float acc[COLS];
      sum_edges<T, COLS>(x, col, w, beg, end, feat, c0, lane, acc);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        if (c < feat) partial[s * feat + c] = acc[j];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_combine_kernel(const float* __restrict__ partial,
                    const int64_t* __restrict__ seg_ptr, T* __restrict__ out,
                    int64_t num_rows, int64_t feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t s0 = row > 0 ? seg_ptr[row - 1] : 0;
    const int64_t s1 = seg_ptr[row];
    for (int64_t c = lane; s1 > s0 && c < feat; c += 32) {
      float a = 0.0f;
      for (int64_t s = s0; s < s1; ++s) a += partial[s * feat + c];
      out[row * feat + c] = from_float<T>(a);
    }
  }
}

template <typename T, int COLS>
void launch_cols(const T* xp, const int64_t* rp, const int32_t* cp,
                 const float* wp, T* op, const int64_t* sp, float* pp,
                 int64_t num_rows, int64_t feat, int64_t long_row,
                 int64_t max_segments, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  spmm_csr_kernel<T, COLS><<<sgnn::warp_blocks(num_rows), block, 0, stream>>>(
      xp, rp, cp, wp, op, num_rows, feat, long_row);
  spmm_segment_kernel<T, COLS>
      <<<sgnn::warp_blocks(max_segments), block, 0, stream>>>(
          xp, rp, cp, wp, sp, pp, num_rows, feat, long_row);
  spmm_combine_kernel<T><<<sgnn::warp_blocks(num_rows), block, 0, stream>>>(
      pp, sp, op, num_rows, feat);
}

template <typename T>
void launch(const void* x, const void* rowptr, const void* col, const void* w,
            void* out, const void* seg_ptr, void* partial, int64_t num_rows,
            int64_t feat, int64_t long_row, int64_t max_segments,
            cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int32_t* cp = static_cast<const int32_t*>(col);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  const int64_t* sp = static_cast<const int64_t*>(seg_ptr);
  float* pp = static_cast<float*>(partial);
  if (feat <= 32) {
    launch_cols<T, 1>(xp, rp, cp, wp, op, sp, pp, num_rows, feat, long_row,
                      max_segments, stream);
  } else if (feat <= 64) {
    launch_cols<T, 2>(xp, rp, cp, wp, op, sp, pp, num_rows, feat, long_row,
                      max_segments, stream);
  } else if (feat <= 128) {
    launch_cols<T, 4>(xp, rp, cp, wp, op, sp, pp, num_rows, feat, long_row,
                      max_segments, stream);
  } else {
    launch_cols<T, 8>(xp, rp, cp, wp, op, sp, pp, num_rows, feat, long_row,
                      max_segments, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of x and out).  seg_ptr
// [num_rows] int64 is the inclusive running count of each row's segments
// (ceil(len / long_row) for rows longer than long_row, else 0), partial an
// f32 [max_segments, feat] scratch with max_segments >= seg_ptr's last
// entry.  The caller checks shapes, dtypes, devices and index bounds, and
// passes num_rows >= 1, feat >= 1 and long_row >= 1.  Returns
// cudaGetLastError() after the launches.
extern "C" int sgnn_spmm_csr(const void* x, const void* rowptr,
                             const void* col, const void* w, void* out,
                             const void* seg_ptr, void* partial,
                             long long num_rows, long long feat,
                             long long long_row, long long max_segments,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (long_row < 1 || max_segments < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    launch<float>(x, rowptr, col, w, out, seg_ptr, partial, num_rows, feat,
                  long_row, max_segments, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, rowptr, col, w, out, seg_ptr, partial, num_rows,
                          feat, long_row, max_segments, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
