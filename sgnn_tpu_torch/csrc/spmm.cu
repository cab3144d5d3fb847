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
//  * a warp per row (sgnn_spmm_csr), the forward over a CSR whose every
//    row fits one warp (the serving CSR, keyed by destination, ~51 edges a
//    row), where it beats the edge-balanced sum.  The caller checks the
//    rows' lengths once per CSR.  What bounded its first design (lanes
//    striding scalar columns, an edge's col and w broadcast by two
//    shuffles before each row's load, one row in flight, 64 lane slots
//    for F = 41's 41 columns) was the work per edge and its latency,
//    not bytes.  So:
//     - vector columns: where F % 4 == 0 and x is 16-byte aligned, a lane
//       holds 4 adjacent columns, one 16-byte (f32) or 8-byte (bf16) load
//       (F = 128: one a lane); else one column a load, lanes striding;
//     - edges in flight: lane k loads edge k's col and w of each 32-edge
//       window once, coalesced, and stages them in shared memory, where
//       every lane reads them (faster than broadcasting them by
//       shuffles, scripts/torch_row_kernel_variants.py); kUnroll source
//       rows are loaded before their FMAs;
//     - narrow rows: for F <= 64 the warp is two half-warps of 16 lanes
//       that take alternate edges of the row (F = 41: 16 lanes x 3
//       columns, 41 of 48 lane slots live), and add their two sums with
//       one __shfl_xor_sync at the end;
//     - a loop over column tiles of LANES * COLS * VEC columns takes any F;
//     - at most 48 registers a thread (5 blocks an SM), as K3.
// Both keep f32 sums in a fixed edge order within a row, half-warp or
// piece and one rounding at the store, write each output element once (no
// atomics: bit-identical from run to run; a row with no edges writes
// zeros), take f32 or bf16 x with f32 w, and use 64-bit offsets.  Staging
// rows with cp.async/TMA is left for later work.

#include <cstdint>

#include "csr_sum.cuh"

namespace {

using sgnn::kFullMask;
using sgnn::kUnroll;
using sgnn::kWarpsPerBlock;

// The row kernel's layout: a warp is 32 / lanes groups of `lanes` lanes,
// group g summing the edges k == g (mod 32 / lanes) of each window; lane
// l of a group holds `cols` groups of `vec` adjacent columns, group j at
// c0 + (l + lanes * j) * vec of a tile of lanes * cols * vec columns.
struct RowLayout {
  int lanes;
  int cols;
  int vec;
};

RowLayout row_layout(const void* x, int64_t feat) {
  if (feat % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    if (feat <= 64) return {16, 1, 4};
    return {32, feat <= 128 ? 1 : 2, 4};
  }
  if (feat <= 64) return {16, static_cast<int>((feat + 15) / 16), 1};
  return {32, feat <= 128 ? 4 : 8, 1};
}

// At most 48 registers a thread (5 blocks an SM).  Warp-uniform branches
// only: every full-mask shuffle and __syncwarp sees all 32 lanes.
template <typename T, int LANES, int COLS, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 5)
spmm_csr_kernel(const T* __restrict__ x, const int64_t* __restrict__ rowptr,
                const int32_t* __restrict__ col, const float* __restrict__ w,
                T* __restrict__ out, int64_t num_rows, int64_t feat) {
  constexpr int kGroups = 32 / LANES;
  constexpr int kStep = kGroups * kUnroll;  // edges of one load round
  constexpr int64_t kTile = LANES * COLS * VEC;
  __shared__ int2 stage[kWarpsPerBlock][32];  // (col, w) of a window's edges
  const int lane = threadIdx.x & 31;
  const int grp = lane / LANES;
  int2* my_stage = stage[threadIdx.x >> 5];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    for (int64_t c0 = 0; c0 < feat; c0 += kTile) {
      int64_t c[COLS];
      bool live[COLS];
      float acc[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        c[j] = c0 + static_cast<int64_t>(lane % LANES + LANES * j) * VEC;
        live[j] = c[j] < feat;  // VEC columns all in or all out
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[j][q] = 0.0f;
      }
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
        int my_col = 0;
        float my_w = 0.0f;
        if (lane < n) {
          my_col = col[e0 + lane];
          my_w = w[e0 + lane];
        }
        my_stage[lane] = make_int2(my_col, __float_as_int(my_w));
        __syncwarp();
        for (int k = 0; k < n; k += kStep) {
          float v[kUnroll][COLS][VEC];
          float wk[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int e = k + u * kGroups + grp;  // this group's edge
            const int2 s = my_stage[e & 31];
            wk[u] = __int_as_float(s.y);
            const T* x_row = x + static_cast<int64_t>(s.x) * feat;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              if (e < n && live[j]) {
                sgnn::load_cols<T, VEC>(x_row + c[j], v[u][j]);
              } else {
#pragma unroll
                for (int q = 0; q < VEC; ++q) v[u][j][q] = 0.0f;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (k + u * kGroups + grp < n) {
#pragma unroll
              for (int j = 0; j < COLS; ++j) {
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                  acc[j][q] = fmaf(wk[u], v[u][j][q], acc[j][q]);
                }
              }
            }
          }
        }
        __syncwarp();  // reads done before the next window's writes
      }
      if constexpr (kGroups == 2) {  // the odd edges' sum onto the even's
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            acc[j][q] += __shfl_xor_sync(kFullMask, acc[j][q], 16);
          }
        }
      }
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          if (live[j]) {
            sgnn::store_cols<T, VEC>(out + row * feat + c[j], acc[j]);
          }
        }
      }
    }
  }
}

template <typename T>
using RowKernel = void (*)(const T*, const int64_t*, const int32_t*,
                           const float*, T*, int64_t, int64_t);

// spmm_csr_kernel's instance for a layout.
template <typename T>
RowKernel<T> row_kernel(const RowLayout& l) {
  if (l.vec == 4) {
    if (l.lanes == 16) return spmm_csr_kernel<T, 16, 1, 4>;
    return l.cols == 1 ? spmm_csr_kernel<T, 32, 1, 4>
                       : spmm_csr_kernel<T, 32, 2, 4>;
  }
  if (l.lanes == 16) {
    switch (l.cols) {
      case 1: return spmm_csr_kernel<T, 16, 1, 1>;
      case 2: return spmm_csr_kernel<T, 16, 2, 1>;
      case 3: return spmm_csr_kernel<T, 16, 3, 1>;
      default: return spmm_csr_kernel<T, 16, 4, 1>;
    }
  }
  return l.cols == 4 ? spmm_csr_kernel<T, 32, 4, 1>
                     : spmm_csr_kernel<T, 32, 8, 1>;
}

template <typename T>
void launch(const void* x, const void* rowptr, const void* col, const void* w,
            void* out, int64_t num_rows, int64_t feat, cudaStream_t stream) {
  row_kernel<T>(row_layout(x, feat))
      <<<sgnn::warp_blocks(num_rows), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const int64_t*>(rowptr),
          static_cast<const int32_t*>(col), static_cast<const float*>(w),
          static_cast<T*>(out), num_rows, feat);
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

// The row kernel's layout for x (its address, width and dtype): lanes of
// a group (16: half-warps on alternate edges), column groups a lane,
// columns a load (4: vector; 1: scalar), and that instance's registers
// and local memory (spills) a thread as the loaded module reports them
// (cudaFuncGetAttributes).  Returns its error code.
extern "C" int sgnn_spmm_csr_layout(const void* x, long long feat, int dtype,
                                    int* lanes, int* cols, int* vec,
                                    int* registers, int* local_bytes) {
  const RowLayout l = row_layout(x, feat);
  *lanes = l.lanes;
  *cols = l.cols;
  *vec = l.vec;
  cudaFuncAttributes a{};
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = cudaFuncGetAttributes(&a, row_kernel<float>(l));
  } else if (dtype == 1) {
    rc = cudaFuncGetAttributes(&a, row_kernel<__nv_bfloat16>(l));
  }
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(rc);
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
