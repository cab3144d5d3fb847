// Attention aggregation for the port's whole-graph GAT serving passes:
//
//     u[e, h]   = exp(clip(leaky_relu(ts[col[e], h] + td[d, h], 0.2), +-60))
//     out[d, c] = sum over e in [rowptr[d], rowptr[d+1]) of u[e, c/fh] * ht[col[e], c]
//     z[d, h]   = sum over the same edges of u[e, h]
//     out[d, c] /= max(z[d, c/fh], FLT_MIN)
//
// with F = heads * fh columns, head h owning columns [h*fh, (h+1)*fh).
//
// Replaces sgnn_tpu/ops/pallas/mxu_gat.py::_gat_kernel (launched by
// _gat_apply, reached through mxu_gat_aggregate).  That kernel gathers the
// source rows, the score halves and the destination halves with one-hot
// matmuls only because Mosaic has no usable in-kernel gather, and pads its
// tables to 8 columns and F to 128 for the TPU's lanes; Hopper gathers
// natively, so this is the spmm.cu gather-and-sum with the weight of each
// edge computed in the kernel from the per-row score tables.  It keeps
// the JAX kernel's max-free exponential (clip at +-60, divide after the
// sum), so one pass over the edges gives both out and z.
//
// What bounds it on an H100: device-memory bytes, as the SpMM.  Each
// input read once is S*F*b + 4*H*(S + D) + 8*(D+1) + 4*E bytes, and the
// outputs D*F*b + 4*D*H (b = width of ht's dtype): about 0.09 ms at
// 3.35 TB/s for the F=128 layer of GAT 602-128-41 on the Reddit-shaped
// graph (V = 232,965, E = 11.9M).  A row gather reads ht once per edge,
// and ht (119 MB at F=128 f32) does not fit the 50 MB L2, so the gathers
// really move nearer E*F*b: about 6 GB, 1.8 ms, for that layer.  Per edge
// it adds one table read and one expf per head of a column tile.
//
// Design, simple first:
//  * one warp per destination row, kWarpsPerBlock rows per block, a grid-
//    stride loop over rows; the lanes stride the columns of a column tile,
//    COLS columns per lane, and a loop over tiles takes any F.  A tile is
//    at most 32*COLS columns and spans at most kMaxTileHeads heads (a head
//    narrower than the tile gives a tile of whole heads), so any H works;
//  * 32 edges at a time, lane k loads edge k's col and computes u for
//    edge k and each head of the tile, from td[d] loaded once per tile,
//    into a per-warp shared buffer; the warp broadcasts each edge's col
//    with __shfl_sync and every lane reads that edge's u from the buffer.
//    So each (edge, head) takes one expf per tile, not one per column;
//  * out and z are summed in f32 registers in CSR edge order.  Every lane
//    sums z for its own columns' heads (lanes of one head sum the same u
//    in the same order, so no reduction across lanes is needed); the lane
//    holding a head's first column writes z.  Each element of out and z
//    is written once, after the divide: no atomics, so the result is
//    deterministic, and a row with no edges writes zeros;
//  * ht is f32 or bf16 (bf16 rounds once, at the store); ts, td and z are
//    f32; row*F and rowptr are 64-bit.  expf, no fast math.
// Scheduling hub rows, and staging rows with cp.async/TMA, are left for
// later work.

#include <cfloat>

#include "common.cuh"

namespace {

using sgnn::from_float;
using sgnn::kFullMask;
using sgnn::kWarpsPerBlock;
using sgnn::to_float;

constexpr float kClip = 60.0f;      // == sgnn_tpu_torch/ops/gat.py ATT_CLIP
constexpr float kNegSlope = 0.2f;  // == sgnn_tpu_torch/ops/gat.py NEG_SLOPE
constexpr int kMaxTileHeads = 8;    // heads one column tile may span
constexpr int kUStride = 33;        // lanes reading other heads of one edge
                                    // fall in other shared-memory banks

__device__ __forceinline__ float attention_exp(float s) {
  s = s >= 0.0f ? s : kNegSlope * s;
  return expf(fminf(fmaxf(s, -kClip), kClip));
}

template <typename T, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_kernel(const T* __restrict__ ht, const float* __restrict__ ts,
           const float* __restrict__ td, const int64_t* __restrict__ rowptr,
           const int32_t* __restrict__ col, T* __restrict__ out,
           float* __restrict__ z, int64_t num_rows, int64_t feat, int heads,
           int64_t tile) {
  __shared__ float u_smem[kWarpsPerBlock][kMaxTileHeads * kUStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* us = u_smem[warp];
  const int64_t fh = feat / heads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // every branch below depends only on the row and the tile, so it is
  // warp-uniform and the full-mask shuffles see all 32 lanes
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    const float* td_row = td + row * heads;
    for (int64_t c0 = 0; c0 < feat; c0 += tile) {
      const int64_t c_end = min(c0 + tile, feat);
      const int h_first = static_cast<int>(c0 / fh);
      const int n_tile_heads = static_cast<int>((c_end - 1) / fh) - h_first + 1;
      int head[COLS];      // this lane's columns' heads, from the tile's first
      float acc[COLS], zacc[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        head[j] = c < c_end ? static_cast<int>(c / fh) - h_first : 0;
        acc[j] = 0.0f;
        zacc[j] = 0.0f;
      }
      float td_tile[kMaxTileHeads];
#pragma unroll
      for (int i = 0; i < kMaxTileHeads; ++i) {
        td_tile[i] = i < n_tile_heads ? td_row[h_first + i] : 0.0f;
      }
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
        const int my_col = lane < n ? col[e0 + lane] : 0;
        if (lane < n) {
          const float* ts_row =
              ts + static_cast<int64_t>(my_col) * heads + h_first;
#pragma unroll
          for (int i = 0; i < kMaxTileHeads; ++i) {
            if (i < n_tile_heads) {
              us[i * kUStride + lane] = attention_exp(ts_row[i] + td_tile[i]);
            }
          }
        }
        __syncwarp();
        for (int k = 0; k < n; ++k) {
          const int src = __shfl_sync(kFullMask, my_col, k);
          const T* x_row = ht + static_cast<int64_t>(src) * feat;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int64_t c = c0 + lane + 32 * j;
            if (c < c_end) {
              const float u = us[head[j] * kUStride + k];
              acc[j] = fmaf(u, to_float(x_row[c]), acc[j]);
              zacc[j] += u;
            }
          }
        }
        __syncwarp();  // reads done before the next chunk's writes
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        if (c < c_end) {
          out[row * feat + c] = from_float<T>(acc[j] / fmaxf(zacc[j], FLT_MIN));
          if (c % fh == 0) z[row * heads + h_first + head[j]] = zacc[j];
        }
      }
    }
  }
}

// Columns of one tile: at most 256 (8 per lane); a head narrower than
// that makes the tile whole heads, at most kMaxTileHeads of them, and a
// wider one lets a tile span at most two heads.
int64_t tile_width(int64_t feat, int64_t fh) {
  const int64_t w = std::min<int64_t>(feat, 256);
  if (fh >= w) return w;
  return fh * std::min<int64_t>(kMaxTileHeads, w / fh);
}

template <typename T, int COLS>
void launch_cols(const void* ht, const void* ts, const void* td,
                 const void* rowptr, const void* col, void* out, void* z,
                 int64_t num_rows, int64_t feat, int heads, int64_t tile,
                 cudaStream_t stream) {
  const dim3 grid(sgnn::warp_blocks(num_rows)), block(kWarpsPerBlock * 32);
  gat_kernel<T, COLS><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ht), static_cast<const float*>(ts),
      static_cast<const float*>(td), static_cast<const int64_t*>(rowptr),
      static_cast<const int32_t*>(col), static_cast<T*>(out),
      static_cast<float*>(z), num_rows, feat, heads, tile);
}

template <typename T>
void launch(const void* ht, const void* ts, const void* td, const void* rowptr,
            const void* col, void* out, void* z, int64_t num_rows,
            int64_t feat, int heads, cudaStream_t stream) {
  const int64_t tile = tile_width(feat, feat / heads);
  if (tile <= 32) {
    launch_cols<T, 1>(ht, ts, td, rowptr, col, out, z, num_rows, feat, heads,
                      tile, stream);
  } else if (tile <= 64) {
    launch_cols<T, 2>(ht, ts, td, rowptr, col, out, z, num_rows, feat, heads,
                      tile, stream);
  } else if (tile <= 128) {
    launch_cols<T, 4>(ht, ts, td, rowptr, col, out, z, num_rows, feat, heads,
                      tile, stream);
  } else {
    launch_cols<T, 8>(ht, ts, td, rowptr, col, out, z, num_rows, feat, heads,
                      tile, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of ht and out); ts, td and
// z are float32.  The caller checks shapes, dtypes, devices and index
// bounds, and passes num_rows >= 1, feat >= 1 and heads >= 1 dividing feat.
// Returns cudaGetLastError() after the launch.
extern "C" int sgnn_gat_aggregate(const void* ht, const void* ts,
                                  const void* td, const void* rowptr,
                                  const void* col, void* out, void* z,
                                  long long num_rows, long long feat,
                                  int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads < 1 || feat < 1 || feat % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    launch<float>(ht, ts, td, rowptr, col, out, z, num_rows, feat, heads, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(ht, ts, td, rowptr, col, out, z, num_rows, feat,
                          heads, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
