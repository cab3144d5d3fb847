// K4, the backward of the attention aggregation (gat.cu), for the port's
// whole-graph GAT training.  With G = dL/dh, per destination d and head h
// the z-folded operands Gz[d] = G[d]/z[d,h] and rz[d,h] = <G[d], h[d]>/z[d,h]
// (both 0 where z = 0) are computed by the caller; per edge e = (s -> d):
//
//     score = ts[s,h] + td[d,h];  lr = leaky_relu(score, 0.2)
//     u     = exp(clip(lr, +-60))
//     t_e   = <Gz[d, head h], ht[s, head h]>
//     q_e   = u * lrelu'(score) * [|lr| <= 60] * (t_e - rz[d,h])   (= dL/dscore)
//
//   B1, one warp per SOURCE row over the transposed CSR (col = destinations):
//     dht_agg[s, head h] = sum_e u * Gz[d, head h];   dts[s,h] = sum_e q_e
//   B2, one warp per DESTINATION row over the CSR (col = sources):
//     dtd[d,h] = sum_e q_e
//
// Replaces sgnn_tpu/ops/pallas/mxu_gat.py::_gat_bwd_kernel (:431, launched
// by _gat_bwd_apply :522, two passes from _gat_train_bwd :649).  The Pallas
// kernel gathers both sides' rows and tables through one-hot matmuls over
// a padded plan because Mosaic has no in-kernel gather, and reduces t_e
// with a head-expansion matmul; Hopper gathers rows natively, so each pass
// is a gather-and-reduce over the CSR the trainer already holds.  Both
// passes recompute u and q from the same per-vertex tables, as the JAX
// kernel does, so no per-edge state crosses passes.  Unlike the Pallas
// kernel this one keeps the clip's indicator, as the autodiff of the
// forward does (ROADMAP Queue 3).
//
// What bounds it on an H100: device-memory bytes.  Each input read once
// and each output written once: B1 moves V*F*(b + 8) + 16*H*V + 8*(V+1)
// + 4*E bytes for 4*E*F + 10*E*H operations, B2 V*F*(b + 4) + 16*H*V +
// 8*(V+1) + 4*E for 2*E*F + 10*E*H (b = width of ht's dtype), about
// 0.09-0.12 ms of HBM time at F=128 on the Reddit-shaped graph (V =
// 232,965, E = 11.9M).  A row gather reads one row per edge, and the rows
// (119 MB at F=128 f32) do not fit the 50 MB L2, so the gathers really
// move nearer E*F*4: about 6 GB, 1.8 ms, per pass at F=128.  K3 (gat.cu)
// measured bound by instruction issue, so the per-edge work here is kept
// lean:
//
// Design, simple first:
//  * one warp per row, kWarpsPerBlock rows per block, a grid-stride loop
//    over rows; each lane owns C contiguous columns (C in 1, 2, 4, 8,
//    picked from the tile width), loaded as 16-byte vectors where the rows
//    are aligned, so one head's columns sit on an aligned group of
//    fh/C lanes (a power of two) and t_e reduces with __shfl_xor_sync in
//    log2(fh/C) steps, for every head of the tile at once;
//  * a column tile is whole heads, at most kMaxTileHeads and 256 columns;
//    where the heads do not fall on such lane groups (fh/C not a power of
//    two) a tile is one head and reduces over the whole warp, as does any
//    single-head tile (F = 41, H = 1).  Heads wider than 256 columns are
//    refused (the wrapper raises);
//  * 32 edges at a time, lane k computes edge k's u and u*lrelu'*[clip]
//    once for each head of the tile (one expf per edge and head) into a
//    per-warp shared buffer (B1 also stages rz of the edge's destination);
//    the warp broadcasts each edge's neighbor with __shfl_sync, and every
//    lane reads its head's values from the buffer;
//  * B2 keeps Gz[d], td[d] and rz[d] in registers and gathers ht[s]; B1
//    keeps ht[s] and ts[s] and gathers Gz[d], td[d] and rz[d];
//  * sums are f32, in CSR edge order, and each output is written once by
//    its row's warp (dts/dtd by the first lane of the head's group): no
//    atomics, deterministic, and a row with no edges writes zeros;
//  * B1's rows are sources, and a hub source of a skewed graph (the
//    Reddit-shaped graph's largest has ~8% of all edges) would keep one
//    warp busy while the card idles.  As in spmm.cu, a source row of more
//    than long_row edges is split: the main kernel skips it, one warp per
//    segment of long_row edges writes a partial row of dht_agg and dts,
//    and a combine kernel sums the partials in segment order;
//  * ht is f32 or bf16; Gz, rz, the tables and the outputs are f32; row*F
//    and rowptr are 64-bit.  expf, no fast math.
// Storing q per edge in B2 for B1 to read, and splitting hub destination
// rows in B2 (their in-degrees stay short on the graphs at hand), are left
// for later work.

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

using sgnn::kFullMask;
using sgnn::kWarpsPerBlock;
using sgnn::to_float;

constexpr float kClip = 60.0f;      // == sgnn_tpu_torch/ops/gat.py ATT_CLIP
constexpr float kNegSlope = 0.2f;  // == sgnn_tpu_torch/ops/gat.py NEG_SLOPE
constexpr int kMaxTileHeads = 8;    // heads one column tile may span
constexpr int kMaxTileCols = 256;   // 32 lanes x 8 columns
constexpr int kStride = 33;         // lanes reading other heads of one edge
                                    // fall in other shared-memory banks

// u = exp(clip(lrelu(score))) and c = u * lrelu'(score) * [|lrelu| <= 60]
__device__ __forceinline__ void edge_weights(float score, float& u,
                                             float& c) {
  const float lr = score >= 0.0f ? score : kNegSlope * score;
  u = expf(fminf(fmaxf(lr, -kClip), kClip));
  const float slope = score >= 0.0f ? 1.0f : kNegSlope;
  c = fabsf(lr) <= kClip ? u * slope : 0.0f;
}

// This lane's n (<= C) columns of a row as f32, zeros past n; 16-byte
// loads when `vec` (row and tile aligned) and the lane holds all C.
template <int C>
__device__ __forceinline__ void load_cols(const float* p, int n, bool vec,
                                          float (&v)[C]) {
  if constexpr (C % 4 == 0) {
    if (vec && n == C) {
#pragma unroll
      for (int j = 0; j < C; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + j);
        v[j] = q.x;
        v[j + 1] = q.y;
        v[j + 2] = q.z;
        v[j + 3] = q.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = j < n ? p[j] : 0.0f;
}

template <int C>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, int n,
                                          bool vec, float (&v)[C]) {
  if constexpr (C % 8 == 0) {
    if (vec && n == C) {
#pragma unroll
      for (int j = 0; j < C; j += 8) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + j);
        const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(b[k]);
          v[j + 2 * k] = f.x;
          v[j + 2 * k + 1] = f.y;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = j < n ? to_float(p[j]) : 0.0f;
}

// Sum over an aligned group of `group` lanes (a power of two <= 32); every
// lane of the group ends with the group's sum.
__device__ __forceinline__ float group_sum(float p, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) {
    p += __shfl_xor_sync(kFullMask, p, off);
  }
  return p;
}

// Where this lane sits in a column tile of `n_heads` heads of width fh,
// starting at head h0.
struct LaneCols {
  int64_t c0;  // the tile's first column
  int lc0;     // this lane's first column within the tile
  int ncols;   // how many of its C columns lie in the tile
  int head;    // the head of its columns, within the tile
};

template <int C>
__device__ __forceinline__ LaneCols lane_cols(int lane, int h0, int n_heads,
                                              int fh) {
  LaneCols lc;
  lc.c0 = static_cast<int64_t>(h0) * fh;
  lc.lc0 = lane * C;
  lc.ncols = max(0, min(C, n_heads * fh - lc.lc0));
  lc.head = min(lc.lc0 / fh, n_heads - 1);
  return lc;
}

// B1 for one column tile (heads h0..h0+n_heads) of source row `row` over
// its edges [beg, end): this lane's columns of dht_agg go to dht_row and
// its head's dts (from the head's first lane) to dts_row[h0 + head].
// Warp-uniform.  us, cs, rs are the warp's shared buffers.
template <typename T, int C>
__device__ __forceinline__ void src_tile(
    const T* __restrict__ ht, const float* __restrict__ ts,
    const float* __restrict__ gz, const float* __restrict__ td,
    const float* __restrict__ rz, const int32_t* __restrict__ col,
    int64_t row, int64_t beg, int64_t end, int64_t feat, int heads, int h0,
    int n_heads, int fh, int group, bool vec_ht, bool vec_gz, int lane,
    float* us, float* cs, float* rs, float* dht_row, float* dts_row) {
  const LaneCols lc = lane_cols<C>(lane, h0, n_heads, fh);
  float x[C], acc[C];
  load_cols<C>(ht + row * feat + lc.c0 + lc.lc0, lc.ncols, vec_ht, x);
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.0f;
  float ts_tile[kMaxTileHeads];
#pragma unroll
  for (int i = 0; i < kMaxTileHeads; ++i) {
    ts_tile[i] = i < n_heads ? ts[row * heads + h0 + i] : 0.0f;
  }
  float accq = 0.0f;
  for (int64_t e0 = beg; e0 < end; e0 += 32) {
    const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
    const int my_dst = lane < n ? col[e0 + lane] : 0;
    if (lane < n) {
      const int64_t off = static_cast<int64_t>(my_dst) * heads + h0;
#pragma unroll
      for (int i = 0; i < kMaxTileHeads; ++i) {
        if (i < n_heads) {
          float u, c;
          edge_weights(ts_tile[i] + td[off + i], u, c);
          us[i * kStride + lane] = u;
          cs[i * kStride + lane] = c;
          rs[i * kStride + lane] = rz[off + i];
        }
      }
    }
    __syncwarp();
    for (int k = 0; k < n; ++k) {
      const int d = __shfl_sync(kFullMask, my_dst, k);
      float g[C];
      load_cols<C>(gz + static_cast<int64_t>(d) * feat + lc.c0 + lc.lc0,
                   lc.ncols, vec_gz, g);
      float p = 0.0f;
#pragma unroll
      for (int j = 0; j < C; ++j) p = fmaf(x[j], g[j], p);
      p = group_sum(p, group);
      const int slot = lc.head * kStride + k;
      const float u = us[slot];
      accq = fmaf(cs[slot], p - rs[slot], accq);
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = fmaf(u, g[j], acc[j]);
    }
    __syncwarp();  // reads done before the next chunk's writes
  }
  float* out = dht_row + lc.c0 + lc.lc0;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    if (j < lc.ncols) out[j] = acc[j];
  }
  if (lc.ncols > 0 && lc.lc0 % fh == 0) dts_row[h0 + lc.head] = accq;
}

#define SGNN_B1_SMEM                                                          \
  __shared__ float u_smem[kWarpsPerBlock][kMaxTileHeads * kStride];           \
  __shared__ float c_smem[kWarpsPerBlock][kMaxTileHeads * kStride];           \
  __shared__ float r_smem[kWarpsPerBlock][kMaxTileHeads * kStride];           \
  const int lane = threadIdx.x & 31;                                          \
  const int warp = threadIdx.x >> 5;                                          \
  const int fh = static_cast<int>(feat / heads);                              \
  const int64_t first =                                                       \
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;               \
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;

// B1 over rows of at most long_row edges; longer ones are split across
// warps by gat_bwd_src_segment_kernel
template <typename T, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_src_kernel(const T* __restrict__ ht, const float* __restrict__ ts,
                   const float* __restrict__ gz, const float* __restrict__ td,
                   const float* __restrict__ rz,
                   const int64_t* __restrict__ rowptr,
                   const int32_t* __restrict__ col, float* __restrict__ dht,
                   float* __restrict__ dts, int64_t num_rows, int64_t feat,
                   int heads, int tile_heads, int group, bool vec_ht,
                   bool vec_gz, int64_t long_row) {
  SGNN_B1_SMEM
  // every branch below depends only on the row and the tile, so it is
  // warp-uniform and the full-mask shuffles see all 32 lanes
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    if (end - beg > long_row) continue;
    for (int h0 = 0; h0 < heads; h0 += tile_heads) {
      src_tile<T, C>(ht, ts, gz, td, rz, col, row, beg, end, feat, heads, h0,
                     min(tile_heads, heads - h0), fh, group, vec_ht, vec_gz,
                     lane, u_smem[warp], c_smem[warp], r_smem[warp],
                     dht + row * feat, dts + row * heads);
    }
  }
}

// One warp per segment of `long_row` edges of a long source row: segment
// s's partial dht_agg and dts rows go to part_dht[s] and part_dts[s]
template <typename T, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_src_segment_kernel(
    const T* __restrict__ ht, const float* __restrict__ ts,
    const float* __restrict__ gz, const float* __restrict__ td,
    const float* __restrict__ rz, const int64_t* __restrict__ rowptr,
    const int32_t* __restrict__ col, const int64_t* __restrict__ seg_ptr,
    float* __restrict__ part_dht, float* __restrict__ part_dts,
    int64_t num_rows, int64_t feat, int heads, int tile_heads, int group,
    bool vec_ht, bool vec_gz, int64_t long_row) {
  SGNN_B1_SMEM
  const int64_t n_seg = seg_ptr[num_rows - 1];
  for (int64_t s = first; s < n_seg; s += stride) {
    const int64_t row = sgnn::segment_row(seg_ptr, num_rows, s);
    const int64_t k = s - (row > 0 ? seg_ptr[row - 1] : 0);
    const int64_t beg = rowptr[row] + k * long_row;
    const int64_t end = min(beg + long_row, rowptr[row + 1]);
    for (int h0 = 0; h0 < heads; h0 += tile_heads) {
      src_tile<T, C>(ht, ts, gz, td, rz, col, row, beg, end, feat, heads, h0,
                     min(tile_heads, heads - h0), fh, group, vec_ht, vec_gz,
                     lane, u_smem[warp], c_smem[warp], r_smem[warp],
                     part_dht + s * feat, part_dts + s * heads);
    }
  }
}

#undef SGNN_B1_SMEM

// Each long source row's dht_agg and dts: its segments' partials summed in
// segment order
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_src_combine_kernel(const float* __restrict__ part_dht,
                           const float* __restrict__ part_dts,
                           const int64_t* __restrict__ seg_ptr,
                           float* __restrict__ dht, float* __restrict__ dts,
                           int64_t num_rows, int64_t feat, int heads) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t s0 = row > 0 ? seg_ptr[row - 1] : 0;
    const int64_t s1 = seg_ptr[row];
    if (s1 == s0) continue;
    for (int64_t c = lane; c < feat; c += 32) {
      float a = 0.0f;
      for (int64_t s = s0; s < s1; ++s) a += part_dht[s * feat + c];
      dht[row * feat + c] = a;
    }
    for (int h = lane; h < heads; h += 32) {
      float a = 0.0f;
      for (int64_t s = s0; s < s1; ++s) a += part_dts[s * heads + h];
      dts[row * heads + h] = a;
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_dst_kernel(const T* __restrict__ ht, const float* __restrict__ ts,
                   const float* __restrict__ gz, const float* __restrict__ td,
                   const float* __restrict__ rz,
                   const int64_t* __restrict__ rowptr,
                   const int32_t* __restrict__ col, float* __restrict__ dtd,
                   int64_t num_rows, int64_t feat, int heads, int tile_heads,
                   int group, bool vec_ht, bool vec_gz) {
  __shared__ float c_smem[kWarpsPerBlock][kMaxTileHeads * kStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* cs = c_smem[warp];
  const int fh = static_cast<int>(feat / heads);
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    for (int h0 = 0; h0 < heads; h0 += tile_heads) {
      const int n_heads = min(tile_heads, heads - h0);
      const LaneCols lc = lane_cols<C>(lane, h0, n_heads, fh);
      float g[C];
      load_cols<C>(gz + row * feat + lc.c0 + lc.lc0, lc.ncols, vec_gz, g);
      float td_tile[kMaxTileHeads];
#pragma unroll
      for (int i = 0; i < kMaxTileHeads; ++i) {
        td_tile[i] = i < n_heads ? td[row * heads + h0 + i] : 0.0f;
      }
      const float my_rz = rz[row * heads + h0 + lc.head];
      float accq = 0.0f;
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
        const int my_src = lane < n ? col[e0 + lane] : 0;
        if (lane < n) {
          const int64_t off = static_cast<int64_t>(my_src) * heads + h0;
#pragma unroll
          for (int i = 0; i < kMaxTileHeads; ++i) {
            if (i < n_heads) {
              float u, c;
              edge_weights(ts[off + i] + td_tile[i], u, c);
              cs[i * kStride + lane] = c;
            }
          }
        }
        __syncwarp();
        for (int k = 0; k < n; ++k) {
          const int s = __shfl_sync(kFullMask, my_src, k);
          float x[C];
          load_cols<C>(ht + static_cast<int64_t>(s) * feat + lc.c0 + lc.lc0,
                       lc.ncols, vec_ht, x);
          float p = 0.0f;
#pragma unroll
          for (int j = 0; j < C; ++j) p = fmaf(x[j], g[j], p);
          p = group_sum(p, group);
          accq = fmaf(cs[lc.head * kStride + k], p - my_rz, accq);
        }
        __syncwarp();  // reads done before the next chunk's writes
      }
      if (lc.ncols > 0 && lc.lc0 % fh == 0) {
        dtd[row * heads + h0 + lc.head] = accq;
      }
    }
  }
}

// The column tiling of F = heads * fh: heads per tile, columns per lane
// (C) and the lane-group width of one head.  Returns false for heads wider
// than kMaxTileCols.
struct Tiling {
  int tile_heads;
  int cols;
  int group;
};

int cols_for(int64_t width) {
  int c = 1;
  while (32 * c < width) c *= 2;
  return c;
}

bool plan_tiling(int64_t feat, int heads, Tiling* t) {
  const int64_t fh = feat / heads;
  if (fh > kMaxTileCols) return false;
  int n = static_cast<int>(std::min<int64_t>(
      {static_cast<int64_t>(heads), int64_t{kMaxTileHeads},
       kMaxTileCols / fh}));
  int c = cols_for(n * fh);
  if (n > 1) {
    const int64_t lanes = fh / c;
    if (fh % c != 0 || (lanes & (lanes - 1)) != 0) {
      n = 1;  // heads off the lane groups: one head per tile, whole warp
      c = cols_for(fh);
    }
  }
  t->tile_heads = n;
  t->cols = c;
  t->group = n == 1 ? 32 : static_cast<int>(fh / c);
  return true;
}

// 16-byte loads of a lane's C columns need the base, the row pitch, the
// tile pitch and the lane's C columns all on 16-byte boundaries.
bool vec_ok(const void* p, int64_t feat, const Tiling& t, int64_t fh,
            int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && feat * elem % 16 == 0 &&
         t.tile_heads * fh * elem % 16 == 0 && t.cols * elem % 16 == 0;
}

// The long-row split of B1 (csrc/spmm.cu's scheme): seg_ptr [num_rows]
// int64, the running count of each source row's segments, and f32 scratch
// for max_segments partial rows of dht_agg and dts.
struct Split {
  const int64_t* seg_ptr;
  float* part_dht;
  float* part_dts;
  int64_t long_row;
  int64_t max_segments;
};

template <typename T>
int launch(bool src_pass, const void* ht, const void* ts, const void* gz,
           const void* td, const void* rz, const void* rowptr,
           const void* col, void* out_a, void* out_b, const Split& split,
           int64_t num_rows, int64_t feat, int heads, cudaStream_t stream) {
  Tiling t;
  if (!plan_tiling(feat, heads, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t fh = feat / heads;
  const bool vht = vec_ok(ht, feat, t, fh, sizeof(T));
  const bool vgz = vec_ok(gz, feat, t, fh, sizeof(float));
  const dim3 grid(sgnn::warp_blocks(num_rows)), block(kWarpsPerBlock * 32);
  const dim3 seg_grid(sgnn::warp_blocks(split.max_segments));
  const T* htp = static_cast<const T*>(ht);
  const float* tsp = static_cast<const float*>(ts);
  const float* gzp = static_cast<const float*>(gz);
  const float* tdp = static_cast<const float*>(td);
  const float* rzp = static_cast<const float*>(rz);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int32_t* cp = static_cast<const int32_t*>(col);
  float* a = static_cast<float*>(out_a);
  float* b = static_cast<float*>(out_b);
#define SGNN_GAT_BWD(C)                                                      \
  if (src_pass) {                                                            \
    gat_bwd_src_kernel<T, C><<<grid, block, 0, stream>>>(                    \
        htp, tsp, gzp, tdp, rzp, rp, cp, a, b, num_rows, feat, heads,        \
        t.tile_heads, t.group, vht, vgz, split.long_row);                    \
    gat_bwd_src_segment_kernel<T, C><<<seg_grid, block, 0, stream>>>(        \
        htp, tsp, gzp, tdp, rzp, rp, cp, split.seg_ptr, split.part_dht,      \
        split.part_dts, num_rows, feat, heads, t.tile_heads, t.group, vht,   \
        vgz, split.long_row);                                                \
    gat_bwd_src_combine_kernel<<<grid, block, 0, stream>>>(                  \
        split.part_dht, split.part_dts, split.seg_ptr, a, b, num_rows, feat, \
        heads);                                                              \
  } else {                                                                   \
    gat_bwd_dst_kernel<T, C><<<grid, block, 0, stream>>>(                    \
        htp, tsp, gzp, tdp, rzp, rp, cp, a, num_rows, feat, heads,           \
        t.tile_heads, t.group, vht, vgz);                                    \
  }
  switch (t.cols) {
    case 1: SGNN_GAT_BWD(1) break;
    case 2: SGNN_GAT_BWD(2) break;
    case 4: SGNN_GAT_BWD(4) break;
    case 8: SGNN_GAT_BWD(8) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SGNN_GAT_BWD
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool src_pass, const void* ht, const void* ts, const void* gz,
             const void* td, const void* rz, const void* rowptr,
             const void* col, void* out_a, void* out_b, const Split& split,
             long long num_rows, long long feat, int heads, int dtype,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads < 1 || feat < 1 || feat % heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (src_pass && (split.long_row < 1 || split.max_segments < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch<float>(src_pass, ht, ts, gz, td, rz, rowptr, col, out_a,
                         out_b, split, num_rows, feat, heads, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(src_pass, ht, ts, gz, td, rz, rowptr, col,
                                 out_a, out_b, split, num_rows, feat, heads,
                                 s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B1 over the transposed CSR (rows = sources, col = destinations): writes
// dht_agg [num_rows, feat] and dts [num_rows, heads].  dtype: 0 = float32,
// 1 = bfloat16 (ht's); every other array is float32.  Rows longer than
// long_row are split: seg_ptr [num_rows] int64 is the inclusive running
// count of each row's segments (ceil(len / long_row) for a long row, else
// 0), part_dht [max_segments, feat] and part_dts [max_segments, heads] f32
// scratch, max_segments >= seg_ptr's last entry.  The caller checks
// shapes, dtypes, devices and index bounds, and passes num_rows >= 1 and
// heads dividing feat with feat/heads <= 256.  Returns cudaGetLastError()
// after the launches, or cudaErrorInvalidValue for arguments it refuses.
extern "C" int sgnn_gat_bwd_src(const void* ht, const void* ts,
                                const void* gz, const void* td,
                                const void* rz, const void* rowptr_t,
                                const void* col_t, void* dht_agg, void* dts,
                                const void* seg_ptr, void* part_dht,
                                void* part_dts, long long num_rows,
                                long long feat, int heads, long long long_row,
                                long long max_segments, int dtype,
                                void* stream) {
  const Split split{static_cast<const int64_t*>(seg_ptr),
                    static_cast<float*>(part_dht),
                    static_cast<float*>(part_dts), long_row, max_segments};
  return dispatch(true, ht, ts, gz, td, rz, rowptr_t, col_t, dht_agg, dts,
                  split, num_rows, feat, heads, dtype, stream);
}

// B2 over the CSR (rows = destinations, col = sources): writes dtd
// [num_rows, heads].  Arguments as sgnn_gat_bwd_src's, without the split:
// B2's rows are destinations, whose in-degrees stay short.
extern "C" int sgnn_gat_bwd_dst(const void* ht, const void* ts,
                                const void* gz, const void* td,
                                const void* rz, const void* rowptr,
                                const void* col, void* dtd,
                                long long num_rows, long long feat, int heads,
                                int dtype, void* stream) {
  const Split none{nullptr, nullptr, nullptr, 0, 0};
  return dispatch(false, ht, ts, gz, td, rz, rowptr, col, dtd, nullptr, none,
                  num_rows, feat, heads, dtype, stream);
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
