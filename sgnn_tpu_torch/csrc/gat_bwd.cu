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
//   B1, over the transposed CSR (rows = sources, col = destinations):
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
// move nearer E*F*4: about 6 GB, 1.8 ms, per pass at F=128.  The first
// B1 (a warp per source row) was bound by neither: a per-edge
// reduction across the head's lanes with one row load in flight, and a
// hub source (the transposed CSR's largest row has ~8% of all edges)
// split by a per-call plan into segments that one warp per hub combined
// serially, 60-84x its bound (PERF.md).
//
// B1, csr_sum.cuh's edge-balanced walk over the transposed CSR (its
// SrcPolicy below):
//  * every warp takes `chunk` edges (ops/segment.csr_chunk_edges), finds
//    its rows by warp-cooperative searches, streams short rows' edges in
//    windows of 32 with kUnroll destination rows loaded before their
//    FMAs, and sums a long row's piece into a carry slot of F + H columns
//    (dht_agg's, then dts's) that the fixed two-level tree combines; rows
//    with no edges are written as zeros; no plan, no float atomics;
//  * lane k of a window finds its edge's source row (a search of the
//    window's row ends) and stages (u, c, rz[d]) of edge k for each head
//    of the column tile once, with c = u * lrelu'(score) * [|lr| <= 60];
//  * ht[s] is fixed along the row and held in registers, so with vector
//    columns the q of the kUnroll edges between two flushes sum to
//    <sum c Gz[d], ht[s]>_h - sum c rz[d,h]: per edge a lane adds VEC
//    columns to u*Gz and to c*Gz and one c*rz, and the head's lanes
//    reduce one dot product per kUnroll edges instead of one per edge.
//    (The same identity over a whole row strays past the 1e-5 bound in
//    f32 where a hub's t_e ~ rz[d]: scripts/torch_b1_identity_error.py,
//    PERF.md.)  With scalar columns (F = 41) a reduction an edge measured
//    faster, and is kept there;
//  * columns: 4 adjacent columns a lane as one 16-byte load where F and
//    the head width are multiples of 4 (F = 128), else one a load (F =
//    41); a column tile is whole heads, each on an aligned power-of-two
//    group of lanes, or one head reduced over the whole warp.
// B2, one warp per DESTINATION row (in-degrees stay short), keeps its
// first design:
//  * kWarpsPerBlock rows per block, a grid-stride loop over rows; each
//    lane owns C contiguous columns (C in 1, 2, 4, 8, picked from the
//    tile width), loaded as 16-byte vectors where the rows are aligned, so
//    one head's columns sit on an aligned group of fh/C lanes (a power of
//    two) and t_e reduces with __shfl_xor_sync in log2(fh/C) steps, for
//    every head of the tile at once; a column tile is whole heads, at most
//    kMaxTileHeads and 256 columns, or one head reduced over the whole
//    warp where the heads are off the lane groups; heads wider than 256
//    columns are refused (the wrapper raises);
//  * 32 edges at a time, lane k computes edge k's u*lrelu'*[clip] once
//    for each head of the tile into a per-warp shared buffer; B2 keeps
//    Gz[d], td[d] and rz[d] in registers and gathers ht[s].
// Both: sums are f32 and each output is written once (dts/dtd by the
// lane holding the head's first column): deterministic, bit-identical
// from run to run.  ht is f32 or bf16; Gz, rz, the tables and the outputs
// are f32; offsets are 64-bit.  expf, no fast math.  Storing q per edge in
// B2 for B1 to read is left for later work.

#include <cfloat>
#include <cstdint>

#include "csr_sum.cuh"

namespace {

using sgnn::col_of;
using sgnn::kFullMask;
using sgnn::kUnroll;
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

// B1: what csr_sum.cuh's walk sums over the transposed CSR (rows are
// sources s, col destinations d), one column tile of whole heads (h_first
// .. h_first + n_th) a pass.  Lane k stages edge k's (u, c, rz[d]) per
// head of the tile once, from ts of its edge's row and td, rz of its
// destination; ht[s] is loaded once a row.  Per edge a lane adds VEC
// columns of u*Gz[d] (dht_agg).  With vector columns it also adds VEC
// columns of c*Gz[d] and one c*rz[d] for its head: ht[s] is fixed along
// the row, so the q of the walk's kUnroll edges e sum to
//     sum_e q_e = <sum_e c_e Gz[d], ht[s]>_h - sum_e c_e rz[d,h],
// one dot product, reduced over the head's aligned group of `group`
// lanes (the whole warp when the tile is one head), a kUnroll edges
// instead of one an edge.  (Over a whole row that form strays past the
// 1e-5 bound in f32 where a hub's t_e ~ rz[d]: PERF.md.)  With scalar
// columns it reduces t = <Gz[d], ht[s]>_h and adds q = c * (t - rz) an
// edge.
template <typename T, int COLS, int VEC>
struct SrcPolicy {
  static constexpr bool kNeedsRow = true;
  // scalar columns (F = 41) reduce q an edge: measured faster there than
  // a reduction a kUnroll edges, which wins with vector columns (PERF.md)
  static constexpr bool kPerEdge = VEC == 1;
  struct Shared {
    float4 stage[kMaxTileHeads * kStride];  // (u, c, rz, -) [head][edge]
  };
  struct Acc {
    float u[COLS][VEC];  // sum of u * Gz[d]: dht_agg's columns
    float c[COLS][VEC];  // sum of c * Gz[d] since the last flush (vector)
    float x[COLS][VEC];  // ht[s]
    float crz[COLS];     // sum of c * rz[d] since the last flush
    float q[COLS];       // sum of q of group j's head (of group 0's when
                         // the tile is one head)
  };
  using Edge = int;  // the destination
  struct Rows {
    float v[kUnroll][COLS][VEC];
  };

  const T* __restrict__ ht;
  const float* __restrict__ ts;
  const float* __restrict__ gz;
  const float* __restrict__ td;
  const float* __restrict__ rz;
  const int32_t* __restrict__ col;
  float* __restrict__ dht;
  float* __restrict__ dts;
  float* __restrict__ carry;  // [slots, pitch]: dht_agg, then dts
  int64_t feat;
  int heads;
  int fh;
  int64_t tw;     // columns of a tile: whole heads
  int group;      // lanes of one head; 32 when a tile is one head
  int64_t pitch;  // >= feat + heads
  Shared* sh;
  // the tile's
  int64_t c0, c_end;
  int h_first, n_th;
  int hd[COLS];    // group j's head within the tile, -1 past the tile
  int slot[COLS];  // its row of the stage

  __device__ __forceinline__ void bind(Shared& s) { sh = &s; }
  __device__ __forceinline__ int64_t width() const { return feat; }
  __device__ __forceinline__ int64_t tile() const { return tw; }
  __device__ __forceinline__ bool one_head() const {
    return COLS == 1 || n_th == 1;
  }
  __device__ __forceinline__ void begin_tile(int64_t c, int lane) {
    c0 = c;
    c_end = min(c + tw, feat);
    h_first = static_cast<int>(c / fh);
    n_th = static_cast<int>((c_end - 1) / fh) - h_first + 1;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t cc = col_of(c0, lane, j, VEC);
      hd[j] = cc < c_end ? static_cast<int>(cc / fh) - h_first : -1;
      slot[j] = max(hd[j], 0) * kStride;
    }
  }
  __device__ __forceinline__ void begin_row(Acc& t, int64_t row, int lane) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      t.crz[j] = t.q[j] = 0.0f;
#pragma unroll
      for (int q = 0; q < VEC; ++q) t.u[j][q] = t.c[j][q] = t.x[j][q] = 0.0f;
      if (row >= 0 && hd[j] >= 0) {
        sgnn::load_cols<T, VEC>(ht + row * feat + col_of(c0, lane, j, VEC),
                                t.x[j]);
      }
    }
  }
  __device__ __forceinline__ Edge stage(int64_t e, bool live, int64_t row,
                                        int lane) {
    int d = 0;
    __syncwarp();  // the last window's reads are done
    if (live) {
      d = col[e];
      const float* tsr = ts + row * heads + h_first;
      const int64_t off = static_cast<int64_t>(d) * heads + h_first;
#pragma unroll
      for (int i = 0; i < kMaxTileHeads; ++i) {
        if (i < n_th) {
          float u, c;
          edge_weights(tsr[i] + td[off + i], u, c);
          sh->stage[i * kStride + lane] = make_float4(u, c, rz[off + i], 0.0f);
        }
      }
    }
    __syncwarp();
    return d;
  }
  __device__ __forceinline__ void load(Edge d, int k, int n, int lane,
                                       Rows& v) const {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int dst = __shfl_sync(kFullMask, d, (k + u) & 31);
      const float* g = gz + static_cast<int64_t>(dst) * feat;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (k + u < n && hd[j] >= 0) {
          sgnn::load_cols<float, VEC>(g + col_of(c0, lane, j, VEC),
                                      v.v[u][j]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v.v[u][j][q] = 0.0f;
        }
      }
    }
  }
  __device__ __forceinline__ void add(Acc& t, Edge, const Rows& v, int u,
                                      int k) const {
    float4 s[COLS];
    float p[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      s[j] = sh->stage[slot[j] + k + u];
      p[j] = 0.0f;
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        t.u[j][q] = fmaf(s[j].x, v.v[u][j][q], t.u[j][q]);
        if constexpr (kPerEdge) {
          p[j] = fmaf(t.x[j][q], v.v[u][j][q], p[j]);
        } else {
          t.c[j][q] = fmaf(s[j].y, v.v[u][j][q], t.c[j][q]);
        }
      }
      if constexpr (!kPerEdge) t.crz[j] = fmaf(s[j].y, s[j].z, t.crz[j]);
    }
    if constexpr (kPerEdge) {  // q = c * (t - rz) of this edge
      if (one_head()) {
        float pp = p[0];
#pragma unroll
        for (int j = 1; j < COLS; ++j) pp += p[j];
        t.q[0] = fmaf(s[0].y, group_sum(pp, group) - s[0].z, t.q[0]);
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          t.q[j] = fmaf(s[j].y, group_sum(p[j], group) - s[j].z, t.q[j]);
        }
      }
    }
  }
  // q += <sum c Gz, ht[s]> - sum c rz over the edges since the last flush
  __device__ __forceinline__ void flush(Acc& t, int) const {
    if constexpr (!kPerEdge) {
      float p[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        p[j] = 0.0f;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          p[j] = fmaf(t.c[j][q], t.x[j][q], p[j]);
          t.c[j][q] = 0.0f;
        }
      }
      if (one_head()) {
        float pp = p[0];
#pragma unroll
        for (int j = 1; j < COLS; ++j) pp += p[j];
        t.q[0] += group_sum(pp, group) - t.crz[0];
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          t.q[j] += group_sum(p[j], group) - t.crz[j];
        }
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) t.crz[j] = 0.0f;
    }
  }
  // dts of the tile's heads: from the lane holding each head's first
  // column, the q of its group j (of group 0 when the tile is one head)
  template <class F>
  __device__ __forceinline__ void head_dts(const Acc& t, int lane,
                                           F&& put) const {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] >= 0 && col_of(c0, lane, j, VEC) % fh == 0) {
        put(h_first + hd[j], t.q[one_head() ? 0 : j]);
      }
    }
  }
  __device__ __forceinline__ void store_row(Acc& t, int64_t row,
                                            int lane) const {
    flush(t, lane);
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] >= 0) {
        sgnn::store_cols<float, VEC>(
            dht + row * feat + col_of(c0, lane, j, VEC), t.u[j]);
      }
    }
    float* out = dts + row * heads;
    head_dts(t, lane, [out](int h, float v) { out[h] = v; });
  }
  __device__ __forceinline__ void store_piece(Acc& t, int64_t s,
                                              int lane) const {
    flush(t, lane);
    float* dst = carry + s * pitch;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] >= 0) {
        sgnn::store_cols<float, VEC>(dst + col_of(c0, lane, j, VEC), t.u[j]);
      }
    }
    float* out = dst + feat;
    head_dts(t, lane, [out](int h, float v) { out[h] = v; });
  }
  __device__ __forceinline__ void zero_row(int64_t row, int lane) const {
    for (int64_t f = lane; f < feat; f += 32) dht[row * feat + f] = 0.0f;
    for (int h = lane; h < heads; h += 32) dts[row * heads + h] = 0.0f;
  }
};

// B1's fix-up store: a finished hub row's carry, dht_agg's columns then
// dts's.
struct SrcStore {
  float* __restrict__ dht;
  float* __restrict__ dts;
  int64_t feat;
  int heads;

  template <int VEC>
  __device__ __forceinline__ void store(int64_t r, int64_t c,
                                        const float (&v)[VEC]) const {
    if (c < feat) {  // feat % VEC == 0: the VEC columns are all dht_agg's
      sgnn::store_cols<float, VEC>(dht + r * feat + c, v);
      return;
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      if (c + q - feat < heads) dts[r * heads + c + q - feat] = v[q];
    }
  }
};

template <typename T, int COLS, int VEC>
void launch_src_cols(const SrcPolicy<T, COLS, VEC>& p,
                     const int64_t* rowptr, int32_t* carry_row,
                     int64_t num_rows, int64_t max_chunks, int64_t chunk,
                     cudaStream_t stream) {
  sgnn::csr_walk_launch<SrcPolicy<T, COLS, VEC>, SrcStore, COLS, VEC>(
      p, SrcStore{p.dht, p.dts, p.feat, p.heads}, rowptr, p.carry, carry_row,
      num_rows, max_chunks, chunk, p.pitch, stream);
}

template <typename T, int VEC>
int launch_src(const void* ht, const void* ts, const void* gz,
               const void* td, const void* rz, const void* rowptr,
               const void* col, void* dht, void* dts, void* carry,
               void* carry_row, int64_t num_rows, int64_t max_edges,
               int64_t chunk, int64_t feat, int heads, int64_t pitch,
               cudaStream_t stream) {
  // a tile is whole heads, at most kMaxTileHeads and 256 columns, each
  // head on an aligned power-of-two group of lanes; where they are not
  // (fh / VEC not a power of two) a tile is one head and the whole warp
  // reduces
  const int fh = static_cast<int>(feat / heads);
  int64_t nh = std::min<int64_t>({static_cast<int64_t>(heads),
                                  int64_t{kMaxTileHeads}, kMaxTileCols / fh});
  const int lanes = fh / VEC;
  if (nh > 1 && (lanes > 32 || (lanes & (lanes - 1)) != 0)) nh = 1;
  const int64_t tw = nh * fh;
  const int group = nh == 1 ? 32 : lanes;
  int cols = 1;
  while (32 * cols * VEC < tw) cols *= 2;
  const int64_t max_chunks =
      std::max<int64_t>(1, (max_edges + chunk - 1) / chunk);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  int32_t* kr = static_cast<int32_t*>(carry_row);
#define SGNN_B1(C)                                                           \
  launch_src_cols<T, C, VEC>(                                                \
      SrcPolicy<T, C, VEC>{                                                  \
          static_cast<const T*>(ht), static_cast<const float*>(ts),          \
          static_cast<const float*>(gz), static_cast<const float*>(td),      \
          static_cast<const float*>(rz), static_cast<const int32_t*>(col),   \
          static_cast<float*>(dht), static_cast<float*>(dts),                \
          static_cast<float*>(carry), feat, heads, fh, tw, group, pitch},    \
      rp, kr, num_rows, max_chunks, chunk, stream)
  if constexpr (VEC == 4) {
    if (cols == 1) {
      SGNN_B1(1);
    } else {
      SGNN_B1(2);
    }
  } else {
    switch (cols) {
      case 1: SGNN_B1(1); break;
      case 2: SGNN_B1(2); break;
      case 4: SGNN_B1(4); break;
      default: SGNN_B1(8); break;
    }
  }
#undef SGNN_B1
  return static_cast<int>(cudaGetLastError());
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

template <typename T>
int launch_dst(const void* ht, const void* ts, const void* gz,
               const void* td, const void* rz, const void* rowptr,
               const void* col, void* dtd, int64_t num_rows, int64_t feat,
               int heads, cudaStream_t stream) {
  Tiling t;
  if (!plan_tiling(feat, heads, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t fh = feat / heads;
  const bool vht = vec_ok(ht, feat, t, fh, sizeof(T));
  const bool vgz = vec_ok(gz, feat, t, fh, sizeof(float));
  const dim3 grid(sgnn::warp_blocks(num_rows)), block(kWarpsPerBlock * 32);
#define SGNN_B2(C)                                                           \
  gat_bwd_dst_kernel<T, C><<<grid, block, 0, stream>>>(                      \
      static_cast<const T*>(ht), static_cast<const float*>(ts),              \
      static_cast<const float*>(gz), static_cast<const float*>(td),          \
      static_cast<const float*>(rz), static_cast<const int64_t*>(rowptr),    \
      static_cast<const int32_t*>(col), static_cast<float*>(dtd), num_rows,  \
      feat, heads, t.tile_heads, t.group, vht, vgz)
  switch (t.cols) {
    case 1: SGNN_B2(1); break;
    case 2: SGNN_B2(2); break;
    case 4: SGNN_B2(4); break;
    case 8: SGNN_B2(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SGNN_B2
  return static_cast<int>(cudaGetLastError());
}

bool args_ok(long long feat, int heads) {
  return heads >= 1 && feat >= 1 && feat % heads == 0 &&
         feat / heads <= kMaxTileCols;
}

}  // namespace

// B1 over the transposed CSR (rows = sources, col = destinations): writes
// dht_agg [num_rows, feat] and dts [num_rows, heads], csr_sum.cuh's walk
// at `chunk` edges a warp.  carry is an f32 [2 * max(1, ceil(max_edges /
// chunk)), pitch] scratch (pitch >= feat + heads, a multiple of 4 when
// vec) and carry_row an int32 scratch of its rows; vec != 0 takes 16-byte
// (f32) or 8-byte (bf16) column loads, for feat and feat / heads multiples
// of 4 and ht and gz 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16
// (ht's); every other array is float32.  The caller checks shapes, dtypes,
// devices and index bounds, and passes num_rows >= 1, max_edges >=
// rowptr_t[num_rows] and heads dividing feat with feat / heads <= 256.
// Returns cudaGetLastError() after the launches, or cudaErrorInvalidValue
// for arguments it refuses.
extern "C" int sgnn_gat_bwd_src(const void* ht, const void* ts,
                                const void* gz, const void* td,
                                const void* rz, const void* rowptr_t,
                                const void* col_t, void* dht_agg, void* dts,
                                void* carry, void* carry_row,
                                long long num_rows, long long max_edges,
                                long long chunk, long long feat, int heads,
                                long long pitch, int vec, int dtype,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!args_ok(feat, heads) || num_rows < 1 || chunk < 1 ||
      pitch < feat + heads ||
      (vec && (feat % 4 != 0 || (feat / heads) % 4 != 0 || pitch % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SGNN_B1_ARGS                                                         \
  ht, ts, gz, td, rz, rowptr_t, col_t, dht_agg, dts, carry, carry_row,       \
      num_rows, max_edges, chunk, feat, heads, pitch, s
  if (dtype == 0) {
    return vec ? launch_src<float, 4>(SGNN_B1_ARGS)
               : launch_src<float, 1>(SGNN_B1_ARGS);
  }
  if (dtype == 1) {
    return vec ? launch_src<__nv_bfloat16, 4>(SGNN_B1_ARGS)
               : launch_src<__nv_bfloat16, 1>(SGNN_B1_ARGS);
  }
#undef SGNN_B1_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// B2 over the CSR (rows = destinations, col = sources): writes dtd
// [num_rows, heads], a warp a destination row (in-degrees stay short).
// Arguments as sgnn_gat_bwd_src's, without the walk's.
extern "C" int sgnn_gat_bwd_dst(const void* ht, const void* ts,
                                const void* gz, const void* td,
                                const void* rz, const void* rowptr,
                                const void* col, void* dtd,
                                long long num_rows, long long feat, int heads,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!args_ok(feat, heads)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    return launch_dst<float>(ht, ts, gz, td, rz, rowptr, col, dtd, num_rows,
                             feat, heads, s);
  }
  if (dtype == 1) {
    return launch_dst<__nv_bfloat16>(ht, ts, gz, td, rz, rowptr, col, dtd,
                                     num_rows, feat, heads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
