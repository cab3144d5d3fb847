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
// B2, one warp per DESTINATION row (the CSR keyed by destination has no
// row over 1024 edges, and a warp per row beats the walk there, as K2's
// forward).  Its first design loaded one source row at a time and reduced
// t_e over the head's lanes for every edge, 21-33x its bound.  Now K3's
// structure (gat.cu) with B1's identity:
//  * B1's column tiling (plan_tiling): a tile is whole heads, at most
//    kMaxTileHeads and 256 columns, each on an aligned power-of-two group
//    of lanes, or one head reduced over the whole warp; heads wider than
//    256 columns are refused (the wrapper raises); 4 adjacent columns a
//    lane as one 16-byte (f32) or 8-byte (bf16) load where F and the head
//    width are multiples of 4 and ht and gz are aligned (F = 128), else
//    one column a load, lanes striding by 32 (F = 41);
//  * 32 edges at a time: lane k stages edge k's source and its c = u *
//    lrelu'(score) * [|lr| <= 60] for each head of the tile once, in a
//    per-warp shared buffer (staged sources measured faster than
//    shuffled ones); Gz[d], rz[d] and td[d] stay in registers; then
//    kUnroll source rows are loaded before their FMAs;
//  * Gz[d] and rz[d] are fixed along the row, so the q of the kUnroll
//    edges between two flushes sum to <Gz[d], sum c ht[s]>_h - rz[d,h] *
//    sum c: per edge a lane adds VEC columns of c * ht[s] and one c, and
//    the head's lanes reduce one dot product per kUnroll edges.  Never
//    over a window or a row: there the f32 form strays past the 1e-5
//    bound where a dominant source makes t_e ~ rz[d]
//    (scripts/torch_b2_identity_error.py, PERF.md).  A reduction an edge
//    (t = <Gz[d], ht[s]>_h reduced and q = c * (t - rz) added an edge, as
//    the first design) measured slower with both layouts
//    (scripts/torch_row_kernel_variants.py);
//  * a register cap by layout: 48 a thread with scalar columns, 64 with
//    vector ones, each the fastest measured.
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

// Sum over an aligned group of `group` lanes (a power of two <= 32); every
// lane of the group ends with the group's sum.
__device__ __forceinline__ float group_sum(float p, int group) {
  for (int off = group >> 1; off > 0; off >>= 1) {
    p += __shfl_xor_sync(kFullMask, p, off);
  }
  return p;
}

// K4's column tiling, both passes: a tile is whole heads, at most
// kMaxTileHeads and kMaxTileCols columns, each head on an aligned
// power-of-two group of fh / vec lanes; where they are not (fh / vec not
// a power of two) a tile is one head and the whole warp reduces.  A lane
// holds `cols` groups of `vec` columns (col_of).  False for heads wider
// than kMaxTileCols.
struct Tiling {
  int64_t tw;  // columns of a tile
  int group;   // lanes of one head; 32 when a tile is one head
  int cols;    // column groups a lane
};

bool plan_tiling(int64_t feat, int heads, int vec, Tiling* t) {
  const int64_t fh = feat / heads;
  if (fh > kMaxTileCols) return false;
  int64_t nh = std::min<int64_t>(
      {static_cast<int64_t>(heads), int64_t{kMaxTileHeads}, kMaxTileCols / fh});
  const int64_t lanes = fh / vec;
  if (nh > 1 && (lanes > 32 || (lanes & (lanes - 1)) != 0)) nh = 1;
  t->tw = nh * fh;
  t->group = nh == 1 ? 32 : static_cast<int>(lanes);
  t->cols = 1;
  while (32 * t->cols * vec < t->tw) t->cols *= 2;
  return true;
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
  Tiling t;
  plan_tiling(feat, heads, VEC, &t);
  const int fh = static_cast<int>(feat / heads);
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
          static_cast<float*>(carry), feat, heads, fh, t.tw, t.group, pitch},\
      rp, kr, num_rows, max_chunks, chunk, stream)
  if constexpr (VEC == 4) {
    if (t.cols == 1) {
      SGNN_B1(1);
    } else {
      SGNN_B1(2);
    }
  } else {
    switch (t.cols) {
      case 1: SGNN_B1(1); break;
      case 2: SGNN_B1(2); break;
      case 4: SGNN_B1(4); break;
      default: SGNN_B1(8); break;
    }
  }
#undef SGNN_B1
  return static_cast<int>(cudaGetLastError());
}

bool args_ok(long long feat, int heads) {
  return heads >= 1 && feat >= 1 && feat % heads == 0 &&
         feat / heads <= kMaxTileCols;
}

// B2 over destination row `row`, one column tile [c0, c0 + tw) of whole
// heads a pass: per edge a lane adds c * ht[s] (VEC columns) and c, and
// the head's lanes reduce one dot product a kUnroll edges (the header's
// identity).  A register cap by layout: 48 a thread with scalar columns
// (5 blocks an SM), 64 with vector ones (4).  Every branch is
// warp-uniform, so the full-mask shuffles and __syncwarp see all 32 lanes.
template <typename T, int COLS, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, VEC == 4 ? 4 : 5)
gat_bwd_dst_kernel(const T* __restrict__ ht, const float* __restrict__ ts,
                   const float* __restrict__ gz, const float* __restrict__ td,
                   const float* __restrict__ rz,
                   const int64_t* __restrict__ rowptr,
                   const int32_t* __restrict__ col, float* __restrict__ dtd,
                   int64_t num_rows, int64_t feat, int heads, int64_t tw,
                   int group) {
  // a window's c [head][edge] and sources, a buffer per warp
  __shared__ float c_smem[kWarpsPerBlock][kMaxTileHeads * kStride];
  __shared__ int src_smem[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  float* cs = c_smem[threadIdx.x >> 5];
  int* ss = src_smem[threadIdx.x >> 5];
  const int64_t fh = feat / heads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row];
    const int64_t end = rowptr[row + 1];
    for (int64_t c0 = 0; c0 < feat; c0 += tw) {
      const int64_t c_end = min(c0 + tw, feat);
      const int h_first = static_cast<int>(c0 / fh);
      const int n_th = static_cast<int>((c_end - 1) / fh) - h_first + 1;
      // every column group of the lane in one head: sums of group 0 only
      const bool one = COLS == 1 || n_th == 1;
      int hd[COLS], slot[COLS];
      float g[COLS][VEC], r[COLS], acc[COLS][VEC], csum[COLS], q[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t cc = col_of(c0, lane, j, VEC);
        hd[j] = cc < c_end ? static_cast<int>(cc / fh) - h_first : -1;
        slot[j] = max(hd[j], 0) * kStride;
        r[j] = csum[j] = q[j] = 0.0f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) g[j][v] = acc[j][v] = 0.0f;
        if (hd[j] >= 0) {
          sgnn::load_cols<float, VEC>(gz + row * feat + cc, g[j]);
          r[j] = rz[row * heads + h_first + hd[j]];
        }
      }
      float td_tile[kMaxTileHeads];
#pragma unroll
      for (int i = 0; i < kMaxTileHeads; ++i) {
        td_tile[i] = i < n_th ? td[row * heads + h_first + i] : 0.0f;
      }
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
        const int my_src = lane < n ? col[e0 + lane] : 0;
        if (lane < n) {
          const float* tsr =
              ts + static_cast<int64_t>(my_src) * heads + h_first;
#pragma unroll
          for (int i = 0; i < kMaxTileHeads; ++i) {
            if (i < n_th) {
              float u, c;
              edge_weights(tsr[i] + td_tile[i], u, c);
              cs[i * kStride + lane] = c;
            }
          }
        }
        ss[lane] = my_src;
        __syncwarp();
        for (int k = 0; k < n; k += kUnroll) {
          float x[kUnroll][COLS][VEC];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const T* x_row =
                ht + static_cast<int64_t>(ss[(k + u) & 31]) * feat;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              if (k + u < n && hd[j] >= 0) {
                sgnn::load_cols<T, VEC>(x_row + col_of(c0, lane, j, VEC),
                                        x[u][j]);
              } else {
#pragma unroll
                for (int v = 0; v < VEC; ++v) x[u][j][v] = 0.0f;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (k + u >= n) break;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              const float c = cs[slot[one ? 0 : j] + k + u];
              if (!one || j == 0) csum[j] += c;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                acc[j][v] = fmaf(c, x[u][j][v], acc[j][v]);
              }
            }
          }
          // q += <Gz, sum c ht>_h - rz * sum c over these kUnroll edges
          float p[COLS];
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            p[j] = 0.0f;
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              p[j] = fmaf(acc[j][v], g[j][v], p[j]);
              acc[j][v] = 0.0f;
            }
          }
          if (one) {
            float pp = p[0];
#pragma unroll
            for (int j = 1; j < COLS; ++j) pp += p[j];
            q[0] += group_sum(pp, group) - r[0] * csum[0];
          } else {
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              q[j] += group_sum(p[j], group) - r[j] * csum[j];
            }
          }
#pragma unroll
          for (int j = 0; j < COLS; ++j) csum[j] = 0.0f;
        }
        __syncwarp();  // reads done before the next window's writes
      }
      // dtd of each head of the tile, from the lane holding its first column
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (hd[j] >= 0 && col_of(c0, lane, j, VEC) % fh == 0) {
          dtd[row * heads + h_first + hd[j]] = q[one ? 0 : j];
        }
      }
    }
  }
}

// B2's columns: 4 adjacent a lane where F and the head width are
// multiples of 4 and ht and gz are 16-byte aligned, else 1.
int dst_vec(const void* ht, const void* gz, int64_t feat, int heads) {
  return feat % 4 == 0 && (feat / heads) % 4 == 0 &&
                 reinterpret_cast<uintptr_t>(ht) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(gz) % 16 == 0
             ? 4
             : 1;
}

template <typename T>
using DstKernel = void (*)(const T*, const float*, const float*, const float*,
                           const float*, const int64_t*, const int32_t*,
                           float*, int64_t, int64_t, int, int64_t, int);

// gat_bwd_dst_kernel's instance for a layout.
template <typename T>
DstKernel<T> dst_kernel(int vec, const Tiling& t) {
  if (vec == 4) {
    return t.cols == 1 ? gat_bwd_dst_kernel<T, 1, 4>
                       : gat_bwd_dst_kernel<T, 2, 4>;
  }
  switch (t.cols) {
    case 1: return gat_bwd_dst_kernel<T, 1, 1>;
    case 2: return gat_bwd_dst_kernel<T, 2, 1>;
    case 4: return gat_bwd_dst_kernel<T, 4, 1>;
    default: return gat_bwd_dst_kernel<T, 8, 1>;
  }
}

template <typename T>
void launch_dst(const void* ht, const void* ts, const void* gz,
                const void* td, const void* rz, const void* rowptr,
                const void* col, void* dtd, int64_t num_rows, int64_t feat,
                int heads, int vec, const Tiling& t, cudaStream_t stream) {
  dst_kernel<T>(vec, t)
      <<<sgnn::warp_blocks(num_rows), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(ht), static_cast<const float*>(ts),
          static_cast<const float*>(gz), static_cast<const float*>(td),
          static_cast<const float*>(rz), static_cast<const int64_t*>(rowptr),
          static_cast<const int32_t*>(col), static_cast<float*>(dtd),
          num_rows, feat, heads, t.tw, t.group);
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
// Arguments as sgnn_gat_bwd_src's, without the walk's; the columns (vector
// or scalar) follow ht's and gz's alignment.
extern "C" int sgnn_gat_bwd_dst(const void* ht, const void* ts,
                                const void* gz, const void* td,
                                const void* rz, const void* rowptr,
                                const void* col, void* dtd,
                                long long num_rows, long long feat, int heads,
                                int dtype, void* stream) {
  const int vec = dst_vec(ht, gz, feat, heads);
  Tiling t;
  if (!args_ok(feat, heads) || !plan_tiling(feat, heads, vec, &t)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_dst<float>(ht, ts, gz, td, rz, rowptr, col, dtd, num_rows, feat,
                      heads, vec, t, s);
  } else if (dtype == 1) {
    launch_dst<__nv_bfloat16>(ht, ts, gz, td, rz, rowptr, col, dtd, num_rows,
                              feat, heads, vec, t, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B2's layout for these ht and gz (and ht's dtype): columns a load (4 or
// 1), column groups a lane, lanes of a head's reduction, and that
// instance's registers and local memory (spills) a thread as the loaded
// module reports them (cudaFuncGetAttributes).  Returns
// cudaErrorInvalidValue for arguments sgnn_gat_bwd_dst refuses, else the
// attribute query's error code.
extern "C" int sgnn_gat_bwd_dst_layout(const void* ht, const void* gz,
                                       long long feat, int heads, int dtype,
                                       int* vec, int* cols, int* group,
                                       int* registers, int* local_bytes) {
  Tiling t;
  if (!args_ok(feat, heads)) return static_cast<int>(cudaErrorInvalidValue);
  *vec = dst_vec(ht, gz, feat, heads);
  plan_tiling(feat, heads, *vec, &t);
  *cols = t.cols;
  *group = t.group;
  cudaFuncAttributes a{};
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = cudaFuncGetAttributes(&a, dst_kernel<float>(*vec, t));
  } else if (dtype == 1) {
    rc = cudaFuncGetAttributes(&a, dst_kernel<__nv_bfloat16>(*vec, t));
  }
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(rc);
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
