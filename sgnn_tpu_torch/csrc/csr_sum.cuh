// The edge-balanced, deterministic CSR walk that K2 (spmm.cu: the serving
// and whole-graph forward over the CSR, K2's backward over its transpose),
// K1's dx (gather_agg.cu, over a per-batch transpose of the block) and
// K4's B1 (gat_bwd.cu, over the transposed CSR) share.  What a walk sums
// is a policy (csr_walk's note lists its calls): SumPolicy, K2's and K1
// dx's, is
//
//     out[r, :] = sum over e in [rowptr[r], rowptr[r+1]) of w[e] * x[col[e], :]
//
// and B1's (gat_bwd.cu) stages per-edge attention weights, adds two sums
// and reduces a dot product per kUnroll edges.  The notes below speak of
// SumPolicy; B1's carries F + H columns.
//
// What bounds it on an H100: device-memory bytes (2*E*F flops on
// E*8 + 8*(R+1) + (S + R)*F*b bytes when every input is read once).  What
// slowed the row-per-warp design it replaces was not bytes but balance: a
// transposed CSR keyed by source has hub rows of ~1e6 edges (8% of E), and
// a row per warp leaves one warp busy while the card idles; its split of
// long rows needed a per-call plan (a cumsum) and a serial combine.
//
// Design: merge-path style, every warp gets the same number of edges.
//  * The edges are cut into chunks of `chunk` edges (the caller's
//    ops/segment.csr_chunk_edges); warp c takes chunk c = [c*chunk, (c+1)*chunk) and
//    finds its rows by binary searches of rowptr, so no host plan exists.
//    E is read from rowptr[num_rows] on the device: a caller that does not
//    know E (K1's transpose) sizes the grid for an upper bound.
//  * A row of at most `chunk` edges is short: the warp of the chunk where
//    it starts sums it whole, in edge order, and stores it once.  The warp
//    streams its short rows' edges in windows of 32, each lane loading one
//    edge's col and w, broadcast by shuffles, kUnroll source rows loaded
//    before their FMAs; the rows' ends come 32 at a time from one load per
//    lane.  So a warp sums at most 2*chunk edges.  The row searches are
//    warp-cooperative (32 pivots a round).
//  * Rows with no edges are written as zeros by a second loop of the same
//    kernel, 32 rows a warp, so a long run of them (a sampled block's
//    padded sources) is spread over the grid.
//  * A row of more than `chunk` edges is long: each chunk it overlaps sums
//    its piece there into a carry slot (f32, [2 * chunks, F]): slot 0 for
//    the long row holding the chunk's first edge, slot 1 for a long row
//    starting inside the chunk (it must cross the chunk's end).
//    carry_row[2c + s] names the row of slot s of chunk c, or -1.
//  * Fix-up, a fixed two-level tree: csr_carry_group_kernel sums each run
//    of kCarryGroup consecutive pieces of a long row (one warp per run,
//    lanes over columns as in the main kernel, pieces in chunk order,
//    kUnroll of them loaded at once) into the run's first slot;
//    csr_carry_finish_kernel, in the chunk holding the row's last edge,
//    sums the runs in order and stores the row once.  The tree depends on
//    the CSR and `chunk` only, not on the grid: at the 256-edge chunks of
//    the Reddit-shaped graph's transposed CSR its hub row of 984,366 edges
//    is about 3,846 pieces in 241 runs of 16, summed by 241 warps, then
//    241 terms per column.
//  * f32 sums and one rounding at the store (bf16 rounds to nearest even);
//    no float atomics anywhere, so the result is bit-identical from run to
//    run; offsets and row*F are 64-bit; x is f32 or bf16, w f32.
//  * Columns: VEC = 4 loads 4 adjacent columns per lane in one 16-byte
//    (f32) or 8-byte (bf16) access, when F % 4 == 0 and x is aligned
//    (F = 128 f32: one float4 a lane); else VEC = 1, scalar columns (F = 41
//    rows are not 16-byte aligned).  COLS groups a lane and a loop over
//    column tiles takes any F.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sgnn {

constexpr int kCarryGroup = 16;  // pieces per run of the fix-up's first level
constexpr int kUnroll = 4;       // source rows loaded before their FMAs

template <typename T, int VEC>
__device__ __forceinline__ void load_cols(const T* __restrict__ p,
                                          float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (VEC == 4) {  // bf16: 8 bytes
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else {
    v[0] = to_float(p[0]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_cols(T* __restrict__ p,
                                           const float (&v)[VEC]) {
  if constexpr (VEC == 4 && std::is_same_v<T, float>) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned*>(&a);
    q.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    p[0] = from_float<T>(v[0]);
  }
}

// A lane's columns of one column tile: group j covers columns
// c0 + (lane + 32 j) * VEC .. + VEC - 1, all in range or all out of it.
template <int COLS, int VEC>
struct Tile {
  float acc[COLS][VEC];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[j][q] = 0.0f;
    }
  }
};

__device__ __forceinline__ int64_t col_of(int64_t c0, int lane, int j,
                                          int vec) {
  return c0 + static_cast<int64_t>(lane + 32 * j) * vec;
}

// kUnroll edges' source rows, loaded before any FMA; edges at or past n
// are skipped (warp-uniform: every lane holds the same k and n).
template <typename T, int COLS, int VEC>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, int my_col,
                                          float my_w, int k, int n,
                                          int64_t feat, int64_t c0, int lane,
                                          float (&v)[kUnroll][COLS][VEC],
                                          float (&wk)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int src = __shfl_sync(kFullMask, my_col, (k + u) & 31);
    wk[u] = __shfl_sync(kFullMask, my_w, (k + u) & 31);
    const T* row = x + static_cast<int64_t>(src) * feat;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t c = col_of(c0, lane, j, VEC);
      if (k + u < n && c < feat) {
        load_cols<T, VEC>(row + c, v[u][j]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[u][j][q] = 0.0f;
      }
    }
  }
}

template <int COLS, int VEC>
__device__ __forceinline__ void fma_row(Tile<COLS, VEC>& t, float wk,
                                        const float (&v)[COLS][VEC]) {
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) t.acc[j][q] = fmaf(wk, v[j][q], t.acc[j][q]);
  }
}

template <typename T, int COLS, int VEC>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const Tile<COLS, VEC>& t,
                                           int64_t feat, int64_t c0,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int64_t c = col_of(c0, lane, j, VEC);
    if (c < feat) store_cols<T, VEC>(dst + c, t.acc[j]);
  }
}

// The first r in [0, n) with a[r] >= key (n if none), a nondecreasing.
// The warp searches together: each round every lane tests one of 32
// evenly spaced pivots and a ballot keeps the one span that holds the
// answer, so ~log32(n) dependent loads instead of log2(n).  Warp-uniform:
// every lane passes the same a, n and key.
__device__ __forceinline__ int64_t warp_lower_bound(const int64_t* a,
                                                    int64_t n, int64_t key,
                                                    int lane) {
  // a[i] < key for i < lo; hi == n or a[hi] >= key
  int64_t lo = 0, hi = n;
  while (hi - lo >= 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned m = __ballot_sync(kFullMask, p >= hi || a[p] >= key);
    if (m == 0) {
      lo += 31 * step + 1;
    } else {
      const int f = __ffs(m) - 1;
      if (f == 0) return lo;
      hi = min(hi, lo + f * step);
      lo += (f - 1) * step + 1;
    }
  }
  const int64_t p = lo + lane;
  const unsigned m = __ballot_sync(kFullMask, p >= hi || a[p] >= key);
  return lo + __ffs(m) - 1;
}

__device__ __forceinline__ int64_t csr_chunks(const int64_t* rowptr,
                                              int64_t num_rows,
                                              int64_t chunk) {
  const int64_t num_edges = rowptr[num_rows];
  return max(static_cast<int64_t>(1), (num_edges + chunk - 1) / chunk);
}

// The window of row ends a warp streams with: lane i holds the end of row
// win + i (past the last row, the largest int64, so the window stays
// nondecreasing for edge_row's search).
__device__ __forceinline__ void load_ends(const int64_t* __restrict__ rowptr,
                                          int64_t num_rows, int64_t win,
                                          int lane, int64_t& my_end) {
  my_end = win + lane < num_rows ? rowptr[win + lane + 1] : INT64_MAX;
}

// next_row's rare path, out of line so that the unrolled edge loop stays
// small: past a run of rows without edges longer than the window, the
// first row in [from, r_stop) that ends past `at`.
__device__ __noinline__ int64_t jump_row(const int64_t* __restrict__ rowptr,
                                         int64_t r_stop, int64_t from,
                                         int64_t at, int lane) {
  return from +
         warp_lower_bound(rowptr + from + 1, r_stop - from, at + 1, lane);
}

// The first row r in [from, r_stop) that ends past `at` (r_stop if none);
// it starts at `at`.  The window moves to hold it.  Warp-uniform.
__device__ __forceinline__ int64_t next_row(const int64_t* __restrict__ rowptr,
                                            int64_t num_rows, int64_t r_stop,
                                            int64_t from, int64_t at, int lane,
                                            int64_t& win, int64_t& my_end) {
  if (from >= r_stop) return r_stop;
  if (from - win >= 32) {
    win = from;
    load_ends(rowptr, num_rows, win, lane, my_end);
  }
  const unsigned m = __ballot_sync(
      kFullMask, win + lane >= from && win + lane < r_stop && my_end > at);
  if (m != 0) return win + __ffs(m) - 1;
  const int64_t nr = jump_row(rowptr, r_stop, from, at, lane);
  if (nr < r_stop) {
    win = nr;
    load_ends(rowptr, num_rows, win, lane, my_end);
  }
  return nr;
}

// The row of edge e, for a window of edges that starts in row r: the
// first row r' >= r that ends past e, searched among the window of row
// ends (lane i holds the end of row win + i, r in [win, win + 32)) with
// lanes as pivots, or in rowptr past the window (a run of rows with no
// edges).  Every lane passes its own e; warp-uniform (the shuffles need
// all 32 lanes).
__device__ __forceinline__ int64_t edge_row(const int64_t* __restrict__ rowptr,
                                            int64_t r, int64_t r_stop,
                                            int64_t win, int64_t my_end,
                                            int64_t e) {
  int lo = static_cast<int>(r - win), hi = 32;  // the answer's lane: [lo, hi]
#pragma unroll
  for (int it = 0; it < 6; ++it) {
    const int mid = min((lo + hi) >> 1, 31);
    const int64_t m = __shfl_sync(kFullMask, my_end, mid);
    if (lo < hi) {
      if (m > e) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
  }
  if (lo < 32) return win + lo;
  int64_t a = win + 32, b = r_stop;
  while (a < b) {
    const int64_t mid = a + (b - a) / 2;
    if (rowptr[mid + 1] > e) {
      b = mid;
    } else {
      a = mid + 1;
    }
  }
  return a;
}

// What a walk sums, as a policy P (SumPolicy below is K2's and K1 dx's
// weighted row sum; gat_bwd.cu's B1 is another).  Every call is
// warp-uniform.
//   P::kNeedsRow      stage() is given the row of its lane's edge
//   P::Acc, P::Edge   a lane's sums of one row (or piece) in the tile, and
//                     what it staged for one edge of the window
//   P::Rows           kUnroll edges' loads
//   P::Shared, bind() per-warp shared memory, bound once by the kernel
//   width(), tile()   columns, and columns a pass over the chunk
//   begin_tile(c0)    start a column tile
//   begin_row(t, r)   start row r's sums (r = -1: past the last row)
//   stage(e, live, r) lane i stages edge e of the window (live: e is one)
//   load(m, k, n, v)  the window's edges k..k+kUnroll-1 (< n) loaded
//   add(t, m, v, u, k) edge k+u added
//   flush(t)          after each kUnroll edges
//   store_row(t, r)   row r complete; store_piece(t, slot) a long row's
//                     piece into its carry slot; zero_row(r) r has no edge
// The sum of edges [beg, end) of row `row` in edge order, one column tile,
// into t (a long row's piece).
template <class P>
__device__ __forceinline__ void walk_piece(P& p, int64_t row, int64_t beg,
                                           int64_t end, int lane,
                                           typename P::Acc& t) {
  p.begin_row(t, row, lane);
  for (int64_t e0 = beg; e0 < end; e0 += 32) {
    const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
    const typename P::Edge m = p.stage(e0 + lane, lane < n, row, lane);
    for (int k = 0; k < n; k += kUnroll) {
      typename P::Rows v;
      p.load(m, k, n, lane, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < n) p.add(t, m, v, u, k);
      }
      p.flush(t, lane);
    }
  }
}

template <class P>
__device__ __forceinline__ void csr_walk(P& p,
                                         const int64_t* __restrict__ rowptr,
                                         int32_t* __restrict__ carry_row,
                                         int64_t num_rows, int64_t chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t num_edges = rowptr[num_rows];
  const int64_t n_chunks = csr_chunks(rowptr, num_rows, chunk);
  // every branch below depends only on the chunk, a row or a broadcast
  // value: warp-uniform, so the full-mask shuffles see all 32 lanes
  for (int64_t c = first; c < n_chunks; c += stride) {
    const int64_t e0 = c * chunk;
    const int64_t e1 = min(e0 + chunk, num_edges);
    const bool last = c == n_chunks - 1;
    // the rows starting in [e0, e1) ([e0, E] in the last chunk, which so
    // takes the trailing rows with no edges): [rs, rl)
    const int64_t rs = warp_lower_bound(rowptr, num_rows, e0, lane);
    const int64_t rl =
        last ? num_rows : warp_lower_bound(rowptr, num_rows, e1, lane);
    // slot 0: the long row holding edge e0 (the first r with
    // rowptr[r+1] > e0), whether it starts here or before
    int64_t row0 = -1;
    if (e0 < num_edges) {
      const int64_t r0 = warp_lower_bound(rowptr + 1, num_rows, e0 + 1, lane);
      if (rowptr[r0 + 1] - rowptr[r0] > chunk) row0 = r0;
    }
    // slot 1: a long row starting inside (e0, e1); it is the last of
    // [rs, rl), and the streamed short rows stop before it.  A long row
    // starting at e0 is slot 0's and also the last of [rs, rl)
    int64_t row1 = -1, r_stop = rl;
    if (rl > rs && rowptr[rl] - rowptr[rl - 1] > chunk) {
      r_stop = rl - 1;
      if (rowptr[rl - 1] > e0) row1 = rl - 1;
    }
    for (int64_t c0 = 0; c0 < p.width(); c0 += p.tile()) {
      p.begin_tile(c0, lane);
      typename P::Acc t;
      if (row0 >= 0) {
        walk_piece(p, row0, e0, min(rowptr[row0 + 1], e1), lane, t);
        p.store_piece(t, 2 * c, lane);
      }
      if (row1 >= 0) {
        walk_piece(p, row1, rowptr[row1], e1, lane, t);
        p.store_piece(t, 2 * c + 1, lane);
      }
      // the short rows of [rs, r_stop) that have edges, streamed over
      // their edges (rows with no edges are the zero loop's, below)
      int64_t win = rs;  // lane i holds the end of row win + i
      int64_t my_end;
      load_ends(rowptr, num_rows, win, lane, my_end);
      int64_t pos = rowptr[rs];
      const int64_t end = rowptr[r_stop];
      int64_t r = next_row(rowptr, num_rows, r_stop, rs, pos, lane, win,
                           my_end);
      int64_t r_end =
          r < r_stop ? __shfl_sync(kFullMask, my_end, static_cast<int>(r - win))
                     : -1;
      p.begin_row(t, r < r_stop ? r : -1, lane);
      for (; pos < end; pos += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32),
                                           end - pos));
        int64_t my_row = r;
        if constexpr (P::kNeedsRow) {
          my_row = edge_row(rowptr, r, r_stop, win, my_end,
                            min(pos + lane, end - 1));
        }
        const typename P::Edge m = p.stage(pos + lane, lane < n, my_row,
                                           lane);
        for (int k = 0; k < n; k += kUnroll) {
          typename P::Rows v;
          p.load(m, k, n, lane, v);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (k + u < n) {
              p.add(t, m, v, u, k);
              if (pos + k + u + 1 == r_end) {  // row r is complete
                p.store_row(t, r, lane);
                r = next_row(rowptr, num_rows, r_stop, r + 1, r_end, lane,
                             win, my_end);
                r_end = r < r_stop ? __shfl_sync(kFullMask, my_end,
                                                 static_cast<int>(r - win))
                                   : -1;
                p.begin_row(t, r < r_stop ? r : -1, lane);
              }
            }
          }
          p.flush(t, lane);
        }
      }
    }
    if (lane == 0) {
      carry_row[2 * c] = static_cast<int32_t>(row0);
      carry_row[2 * c + 1] = static_cast<int32_t>(row1);
    }
  }
  // rows with no edges: zeros, 32 rows a warp.  (The transpose of a
  // sampled block ends in a run of padded sources with no entries: one
  // chunk's warp walking it would serialise the whole call.)
  const int64_t n_groups = (num_rows + 31) / 32;
  for (int64_t g = first; g < n_groups; g += stride) {
    const int64_t r = g * 32 + lane;
    unsigned m = __ballot_sync(
        kFullMask, r < num_rows && rowptr[r] == rowptr[r + 1]);
    while (m != 0) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      p.zero_row(g * 32 + b, lane);
    }
  }
}

// The walk as one kernel: p holds the policy's arguments, and a policy
// with per-warp shared memory gets its warp's P::Shared through bind().
template <class P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_walk_kernel(P p, const int64_t* __restrict__ rowptr,
                int32_t* __restrict__ carry_row, int64_t num_rows,
                int64_t chunk) {
  __shared__ typename P::Shared shared[kWarpsPerBlock];
  p.bind(shared[threadIdx.x >> 5]);
  csr_walk(p, rowptr, carry_row, num_rows, chunk);
}

// K2's and K1 dx's sum: out[r] = sum of w[e] * x[col[e]] over row r, out
// in x's dtype, the carry [slots, feat] f32.
template <typename T, int COLS, int VEC>
struct SumPolicy {
  static constexpr bool kNeedsRow = false;
  struct Shared {};
  using Acc = Tile<COLS, VEC>;
  struct Edge {
    int col;
    float w;
  };
  struct Rows {
    float v[kUnroll][COLS][VEC];
    float wk[kUnroll];
  };

  const T* __restrict__ x;
  const int32_t* __restrict__ col;
  const float* __restrict__ w;
  T* __restrict__ out;
  float* __restrict__ carry;
  int64_t feat;
  int64_t c0;

  __device__ __forceinline__ void bind(Shared&) {}
  __device__ __forceinline__ int64_t width() const { return feat; }
  __device__ __forceinline__ int64_t tile() const { return 32 * COLS * VEC; }
  __device__ __forceinline__ void begin_tile(int64_t c, int) { c0 = c; }
  __device__ __forceinline__ void begin_row(Acc& t, int64_t, int) {
    t.zero();
  }
  __device__ __forceinline__ Edge stage(int64_t e, bool live, int64_t, int) {
    Edge m{0, 0.0f};
    if (live) {
      m.col = col[e];
      m.w = w[e];
    }
    return m;
  }
  __device__ __forceinline__ void load(const Edge& m, int k, int n, int lane,
                                       Rows& v) const {
    load_rows<T, COLS, VEC>(x, m.col, m.w, k, n, feat, c0, lane, v.v, v.wk);
  }
  __device__ __forceinline__ void add(Acc& t, const Edge&, const Rows& v,
                                      int u, int) const {
    fma_row<COLS, VEC>(t, v.wk[u], v.v[u]);
  }
  __device__ __forceinline__ void flush(Acc&, int) const {}
  __device__ __forceinline__ void store_row(const Acc& t, int64_t r,
                                            int lane) const {
    store_tile<T, COLS, VEC>(out + r * feat, t, feat, c0, lane);
  }
  __device__ __forceinline__ void store_piece(const Acc& t, int64_t slot,
                                              int lane) const {
    store_tile<float, COLS, VEC>(carry + slot * feat, t, feat, c0, lane);
  }
  __device__ __forceinline__ void zero_row(int64_t r, int lane) const {
    T* dst = out + r * feat;
    for (int64_t f = lane; f < feat; f += 32) dst[f] = from_float<T>(0.0f);
  }
};

// SumPolicy's fix-up store: a finished long row, VEC columns at c.
template <typename T>
struct RowStore {
  T* __restrict__ out;
  int64_t feat;

  template <int VEC>
  __device__ __forceinline__ void store(int64_t r, int64_t c,
                                        const float (&v)[VEC]) const {
    store_cols<T, VEC>(out + r * feat + c, v);
  }
};

// Where a long row's pieces lie: chunk c0 = rowptr[r] / chunk holds the
// first, in slot 0 if the row starts at the chunk's first edge, else in
// slot 1; every later chunk holds one in slot 0.
__device__ __forceinline__ int64_t piece_slot(int64_t cc, int64_t c0,
                                              int64_t s0) {
  return 2 * cc + (cc == c0 ? s0 : 0);
}

// t += the pieces of a long row (first chunk c0, its slot there s0) at
// chunks from, from + step, ... up to `to`, in that order; kUnroll pieces'
// loads in flight.
template <int COLS, int VEC>
__device__ __forceinline__ void add_pieces(const float* __restrict__ carry,
                                           int64_t from, int64_t to,
                                           int64_t step, int64_t c0,
                                           int64_t s0, int64_t feat,
                                           int64_t c0col, int lane,
                                           Tile<COLS, VEC>& t) {
  for (int64_t cc = from; cc <= to; cc += kUnroll * step) {
    float v[kUnroll][COLS][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t at = cc + u * step;
      const float* piece = carry + piece_slot(at, c0, s0) * feat;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = col_of(c0col, lane, j, VEC);
        if (at <= to && c < feat) {
          load_cols<float, VEC>(piece + c, v[u][j]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v[u][j][q] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cc + u * step > to) break;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) t.acc[j][q] += v[u][j][q];
      }
    }
  }
}

// First level: each run of kCarryGroup pieces (counted from the row's
// first chunk) summed in chunk order into the run's first slot.  Lanes
// over columns as in the main kernel.
template <int COLS, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_carry_group_kernel(const int64_t* __restrict__ rowptr,
                       float* __restrict__ carry,
                       const int32_t* __restrict__ carry_row,
                       int64_t num_rows, int64_t chunk, int64_t feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t n_chunks = csr_chunks(rowptr, num_rows, chunk);
  for (int64_t c = first; c < n_chunks; c += stride) {
    for (int s = 0; s < 2; ++s) {
      const int64_t r = carry_row[2 * c + s];
      if (r < 0) continue;
      const int64_t rb = rowptr[r], re = rowptr[r + 1];
      const int64_t c0 = rb / chunk, c_last = (re - 1) / chunk;
      if ((c - c0) % kCarryGroup != 0) continue;
      const int64_t s0 = rb == c0 * chunk ? 0 : 1;
      const int64_t c_end = min(c + kCarryGroup - 1, c_last);
      for (int64_t c0col = 0; c0col < feat; c0col += 32 * COLS * VEC) {
        Tile<COLS, VEC> t;
        t.zero();
        add_pieces<COLS, VEC>(carry, c, c_end, 1, c0, s0, feat, c0col, lane,
                              t);
        store_tile<float, COLS, VEC>(carry + (2 * c + s) * feat, t, feat,
                                     c0col, lane);
      }
    }
  }
}

// Second level: in the chunk holding a long row's last edge, the row's
// runs summed in order and the row stored once, through the walk's
// store: s.store(r, c, v) takes VEC columns at c < pitch.
template <class S, int COLS, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_carry_finish_kernel(S s, const int64_t* __restrict__ rowptr,
                        const float* __restrict__ carry,
                        const int32_t* __restrict__ carry_row,
                        int64_t num_rows, int64_t chunk, int64_t pitch) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t n_chunks = csr_chunks(rowptr, num_rows, chunk);
  for (int64_t c = first; c < n_chunks; c += stride) {
    const int64_t r = carry_row[2 * c];
    if (r < 0) continue;
    const int64_t rb = rowptr[r], re = rowptr[r + 1];
    if ((re - 1) / chunk != c) continue;  // not the row's last chunk
    const int64_t c0 = rb / chunk;
    const int64_t s0 = rb == c0 * chunk ? 0 : 1;
    for (int64_t c0col = 0; c0col < pitch; c0col += 32 * COLS * VEC) {
      Tile<COLS, VEC> t;
      t.zero();
      add_pieces<COLS, VEC>(carry, c0, c, kCarryGroup, c0, s0, pitch, c0col,
                            lane, t);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t col = col_of(c0col, lane, j, VEC);
        if (col < pitch) s.template store<VEC>(r, col, t.acc[j]);
      }
    }
  }
}

// The walk's three kernels on `stream`: the walk over the chunks (a warp
// a chunk, or per 32 rows of the zero loop if there are more), then the
// two levels of the fix-up over the carry ([2 * max_chunks, pitch] f32,
// COLS and VEC as the walk's when the walk's store sums them).
template <class P, class S, int COLS, int VEC>
void csr_walk_launch(const P& p, const S& s, const int64_t* rowptr,
                     float* carry, int32_t* carry_row, int64_t num_rows,
                     int64_t max_chunks, int64_t chunk, int64_t pitch,
                     cudaStream_t stream) {
  const dim3 grid(warp_blocks(max_chunks)), block(kWarpsPerBlock * 32);
  const dim3 main_grid(
      warp_blocks(std::max<int64_t>(max_chunks, (num_rows + 31) / 32)));
  csr_walk_kernel<P><<<main_grid, block, 0, stream>>>(p, rowptr, carry_row,
                                                      num_rows, chunk);
  csr_carry_group_kernel<COLS, VEC><<<grid, block, 0, stream>>>(
      rowptr, carry, carry_row, num_rows, chunk, pitch);
  csr_carry_finish_kernel<S, COLS, VEC><<<grid, block, 0, stream>>>(
      s, rowptr, carry, carry_row, num_rows, chunk, pitch);
}

template <typename T, int COLS, int VEC>
void csr_sum_cols(const T* x, const int64_t* rowptr, const int32_t* col,
                  const float* w, T* out, float* carry, int32_t* carry_row,
                  int64_t num_rows, int64_t max_chunks, int64_t chunk,
                  int64_t feat, cudaStream_t stream) {
  const SumPolicy<T, COLS, VEC> p{x, col, w, out, carry, feat, 0};
  csr_walk_launch<SumPolicy<T, COLS, VEC>, RowStore<T>, COLS, VEC>(
      p, RowStore<T>{out, feat}, rowptr, carry, carry_row, num_rows,
      max_chunks, chunk, feat, stream);
}

// Launch the three kernels for x of type T.  max_edges >= rowptr[num_rows]
// sizes the grid: max_chunks = max(1, ceil(max_edges / chunk)) warps, and
// carry [2 * max_chunks, feat] f32, carry_row [2 * max_chunks] int32.  vec
// != 0 takes VEC = 4 (the caller checked feat % 4 == 0 and x's alignment).
template <typename T>
void csr_sum(const void* x, const void* rowptr, const void* col,
             const void* w, void* out, void* carry, void* carry_row,
             int64_t num_rows, int64_t max_edges, int64_t chunk, int64_t feat,
             bool vec, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const int64_t* rp = static_cast<const int64_t*>(rowptr);
  const int32_t* cp = static_cast<const int32_t*>(col);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  float* kp = static_cast<float*>(carry);
  int32_t* kr = static_cast<int32_t*>(carry_row);
  const int64_t max_chunks =
      std::max<int64_t>(1, (max_edges + chunk - 1) / chunk);
  if (vec) {
    if (feat <= 128) {
      csr_sum_cols<T, 1, 4>(xp, rp, cp, wp, op, kp, kr, num_rows, max_chunks,
                            chunk, feat, stream);
    } else {
      csr_sum_cols<T, 2, 4>(xp, rp, cp, wp, op, kp, kr, num_rows, max_chunks,
                            chunk, feat, stream);
    }
  } else if (feat <= 32) {
    csr_sum_cols<T, 1, 1>(xp, rp, cp, wp, op, kp, kr, num_rows, max_chunks,
                          chunk, feat, stream);
  } else if (feat <= 64) {
    csr_sum_cols<T, 2, 1>(xp, rp, cp, wp, op, kp, kr, num_rows, max_chunks,
                          chunk, feat, stream);
  } else if (feat <= 128) {
    csr_sum_cols<T, 4, 1>(xp, rp, cp, wp, op, kp, kr, num_rows, max_chunks,
                          chunk, feat, stream);
  } else {
    csr_sum_cols<T, 8, 1>(xp, rp, cp, wp, op, kp, kr, num_rows, max_chunks,
                          chunk, feat, stream);
  }
}

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Returns
// cudaGetLastError() after the launches.
inline int csr_sum_dispatch(const void* x, const void* rowptr,
                            const void* col, const void* w, void* out,
                            void* carry, void* carry_row, int64_t num_rows,
                            int64_t max_edges, int64_t chunk, int64_t feat,
                            int vec, int dtype, cudaStream_t stream) {
  if (chunk < 1 || num_rows < 1 || feat < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    csr_sum<float>(x, rowptr, col, w, out, carry, carry_row, num_rows,
                   max_edges, chunk, feat, vec != 0, stream);
  } else if (dtype == 1) {
    csr_sum<__nv_bfloat16>(x, rowptr, col, w, out, carry, carry_row,
                           num_rows, max_edges, chunk, feat, vec != 0,
                           stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgnn
