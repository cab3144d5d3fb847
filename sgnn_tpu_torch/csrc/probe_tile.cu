// Rate probes of the TPU's one-hot tiles, as Hopper computes the same sums:
// P-T (tile SpMM, with the bisect cases as its modes) and P-A (GAT tile).
//
// P-T replaces scripts/profile_onehot_spmm.py:43 `onehot_spmm` (its
// pl.pallas_call at :101) and the cases of scripts/probe_onehot_parts.py
// (:55, :93, :146) and probe_onehot_parts2.py (:57, :83, :110):
//
//   out[r0[s, e / e_sub] + dst[s, e], :] +=
//       f32(w[s, e]) * f32(slab[src[s, e], :])
//
// over every step s and edge e of [n_steps, e_t], into one f32 block
// (slab bf16 [S_BLK, F]; dst null: dst[s, e] = e; w null: weight 1), or
// the gather alone (case c1): out[s * e_t + e, :] = f32(slab[src[s, e],
// :]).  The TPU built both the gather and the scatter as one-hot matrix
// products on the MXU, about 2F(S_BLK + W) operations an edge, because
// Mosaic had no in-kernel gather and scatter.  Hopper has both, so the
// kernel gathers and scatters directly: 2F operations an edge.  A message is rounded to bf16 where the
// JAX code casts it (profile_onehot_spmm.py:67); a gathered bf16 row is
// already that value, and each product of two bf16 values is exact in f32,
// as on the MXU.
//
// The TPU summed all steps into one VMEM-resident block in order, because
// its grid runs in order.  Blocks here run in parallel.  The first design
// scattered each weighted message with an f32 float4 atomic add into the
// out block in L2: F/4 = 32 vector atomics an edge, 33.5 M for
// configuration 0's 2^20 edges, which the rate of L2 atomics limited, and
// an order of adds into a row that changed from run to run.  Now the sum
// is ordered and atomic-free, as every model kernel of the port is, in
// two launches:
//  * tile_group_kernel: each tile of kTileItems edges groups its edges by
//    bucket of 32 out rows (row >> 5; blocks of up to 2^14 rows, the
//    probe's 8192), stably (rank_tile.cuh's rank_tile), into its own
//    slots, with each bucket's offsets: no global count, scan or scatter.
//    The pairs carry each edge's row, bf16 weight and source (TileRows),
//    so nothing is gathered by edge id later;
//  * tile_bucket_sum_kernel, a block a bucket: it walks the tiles'
//    segments of its bucket in tile order, groups each chunk of them by
//    row in shared memory (the same stable ranking on the 5 low bits),
//    and a half-warp sums a row's edges in (step, edge) order, 4 slab rows
//    in flight (16 bytes, 8 bf16 columns a lane: one load instruction
//    serves two rows; the 256 KiB slab stays in L1/L2), an f32 FMA sum
//    carried across chunks, each out row written once (zeros for a row
//    without edges, so out needs no zeroing).  The result is bit-identical
//    from run to run and equals tile_spmm_ordered (ops/probes.py) bit for
//    bit; it differs from index_add_ only in the order of the f32 sums.
// What limits it is not bytes: the grouping's ranking rounds and the
// sum's dependent slab-row loads (PERF.md, section 6).
// The gather (c1) has no sum: tile_gather_kernel, a warp per 32 edges,
// their indices loaded once and broadcast, a lane storing 4 f32 columns.
// Bound on this card: device-memory bytes (2^20 edges: 10 bytes of
// indices and weight each, the slab and the 4 MiB block once; 15 MB, 4.4
// us at 3.35 TB/s) beside 2F f32 operations an edge (4.0 us at 67
// TFLOP/s).  Any design here reads a slab row an edge, 2^20 x 256 B = 268
// MB, from L1/L2; the grouping moves about 25 MB more.

// P-A replaces scripts/probe_gat_kernel_parts.py:38 `kernel` (its
// pl.pallas_call at :98): a GAT tile, per tile t of n_tiles,
//
//   u[e, j]  = exp(clip(lrelu_0.2(f32 ts[s, j] + f32(bf16 td[d, j])), ±60))
//   out[d, c] += f32(bf16(bf16(u[e, c / fh]) * slab[s, c]))    fh = F/heads
//   z[d, j]  += u[e, j]                                          (f32)
//
// for each edge e = (s, d) of the tile, over the table's `cols` columns.
// Those are the JAX kernel's rounding points (:57, :69-73, :78).  The
// pads are semantics: an edge with src = S_BLK (the one-hot row of nothing)
// has ts's half 0 and still adds its u to z[d]; one with dst = W_WIN adds
// nothing.  The kernel tests both, since CUDA would read past the tables.
// One block a tile: u for every (edge, column) into shared memory first,
// then one thread per output column (and per z column) walks the edges in
// order, adding into a [W, F] f32 tile in shared memory, its slab loads
// eight edges ahead; each output is written once: deterministic.  Bound:
// the tile's bytes (slab 64 KiB, out 64 KiB at the probe's shapes) against
// a few operations per edge and column; the edge walk is serial per
// column, so the latency of the slab row loads is what it hides or not.

#include "rank_tile.cuh"

namespace {

using sgnn::kFullMask;

constexpr int kTileWarps = 8;
constexpr int kTileUnroll = 4;  // slab rows in flight a half-warp
// out rows of a bucket (the grouping's digit is row >> kRowBits), the
// sum's warps a block and edges a chunk
constexpr int kRowBits = 5;
constexpr int kBucketRows = 1 << kRowBits;
constexpr int kSumWarps = 16;
constexpr int kSumChunk = 2048;
constexpr int kGroupWarps = 16;  // the grouping's warps a tile
// a thread per out column (128) and per z column (8), in 5 warps
constexpr int kGatThreads = 160;
constexpr int kEdgeBatch = 8;
constexpr int kMaxTableCols = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may ask for
constexpr float kNegSlope = 0.2f;  // ops/gat.NEG_SLOPE
constexpr float kClip = 60.0f;     // ops/gat.ATT_CLIP

__device__ __forceinline__ float4 bf16x4_to_float4(const uint2 raw) {
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));  // round to nearest even
}

// Edge i = step * e_t + e as the grouping's pair: .x its output row
// r0[step, e / e_sub] + dst[i] (dst null: e) in the low 16 bits and its
// weight's bf16 bits (w null: 1.0) in the high 16, .y its source src[i].
// The sum needs nothing else, so it gathers nothing by edge id; the
// grouping's digit is row bits (rows < 2^14).
struct TileRows {
  const int32_t* src;
  const int32_t* dst;
  const __nv_bfloat16* w;
  const int32_t* r0;
  int e_t, e_sub, n_sub;

  // n_edges < 2^31: 32-bit unsigned division
  __device__ __forceinline__ int2 operator()(int64_t i) const {
    const unsigned ui = static_cast<unsigned>(i);
    const unsigned step = ui / static_cast<unsigned>(e_t);
    const unsigned e = ui - step * static_cast<unsigned>(e_t);
    const int row = __ldg(r0 + step * n_sub + e / e_sub) +
                    (dst != nullptr ? __ldg(dst + i) : static_cast<int>(e));
    const unsigned wb =
        w != nullptr ? __bfloat16_as_ushort(w[i]) : 0x3f80u;  // bf16 1.0
    return make_int2(static_cast<int>((wb << 16) | static_cast<unsigned>(row)),
                     __ldg(src + i));
  }
};

__global__ void __launch_bounds__(kTileWarps * 32)
tile_gather_kernel(const __nv_bfloat16* __restrict__ slab,
                   const int32_t* __restrict__ src, float* __restrict__ out,
                   int64_t n_edges, int feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileWarps +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTileWarps;
  for (int64_t chunk = first; chunk * 32 < n_edges; chunk += stride) {
    const int64_t e0 = chunk * 32;
    const int n = n_edges - e0 < 32 ? static_cast<int>(n_edges - e0) : 32;
    const int my_src = lane < n ? src[e0 + lane] : 0;
    // n is warp-uniform: every lane runs every shuffle
    for (int k = 0; k < n; ++k) {
      const int s = __shfl_sync(kFullMask, my_src, k);
      const __nv_bfloat16* srow = slab + static_cast<int64_t>(s) * feat;
      float* orow = out + (e0 + k) * feat;
      for (int c = lane * 4; c < feat; c += 32 * 4) {
        *reinterpret_cast<float4*>(orow + c) =
            bf16x4_to_float4(*reinterpret_cast<const uint2*>(srow + c));
      }
    }
  }
}

// The sort's first level, one tile of kTileItems edges a block of
// kGroupWarps warps: its pairs (TileRows) grouped by bucket, row >>
// kRowBits, stably (rank_tile.cuh's rank_tile, 4 rounds a warp), into the
// tile's own slots of `local`, and offsets[tile][d] the first slot of
// bucket d (offsets[tile][kBuckets] the tile's edges).  Every write stays
// in the tile's rows: no global count, scan or scatter.
__global__ void __launch_bounds__(kGroupWarps * 32)
tile_group_kernel(TileRows keys, int64_t n_edges, int2* __restrict__ local,
                  int32_t* __restrict__ offsets) {
  using sgnn::kBuckets;
  constexpr int kRounds = sgnn::kTileItems / (kGroupWarps * 32);
  static_assert(kBuckets == kGroupWarps * 32, "a bucket a thread");
  __shared__ int32_t warp_at[kGroupWarps][kBuckets];
  __shared__ int32_t warp_sum[kGroupWarps];
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 item[kRounds];
  int32_t rank[kRounds];
  int digit[kRounds];
  sgnn::rank_tile<kGroupWarps>(keys, nullptr, n_edges, kRowBits, tile, item,
                               digit, rank, warp_at);
  __syncthreads();
  // bucket d = this thread: each warp's first place within the bucket,
  // the bucket's edges, then an exclusive scan of the buckets
  const int d = threadIdx.x;
  int32_t tot = 0;
  for (int v = 0; v < kGroupWarps; ++v) {
    const int32_t c = warp_at[v][d];
    warp_at[v][d] = tot;
    tot += c;
  }
  int32_t incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t up = __shfl_up_sync(kFullMask, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  for (int v = 0; v < warp; ++v) incl += warp_sum[v];
  const int32_t first = incl - tot;
  // the bucket's first slot, on top of each warp's place in it
  for (int v = 0; v < kGroupWarps; ++v) warp_at[v][d] += first;
  int32_t* off = offsets + tile * (kBuckets + 1);
  off[d] = first;
  if (d == kBuckets - 1) off[kBuckets] = incl;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    if (digit[j] < kBuckets) {
      local[tile * sgnn::kTileItems + warp_at[warp][digit[j]] + rank[j]] =
          item[j];
    }
  }
}

// The sum of bucket b (blockIdx.x): out rows [32 b, 32 b + 32), whose
// edges are tile t's slots [offsets[t][b], offsets[t][b + 1]) for t in
// order: (step, edge) order.  A window of kSumWarps * 32 tiles at a time
// (a tile a thread, their segments' ends scanned into win_end), and a
// chunk of kSumChunk of the window's edges at a time: each warp ranks its
// kSumChunk / kSumWarps edges by local row (row & 31) in edge order
// (as rank_tile.cuh's rank_tile ranks digits), the ranks become places,
// and each edge's (src, f32 w) is written to its place, so the chunk is
// grouped by row in edge order; then the half-warps of warp v sum rows v
// and v + kSumWarps of the chunk into registers, side by side,
// kTileUnroll slab rows in flight (16 lanes over 8-column groups of a
// 128-column tile).  Rows carry across chunks, and every row of the
// bucket is written once at the end.  At most 64 registers a thread, so
// two blocks share an SM.
struct BucketSmem {
  int2 order[kSumChunk];                // the chunk's (src, w bits) by row
  int32_t at[kSumWarps][kBucketRows];   // per warp and row: count, place
  int32_t row_at[kBucketRows + 1];      // each row's first place in order
  int32_t win_end[kSumWarps * 32];      // the window's segment ends
  int64_t win_at[kSumWarps * 32];       // segment i's slot of position 0
  int32_t warp_sum[kSumWarps];
};
static_assert(kBucketRows == 32 && kSumWarps * 2 == kBucketRows,
              "the place scan takes a row a lane, a half-warp sums a row");

__global__ void __launch_bounds__(kSumWarps * 32, 2)
tile_bucket_sum_kernel(const __nv_bfloat16* __restrict__ slab,
                       const int2* __restrict__ local,
                       const int32_t* __restrict__ offsets, int tiles,
                       int d_blk, int feat, float* __restrict__ out) {
  constexpr int kPerWarp = kSumChunk / kSumWarps;
  constexpr int kRounds = kPerWarp / 32;
  __shared__ BucketSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  constexpr int kWindow = kSumWarps * 32;
  const int b = blockIdx.x;
  // half-warp h sums row warp + h * kSumWarps, lane l of it 8 columns
  const int half = lane >> 4;
  const int r = warp + half * kSumWarps;
  for (int c0 = 0; c0 < feat; c0 += 16 * 8) {
    const int c = c0 + (lane & 15) * 8;
    const bool live = c < feat;
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
    for (int t0 = 0; t0 < tiles; t0 += kWindow) {
      // tile t0 + i's segment: window positions [win_end[i - 1],
      // win_end[i]), position p at slot win_at[i] + p of local
      const int t = t0 + static_cast<int>(threadIdx.x);
      int32_t cnt = 0;
      int64_t at = 0;
      if (t < tiles) {
        const int32_t* o = offsets + static_cast<int64_t>(t) *
                                         (sgnn::kBuckets + 1);
        at = static_cast<int64_t>(t) * sgnn::kTileItems + o[b];
        cnt = o[b + 1] - o[b];
      }
      int32_t end = cnt;  // inclusive scan over the window's tiles
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t up = __shfl_up_sync(kFullMask, end, o);
        if (lane >= o) end += up;
      }
      __syncthreads();  // the previous window's readers are done
      if (lane == 31) sm.warp_sum[warp] = end;
      __syncthreads();
      for (int v = 0; v < warp; ++v) end += sm.warp_sum[v];
      sm.win_end[threadIdx.x] = end;
      sm.win_at[threadIdx.x] = at - (end - cnt);
      __syncthreads();
      const int32_t total = sm.win_end[kWindow - 1];
      for (int32_t ch = 0; ch < total; ch += kSumChunk) {
        const int m = min(kSumChunk, total - ch);
        // every edge of the warp's share loaded before any is ranked:
        // kRounds loads in flight a lane, while other warps finish the
        // previous chunk
        int2 item[kRounds];
        int rank[kRounds], row[kRounds];
#pragma unroll
        for (int j = 0; j < kRounds; ++j) {
          const int k = warp * kPerWarp + j * 32 + lane;
          row[j] = kBucketRows;
          if (k < m) {
            // the segment holding window position p: the first win_end > p
            // (a fixed, branch-free search, so the rounds' searches
            // interleave)
            const int32_t p = ch + k;
            int lo = 0;
#pragma unroll
            for (int step = kWindow / 2; step >= 1; step >>= 1) {
              if (sm.win_end[lo + step - 1] <= p) lo += step;
            }
            const int2 pr = __ldcs(local + sm.win_at[lo] + p);  // read once
            row[j] = pr.x & (kBucketRows - 1);
            // (src, f32 w): the bf16 bits above the row, shifted into place
            item[j] = make_int2(pr.y, static_cast<int>(
                                          static_cast<unsigned>(pr.x) &
                                          0xffff0000u));
          }
        }
        for (int i = threadIdx.x; i < kSumWarps * kBucketRows;
             i += blockDim.x) {
          sm.at[i / kBucketRows][i % kBucketRows] = 0;
        }
        __syncthreads();  // also: the previous chunk's sums are done
        // ranks as rank_tile.cuh's rank_tile ranks digits
#pragma unroll
        for (int j = 0; j < kRounds; ++j) {
          const bool valid = row[j] < kBucketRows;
          const unsigned peers = __match_any_sync(kFullMask, row[j]);
          const int32_t before = valid ? sm.at[warp][row[j]] : 0;
          rank[j] = before + __popc(peers & below);
          __syncwarp();
          if (valid && (peers & below) == 0) {
            sm.at[warp][row[j]] = before + __popc(peers);
          }
          __syncwarp();
        }
        __syncthreads();
        // places: row r's edges start after every earlier row's, and warp
        // v's after the earlier warps' of row r (one warp, 32 rows a lane)
        if (warp == 0) {
          int32_t run = 0;
#pragma unroll
          for (int v = 0; v < kSumWarps; ++v) {
            const int32_t n = sm.at[v][lane];
            sm.at[v][lane] = run;
            run += n;
          }
          int32_t incl = run;  // the row's edges; scan over the rows
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int32_t up = __shfl_up_sync(kFullMask, incl, o);
            if (lane >= o) incl += up;
          }
          const int32_t first = incl - run;
#pragma unroll
          for (int v = 0; v < kSumWarps; ++v) sm.at[v][lane] += first;
          sm.row_at[lane] = first;
          if (lane == 31) sm.row_at[kBucketRows] = incl;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kRounds; ++j) {
          if (row[j] < kBucketRows) {
            sm.order[sm.at[warp][row[j]] + rank[j]] = item[j];
          }
        }
        __syncthreads();
        // both half-warps step together over the longer of their rows
        const int e0 = sm.row_at[r], e1 = sm.row_at[r + 1];
        const int other = __shfl_xor_sync(kFullMask, e1 - e0, 16);
        const int steps = max(e1 - e0, other);
        for (int k = 0; k < steps; k += kTileUnroll) {
          uint4 raw[kTileUnroll];
          float wk[kTileUnroll];
#pragma unroll
          for (int u = 0; u < kTileUnroll; ++u) {
            const int e = e0 + k + u;
            const int2 it = sm.order[min(e, max(e1 - 1, 0))];
            wk[u] = __int_as_float(it.y);
            raw[u] = live && e < e1
                         ? __ldg(reinterpret_cast<const uint4*>(
                               slab + static_cast<int64_t>(it.x) * feat + c))
                         : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < kTileUnroll; ++u) {
            if (e0 + k + u < e1) {
              const unsigned w4[4] = {raw[u].x, raw[u].y, raw[u].z,
                                      raw[u].w};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                acc[2 * q] = fmaf(wk[u], __uint_as_float(w4[q] << 16),
                                  acc[2 * q]);
                acc[2 * q + 1] = fmaf(
                    wk[u], __uint_as_float(w4[q] & 0xffff0000u),
                    acc[2 * q + 1]);
              }
            }
          }
        }
      }
    }
    const int64_t row = static_cast<int64_t>(b) * kBucketRows + r;
    if (live && row < d_blk) {
      float4* o = reinterpret_cast<float4*>(out + row * feat + c);
      o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();  // the next column tile reuses the shared arrays
  }
}

__global__ void __launch_bounds__(kGatThreads)
gat_tile_kernel(const __nv_bfloat16* __restrict__ slab,
                const __nv_bfloat16* __restrict__ ts,
                const float* __restrict__ td,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst, float* __restrict__ out,
                float* __restrict__ z, int n_tiles, int s_blk, int w_win,
                int n_e, int feat, int cols, int heads) {
  extern __shared__ float smem[];
  float* outs = smem;                   // [w_win][feat]
  float* zs = outs + w_win * feat;      // [w_win][cols]
  float* us = zs + w_win * cols;        // [n_e][cols]
  int* es = reinterpret_cast<int*>(us + n_e * cols);  // src [n_e]
  int* ed = es + n_e;                                 // dst [n_e]
  const int fh = feat / heads;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const __nv_bfloat16* slab_t = slab + static_cast<int64_t>(t) * s_blk * feat;
    const __nv_bfloat16* ts_t = ts + static_cast<int64_t>(t) * s_blk * cols;
    const float* td_t = td + static_cast<int64_t>(t) * w_win * cols;
    for (int i = threadIdx.x; i < w_win * feat; i += blockDim.x) outs[i] = 0.f;
    for (int i = threadIdx.x; i < w_win * cols; i += blockDim.x) zs[i] = 0.f;
    for (int e = threadIdx.x; e < n_e; e += blockDim.x) {
      const int s = src[static_cast<int64_t>(t) * n_e + e];
      const int d = dst[static_cast<int64_t>(t) * n_e + e];
      es[e] = s;
      ed[e] = d;
      for (int j = 0; j < cols; ++j) {
        const float have =
            s < s_blk ? __bfloat162float(ts_t[s * cols + j]) : 0.0f;
        const float hadd = d < w_win ? bf16_round(td_t[d * cols + j]) : 0.0f;
        float score = have + hadd;
        score = score >= 0.0f ? score : kNegSlope * score;
        us[e * cols + j] = expf(fminf(fmaxf(score, -kClip), kClip));
      }
    }
    __syncthreads();
    // column c < feat: out's column c; c >= feat: z's column c - feat.
    // Edges go in batches of kEdgeBatch: the batch's slab loads are issued
    // before its adds, which the compiler may not reorder across (the
    // shared arrays may alias), so kEdgeBatch loads are in flight at once.
    for (int c = threadIdx.x; c < feat + cols; c += blockDim.x) {
      if (c < feat) {
        const int h = c / fh;
        for (int e0 = 0; e0 < n_e; e0 += kEdgeBatch) {
          float msg[kEdgeBatch];
          int row[kEdgeBatch];
#pragma unroll
          for (int k = 0; k < kEdgeBatch; ++k) {
            const int e = e0 + k;
            const int s = e < n_e ? es[e] : s_blk;
            const int d = e < n_e ? ed[e] : w_win;
            const float m =
                __bfloat162float(slab_t[min(s, s_blk - 1) * feat + c]);
            row[k] = (s < s_blk && d < w_win) ? d : -1;
            msg[k] = row[k] < 0 ? 0.0f
                                : bf16_round(bf16_round(us[e * cols + h]) * m);
          }
#pragma unroll
          for (int k = 0; k < kEdgeBatch; ++k) {
            if (row[k] >= 0) outs[row[k] * feat + c] += msg[k];
          }
        }
      } else {
        const int j = c - feat;
        for (int e = 0; e < n_e; ++e) {
          const int d = ed[e];
          if (d < w_win) zs[d * cols + j] += us[e * cols + j];
        }
      }
    }
    __syncthreads();
    float* out_t = out + static_cast<int64_t>(t) * w_win * feat;
    float* z_t = z + static_cast<int64_t>(t) * w_win * cols;
    for (int i = threadIdx.x; i < w_win * feat; i += blockDim.x) {
      out_t[i] = outs[i];
    }
    for (int i = threadIdx.x; i < w_win * cols; i += blockDim.x) {
      z_t[i] = zs[i];
    }
    __syncthreads();
  }
}

}  // namespace

// The gather alone: out [n_edges, feat] f32 = f32(slab[src]).  feat % 4
// == 0, slab 8-byte and out 16-byte aligned.  The caller checks shapes,
// dtypes, devices and index bounds.  Returns cudaGetLastError().
extern "C" int sgnn_probe_tile_gather(const void* slab, const void* src,
                                      void* out, long long n_edges, int feat,
                                      void* stream) {
  if (feat % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (n_edges + 31) / 32;
  const int64_t blocks = (chunks + kTileWarps - 1) / kTileWarps;
  const unsigned grid = static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(blocks, int64_t{1} << 30)));
  tile_gather_kernel<<<grid, kTileWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(slab),
      static_cast<const int32_t*>(src), static_cast<float*>(out), n_edges,
      feat);
  return static_cast<int>(cudaGetLastError());
}

// The scatter modes in two launches: tile_group_kernel on tiles =
// ceil(n_edges / kTileItems) blocks, from TileRows of src, dst (or null),
// w (or null) and r0 [n_steps, n_sub], into local [n_edges] int2 and
// offsets [tiles, kBuckets + 1] int32 (the caller's scratch); then
// tile_bucket_sum_kernel, a block a bucket of out rows, into out [d_blk,
// feat] f32 (slab [S, feat] bf16).  1 <= n_edges < 2^31, 1 <= d_blk <=
// kBuckets * kBucketRows, feat % 8 == 0, slab and out 16-byte aligned.
// Returns cudaGetLastError() after the launches.
extern "C" int sgnn_probe_tile_spmm(const void* slab, const void* src,
                                    const void* dst, const void* w,
                                    const void* r0, void* local,
                                    void* offsets, void* out,
                                    long long n_edges, int e_t, int n_sub,
                                    int d_blk, int feat, void* stream) {
  if (feat % 8 != 0 || d_blk < 1 || d_blk > sgnn::kBuckets * kBucketRows ||
      n_edges < 1 || n_edges >= (1LL << 31) || e_t < 1 || n_sub < 1 ||
      e_t % n_sub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles =
      static_cast<int>((n_edges + sgnn::kTileItems - 1) / sgnn::kTileItems);
  const TileRows keys{static_cast<const int32_t*>(src),
                      static_cast<const int32_t*>(dst),
                      static_cast<const __nv_bfloat16*>(w),
                      static_cast<const int32_t*>(r0), e_t, e_t / n_sub,
                      n_sub};
  tile_group_kernel<<<tiles, kGroupWarps * 32, 0, s>>>(
      keys, n_edges, static_cast<int2*>(local),
      static_cast<int32_t*>(offsets));
  tile_bucket_sum_kernel<<<(d_blk + kBucketRows - 1) / kBucketRows,
                           kSumWarps * 32, 0, s>>>(
      static_cast<const __nv_bfloat16*>(slab), static_cast<const int2*>(local),
      static_cast<const int32_t*>(offsets), tiles, d_blk, feat,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// tile_bucket_sum_kernel's registers and local memory (spills) a thread,
// as the loaded module reports them (cudaFuncGetAttributes).  Returns its
// error code.
extern "C" int sgnn_probe_tile_sum_attrs(int* registers, int* local_bytes) {
  cudaFuncAttributes a{};
  const cudaError_t rc = cudaFuncGetAttributes(&a, tile_bucket_sum_kernel);
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(rc);
}

// slab [n_tiles, s_blk, feat] bf16, ts [n_tiles, s_blk, cols] bf16, td
// [n_tiles, w_win, cols] f32, src/dst [n_tiles, n_e] int32 (s_blk and
// w_win the sentinels), out [n_tiles, w_win, feat] and z [n_tiles, w_win,
// cols] f32; 1 <= heads <= cols <= 8, heads dividing feat.  Returns
// cudaGetLastError() after the launch.
extern "C" int sgnn_probe_gat_tile(const void* slab, const void* ts,
                                   const void* td, const void* src,
                                   const void* dst, void* out, void* z,
                                   int n_tiles, int s_blk, int w_win, int n_e,
                                   int feat, int cols, int heads,
                                   void* stream) {
  const int64_t smem =
      (int64_t{w_win} * feat + int64_t{w_win} * cols + int64_t{n_e} * cols +
       2 * int64_t{n_e}) * 4;
  if (n_tiles < 1 || s_blk < 1 || heads < 1 || cols < heads ||
      cols > kMaxTableCols || feat % heads != 0 || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // raised the first time a launch needs more, so that launches captured
  // into a CUDA graph later make no call
  static int64_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gat_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  gat_tile_kernel<<<n_tiles, kGatThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(slab),
      static_cast<const __nv_bfloat16*>(ts), static_cast<const float*>(td),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<float*>(out), static_cast<float*>(z), n_tiles, s_blk, w_win,
      n_e, feat, cols, heads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
