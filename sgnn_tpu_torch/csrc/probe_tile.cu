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
// (slab bf16 [S_BLK, F]; dst null: dst[s, e] = e; w null: weight 1; r0
// null: window start 0), or with `gather` set, the gather alone:
// out[s * e_t + e, :] = f32(slab[src[s, e], :]).  The TPU built both the
// gather and the scatter as one-hot matrix products on the MXU, about
// 2F(S_BLK + W) operations an edge, because Mosaic had no in-kernel gather
// and scatter.  Hopper has both, so the kernel gathers and scatters
// directly: 2F operations an edge.  A message is rounded to bf16 where the
// JAX code casts it (profile_onehot_spmm.py:67); a gathered bf16 row is
// already that value, and each product of two bf16 values is exact in f32,
// as on the MXU.
//
// The TPU summed all steps into one VMEM-resident block because its grid
// runs in order.  Blocks of this kernel run in parallel, so the scatter is
// an f32 float4 atomic add (vector red.global.add, sm_90) into the out
// block, which at [8192, 128] f32 (4 MiB) stays in L2.  The order of the
// adds into one row changes from run to run: the scatter is NOT
// bit-deterministic (the gather is).  One warp takes 32 edges at a time,
// their indices loaded once and broadcast with __shfl_sync; a lane owns 4
// columns (an 8-byte bf16 load, a 16-byte atomic).  Bound on this card:
// device-memory bytes (2^20 edges: 10 bytes of indices and weight each,
// the 4 MiB block written once; 15 MB, 4.4 us at 3.35 TB/s) beside 2F
// f32 operations an edge (4.0 us at 67 TFLOP/s); what limits it in fact
// is the rate of L2 atomics, F/4 of them an edge.
//
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

#include "common.cuh"

namespace {

using sgnn::kFullMask;

constexpr int kTileWarps = 8;
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

__global__ void __launch_bounds__(kTileWarps * 32)
tile_spmm_kernel(const __nv_bfloat16* __restrict__ slab,
                 const int32_t* __restrict__ src,
                 const int32_t* __restrict__ dst,
                 const __nv_bfloat16* __restrict__ w,
                 const int32_t* __restrict__ r0, float* __restrict__ out,
                 int64_t n_edges, int e_t, int e_sub, int n_sub, int feat,
                 int gather) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTileWarps +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kTileWarps;
  for (int64_t chunk = first; chunk * 32 < n_edges; chunk += stride) {
    const int64_t e0 = chunk * 32;
    const int n = n_edges - e0 < 32 ? static_cast<int>(n_edges - e0) : 32;
    int my_src = 0;
    long long my_row = 0;
    float my_w = 1.0f;
    if (lane < n) {
      const int64_t i = e0 + lane;
      my_src = src[i];
      if (gather) {
        my_row = i;
      } else {
        const int64_t step = i / e_t;
        const int e = static_cast<int>(i - step * e_t);
        my_row = (r0 != nullptr ? r0[step * n_sub + e / e_sub] : 0) +
                 (dst != nullptr ? dst[i] : e);
        if (w != nullptr) my_w = __bfloat162float(w[i]);
      }
    }
    // n is warp-uniform: every lane runs every shuffle
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const int s = __shfl_sync(kFullMask, my_src, k);
      const long long row = __shfl_sync(kFullMask, my_row, k);
      const float wk = __shfl_sync(kFullMask, my_w, k);
      const __nv_bfloat16* srow = slab + static_cast<int64_t>(s) * feat;
      float* orow = out + row * feat;
      for (int c = lane * 4; c < feat; c += 32 * 4) {
        const float4 v =
            bf16x4_to_float4(*reinterpret_cast<const uint2*>(srow + c));
        if (gather) {
          *reinterpret_cast<float4*>(orow + c) = v;
        } else {
          atomicAdd(reinterpret_cast<float4*>(orow + c),
                    make_float4(wk * v.x, wk * v.y, wk * v.z, wk * v.w));
        }
      }
    }
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

// gather 1: the gather alone (dst, w, r0 ignored, out [n_edges, feat]);
// gather 0: the weighted window scatter into a zeroed out block.  feat %
// 4 == 0, slab 8-byte and out 16-byte aligned; n_edges = n_steps * e_t,
// e_sub = e_t / n_sub.  The caller checks shapes, dtypes, devices and
// index bounds.  Returns cudaGetLastError() after the launch.
extern "C" int sgnn_probe_tile_spmm(const void* slab, const void* src,
                                    const void* dst, const void* w,
                                    const void* r0, void* out,
                                    long long n_edges, int e_t, int n_sub,
                                    int feat, int gather, void* stream) {
  if (feat % 4 != 0 || e_t < 1 || n_sub < 1 || e_t % n_sub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t chunks = (n_edges + 31) / 32;
  const int64_t blocks = (chunks + kTileWarps - 1) / kTileWarps;
  const unsigned grid = static_cast<unsigned>(
      std::max<int64_t>(1, std::min<int64_t>(blocks, int64_t{1} << 30)));
  tile_spmm_kernel<<<grid, kTileWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(slab),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const __nv_bfloat16*>(w), static_cast<const int32_t*>(r0),
      static_cast<float*>(out), n_edges, e_t, e_t / n_sub, n_sub, feat,
      gather);
  return static_cast<int>(cudaGetLastError());
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
