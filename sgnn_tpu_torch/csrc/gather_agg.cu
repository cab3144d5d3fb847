// Sampled-block aggregation (K1) and its two backward products, over the
// dense-fanout layout of the sampler (nbr int32 [D, K], w f32 [D, K], x
// [S, F] f32 or bf16):
//
//   forward  out[d, :]  = sum over k of w[d, k] * x[nbr[d, k], :]
//   dx       dx[s, :]   = sum over nbr[d, k] = s of w[d, k] * g[d, :]
//   dw       dw[d, k]   = <g[d, :], x[nbr[d, k], :]>
//
// The forward replaces sgnn_tpu/ops/pallas/gather_agg.py::_kernel (launched
// by pallas_gather_aggregate_fwd_impl); the backward replaces the XLA VJP
// that kernel borrows, sgnn_tpu/ops/aggregate.py::_gather_aggregate_bwd.
// The TPU kernel streams the K rows of each 8-row destination tile into
// VMEM with double-buffered row DMAs; Hopper gathers rows with ordinary
// loads, so the port keeps the function and none of the tiling: any D, any
// F, no DMA pipeline.
//
// What bounds it on an H100: device-memory bytes.  The forward does
// 2*D*K*F flops on D*K*8 + S*F*b + D*F*b bytes when each input is read
// once (b = width of x's dtype): at the GraphSAGE 602-128-41 bottom layer
// (D = S = 233,088, K = 10, F = 128, f32) that is 257 MB, 0.077 ms at
// 3.35 TB/s, against 0.009 ms of f32 FMA time.  The gathers read a row of x
// per slot, and x (119 MB there) does not fit the 50 MB L2, so the traffic
// really caused is nearer D*K*F*b for the rows.  dx moves the same bytes
// the other way.
//
// Design, simple first:
//  * forward: one warp per destination row, lanes over feature columns
//    (COLS per lane, picked from F, and a column-tile loop for any F); each
//    slot's index and weight are loaded once per column tile by one lane
//    and broadcast with __shfl_sync; slots of weight 0 are skipped (the
//    sampler's padding); the sum is an f32 register sum in slot order and
//    each output element is written once, so the forward is deterministic;
//  * dx, without float atomics: the block is first transposed into a CSR
//    keyed by source (block_transpose_*: the key of slot p is nbr[p], or S
//    for a slot of weight 0 so that the padding, which points at row 0, is
//    dropped instead of making row 0 a hub; a stable LSD radix sort of
//    the keys, a counting sort per 9-bit digit, ranked by rank_tile.cuh;
//    then the fill of each entry (d = p / K, w[p]) and of rowptr by binary
//    searches of the sorted keys).  Each source's entries keep ascending
//    slot order p = d*K + k, so the order is fixed.  Then
//    csr_sum.cuh's edge-balanced gather-sum over that CSR, the same sum
//    as K2's, writes every dx row once in x's dtype (rows with no entries
//    as zeros): bit-identical from run to run;
//  * dw (not on the training path: the sampler's weights need no
//    gradient) gathers the forward's rows, D*K rows of F, and reads g and
//    nbr once: the forward's bytes.  Its first design gave each (row,
//    slot) pair a warp, so g[d] was read K times, 4 bytes a lane, 23 of 32
//    lanes idled in F = 41's second pass and every pair paid a 5-step
//    shuffle tree and a 4-byte store by one lane: about three times the
//    forward's time on the same rows.  Now a destination row goes to a
//    group of 8, 16 or 32 lanes (dw_layout: the fewest idle lane slots for
//    F), g[d] is loaded once into registers (vector columns: 16-byte f32
//    or 8-byte bf16 loads where F % 4 == 0 and g and x are aligned),
//    nbr[d, :] once and broadcast by shuffles, 4 slot rows are in flight,
//    and the K partial sums (rounded up to 8, 16 or 32) are reduced
//    together by one transposing butterfly (31 shuffles for 32 slots on 32
//    lanes, not 5 each); then each slot's lane stores it.  Fixed trees:
//    bit-identical from run to run.
// Row offsets are 64-bit.  Staging rows with cp.async/TMA and
// degree-sorted scheduling are later work.

#include "csr_sum.cuh"
#include "rank_tile.cuh"

namespace {

using sgnn::from_float;
using sgnn::kFullMask;
using sgnn::kWarpsPerBlock;
using sgnn::load_cols;
using sgnn::to_float;

template <typename T, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_agg_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ nbr,
                      const float* __restrict__ w, T* __restrict__ out,
                      int64_t num_dst, int k_slots, int64_t feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  // every branch below depends only on the row or on a broadcast value, so
  // it is warp-uniform and the full-mask shuffles see all 32 lanes
  for (int64_t row = first; row < num_dst; row += stride) {
    const int64_t base = row * k_slots;
    T* out_row = out + row * feat;
    for (int64_t c0 = 0; c0 < feat; c0 += 32 * COLS) {
      float acc[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[j] = 0.0f;
      for (int k0 = 0; k0 < k_slots; k0 += 32) {
        const int n = min(32, k_slots - k0);
        int my_src = 0;
        float my_w = 0.0f;
        if (lane < n) {
          my_src = nbr[base + k0 + lane];
          my_w = w[base + k0 + lane];
        }
        for (int k = 0; k < n; ++k) {
          const int src = __shfl_sync(kFullMask, my_src, k);
          const float wk = __shfl_sync(kFullMask, my_w, k);
          if (wk == 0.0f) continue;
          const T* x_row = x + static_cast<int64_t>(src) * feat;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int64_t c = c0 + lane + 32 * j;
            if (c < feat) acc[j] = fmaf(wk, to_float(x_row[c]), acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        if (c < feat) out_row[c] = from_float<T>(acc[j]);
      }
    }
  }
}

// dx's transpose is a stable LSD radix sort of the slots by key, a
// counting sort per kRadixBits-bit digit: the key of slot p is nbr[p], or
// num_src for a slot of weight 0 (dropped: keyed past the last source).
// Each pass: block_transpose_count_kernel counts the digits of each tile
// of kTileItems slots (digit-major, counts[digit * tiles + tile]); the
// caller's torch.cumsum of counts (index bookkeeping) gives every (digit,
// tile) its first output place; block_transpose_scatter_kernel then writes
// each tile's (key, slot) pairs there in slot order.  Integer atomics on
// shared-memory counts only.  The first pass reads nbr and w
// (slot = its index); later passes the previous pass's output.
using sgnn::kBuckets;
using sgnn::kSortThreads;
using sgnn::kSortWarps;
using sgnn::kTileItems;
constexpr int kSortRounds = kTileItems / kSortThreads;

// Slot i's (key, slot) in the first pass.
struct SlotKeys {
  const int32_t* nbr;
  const float* w;
  int32_t num_src;

  __device__ __forceinline__ int2 operator()(int64_t i) const {
    return make_int2(w[i] != 0.0f ? nbr[i] : num_src,
                     static_cast<int32_t>(i));
  }
};

__global__ void __launch_bounds__(kSortThreads)
block_transpose_count_kernel(SlotKeys keys, const int2* __restrict__ pairs,
                             int32_t* __restrict__ counts, int64_t n_slots,
                             int shift) {
  __shared__ int32_t hist[kBuckets];
  const int64_t tile = blockIdx.x, tiles = gridDim.x;
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < kBuckets; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  for (int j = 0; j < kTileItems; j += kSortThreads) {
    const int64_t i = tile * kTileItems + j + threadIdx.x;
    const int digit =
        i < n_slots
            ? (sgnn::sort_item(keys, pairs, i).x >> shift) & (kBuckets - 1)
            : kBuckets;
    // one shared-memory add per digit present in the warp
    const unsigned peers = __match_any_sync(kFullMask, digit);
    if (digit < kBuckets && (peers & ((1u << lane) - 1u)) == 0) {
      atomicAdd(&hist[digit], __popc(peers));
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kBuckets; d += kSortThreads) {
    counts[d * tiles + tile] = hist[d];
  }
}

// rank_tile (rank_tile.cuh) ranks the tile's slots by digit, stably;
// every digit's place is then the tile's start for it (cums - counts)
// plus the earlier warps' counts, and each slot is written there: slot
// order within the tile, so the pass is stable.
__global__ void __launch_bounds__(kSortThreads)
block_transpose_scatter_kernel(SlotKeys keys, const int2* __restrict__ pairs,
                               const int32_t* __restrict__ counts,
                               const int32_t* __restrict__ cums,
                               int2* __restrict__ pairs_out,
                               int64_t n_slots, int shift) {
  __shared__ int32_t warp_at[kSortWarps][kBuckets];
  const int64_t tile = blockIdx.x, tiles = gridDim.x;
  const int warp = threadIdx.x >> 5;
  int2 item[kSortRounds];
  int32_t rank[kSortRounds];
  int digit[kSortRounds];
  sgnn::rank_tile<kSortWarps>(keys, pairs, n_slots, shift, tile, item, digit,
                              rank, warp_at);
  __syncthreads();
  for (int d = threadIdx.x; d < kBuckets; d += kSortThreads) {
    const int64_t at = d * tiles + tile;
    int32_t run = cums[at] - counts[at];  // exclusive: the (digit, tile) start
    for (int v = 0; v < kSortWarps; ++v) {
      const int32_t n = warp_at[v][d];
      warp_at[v][d] = run;
      run += n;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortRounds; ++j) {
    if (digit[j] < kBuckets) {
      pairs_out[warp_at[warp][digit[j]] + rank[j]] = item[j];
    }
  }
}

// The first i in [0, n) with a[i].x >= key (n if none).
__device__ __forceinline__ int64_t lower_bound_key(const int2* a, int64_t n,
                                                   int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (a[mid].x >= key) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// After the sort (sorted: (key, slot) pairs in key order): entry i is slot
// p = sorted[i].y, destination p / K with weight w[p]; rowptr_t[s] is the
// first i whose key is >= s, so rowptr_t[num_src] counts the kept slots
// and the dropped ones follow it.  Every element is written once.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_transpose_fill_kernel(const int2* __restrict__ sorted,
                            const float* __restrict__ w,
                            int32_t* __restrict__ col_t,
                            float* __restrict__ w_t,
                            int64_t* __restrict__ rowptr_t, int64_t n_slots,
                            int k_slots, int64_t num_src) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n = max(n_slots, num_src + 1);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (i < n_slots) {
      const int32_t p = sorted[i].y;
      col_t[i] = static_cast<int32_t>(p / k_slots);
      w_t[i] = w[p];
    }
    if (i <= num_src) rowptr_t[i] = lower_bound_key(sorted, n_slots, i);
  }
}

// The slots' variant of the fill, for a caller that reads per-slot state
// itself (the sampled GAT backward, gat_sampled.cu): entry i is the slot
// p = sorted[i].y, and rowptr_t as the fill's.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_transpose_slots_kernel(const int2* __restrict__ sorted,
                             int32_t* __restrict__ slot_t,
                             int64_t* __restrict__ rowptr_t, int64_t n_slots,
                             int64_t num_src) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n = max(n_slots, num_src + 1);
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (i < n_slots) slot_t[i] = sorted[i].y;
    if (i <= num_src) rowptr_t[i] = lower_bound_key(sorted, n_slots, i);
  }
}

// dw's layout: a destination row to a group of `lanes` lanes (32 / lanes
// rows a warp), `vec` adjacent columns a load (4: one 16-byte f32 or
// 8-byte bf16 load, where F % 4 == 0 and g and x are aligned; else 1),
// `slots` partial sums a row in registers (K rounded up to 8, 16 or 32;
// K > 32 in passes of 32).  Lanes: of 8, 16 and 32, the fewest lane slots
// over F's column loads, ties to more lanes (F = 128 f32: 32 lanes of one
// float4; F = 41: 16 lanes, 3 column tiles, 41 of 48 slots live).
struct DwLayout {
  int lanes;
  int vec;
  int slots;
};

DwLayout dw_layout(const void* g, const void* x, int64_t feat, int k_slots,
                   int elem_bytes) {
  const uintptr_t align = 4 * elem_bytes;
  const bool aligned = reinterpret_cast<uintptr_t>(g) % align == 0 &&
                       reinterpret_cast<uintptr_t>(x) % align == 0;
  const int vec = feat % 4 == 0 && aligned ? 4 : 1;
  const int64_t loads = (feat + vec - 1) / vec;
  int lanes = 32;
  for (int l = 16; l >= 8; l /= 2) {
    if ((loads + l - 1) / l * l < (loads + lanes - 1) / lanes * lanes) {
      lanes = l;
    }
  }
  const int slots = k_slots <= 8 ? 8 : k_slots <= 16 ? 16 : 32;
  return {lanes, vec, slots};
}

// Sums the group's P partial sums across its L lanes in one transposing
// butterfly: at offset o each lane keeps half of its live values and adds
// its partner's copy of them (N/2 shuffles, not one 5-step tree per
// value), so P = 32 values on 32 lanes take 31 shuffles.  After it, lane
// l holds the full sums of slots base + j, j < max(P / L, 1); where P < L,
// lanes that differ only in the bits below L / P hold the same sums
// (a + b on one, b + a on the other).  The tree is fixed: deterministic.
template <int L, int N, int P>
__device__ __forceinline__ void dw_butterfly(float (&v)[P], int sub,
                                             int& base) {
  if constexpr (L > 1) {
    constexpr int o = L / 2;
    if constexpr (N > 1) {
      constexpr int h = N / 2;
      const bool upper = (sub & o) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? v[i] : v[i + h];
        const float keep = upper ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(kFullMask, send, o);
      }
      if (upper) base += h;
      dw_butterfly<o, h, P>(v, sub, base);
    } else {
      v[0] += __shfl_xor_sync(kFullMask, v[0], o);
      dw_butterfly<o, 1, P>(v, sub, base);
    }
  }
}

// dw[d, k] = <g[d], x[nbr[d, k]]>: group-per-row, g's columns loaded once
// into registers per column tile, the slots' indices loaded once and
// broadcast by shuffles, the slots' rows loaded kBatch at a time before
// their FMAs, an f32 sum per slot in column order, then one butterfly and
// a store per slot.  Four slot rows in flight, not all: rows in flight on
// more warps beat more slots in flight on fewer (PERF.md, section 6).
// Warp-uniform loops: every lane runs every shuffle (a group past the
// last row loads nothing).
template <typename T, int L, int VEC, int P>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_agg_dw_kernel(const T* __restrict__ g, const T* __restrict__ x,
                     const int32_t* __restrict__ nbr, float* __restrict__ dw,
                     int64_t num_dst, int k_slots, int64_t feat) {
  constexpr int kGroups = 32 / L;
  constexpr int kIdx = P > L ? P / L : 1;  // slot indices a lane holds
  constexpr int kTile = L * VEC;
  constexpr int kOut = P > L ? P / L : 1;  // sums a lane stores
  constexpr int kDup = P < L ? L / P : 1;  // lanes holding the same sums
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
      kGroups;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * kGroups;
  const bool writer = sub % kDup == 0;  // one of them stores them
  for (int64_t r0 = first; r0 < num_dst; r0 += stride) {
    const int64_t row = r0 + lane / L;
    const bool valid = row < num_dst;
    const T* g_row = g + (valid ? row : 0) * feat;
    for (int k0 = 0; k0 < k_slots; k0 += P) {
      const int n = min(P, k_slots - k0);
      int my_src[kIdx];
#pragma unroll
      for (int i = 0; i < kIdx; ++i) {
        const int k = i * L + sub;
        my_src[i] = valid && k < n ? nbr[row * k_slots + k0 + k] : 0;
      }
      float acc[P];
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] = 0.0f;
      for (int64_t c0 = 0; c0 < feat; c0 += kTile) {
        const int64_t c = c0 + sub * VEC;
        const bool live = valid && c < feat;
        float gv[VEC];
        if (live) {
          load_cols<T, VEC>(g_row + c, gv);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) gv[q] = 0.0f;
        }
#pragma unroll
        for (int kb = 0; kb < P; kb += kBatch) {
          if (kb < n) {
            float v[kBatch][VEC];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int k = kb + u;
              const int src = __shfl_sync(kFullMask, my_src[k / L], k % L, L);
              if (live && k < n) {
                load_cols<T, VEC>(x + static_cast<int64_t>(src) * feat + c,
                                  v[u]);
              } else {
#pragma unroll
                for (int q = 0; q < VEC; ++q) v[u][q] = 0.0f;
              }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              if (kb + u < n) {
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                  acc[kb + u] = fmaf(gv[q], v[u][q], acc[kb + u]);
                }
              }
            }
          }
        }
      }
      int base = 0;
      dw_butterfly<L, P, P>(acc, sub, base);
      if (valid && writer) {
        float* dw_row = dw + row * k_slots + k0;
#pragma unroll
        for (int j = 0; j < kOut; ++j) {
          if (base + j < n) dw_row[base + j] = acc[j];
        }
      }
    }
  }
}

template <typename T>
using DwKernel = void (*)(const T*, const T*, const int32_t*, float*, int64_t,
                          int, int64_t);

template <typename T, int L, int VEC>
DwKernel<T> dw_kernel_slots(int slots) {
  if (slots == 8) return gather_agg_dw_kernel<T, L, VEC, 8>;
  if (slots == 16) return gather_agg_dw_kernel<T, L, VEC, 16>;
  return gather_agg_dw_kernel<T, L, VEC, 32>;
}

// gather_agg_dw_kernel's instance for a layout.
template <typename T>
DwKernel<T> dw_kernel(const DwLayout& l) {
  if (l.vec == 4) {
    if (l.lanes == 8) return dw_kernel_slots<T, 8, 4>(l.slots);
    if (l.lanes == 16) return dw_kernel_slots<T, 16, 4>(l.slots);
    return dw_kernel_slots<T, 32, 4>(l.slots);
  }
  if (l.lanes == 8) return dw_kernel_slots<T, 8, 1>(l.slots);
  if (l.lanes == 16) return dw_kernel_slots<T, 16, 1>(l.slots);
  return dw_kernel_slots<T, 32, 1>(l.slots);
}

template <typename T>
void launch_fwd(const void* x, const void* nbr, const void* w, void* out,
                int64_t num_dst, int k_slots, int64_t feat,
                cudaStream_t stream) {
  const dim3 grid(sgnn::warp_blocks(num_dst)), block(kWarpsPerBlock * 32);
  const T* xp = static_cast<const T*>(x);
  const int32_t* np_ = static_cast<const int32_t*>(nbr);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  if (feat <= 32) {
    gather_agg_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
        xp, np_, wp, op, num_dst, k_slots, feat);
  } else if (feat <= 64) {
    gather_agg_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(
        xp, np_, wp, op, num_dst, k_slots, feat);
  } else if (feat <= 128) {
    gather_agg_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(
        xp, np_, wp, op, num_dst, k_slots, feat);
  } else {
    gather_agg_fwd_kernel<T, 8><<<grid, block, 0, stream>>>(
        xp, np_, wp, op, num_dst, k_slots, feat);
  }
}

template <typename T>
void launch_dw(const void* g, const void* x, const void* nbr, void* dw,
               int64_t num_dst, int k_slots, int64_t feat,
               cudaStream_t stream) {
  const DwLayout l = dw_layout(g, x, feat, k_slots, sizeof(T));
  const int64_t warps = (num_dst + 32 / l.lanes - 1) / (32 / l.lanes);
  dw_kernel<T>(l)<<<sgnn::warp_blocks(warps), kWarpsPerBlock * 32, 0,
                    stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const int32_t*>(nbr), static_cast<float*>(dw), num_dst,
      k_slots, feat);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of x, g, out and dx; w and
// dw are f32).  The caller checks shapes, dtypes, devices and index bounds
// and passes num_dst, k_slots and feat >= 1.  Each returns
// cudaGetLastError() after its launches.
extern "C" int sgnn_gather_agg_fwd(const void* x, const void* nbr,
                                   const void* w, void* out,
                                   long long num_dst, int k_slots,
                                   long long feat, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_fwd<float>(x, nbr, w, out, num_dst, k_slots, feat, s);
  } else if (dtype == 1) {
    launch_fwd<__nv_bfloat16>(x, nbr, w, out, num_dst, k_slots, feat, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx's transpose: one radix pass (count, then scatter around the caller's
// cumsum of counts) on tiles = ceil(n_slots / kTileItems) blocks, from
// (key, slot) pairs [n_slots] int2, null in the first pass, into
// pairs_out.  counts and cums [kBuckets * tiles] int32.
extern "C" int sgnn_block_transpose_count(const void* nbr, const void* w,
                                          const void* pairs, void* counts,
                                          long long n_slots, int num_src,
                                          int shift, long long tiles,
                                          void* stream) {
  const SlotKeys keys{static_cast<const int32_t*>(nbr),
                      static_cast<const float*>(w), num_src};
  block_transpose_count_kernel<<<static_cast<unsigned>(tiles), kSortThreads,
                                 0, static_cast<cudaStream_t>(stream)>>>(
      keys, static_cast<const int2*>(pairs), static_cast<int32_t*>(counts),
      n_slots, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sgnn_block_transpose_scatter(
    const void* nbr, const void* w, const void* pairs, const void* counts,
    const void* cums, void* pairs_out, long long n_slots, int num_src,
    int shift, long long tiles, void* stream) {
  const SlotKeys keys{static_cast<const int32_t*>(nbr),
                      static_cast<const float*>(w), num_src};
  block_transpose_scatter_kernel<<<static_cast<unsigned>(tiles), kSortThreads,
                                   0, static_cast<cudaStream_t>(stream)>>>(
      keys, static_cast<const int2*>(pairs),
      static_cast<const int32_t*>(counts), static_cast<const int32_t*>(cums),
      static_cast<int2*>(pairs_out), n_slots, shift);
  return static_cast<int>(cudaGetLastError());
}

// Then the transposed block from the sorted (key, slot) pairs:
// rowptr_t [num_src + 1] int64, col_t [n_slots] int32 destinations and
// w_t [n_slots] f32.  n_slots = D*K >= 1.
extern "C" int sgnn_block_transpose_fill(const void* sorted, const void* w,
                                         void* col_t, void* w_t,
                                         void* rowptr_t, long long n_slots,
                                         int k_slots, long long num_src,
                                         void* stream) {
  const int64_t n = std::max<int64_t>(n_slots, num_src + 1);
  const dim3 grid(sgnn::warp_blocks(n / 32 + 1));
  block_transpose_fill_kernel<<<grid, kWarpsPerBlock * 32, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(sorted), static_cast<const float*>(w),
      static_cast<int32_t*>(col_t), static_cast<float*>(w_t),
      static_cast<int64_t*>(rowptr_t), n_slots, k_slots, num_src);
  return static_cast<int>(cudaGetLastError());
}

// Or the slots: slot_t [n_slots] int32 and rowptr_t [num_src + 1] int64.
extern "C" int sgnn_block_transpose_fill_slots(const void* sorted,
                                               void* slot_t, void* rowptr_t,
                                               long long n_slots,
                                               long long num_src,
                                               void* stream) {
  const int64_t n = std::max<int64_t>(n_slots, num_src + 1);
  const dim3 grid(sgnn::warp_blocks(n / 32 + 1));
  block_transpose_slots_kernel<<<grid, kWarpsPerBlock * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(sorted), static_cast<int32_t*>(slot_t),
      static_cast<int64_t*>(rowptr_t), n_slots, num_src);
  return static_cast<int>(cudaGetLastError());
}

// dx over the transposed block: csr_sum.cuh's sum of g's rows, with
// spmm.cu's arguments (num_rows = S, max_edges = D*K, carry scratch).
extern "C" int sgnn_gather_agg_bwd_dx(const void* g, const void* rowptr_t,
                                      const void* col_t, const void* w_t,
                                      void* dx, void* carry, void* carry_row,
                                      long long num_src, long long max_edges,
                                      long long chunk, long long feat,
                                      int vec, int dtype, void* stream) {
  return sgnn::csr_sum_dispatch(g, rowptr_t, col_t, w_t, dx, carry,
                                carry_row, num_src, max_edges, chunk, feat,
                                vec, dtype,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int sgnn_gather_agg_bwd_dw(const void* g, const void* x,
                                      const void* nbr, void* dw,
                                      long long num_dst, int k_slots,
                                      long long feat, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_dw<float>(g, x, nbr, dw, num_dst, k_slots, feat, s);
  } else if (dtype == 1) {
    launch_dw<__nv_bfloat16>(g, x, nbr, dw, num_dst, k_slots, feat, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw's layout for g and x (their addresses, width, K and dtype): lanes
// a row, columns a load, partial sums a row, and that instance's registers
// and local memory (spills) a thread as the loaded module reports them
// (cudaFuncGetAttributes).  Returns its error code.
extern "C" int sgnn_gather_agg_dw_layout(const void* g, const void* x,
                                         long long feat, int k_slots,
                                         int dtype, int* lanes, int* vec,
                                         int* slots, int* registers,
                                         int* local_bytes) {
  cudaFuncAttributes a{};
  cudaError_t rc = cudaErrorInvalidValue;
  DwLayout l{0, 0, 0};
  if (dtype == 0) {
    l = dw_layout(g, x, feat, k_slots, sizeof(float));
    rc = cudaFuncGetAttributes(&a, dw_kernel<float>(l));
  } else if (dtype == 1) {
    l = dw_layout(g, x, feat, k_slots, sizeof(__nv_bfloat16));
    rc = cudaFuncGetAttributes(&a, dw_kernel<__nv_bfloat16>(l));
  }
  *lanes = l.lanes;
  *vec = l.vec;
  *slots = l.slots;
  *registers = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(rc);
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
