// The sampled GAT layer's attention aggregation, forward and backward,
// over the dense-fanout block of the device sampler (nbr int32 [D, K], w
// f32 [D, K] with 0 on padded slots, seed int32 [D]: each destination's
// own row among the S source rows), h [S, F] f32 or bf16 with F = heads *
// fh, and the per-row score halves ts, td [S, H] f32
// (ops/gat.pack_score_tables).  Per destination d, valid slot k (w != 0),
// source s = nbr[d, k] and head h:
//
//   score  = leaky_relu(ts[s, h] + td[seed[d], h], 0.2)
//   att    = exp(score - m[d, h]) / max(z[d, h], FLT_MIN),  m the max over
//            the valid slots, z the sum of their exponentials; 0 on padded
//            slots (a row with no valid slot is all zero)
//   out[d, head h] = sum over k of att[d, k, h] * h[s, head h]
//
// the function of models/gnn._gat_layer's torch ops (scatter_src_to_edges,
// the score einsums, ops/aggregate.edge_softmax, aggregate_edges_to_dst),
// max-shifted as edge_softmax, not K3's max-free clipped exponential.  With
// G = dL/dout the backward is
//
//   datt   = <G[d, head h], h[s, head h]>
//   dscore = att * (datt - sum over k of att * datt) * leaky_relu'(score)
//   dh[s, head h] = sum over (d, k) with nbr = s of att * G[d, head h]
//   dts[s, h]     = sum over (d, k) with nbr = s of dscore
//   dtd[s, h]     = sum over d with seed[d] = s of sum over k of dscore
//
// with leaky_relu'(x) = 1 for x > 0, else 0.2, as torch's.
//
// The torch ops it replaces gather h[nbr] as a [D, K, F] tensor (1.19 GB
// at the 602-128-41 bottom layer, D = 233,088, K = 10, F = 128), read it in
// two einsums, and autograd scatters two more such tensors back with
// index_add_, whose float atomics pile the padded slots, which all point
// at row 0, onto row 0's 128 addresses.  What bounds this instead on an
// H100 is device-memory bytes: a source row read a valid slot, forward and
// backward, the [D, K] block, [D, K, H] f32 per-slot scalars and the
// [D, F] rows once.
//
// Design:
//  * forward (gat_sampled_fwd_kernel): a destination row to a group of 8,
//    16 or 32 lanes (row_layout: dw_layout's rule in gather_agg.cu, the
//    fewest idle lane slots for F), `cols` column groups of `vec` columns
//    a lane (4 adjacent columns in one 16-byte f32 or 8-byte bf16 load
//    where F and fh are multiples of 4 and the rows aligned, else 1).
//    Per head, the group's lanes take the slots, skip padded ones, and
//    reduce the masked max and then z over the group (fixed trees); each
//    slot's att is written once to att [D, K, H] f32, the state the
//    backward keeps.  Then the row's valid slots (a bit mask from ballots
//    of w) are gathered in slot order, 4 source rows in flight, each
//    weighted by its head's att, summed in f32, and the row stored once.
//  * backward, destination pass (gat_sampled_dst_kernel, the same layout):
//    datt of each valid slot and head from G[d] held in registers and the
//    gathered source row (reduced over the head's aligned lanes where a
//    head is a power-of-two group of them, else over the group a head at a
//    time), written to dscore's buffer; then per head the group's lanes
//    reduce sum att * datt, write each slot's dscore (0 on padded slots)
//    and reduce dtd_rows[d, h]; rowflag[d] is 1 where the row has a valid
//    slot.
//  * backward, source pass: gather_agg.cu's block transpose (a stable
//    radix sort of the slots keyed by source, padded slots keyed past the
//    last source and dropped) hands out each source's slots p in
//    ascending order; csr_sum.cuh's edge-balanced walk with AttSrcPolicy
//    sums att[p] * G[p / K] (dh, in h's dtype) and dscore[p] (dts) a
//    source row, hub sources in pieces combined by the walk's fixed tree.
//  * dtd_rows reach the source rows through the same transpose of seed as
//    a K = 1 block weighted by rowflag and K2's CSR sum (the wrapper,
//    ops/cuda/gat_sampled.py).
// No float atomics anywhere and every output element written once by a
// fixed order of sums: bit-identical from run to run.  Sums in f32, expf
// and IEEE division (no fast math); offsets 64-bit.

#include <cfloat>
#include <cstdint>

#include "csr_sum.cuh"

namespace {

using sgnn::col_of;
using sgnn::kFullMask;
using sgnn::kUnroll;
using sgnn::kWarpsPerBlock;
using sgnn::load_cols;
using sgnn::store_cols;

constexpr float kNegSlope = 0.2f;  // == sgnn_tpu_torch/ops/gat.py NEG_SLOPE
constexpr int kBatch = 4;          // source rows in flight

// A row's layout: `lanes` a destination row (32 / lanes rows a warp),
// `vec` adjacent columns a load, `cols` column groups a lane (a power of
// two, up to 4 scalar or 2 vector ones: 256 columns on 32 lanes; F past
// lanes * vec * cols in column tiles).  Lanes: of 8, 16 and 32, the
// fewest lane slots over F's column loads, ties to more lanes
// (gather_agg.cu dw_layout's rule): F = 128 at 4 heads, f32, is 32 lanes
// of one float4; F = 41 is 16 lanes of 4 scalar groups.
struct Layout {
  int lanes;
  int vec;
  int cols;
};

Layout row_layout(const void* a, const void* b, int64_t feat, int heads,
                  int elem_bytes) {
  const uintptr_t align = 4 * elem_bytes;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % align == 0 &&
                       reinterpret_cast<uintptr_t>(b) % align == 0;
  const int vec = feat % 4 == 0 && (feat / heads) % 4 == 0 && aligned ? 4 : 1;
  const int64_t loads = (feat + vec - 1) / vec;
  int lanes = 32;
  for (int l = 16; l >= 8; l /= 2) {
    if ((loads + l - 1) / l * l < (loads + lanes - 1) / lanes * lanes) {
      lanes = l;
    }
  }
  const int max_cols = vec == 4 ? 2 : 4;
  int cols = 1;
  while (cols < max_cols && int64_t{lanes} * cols < loads) cols *= 2;
  return {lanes, vec, cols};
}

// The lanes of this lane's group of L, as a shuffle mask.
template <int L>
__device__ __forceinline__ unsigned group_mask(int lane) {
  if constexpr (L == 32) {
    return kFullMask;
  } else {
    return ((1u << L) - 1u) << (lane / L * L);
  }
}

template <int L>
__device__ __forceinline__ float group_sum(float v, unsigned gmask) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(gmask, v, o);
  return v;
}

template <int L>
__device__ __forceinline__ float group_max(float v, unsigned gmask) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(gmask, v, o));
  }
  return v;
}

// The score of slot p for head hh before leaky_relu.
__device__ __forceinline__ float raw_score(const float* __restrict__ ts,
                                           int32_t src, int heads, int hh,
                                           float tdv) {
  return ts[static_cast<int64_t>(src) * heads + hh] + tdv;
}

__device__ __forceinline__ float leaky(float s) {
  return s > 0.0f ? s : kNegSlope * s;
}

// Bit i of the result: slot k0 + i of the group's row is valid (w != 0).
// Warp-uniform: the trip count depends on K only, every lane ballots.
template <int L>
__device__ __forceinline__ unsigned valid_mask(const float* __restrict__ w,
                                               int64_t base, int k0,
                                               int k_slots, bool live,
                                               int lane) {
  const int sub = lane % L;
  unsigned mask = 0;
  for (int i = 0; i < 32 && k0 + i < k_slots; i += L) {
    const int k = k0 + i + sub;
    const bool v = live && k < k_slots && w[base + k] != 0.0f;
    const unsigned b = __ballot_sync(kFullMask, v);
    if constexpr (L == 32) {
      mask |= b;
    } else {
      mask |= ((b >> (lane - sub)) & ((1u << L) - 1u)) << i;
    }
  }
  return mask;
}

// Up to kBatch of mask's lowest set bits, in order (-1 past them), taken
// out of mask.
__device__ __forceinline__ void next_slots(unsigned& mask, int (&ks)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    ks[u] = mask != 0 ? __ffs(mask) - 1 : -1;
    mask &= mask - 1u;
  }
}

// kBatch slots' source rows (their column groups of this lane), loaded
// before any use; slots of -1 and columns past F give zeros.
template <typename T, int VEC, int COLS>
__device__ __forceinline__ void load_slot_rows(
    const T* __restrict__ h, const int32_t* __restrict__ nbr, int64_t at,
    const int (&ks)[kBatch], const int64_t (&cj)[COLS], const int (&hd)[COLS],
    int64_t feat, float (&v)[kBatch][COLS][VEC]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int src = ks[u] >= 0 ? nbr[at + ks[u]] : 0;
    const T* row = h + static_cast<int64_t>(src) * feat;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (ks[u] >= 0 && hd[j] >= 0) {
        load_cols<T, VEC>(row + cj[j], v[u][j]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[u][j][q] = 0.0f;
      }
    }
  }
}

// A lane's column groups of the tile starting at c0: first column cj[j]
// and its head hd[j] (-1 past F).
template <int L, int VEC, int COLS>
__device__ __forceinline__ void tile_cols(int64_t c0, int sub, int64_t feat,
                                          int64_t fh, int64_t (&cj)[COLS],
                                          int (&hd)[COLS]) {
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    cj[j] = c0 + static_cast<int64_t>(sub + L * j) * VEC;
    hd[j] = cj[j] < feat ? static_cast<int>(cj[j] / fh) : -1;
  }
}

// Forward: att [D, K, H] and out [D, F] (module note).  Every loop that
// holds a shuffle or a ballot is warp-uniform; the gather's loop over a
// row's valid slots differs between the groups of a warp and holds none.
template <typename T, int L, int VEC, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_sampled_fwd_kernel(const T* __restrict__ h, const float* __restrict__ ts,
                       const float* __restrict__ td,
                       const int32_t* __restrict__ nbr,
                       const float* __restrict__ w,
                       const int32_t* __restrict__ seed, T* __restrict__ out,
                       float* __restrict__ att, int64_t num_dst, int k_slots,
                       int64_t feat, int heads) {
  constexpr int kGroups = 32 / L;
  constexpr int kTile = L * VEC * COLS;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const unsigned gmask = group_mask<L>(lane);
  const int64_t fh = feat / heads;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
      kGroups;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * kGroups;
  for (int64_t r0 = first; r0 < num_dst; r0 += stride) {
    const int64_t row = r0 + lane / L;
    const bool live = row < num_dst;
    const int64_t base = (live ? row : 0) * k_slots;
    const int64_t dst = live ? seed[row] : 0;
    // the attention, a head at a time: masked max, z, then each slot's
    for (int hh = 0; hh < heads; ++hh) {
      const float tdv = td[dst * heads + hh];
      float m = -FLT_MAX;  // torch.finfo(float32).min, edge_softmax's fill
      for (int k = sub; k < k_slots; k += L) {
        if (live && w[base + k] != 0.0f) {
          m = fmaxf(m, leaky(raw_score(ts, nbr[base + k], heads, hh, tdv)));
        }
      }
      m = group_max<L>(m, gmask);
      float z = 0.0f;
      for (int k = sub; k < k_slots; k += L) {
        if (live && w[base + k] != 0.0f) {
          z += expf(leaky(raw_score(ts, nbr[base + k], heads, hh, tdv)) - m);
        }
      }
      const float zc = fmaxf(group_sum<L>(z, gmask), FLT_MIN);
      for (int k = sub; k < k_slots; k += L) {
        if (!live) continue;
        float a = 0.0f;
        if (w[base + k] != 0.0f) {
          a = expf(leaky(raw_score(ts, nbr[base + k], heads, hh, tdv)) - m) /
              zc;
        }
        att[(base + k) * heads + hh] = a;
      }
    }
    __syncwarp();  // the group's att writes, before its lanes read them
    for (int64_t c0 = 0; c0 < feat; c0 += kTile) {
      int64_t cj[COLS];
      int hd[COLS];
      tile_cols<L, VEC, COLS>(c0, sub, feat, fh, cj, hd);
      float acc[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[j][q] = 0.0f;
      }
      for (int k0 = 0; k0 < k_slots; k0 += 32) {
        unsigned mask = valid_mask<L>(w, base, k0, k_slots, live, lane);
        while (mask != 0) {  // the row's valid slots, in order
          int ks[kBatch];
          next_slots(mask, ks);
          float v[kBatch][COLS][VEC];
          load_slot_rows<T, VEC, COLS>(h, nbr, base + k0, ks, cj, hd, feat,
                                       v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (ks[u] < 0) break;
            const float* at = att + (base + k0 + ks[u]) * heads;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              const float a = hd[j] >= 0 ? at[hd[j]] : 0.0f;
#pragma unroll
              for (int q = 0; q < VEC; ++q) {
                acc[j][q] = fmaf(a, v[u][j][q], acc[j][q]);
              }
            }
          }
        }
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          if (hd[j] >= 0) store_cols<T, VEC>(out + row * feat + cj[j], acc[j]);
        }
      }
    }
  }
}

// Backward, destination pass (module note): dscore [D, K, H] (first datt,
// then dscore), dtd_rows [D, H], rowflag [D].  `lph`: the lanes of one
// head where heads > 1 and fh / vec is a power of two <= L (a head is an
// aligned lane group and never spans a column tile), else 0 (a head's
// datt reduced over the whole group, one head of the tile at a time, and
// added across column tiles).
template <typename T, int L, int VEC, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_sampled_dst_kernel(const T* __restrict__ g, const T* __restrict__ h,
                       const float* __restrict__ ts,
                       const float* __restrict__ td,
                       const int32_t* __restrict__ nbr,
                       const float* __restrict__ w,
                       const int32_t* __restrict__ seed,
                       const float* __restrict__ att,
                       float* __restrict__ dscore, float* __restrict__ dtd,
                       float* __restrict__ rowflag, int64_t num_dst,
                       int k_slots, int64_t feat, int heads, int lph) {
  constexpr int kGroups = 32 / L;
  constexpr int kTile = L * VEC * COLS;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const unsigned gmask = group_mask<L>(lane);
  const int64_t fh = feat / heads;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
      kGroups;
  const int64_t stride =
      static_cast<int64_t>(gridDim.x) * kWarpsPerBlock * kGroups;
  for (int64_t r0 = first; r0 < num_dst; r0 += stride) {
    const int64_t row = r0 + lane / L;
    const bool live = row < num_dst;
    const int64_t base = (live ? row : 0) * k_slots;
    const int64_t dst = live ? seed[row] : 0;
    // datt of every valid slot and head, into dscore
    for (int64_t c0 = 0; c0 < feat; c0 += kTile) {
      int64_t cj[COLS];
      int hd[COLS];
      tile_cols<L, VEC, COLS>(c0, sub, feat, fh, cj, hd);
      float gr[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (live && hd[j] >= 0) {
          load_cols<T, VEC>(g + row * feat + cj[j], gr[j]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) gr[j][q] = 0.0f;
        }
      }
      const int h_first = static_cast<int>(c0 / fh);
      const int h_last =
          static_cast<int>((min(c0 + kTile, feat) - 1) / fh);
      for (int k0 = 0; k0 < k_slots; k0 += 32) {
        unsigned mask = valid_mask<L>(w, base, k0, k_slots, live, lane);
        // the same mask on every lane of the group, so its shuffles (on
        // the group's mask) see all of its lanes
        while (mask != 0) {
          int ks[kBatch];
          next_slots(mask, ks);
          float v[kBatch][COLS][VEC];
          load_slot_rows<T, VEC, COLS>(h, nbr, base + k0, ks, cj, hd, feat,
                                       v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (ks[u] < 0) break;
            float* ds = dscore + (base + k0 + ks[u]) * heads;
            float p[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              p[j] = 0.0f;
#pragma unroll
              for (int q = 0; q < VEC; ++q) p[j] = fmaf(gr[j][q], v[u][j][q], p[j]);
            }
            if (lph > 0) {
#pragma unroll
              for (int j = 0; j < COLS; ++j) {
                float t = p[j];
                for (int o = lph / 2; o > 0; o >>= 1) {
                  t += __shfl_xor_sync(gmask, t, o);
                }
                if (hd[j] >= 0 && cj[j] % fh == 0) ds[hd[j]] = t;
              }
            } else {
              for (int hh = h_first; hh <= h_last; ++hh) {
                float t = 0.0f;
#pragma unroll
                for (int j = 0; j < COLS; ++j) {
                  if (hd[j] == hh) t += p[j];
                }
                t = group_sum<L>(t, gmask);
                if (sub == 0) {
                  // a head whose columns began in an earlier tile adds
                  ds[hh] = hh * fh < c0 ? ds[hh] + t : t;
                }
              }
            }
          }
        }
      }
    }
    __syncwarp();  // datt written, before other lanes of the group read it
    bool any = false;
    for (int hh = 0; hh < heads; ++hh) {
      const float tdv = td[dst * heads + hh];
      float r = 0.0f;
      for (int k = sub; k < k_slots; k += L) {
        const int64_t p = (base + k) * heads + hh;
        if (live && w[base + k] != 0.0f) r = fmaf(att[p], dscore[p], r);
      }
      r = group_sum<L>(r, gmask);
      float dsum = 0.0f;
      for (int k = sub; k < k_slots; k += L) {
        if (!live) continue;
        const int64_t p = (base + k) * heads + hh;
        float d = 0.0f;
        if (w[base + k] != 0.0f) {
          any = true;
          const float s = raw_score(ts, nbr[base + k], heads, hh, tdv);
          d = att[p] * (dscore[p] - r) * (s > 0.0f ? 1.0f : kNegSlope);
        }
        dscore[p] = d;
        dsum += d;
      }
      dsum = group_sum<L>(dsum, gmask);
      if (live && sub == 0) dtd[row * heads + hh] = dsum;
    }
    const unsigned rows_any = __ballot_sync(kFullMask, any) & gmask;
    if (live && sub == 0) rowflag[row] = rows_any != 0 ? 1.0f : 0.0f;
  }
}

template <typename T>
using FwdKernel = void (*)(const T*, const float*, const float*,
                           const int32_t*, const float*, const int32_t*, T*,
                           float*, int64_t, int, int64_t, int);
template <typename T>
using DstKernel = void (*)(const T*, const T*, const float*, const float*,
                           const int32_t*, const float*, const int32_t*,
                           const float*, float*, float*, float*, int64_t, int,
                           int64_t, int, int);

// The instance of kernel K for a layout: K<T, lanes, vec, cols>.
#define SGNN_PICK(K, T, l)                                                    \
  ((l).vec == 4                                                               \
       ? ((l).lanes == 8                                                      \
              ? ((l).cols == 1 ? K<T, 8, 4, 1> : K<T, 8, 4, 2>)               \
          : (l).lanes == 16                                                   \
              ? ((l).cols == 1 ? K<T, 16, 4, 1> : K<T, 16, 4, 2>)             \
              : ((l).cols == 1 ? K<T, 32, 4, 1> : K<T, 32, 4, 2>))            \
       : ((l).lanes == 8                                                      \
              ? ((l).cols == 1 ? K<T, 8, 1, 1>                                \
                 : (l).cols == 2 ? K<T, 8, 1, 2> : K<T, 8, 1, 4>)             \
          : (l).lanes == 16                                                   \
              ? ((l).cols == 1 ? K<T, 16, 1, 1>                               \
                 : (l).cols == 2 ? K<T, 16, 1, 2> : K<T, 16, 1, 4>)           \
              : ((l).cols == 1 ? K<T, 32, 1, 1>                               \
                 : (l).cols == 2 ? K<T, 32, 1, 2> : K<T, 32, 1, 4>)))

template <typename T>
FwdKernel<T> fwd_kernel(const Layout& l) {
  return SGNN_PICK(gat_sampled_fwd_kernel, T, l);
}

template <typename T>
DstKernel<T> dst_kernel(const Layout& l) {
  return SGNN_PICK(gat_sampled_dst_kernel, T, l);
}

// lanes of one head for gat_sampled_dst_kernel (its note), 0 for the
// general reduction
int head_lanes(const Layout& l, int64_t feat, int heads) {
  const int64_t lph = feat / heads / l.vec;
  return heads > 1 && feat % (heads * l.vec) == 0 && lph <= l.lanes &&
                 (lph & (lph - 1)) == 0
             ? static_cast<int>(lph)
             : 0;
}

unsigned row_blocks(int64_t num_dst, const Layout& l) {
  return sgnn::warp_blocks((num_dst + 32 / l.lanes - 1) / (32 / l.lanes));
}

template <typename T>
int launch_fwd(const void* h, const void* ts, const void* td, const void* nbr,
               const void* w, const void* seed, void* out, void* att,
               int64_t num_dst, int k_slots, int64_t feat, int heads,
               cudaStream_t stream) {
  const Layout l = row_layout(h, out, feat, heads, sizeof(T));
  fwd_kernel<T>(l)<<<row_blocks(num_dst, l), kWarpsPerBlock * 32, 0,
                     stream>>>(
      static_cast<const T*>(h), static_cast<const float*>(ts),
      static_cast<const float*>(td), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(w), static_cast<const int32_t*>(seed),
      static_cast<T*>(out), static_cast<float*>(att), num_dst, k_slots, feat,
      heads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dst(const void* g, const void* h, const void* ts, const void* td,
               const void* nbr, const void* w, const void* seed,
               const void* att, void* dscore, void* dtd, void* rowflag,
               int64_t num_dst, int k_slots, int64_t feat, int heads,
               cudaStream_t stream) {
  const Layout l = row_layout(g, h, feat, heads, sizeof(T));
  dst_kernel<T>(l)<<<row_blocks(num_dst, l), kWarpsPerBlock * 32, 0,
                     stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(h),
      static_cast<const float*>(ts), static_cast<const float*>(td),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(w),
      static_cast<const int32_t*>(seed), static_cast<const float*>(att),
      static_cast<float*>(dscore), static_cast<float*>(dtd),
      static_cast<float*>(rowflag), num_dst, k_slots, feat, heads,
      head_lanes(l, feat, heads));
  return static_cast<int>(cudaGetLastError());
}

// Backward, source pass: what csr_sum.cuh's walk sums over the block's
// transpose (rows are sources s, each entry a slot p = d * K + k):
//     dh[s]     = sum over p of att[p, head] * G[p / K]   (h's dtype)
//     dts[s, h] = sum over p of dscore[p, h]
// A lane's column group j lies in one head (vec columns need fh % 4 ==
// 0); the lane holding a head's first column also sums its dscore.
template <typename T, int COLS, int VEC>
struct AttSrcPolicy {
  static constexpr bool kNeedsRow = false;
  struct Shared {};
  struct Acc {
    float u[COLS][VEC];  // sum of att * G[d]
    float q[COLS];       // sum of dscore of group j's head (its first lane)
  };
  using Edge = int;  // the slot p
  struct Rows {
    float v[kUnroll][COLS][VEC];
    float a[kUnroll][COLS];
    float ds[kUnroll][COLS];
  };

  const T* __restrict__ g;
  const float* __restrict__ att;
  const float* __restrict__ dscore;
  const int32_t* __restrict__ slot;
  T* __restrict__ dh;
  float* __restrict__ dts;
  float* __restrict__ carry;  // [slots, pitch]: dh's columns, then dts's
  int64_t feat;
  int heads;
  int64_t fh;
  int k_slots;
  int64_t pitch;
  // the tile's
  int64_t c0;
  int hd[COLS];     // group j's head, -1 past F
  bool lead[COLS];  // group j starts its head

  __device__ __forceinline__ void bind(Shared&) {}
  __device__ __forceinline__ int64_t width() const { return feat; }
  __device__ __forceinline__ int64_t tile() const { return 32 * COLS * VEC; }
  __device__ __forceinline__ void begin_tile(int64_t c, int lane) {
    c0 = c;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t cc = col_of(c0, lane, j, VEC);
      hd[j] = cc < feat ? static_cast<int>(cc / fh) : -1;
      lead[j] = cc < feat && cc % fh == 0;
    }
  }
  __device__ __forceinline__ void begin_row(Acc& t, int64_t, int) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      t.q[j] = 0.0f;
#pragma unroll
      for (int q = 0; q < VEC; ++q) t.u[j][q] = 0.0f;
    }
  }
  __device__ __forceinline__ Edge stage(int64_t e, bool live, int64_t, int) {
    return live ? slot[e] : 0;
  }
  __device__ __forceinline__ void load(Edge m, int k, int n, int lane,
                                       Rows& v) const {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = __shfl_sync(kFullMask, m, (k + u) & 31);
      const T* grow = g + static_cast<int64_t>(p / k_slots) * feat;
      const int64_t at = static_cast<int64_t>(p) * heads;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (k + u < n && hd[j] >= 0) {
          load_cols<T, VEC>(grow + col_of(c0, lane, j, VEC), v.v[u][j]);
          v.a[u][j] = att[at + hd[j]];
          v.ds[u][j] = lead[j] ? dscore[at + hd[j]] : 0.0f;
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v.v[u][j][q] = 0.0f;
          v.a[u][j] = v.ds[u][j] = 0.0f;
        }
      }
    }
  }
  __device__ __forceinline__ void add(Acc& t, Edge, const Rows& v, int u,
                                      int) const {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        t.u[j][q] = fmaf(v.a[u][j], v.v[u][j][q], t.u[j][q]);
      }
      t.q[j] += v.ds[u][j];
    }
  }
  __device__ __forceinline__ void flush(Acc&, int) const {}
  __device__ __forceinline__ void store_row(const Acc& t, int64_t r,
                                            int lane) const {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] < 0) continue;
      store_cols<T, VEC>(dh + r * feat + col_of(c0, lane, j, VEC), t.u[j]);
      if (lead[j]) dts[r * heads + hd[j]] = t.q[j];
    }
  }
  __device__ __forceinline__ void store_piece(const Acc& t, int64_t s,
                                              int lane) const {
    float* dst = carry + s * pitch;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] < 0) continue;
      store_cols<float, VEC>(dst + col_of(c0, lane, j, VEC), t.u[j]);
      if (lead[j]) dst[feat + hd[j]] = t.q[j];
    }
  }
  __device__ __forceinline__ void zero_row(int64_t r, int lane) const {
    T* dst = dh + r * feat;
    for (int64_t f = lane; f < feat; f += 32) {
      dst[f] = sgnn::from_float<T>(0.0f);
    }
    for (int hh = lane; hh < heads; hh += 32) dts[r * heads + hh] = 0.0f;
  }
};

// The fix-up's store of a hub source: dh's columns, then dts's.
template <typename T>
struct AttSrcStore {
  T* __restrict__ dh;
  float* __restrict__ dts;
  int64_t feat;
  int heads;

  template <int VEC>
  __device__ __forceinline__ void store(int64_t r, int64_t c,
                                        const float (&v)[VEC]) const {
    if (c < feat) {  // feat % VEC == 0: the VEC columns are all dh's
      store_cols<T, VEC>(dh + r * feat + c, v);
      return;
    }
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      if (c + q - feat < heads) dts[r * heads + c + q - feat] = v[q];
    }
  }
};

template <typename T, int COLS, int VEC>
void launch_src_cols(const void* g, const void* att, const void* dscore,
                     const void* rowptr_t, const void* slot_t, void* dh,
                     void* dts, void* carry, void* carry_row,
                     int64_t num_src, int64_t max_chunks, int64_t chunk,
                     int64_t feat, int heads, int k_slots, int64_t pitch,
                     cudaStream_t stream) {
  const AttSrcPolicy<T, COLS, VEC> p{
      static_cast<const T*>(g),        static_cast<const float*>(att),
      static_cast<const float*>(dscore), static_cast<const int32_t*>(slot_t),
      static_cast<T*>(dh),             static_cast<float*>(dts),
      static_cast<float*>(carry),      feat,
      heads,                           feat / heads,
      k_slots,                         pitch};
  sgnn::csr_walk_launch<AttSrcPolicy<T, COLS, VEC>, AttSrcStore<T>, COLS,
                        VEC>(
      p, AttSrcStore<T>{static_cast<T*>(dh), static_cast<float*>(dts), feat,
                        heads},
      static_cast<const int64_t*>(rowptr_t), static_cast<float*>(carry),
      static_cast<int32_t*>(carry_row), num_src, max_chunks, chunk, pitch,
      stream);
}

template <typename T>
int launch_src(const void* g, const void* att, const void* dscore,
               const void* rowptr_t, const void* slot_t, void* dh, void* dts,
               void* carry, void* carry_row, int64_t num_src,
               int64_t max_edges, int64_t chunk, int64_t feat, int heads,
               int k_slots, int64_t pitch, bool vec, cudaStream_t stream) {
  const int64_t max_chunks =
      std::max<int64_t>(1, (max_edges + chunk - 1) / chunk);
#define SGNN_SRC(C, V)                                                       \
  launch_src_cols<T, C, V>(g, att, dscore, rowptr_t, slot_t, dh, dts, carry, \
                           carry_row, num_src, max_chunks, chunk, feat,      \
                           heads, k_slots, pitch, stream)
  if (vec) {
    if (feat <= 128) {
      SGNN_SRC(1, 4);
    } else {
      SGNN_SRC(2, 4);
    }
  } else if (feat <= 32) {
    SGNN_SRC(1, 1);
  } else if (feat <= 64) {
    SGNN_SRC(2, 1);
  } else {
    SGNN_SRC(4, 1);
  }
#undef SGNN_SRC
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h's, out's, g's and dh's); every
// other float array is float32, nbr and seed int32.  The caller checks
// shapes, dtypes, devices and index bounds and passes num_dst, k_slots,
// feat >= 1 and heads dividing feat.  Each returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for a dtype it does not
// know.

// Forward: out [num_dst, feat] and att [num_dst, k_slots, heads].
extern "C" int sgnn_gat_sampled_fwd(const void* h, const void* ts,
                                    const void* td, const void* nbr,
                                    const void* w, const void* seed,
                                    void* out, void* att, long long num_dst,
                                    int k_slots, long long feat, int heads,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_fwd<float>(h, ts, td, nbr, w, seed, out, att, num_dst,
                             k_slots, feat, heads, s);
  }
  if (dtype == 1) {
    return launch_fwd<__nv_bfloat16>(h, ts, td, nbr, w, seed, out, att,
                                     num_dst, k_slots, feat, heads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward, destination pass: dscore [num_dst, k_slots, heads], dtd_rows
// [num_dst, heads] and rowflag [num_dst].
extern "C" int sgnn_gat_sampled_bwd_dst(
    const void* g, const void* h, const void* ts, const void* td,
    const void* nbr, const void* w, const void* seed, const void* att,
    void* dscore, void* dtd_rows, void* rowflag, long long num_dst,
    int k_slots, long long feat, int heads, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_dst<float>(g, h, ts, td, nbr, w, seed, att, dscore,
                             dtd_rows, rowflag, num_dst, k_slots, feat, heads,
                             s);
  }
  if (dtype == 1) {
    return launch_dst<__nv_bfloat16>(g, h, ts, td, nbr, w, seed, att, dscore,
                                     dtd_rows, rowflag, num_dst, k_slots,
                                     feat, heads, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward, source pass over the block's transpose (rowptr_t [num_src + 1]
// int64, slot_t the slots p int32): dh [num_src, feat] in h's dtype and
// dts [num_src, heads] f32, csr_sum.cuh's walk at `chunk` edges a warp
// over at most max_edges entries.  carry is an f32 [2 * max(1,
// ceil(max_edges / chunk)), pitch] scratch (pitch >= feat + heads, a
// multiple of 4 when vec) and carry_row an int32 scratch of its rows; vec
// != 0 takes 4 adjacent columns a load (feat and feat / heads multiples
// of 4, g and dh aligned).
extern "C" int sgnn_gat_sampled_bwd_src(
    const void* g, const void* att, const void* dscore, const void* rowptr_t,
    const void* slot_t, void* dh, void* dts, void* carry, void* carry_row,
    long long num_src, long long max_edges, long long chunk, long long feat,
    int heads, int k_slots, long long pitch, int vec, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_src < 1 || chunk < 1 || feat < 1 || heads < 1 ||
      feat % heads != 0 || pitch < feat + heads ||
      (vec && (feat % 4 != 0 || (feat / heads) % 4 != 0 || pitch % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_src<float>(g, att, dscore, rowptr_t, slot_t, dh, dts, carry,
                             carry_row, num_src, max_edges, chunk, feat,
                             heads, k_slots, pitch, vec != 0, s);
  }
  if (dtype == 1) {
    return launch_src<__nv_bfloat16>(g, att, dscore, rowptr_t, slot_t, dh,
                                     dts, carry, carry_row, num_src,
                                     max_edges, chunk, feat, heads, k_slots,
                                     pitch, vec != 0, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The row kernels' layout for rows a and b (the forward's h and out, the
// destination pass's g and h: their addresses), feat, heads and dtype:
// lanes a row, columns a load, column groups a lane, and the registers
// and local memory (spills) a thread of the forward's (kernel 0) or the
// destination pass's (kernel 1) instance, as the loaded module reports
// them.  Returns the attribute query's error code.
extern "C" int sgnn_gat_sampled_layout(const void* a, const void* b,
                                       long long feat, int heads, int dtype,
                                       int kernel, int* lanes, int* vec,
                                       int* cols, int* registers,
                                       int* local_bytes) {
  cudaFuncAttributes attr{};
  cudaError_t rc = cudaErrorInvalidValue;
  Layout l{0, 0, 0};
  if (heads >= 1 && feat >= 1 && feat % heads == 0) {
    if (dtype == 0) {
      l = row_layout(a, b, feat, heads, sizeof(float));
      rc = kernel == 0 ? cudaFuncGetAttributes(&attr, fwd_kernel<float>(l))
                       : cudaFuncGetAttributes(&attr, dst_kernel<float>(l));
    } else if (dtype == 1) {
      l = row_layout(a, b, feat, heads, sizeof(__nv_bfloat16));
      rc = kernel == 0
               ? cudaFuncGetAttributes(&attr, fwd_kernel<__nv_bfloat16>(l))
               : cudaFuncGetAttributes(&attr, dst_kernel<__nv_bfloat16>(l));
    }
  }
  *lanes = l.lanes;
  *vec = l.vec;
  *cols = l.cols;
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(rc);
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
