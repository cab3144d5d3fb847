// The sampled GATv2 layer's attention aggregation, forward and backward,
// over the dense-fanout block of the device sampler (nbr int32 [D, K], w
// f32 [D, K] with 0 on padded slots), xl [S, F] f32 the sources' rows,
// xr [D, F] f32 the destinations' own rows and att [F] f32, F = heads *
// C.  Per destination d, valid slot k (w != 0), source s = nbr[d, k] and
// head h (PyG's GATv2Conv, ops/gatv2_sampled.py):
//
//   u      = xl[s, head h] + xr[d, head h]                  (C columns)
//   e      = sum over c of att[h, c] * leaky_relu(u[c], 0.2)
//   alpha  = exp(e - m[d, h]) / max(z[d, h], FLT_MIN),  m the max over the
//            valid slots, z the sum of their exponentials; 0 on padded
//            slots (a row with no valid slot is all zero)
//   out[d, head h] = sum over k of alpha * xl[s, head h]
//
// With G = dL/dout the backward is
//
//   datt   = <G[d, head h], xl[s, head h]>
//   dscore = alpha * (datt - sum over k of alpha * datt)
//   dxl[s, head h] = sum over (d, k) with nbr = s of
//                    alpha * G[d, head h] + dscore * att ⊙ leaky'(u)
//   dxr[d, head h] = sum over k of dscore * att ⊙ leaky'(u)
//   d att[head h]  = sum over (d, k) of dscore * leaky_relu(u)
//
// with leaky'(x) = 1 for x > 0, else 0.2, as torch's.  GAT's score splits
// into per-vertex tables (gat_sampled.cu); this one does not: every
// (slot, head) costs a C-wide vector operation in both passes, and the
// backward's source side needs xr[d] and G[d] for every slot.
//
// Design:
//  * forward (gatv2_sampled_fwd_kernel): a warp a destination row, a head
//    at a time; a lane holds `cols` groups of `vec` columns of the head
//    (4 adjacent columns in one 16-byte load where C is a multiple of 4
//    and the rows aligned, else 1), xr[d]'s and att's in registers.  The
//    row's valid slots (a ballot of w) go in slot order, 4 source rows in
//    flight; each slot's score is reduced over the warp and folded into an
//    online softmax (running max m, sum z, the weighted row rescaled when
//    m grows), so every source row is read once.  The lane of a slot's
//    bit writes its score; once m and z are final it rewrites it as alpha
//    [D, K, H], the state the backward keeps.
//  * backward, destination pass (gatv2_sampled_dst_kernel, the same
//    layout): per head, G[d] in registers; first the datt of each valid
//    slot (its source row read, the dot product reduced over the warp)
//    and their alpha-weighted sum r; then the source rows again for u
//    (L2 holds a row's 11 head slices between the two reads), dscore,
//    dxr[d] summed in registers and stored once, and att's gradient added
//    into the warp's row of shared memory.  The grid is at most
//    `max_blocks` blocks, fixed by D alone: each block writes its warps'
//    rows summed in warp order as one partial row, and
//    gatv2_sampled_datt_kernel sums the partial rows in block order.
//  * backward, source pass: gather_agg.cu's block transpose (a stable
//    radix sort of the slots keyed by source, padded slots dropped) hands
//    out each source's slots p in ascending order; csr_sum.cuh's
//    edge-balanced walk with Gatv2SrcPolicy loads the source's own row at
//    the row's start and, for each slot, G[p / K] and xr[p / K] with
//    alpha[p] and dscore[p], and sums dxl a source row (hub sources in
//    pieces combined by the walk's fixed tree, Gatv2SrcStore).
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

__device__ __forceinline__ float leaky(float u) {
  return u > 0.0f ? u : kNegSlope * u;
}

__device__ __forceinline__ float leaky_grad(float u) {
  return u > 0.0f ? 1.0f : kNegSlope;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// A lane's column groups of head hh: group j starts at column col[j] of
// the row (-1 past the head); a group lies in the head whole (C % VEC ==
// 0).
template <int VEC, int COLS>
__device__ __forceinline__ void head_cols(int hh, int64_t c, int lane,
                                          int64_t (&col)[COLS]) {
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int64_t cc = static_cast<int64_t>(lane + 32 * j) * VEC;
    col[j] = cc < c ? hh * c + cc : -1;
  }
}

// VEC columns at p, or zeros where the group is past the head.
template <int VEC>
__device__ __forceinline__ void load_or_zero(const float* __restrict__ p,
                                             bool in, float (&v)[VEC]) {
  if (in) {
    load_cols<float, VEC>(p, v);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = 0.0f;
  }
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

// kBatch slots' source rows (this lane's column groups of the head),
// loaded before any use; `my_src` is lane i's source of slot k0 + i.
// Warp-uniform: ks is the same on every lane.
template <int VEC, int COLS>
__device__ __forceinline__ void load_slot_rows(
    const float* __restrict__ xl, int my_src, const int (&ks)[kBatch],
    const int64_t (&col)[COLS], int64_t feat,
    float (&v)[kBatch][COLS][VEC]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int src = __shfl_sync(kFullMask, my_src, ks[u] & 31);
    const float* row = xl + static_cast<int64_t>(src) * feat;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      load_or_zero<VEC>(row + col[j], ks[u] >= 0 && col[j] >= 0, v[u][j]);
    }
  }
}

// This lane's share of a slot's score: sum of att * leaky(x + xr).
template <int VEC, int COLS>
__device__ __forceinline__ float score_part(const float (&x)[COLS][VEC],
                                            const float (&r)[COLS][VEC],
                                            const float (&a)[COLS][VEC]) {
  float p = 0.0f;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
#pragma unroll
    for (int q = 0; q < VEC; ++q) p = fmaf(a[j][q], leaky(x[j][q] + r[j][q]), p);
  }
  return p;
}

// Forward (module note).  Every loop holding a shuffle or a ballot is
// warp-uniform: a warp takes one row at a time.
template <int VEC, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_sampled_fwd_kernel(const float* __restrict__ xl,
                         const float* __restrict__ xr,
                         const float* __restrict__ att,
                         const int32_t* __restrict__ nbr,
                         const float* __restrict__ w, float* __restrict__ out,
                         float* __restrict__ alpha, int64_t num_dst,
                         int k_slots, int64_t feat, int heads) {
  const int lane = threadIdx.x & 31;
  const int64_t c = feat / heads;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_dst; row += stride) {
    const int64_t base = row * k_slots;
    for (int hh = 0; hh < heads; ++hh) {
      int64_t col[COLS];
      head_cols<VEC, COLS>(hh, c, lane, col);
      float r[COLS][VEC], a[COLS][VEC], acc[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        load_or_zero<VEC>(xr + row * feat + col[j], col[j] >= 0, r[j]);
        load_or_zero<VEC>(att + col[j], col[j] >= 0, a[j]);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[j][q] = 0.0f;
      }
      float m = -FLT_MAX;  // torch.finfo(float32).min, edge_softmax's fill
      float z = 0.0f;
      for (int k0 = 0; k0 < k_slots; k0 += 32) {
        const int k = k0 + lane;
        const int my_src = k < k_slots ? nbr[base + k] : 0;
        unsigned mask =
            __ballot_sync(kFullMask, k < k_slots && w[base + k] != 0.0f);
        while (mask != 0) {  // the row's valid slots, in order
          int ks[kBatch];
          next_slots(mask, ks);
          float v[kBatch][COLS][VEC];
          load_slot_rows<VEC, COLS>(xl, my_src, ks, col, feat, v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (ks[u] < 0) break;
            const float e = warp_sum(score_part<VEC, COLS>(v[u], r, a));
            if (lane == ks[u]) alpha[(base + k0 + ks[u]) * heads + hh] = e;
            const float mn = fmaxf(m, e);
            const float sc = expf(m - mn);
            const float pe = expf(e - mn);
            z = z * sc + pe;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
#pragma unroll
              for (int q = 0; q < VEC; ++q) {
                acc[j][q] = acc[j][q] * sc + pe * v[u][j][q];
              }
            }
            m = mn;
          }
        }
      }
      const float zc = fmaxf(z, FLT_MIN);
      // each lane rewrites the scores it wrote as alpha (0 where padded)
      for (int k = lane; k < k_slots; k += 32) {
        const int64_t p = (base + k) * heads + hh;
        alpha[p] = w[base + k] != 0.0f ? expf(alpha[p] - m) / zc : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (col[j] < 0) continue;
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[j][q] /= zc;
        store_cols<float, VEC>(out + row * feat + col[j], acc[j]);
      }
    }
  }
}

// Backward, destination pass (module note): dscore [D, K, H], dxr [D, F]
// and the block's partial row of att's gradient, datt_part [gridDim.x,
// F].  Dynamic shared memory: kWarpsPerBlock rows of F floats.
template <int VEC, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gatv2_sampled_dst_kernel(const float* __restrict__ g,
                         const float* __restrict__ xl,
                         const float* __restrict__ xr,
                         const float* __restrict__ att,
                         const int32_t* __restrict__ nbr,
                         const float* __restrict__ w,
                         const float* __restrict__ alpha,
                         float* __restrict__ dscore, float* __restrict__ dxr,
                         float* __restrict__ datt_part, int64_t num_dst,
                         int k_slots, int64_t feat, int heads) {
  extern __shared__ float shared_datt[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = shared_datt + warp * feat;  // this warp's att gradient
  for (int64_t f = lane; f < feat; f += 32) mine[f] = 0.0f;
  __syncwarp();
  const int64_t c = feat / heads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_dst; row += stride) {
    const int64_t base = row * k_slots;
    for (int hh = 0; hh < heads; ++hh) {
      int64_t col[COLS];
      head_cols<VEC, COLS>(hh, c, lane, col);
      float gr[COLS][VEC], r[COLS][VEC], a[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        load_or_zero<VEC>(g + row * feat + col[j], col[j] >= 0, gr[j]);
        load_or_zero<VEC>(xr + row * feat + col[j], col[j] >= 0, r[j]);
        load_or_zero<VEC>(att + col[j], col[j] >= 0, a[j]);
      }
      // datt of every valid slot into dscore, and their alpha-weighted sum
      float rsum = 0.0f;
      for (int k0 = 0; k0 < k_slots; k0 += 32) {
        const int k = k0 + lane;
        const int my_src = k < k_slots ? nbr[base + k] : 0;
        unsigned mask =
            __ballot_sync(kFullMask, k < k_slots && w[base + k] != 0.0f);
        while (mask != 0) {
          int ks[kBatch];
          next_slots(mask, ks);
          float v[kBatch][COLS][VEC];
          load_slot_rows<VEC, COLS>(xl, my_src, ks, col, feat, v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (ks[u] < 0) break;
            float d = 0.0f;
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
#pragma unroll
              for (int q = 0; q < VEC; ++q) d = fmaf(gr[j][q], v[u][j][q], d);
            }
            d = warp_sum(d);
            const int64_t p = (base + k0 + ks[u]) * heads + hh;
            if (lane == ks[u]) dscore[p] = d;
            rsum = fmaf(alpha[p], d, rsum);
          }
        }
      }
      __syncwarp();  // datt written, before other lanes read it
      // the rows again: u, dscore, dxr and att's gradient
      float dr[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) dr[j][q] = 0.0f;
      }
      for (int k0 = 0; k0 < k_slots; k0 += 32) {
        const int k = k0 + lane;
        const int my_src = k < k_slots ? nbr[base + k] : 0;
        unsigned mask =
            __ballot_sync(kFullMask, k < k_slots && w[base + k] != 0.0f);
        while (mask != 0) {
          int ks[kBatch];
          next_slots(mask, ks);
          float v[kBatch][COLS][VEC];
          load_slot_rows<VEC, COLS>(xl, my_src, ks, col, feat, v);
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (ks[u] < 0) break;
            const int64_t p = (base + k0 + ks[u]) * heads + hh;
            const float ds = alpha[p] * (dscore[p] - rsum);
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              if (col[j] < 0) continue;
#pragma unroll
              for (int q = 0; q < VEC; ++q) {
                const float uu = v[u][j][q] + r[j][q];
                dr[j][q] += ds * a[j][q] * leaky_grad(uu);
                mine[col[j] + q] += ds * leaky(uu);
              }
            }
          }
        }
      }
      __syncwarp();  // every lane has read the datt it needs
      // each lane turns its own slots' datt into dscore (as above)
      for (int k = lane; k < k_slots; k += 32) {
        const int64_t p = (base + k) * heads + hh;
        if (w[base + k] != 0.0f) dscore[p] = alpha[p] * (dscore[p] - rsum);
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (col[j] >= 0) store_cols<float, VEC>(dxr + row * feat + col[j], dr[j]);
      }
    }
  }
  __syncthreads();
  for (int64_t f = threadIdx.x; f < feat; f += blockDim.x) {
    float s = 0.0f;
    for (int wp = 0; wp < kWarpsPerBlock; ++wp) s += shared_datt[wp * feat + f];
    datt_part[blockIdx.x * feat + f] = s;
  }
}

// att's gradient: the destination pass's partial rows summed in block
// order.  A block of 32 x 32 threads takes 32 columns; thread (ty, tx)
// sums column tx's rows ty, ty + 32, ... in order, then the 32 sums of a
// column are added in ty order.
__global__ void __launch_bounds__(1024)
gatv2_sampled_datt_kernel(const float* __restrict__ part,
                          float* __restrict__ datt, int64_t rows,
                          int64_t feat) {
  __shared__ float sums[32][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t f = static_cast<int64_t>(blockIdx.x) * 32 + tx;
  float s = 0.0f;
  if (f < feat) {
    for (int64_t b = ty; b < rows; b += 32) s += part[b * feat + f];
  }
  sums[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && f < feat) {
    float t = 0.0f;
    for (int i = 0; i < 32; ++i) t += sums[i][tx];
    datt[f] = t;
  }
}

template <int VEC, int COLS>
int launch_fwd(const float* xl, const float* xr, const float* att,
               const int32_t* nbr, const float* w, float* out, float* alpha,
               int64_t num_dst, int k_slots, int64_t feat, int heads,
               cudaStream_t stream) {
  gatv2_sampled_fwd_kernel<VEC, COLS>
      <<<sgnn::warp_blocks(num_dst), kWarpsPerBlock * 32, 0, stream>>>(
          xl, xr, att, nbr, w, out, alpha, num_dst, k_slots, feat, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int VEC, int COLS>
int launch_dst(const float* g, const float* xl, const float* xr,
               const float* att, const int32_t* nbr, const float* w,
               const float* alpha, float* dscore, float* dxr, float* part,
               float* datt, int64_t num_dst, int k_slots, int64_t feat,
               int heads, int64_t max_blocks, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(std::min<int64_t>(
      sgnn::warp_blocks(num_dst), max_blocks));
  const size_t shared = sizeof(float) * kWarpsPerBlock * feat;
  gatv2_sampled_dst_kernel<VEC, COLS>
      <<<blocks, kWarpsPerBlock * 32, shared, stream>>>(
          g, xl, xr, att, nbr, w, alpha, dscore, dxr, part, num_dst, k_slots,
          feat, heads);
  gatv2_sampled_datt_kernel<<<static_cast<unsigned>((feat + 31) / 32), 1024,
                              0, stream>>>(part, datt, blocks, feat);
  return static_cast<int>(cudaGetLastError());
}

// A head's column groups a lane: the fewest powers of two that cover C
// (at most 4: 512 vector or 128 scalar columns a head), 0 past that.
int head_groups(int64_t c, int vec) {
  for (int cols = 1; cols <= 4; cols *= 2) {
    if (32 * vec * cols >= c) return cols;
  }
  return 0;
}

// The row kernels' instance for (vec, cols): L(VEC, COLS) launches it.
#define SGNN_ROW_PICK(L, vec, cols)             \
  ((vec) == 4 ? ((cols) == 1   ? L(4, 1)        \
                 : (cols) == 2 ? L(4, 2)        \
                               : L(4, 4))       \
              : ((cols) == 1   ? L(1, 1)        \
                 : (cols) == 2 ? L(1, 2)        \
                               : L(1, 4)))

// Backward, source pass: what csr_sum.cuh's walk sums over the block's
// transpose (rows are sources s, each entry a slot p = d * K + k):
//     dxl[s] = sum over p of alpha[p] * G[d] + dscore[p] * att ⊙ leaky'(u)
// with u = xl[s] + xr[d], d = p / K, a group's head's alpha and dscore.
// The source's own row xl[s] is loaded as its row (or piece) begins.
template <int COLS, int VEC>
struct Gatv2SrcPolicy {
  static constexpr bool kNeedsRow = false;
  struct Shared {};
  struct Acc {
    float xs[COLS][VEC];  // xl[s]
    float sum[COLS][VEC];
  };
  using Edge = int;  // the slot p
  struct Rows {
    float g[kUnroll][COLS][VEC];
    float r[kUnroll][COLS][VEC];
    float a[kUnroll][COLS];
    float ds[kUnroll][COLS];
  };

  const float* __restrict__ g;
  const float* __restrict__ xl;
  const float* __restrict__ xr;
  const float* __restrict__ att;
  const float* __restrict__ alpha;
  const float* __restrict__ dscore;
  const int32_t* __restrict__ slot;
  float* __restrict__ dxl;
  float* __restrict__ carry;  // [slots, feat]
  int64_t feat;
  int heads;
  int64_t c;
  int k_slots;
  // the tile's
  int64_t c0;
  int hd[COLS];           // group j's head, -1 past F
  float av[COLS][VEC];    // group j's att

  __device__ __forceinline__ void bind(Shared&) {}
  __device__ __forceinline__ int64_t width() const { return feat; }
  __device__ __forceinline__ int64_t tile() const { return 32 * COLS * VEC; }
  __device__ __forceinline__ void begin_tile(int64_t c_first, int lane) {
    c0 = c_first;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t cc = col_of(c0, lane, j, VEC);
      hd[j] = cc < feat ? static_cast<int>(cc / c) : -1;
      load_or_zero<VEC>(att + cc, hd[j] >= 0, av[j]);
    }
  }
  __device__ __forceinline__ void begin_row(Acc& t, int64_t r, int lane) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      load_or_zero<VEC>(xl + (r >= 0 ? r : 0) * feat + col_of(c0, lane, j, VEC),
                        r >= 0 && hd[j] >= 0, t.xs[j]);
#pragma unroll
      for (int q = 0; q < VEC; ++q) t.sum[j][q] = 0.0f;
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
      const int64_t d = p / k_slots;
      const int64_t at = static_cast<int64_t>(p) * heads;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const bool in = k + u < n && hd[j] >= 0;
        const int64_t cc = col_of(c0, lane, j, VEC);
        load_or_zero<VEC>(g + d * feat + cc, in, v.g[u][j]);
        load_or_zero<VEC>(xr + d * feat + cc, in, v.r[u][j]);
        v.a[u][j] = in ? alpha[at + hd[j]] : 0.0f;
        v.ds[u][j] = in ? dscore[at + hd[j]] : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void add(Acc& t, Edge, const Rows& v, int u,
                                      int) const {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const float uu = t.xs[j][q] + v.r[u][j][q];
        t.sum[j][q] += v.a[u][j] * v.g[u][j][q] +
                       v.ds[u][j] * av[j][q] * leaky_grad(uu);
      }
    }
  }
  __device__ __forceinline__ void flush(Acc&, int) const {}
  __device__ __forceinline__ void store_row(const Acc& t, int64_t r,
                                            int lane) const {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] >= 0) {
        store_cols<float, VEC>(dxl + r * feat + col_of(c0, lane, j, VEC),
                               t.sum[j]);
      }
    }
  }
  __device__ __forceinline__ void store_piece(const Acc& t, int64_t s,
                                              int lane) const {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (hd[j] >= 0) {
        store_cols<float, VEC>(carry + s * feat + col_of(c0, lane, j, VEC),
                               t.sum[j]);
      }
    }
  }
  __device__ __forceinline__ void zero_row(int64_t r, int lane) const {
    for (int64_t f = lane; f < feat; f += 32) dxl[r * feat + f] = 0.0f;
  }
};

// The fix-up's store of a hub source's dxl row.
struct Gatv2SrcStore {
  float* __restrict__ dxl;
  int64_t feat;

  template <int VEC>
  __device__ __forceinline__ void store(int64_t r, int64_t c,
                                        const float (&v)[VEC]) const {
    store_cols<float, VEC>(dxl + r * feat + c, v);
  }
};

template <int COLS, int VEC>
int launch_src(const float* g, const float* xl, const float* xr,
               const float* att, const float* alpha, const float* dscore,
               const int64_t* rowptr_t, const int32_t* slot_t, float* dxl,
               float* carry, int32_t* carry_row, int64_t num_src,
               int64_t max_edges, int64_t chunk, int64_t feat, int heads,
               int k_slots, cudaStream_t stream) {
  const int64_t max_chunks =
      std::max<int64_t>(1, (max_edges + chunk - 1) / chunk);
  Gatv2SrcPolicy<COLS, VEC> p{g,     xl,    xr,          att,     alpha,
                              dscore, slot_t, dxl,       carry,   feat,
                              heads, feat / heads, k_slots};
  sgnn::csr_walk_launch<Gatv2SrcPolicy<COLS, VEC>, Gatv2SrcStore, COLS, VEC>(
      p, Gatv2SrcStore{dxl, feat}, rowptr_t, carry, carry_row, num_src,
      max_chunks, chunk, feat, stream);
  return static_cast<int>(cudaGetLastError());
}

// The arguments every entry checks: vec 4 needs C % 4 == 0 (the caller
// checked the alignment), and a head fits a lane's column groups.
bool bad_shape(int64_t num_dst, int k_slots, int64_t feat, int heads,
               int vec) {
  return num_dst < 1 || k_slots < 1 || heads < 1 || feat < heads ||
         feat % heads != 0 || (vec != 1 && vec != 4) ||
         (feat / heads) % vec != 0 || head_groups(feat / heads, vec) == 0;
}

}  // namespace

// Every float array is float32, nbr int32.  The caller checks shapes,
// dtypes, devices, alignment and index bounds; vec (1 or 4) is the
// columns a load.  Each returns cudaGetLastError() after its launches, or
// cudaErrorInvalidValue for shapes it does not take.

// Forward: out [num_dst, feat] and alpha [num_dst, k_slots, heads].
extern "C" int sgnn_gatv2_sampled_fwd(const void* xl, const void* xr,
                                      const void* att, const void* nbr,
                                      const void* w, void* out, void* alpha,
                                      long long num_dst, int k_slots,
                                      long long feat, int heads, int vec,
                                      void* stream) {
  if (bad_shape(num_dst, k_slots, feat, heads, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = head_groups(feat / heads, vec);
#define SGNN_FWD(V, C)                                                     \
  launch_fwd<V, C>(static_cast<const float*>(xl),                          \
                   static_cast<const float*>(xr),                          \
                   static_cast<const float*>(att),                         \
                   static_cast<const int32_t*>(nbr),                       \
                   static_cast<const float*>(w), static_cast<float*>(out), \
                   static_cast<float*>(alpha), num_dst, k_slots, feat,     \
                   heads, static_cast<cudaStream_t>(stream))
  return SGNN_ROW_PICK(SGNN_FWD, vec, cols);
#undef SGNN_FWD
}

// Backward, destination pass: dscore [num_dst, k_slots, heads], dxr
// [num_dst, feat] and datt [feat], through part, a [max_blocks, feat]
// scratch of partial rows.  Shared memory: 8 * feat floats a block
// (feat <= 1536).
extern "C" int sgnn_gatv2_sampled_bwd_dst(
    const void* g, const void* xl, const void* xr, const void* att,
    const void* nbr, const void* w, const void* alpha, void* dscore,
    void* dxr, void* part, void* datt, long long num_dst, int k_slots,
    long long feat, int heads, int vec, long long max_blocks, void* stream) {
  if (bad_shape(num_dst, k_slots, feat, heads, vec) || max_blocks < 1 ||
      feat > 1536) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cols = head_groups(feat / heads, vec);
#define SGNN_DST(V, C)                                                        \
  launch_dst<V, C>(                                                           \
      static_cast<const float*>(g), static_cast<const float*>(xl),            \
      static_cast<const float*>(xr), static_cast<const float*>(att),          \
      static_cast<const int32_t*>(nbr), static_cast<const float*>(w),         \
      static_cast<const float*>(alpha), static_cast<float*>(dscore),          \
      static_cast<float*>(dxr), static_cast<float*>(part),                    \
      static_cast<float*>(datt), num_dst, k_slots, feat, heads, max_blocks,   \
      static_cast<cudaStream_t>(stream))
  return SGNN_ROW_PICK(SGNN_DST, vec, cols);
#undef SGNN_DST
}

// Backward, source pass over the block's transpose (rowptr_t [num_src + 1]
// int64, slot_t the slots p int32): dxl [num_src, feat], csr_sum.cuh's
// walk at `chunk` edges a warp over at most max_edges entries.  carry is
// an f32 [2 * max(1, ceil(max_edges / chunk)), feat] scratch and
// carry_row an int32 scratch of its rows.
extern "C" int sgnn_gatv2_sampled_bwd_src(
    const void* g, const void* xl, const void* xr, const void* att,
    const void* alpha, const void* dscore, const void* rowptr_t,
    const void* slot_t, void* dxl, void* carry, void* carry_row,
    long long num_src, long long max_edges, long long chunk, long long feat,
    int heads, int k_slots, int vec, void* stream) {
  if (num_src < 1 || chunk < 1 || bad_shape(1, k_slots, feat, heads, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SGNN_SRC(C, V)                                                      \
  launch_src<C, V>(                                                         \
      static_cast<const float*>(g), static_cast<const float*>(xl),          \
      static_cast<const float*>(xr), static_cast<const float*>(att),        \
      static_cast<const float*>(alpha), static_cast<const float*>(dscore),  \
      static_cast<const int64_t*>(rowptr_t),                                \
      static_cast<const int32_t*>(slot_t), static_cast<float*>(dxl),        \
      static_cast<float*>(carry), static_cast<int32_t*>(carry_row),         \
      num_src, max_edges, chunk, feat, heads, k_slots,                      \
      static_cast<cudaStream_t>(stream))
  return vec == 4 ? SGNN_SRC(1, 4) : SGNN_SRC(2, 1);
#undef SGNN_SRC
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
