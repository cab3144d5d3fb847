// Sampled-block aggregation (K1) and its two backward products, over the
// dense-fanout layout of the sampler (nbr int32 [D, K], w f32 [D, K], x
// [S, F] f32 or bf16):
//
//   forward  out[d, :]  = sum over k of w[d, k] * x[nbr[d, k], :]
//   dx       dx[s, :]  += w[d, k] * g[d, :]          for every nbr[d, k] = s
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
// the other way, through f32 atomics into a [S, F] buffer.
//
// Design, simple first:
//  * forward: one warp per destination row, lanes over feature columns
//    (COLS per lane, picked from F, and a column-tile loop for any F); each
//    slot's index and weight are loaded once per column tile by one lane
//    and broadcast with __shfl_sync; slots of weight 0 are skipped (the
//    sampler's padding); the sum is an f32 register sum in slot order and
//    each output element is written once, so the forward is deterministic;
//  * dx: one warp per destination row, the row of g held in registers, and
//    for each slot of nonzero weight an f32 atomicAdd of w*g into the
//    source row, as float4 (a vector red.global.add, sm_90) when F is a
//    multiple of 4, else per element.  Atomics from different destinations
//    into one source row land in an order that changes from run to run, so
//    dx is NOT bit-deterministic; the hub sources of a power-law graph are
//    where they contend;
//  * dw: one warp per (row, slot) pair, lanes over F, an f32 sum reduced
//    across the warp with __shfl_xor_sync, written once.  Not on the
//    training path (the sampler's weights need no gradient).
// Row offsets are 64-bit.  Staging rows with cp.async/TMA, degree-sorted
// scheduling and an atomic-free dx (a per-batch transpose) are later work.

#include "common.cuh"

namespace {

using sgnn::from_float;
using sgnn::kFullMask;
using sgnn::kWarpsPerBlock;
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

// VEC = 4: each lane owns 4 adjacent columns per group and adds them with
// one float4 atomic (needs F % 4 == 0, so a group is in range as a whole
// and 16-byte aligned); VEC = 1: one column per group, scalar atomics.
template <typename T, int COLS, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_agg_dx_kernel(const T* __restrict__ g, const int32_t* __restrict__ nbr,
                     const float* __restrict__ w, float* __restrict__ dx,
                     int64_t num_dst, int k_slots, int64_t feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_dst; row += stride) {
    const int64_t base = row * k_slots;
    const T* g_row = g + row * feat;
    for (int64_t c0 = 0; c0 < feat; c0 += 32 * COLS * VEC) {
      float gv[COLS][VEC];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + static_cast<int64_t>(lane + 32 * j) * VEC;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          gv[j][v] = c < feat ? to_float(g_row[c + v]) : 0.0f;
        }
      }
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
          float* dx_row = dx + static_cast<int64_t>(src) * feat;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int64_t c = c0 + static_cast<int64_t>(lane + 32 * j) * VEC;
            if (c >= feat) continue;
            if constexpr (VEC == 4) {
              atomicAdd(reinterpret_cast<float4*>(dx_row + c),
                        make_float4(wk * gv[j][0], wk * gv[j][1],
                                    wk * gv[j][2], wk * gv[j][3]));
            } else {
              atomicAdd(dx_row + c, wk * gv[j][0]);
            }
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_agg_dw_kernel(const T* __restrict__ g, const T* __restrict__ x,
                     const int32_t* __restrict__ nbr, float* __restrict__ dw,
                     int64_t num_pairs, int k_slots, int64_t feat) {
  const int lane = threadIdx.x & 31;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                        (threadIdx.x >> 5);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t p = first; p < num_pairs; p += stride) {
    const T* g_row = g + (p / k_slots) * feat;
    const T* x_row = x + static_cast<int64_t>(nbr[p]) * feat;
    float acc = 0.0f;
    for (int64_t c = lane; c < feat; c += 32) {
      acc = fmaf(to_float(g_row[c]), to_float(x_row[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(kFullMask, acc, off);
    }
    if (lane == 0) dw[p] = acc;
  }
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
void launch_dx(const void* g, const void* nbr, const void* w, void* dx,
               int64_t num_dst, int k_slots, int64_t feat,
               cudaStream_t stream) {
  const dim3 grid(sgnn::warp_blocks(num_dst)), block(kWarpsPerBlock * 32);
  const T* gp = static_cast<const T*>(g);
  const int32_t* np_ = static_cast<const int32_t*>(nbr);
  const float* wp = static_cast<const float*>(w);
  float* dp = static_cast<float*>(dx);
  if (feat % 4 == 0) {
    if (feat <= 128) {
      gather_agg_dx_kernel<T, 1, 4><<<grid, block, 0, stream>>>(
          gp, np_, wp, dp, num_dst, k_slots, feat);
    } else {
      gather_agg_dx_kernel<T, 2, 4><<<grid, block, 0, stream>>>(
          gp, np_, wp, dp, num_dst, k_slots, feat);
    }
  } else if (feat <= 32) {
    gather_agg_dx_kernel<T, 1, 1><<<grid, block, 0, stream>>>(
        gp, np_, wp, dp, num_dst, k_slots, feat);
  } else if (feat <= 64) {
    gather_agg_dx_kernel<T, 2, 1><<<grid, block, 0, stream>>>(
        gp, np_, wp, dp, num_dst, k_slots, feat);
  } else if (feat <= 128) {
    gather_agg_dx_kernel<T, 4, 1><<<grid, block, 0, stream>>>(
        gp, np_, wp, dp, num_dst, k_slots, feat);
  } else {
    gather_agg_dx_kernel<T, 8, 1><<<grid, block, 0, stream>>>(
        gp, np_, wp, dp, num_dst, k_slots, feat);
  }
}

template <typename T>
void launch_dw(const void* g, const void* x, const void* nbr, void* dw,
               int64_t num_dst, int k_slots, int64_t feat,
               cudaStream_t stream) {
  const int64_t pairs = num_dst * k_slots;
  const dim3 grid(sgnn::warp_blocks(pairs)), block(kWarpsPerBlock * 32);
  gather_agg_dw_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const int32_t*>(nbr), static_cast<float*>(dw), pairs,
      k_slots, feat);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the dtype of x, g and out; w, dw and
// the dx buffer are f32).  The caller checks shapes, dtypes, devices and
// index bounds, zeroes the dx buffer, and passes num_dst, k_slots and feat
// >= 1.  Each returns cudaGetLastError() after its launch.
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

extern "C" int sgnn_gather_agg_bwd_dx(const void* g, const void* nbr,
                                      const void* w, void* dx,
                                      long long num_dst, int k_slots,
                                      long long feat, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_dx<float>(g, nbr, w, dx, num_dst, k_slots, feat, s);
  } else if (dtype == 1) {
    launch_dx<__nv_bfloat16>(g, nbr, w, dx, num_dst, k_slots, feat, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
