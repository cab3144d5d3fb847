// Rate probes of row gathers on Hopper: P-G (gather-sum) and P-S (shuffle).
//
// P-G replaces scripts/profile_vmem_gather.py:43 `pallas_vmem_gather_sum`
// (its pl.pallas_call at :57):
//
//   out[i, :] = sum over k of table[idx[i, k], :]     table [T, F] f32,
//                                                      idx [n_tiles, tile]
//
// The TPU probe asked whether a random row gather is bound by memory or by
// the rate at which the core issues gathers, by gathering from a table
// held in VMEM.  Two kernels ask the same of an H100:
//  * resident: a block holds a column slice of the whole table (T rows x
//    kSliceCols f32, 64 KiB at T = 2048) in shared memory and walks tiles
//    for that slice, each tile's indices staged in shared memory too (and
//    fetched into registers a chunk ahead); two
//    threads read a row's slice, a float4 each, 128 row groups take the
//    tile's rows in turn, and their partial sums are added by a fixed
//    butterfly in each warp, then in warp order: deterministic.  Three
//    blocks an SM, in one wave.  Bound on this card: shared-memory reads,
//    E*F words at 32 words a clock per SM (about 18 us for E = 2^20, F =
//    128), beside 4*E index bytes from L2 per slice.
//  * global: the same indices gather rows of the table in device memory
//    (one warp per row, a float4 per lane, 16 warps per tile, four rows in
//    flight per warp, per-warp sums added in warp order: deterministic).
//    At T = 2048 the 1 MiB table stays in the 50 MB L2.  At T = 232,965
//    (Reddit's vertex count, 119 MB) each row is drawn about 4.5 times
//    and some of the table stays in L2.  At T = 2^22 (2 GiB) almost
//    every draw is a row not yet read and not in L2: each 512-byte row
//    comes from HBM, E*F*4 bytes (537 MB, 0.16 ms at 3.35 TB/s).
// The four times are the card's shared-memory and L2 random-row rates,
// the rate at Reddit's table size with L2 warm, and the HBM rate, in ns
// per row.
//
// P-S replaces scripts/probe_dyngather_shapes.py:18 `probe` (pl.pallas_call
// at :34): every grid step i < kShuffleSteps (the probe's 64) sets y = take_along_axis(x, idx_i,
// axis) with idx_i[r, c] = (131r + 7c + 13i) mod (m if axis == 0 else n);
// the last step's result stands.  Pure data movement: the result is
// bit-identical to the plain version's.  A gather along axis 1 stays in a
// row, so a block holds a slab of whole rows; along axis 0 it stays in a
// column, so a block holds a slab of whole columns (m rows x a few
// columns).  A block takes a tile of the output, a thread up to 8 of its
// elements, and a run of steps (the TPU's sequential grid steps are
// independent, so blocks take them side by side), with every step's result
// stored to shared memory (volatile, so no step is elided, as the TPU's
// out block took every step's store); the block with the last step copies
// it out.
// Bound: the element moves and index arithmetic of 64 shuffles, all
// on chip; the device-memory traffic is x read once and y written once.

#include "common.cuh"

namespace {

using sgnn::kFullMask;

constexpr int kSliceCols = 8;
constexpr int kLanesPerRow = kSliceCols / 4;  // a float4 each
constexpr int kResidentThreads = 256;
constexpr int kRowGroups = kResidentThreads / kLanesPerRow;
constexpr int kResidentBlocksPerSm = 3;  // 3 x 73 KiB of shared memory
constexpr int kIdxChunk = 2048;  // a tile's indices staged in shared memory
constexpr int kIdxPerThread = kIdxChunk / kResidentThreads;
constexpr int kGlobalWarps = 16;
constexpr int kShuffleThreads = 256;
constexpr int kShuffleSteps = 64;  // probe_dyngather_shapes.py:29's grid
// P-S: at most this many f32 of input slab, and this many outputs, a block
constexpr int kShuffleSlab = 16384;
constexpr int kShuffleOut = 2048;
constexpr int kShufflePer = kShuffleOut / kShuffleThreads;
constexpr int kShuffleBlocksPerSm = 3;  // 3 x 72 KiB of shared memory
constexpr int kMaxSmem = 232448;  // 227 KB, the most a block may ask for

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Chunk e0 of tile t's indices into this thread's kIdxPerThread registers
// (zeros past the tile's end).
__device__ __forceinline__ void fetch_chunk(const int32_t* __restrict__ idx,
                                            int t, int e0, int tile,
                                            int* pre) {
  const int32_t* p = idx + static_cast<int64_t>(t) * tile + e0;
  const int n = min(kIdxChunk, tile - e0);
#pragma unroll
  for (int k = 0; k < kIdxPerThread; ++k) {
    const int i = threadIdx.x + k * kResidentThreads;
    pre[k] = i < n ? p[i] : 0;
  }
}

__global__ void __launch_bounds__(kResidentThreads)
gather_sum_resident_kernel(const float* __restrict__ table,
                           const int32_t* __restrict__ idx,
                           float* __restrict__ out, int t_rows, int n_tiles,
                           int tile, int feat) {
  extern __shared__ float4 tab[];  // [t_rows][kLanesPerRow]
  __shared__ int sidx[kIdxChunk];
  __shared__ float4 part[kResidentThreads / 32][kLanesPerRow];
  const int c0 = blockIdx.x * kSliceCols;
  for (int i = threadIdx.x; i < t_rows * kLanesPerRow; i += blockDim.x) {
    tab[i] = *reinterpret_cast<const float4*>(
        table + static_cast<int64_t>(i / kLanesPerRow) * feat + c0 +
        4 * (i % kLanesPerRow));
  }
  const int piece = threadIdx.x % kLanesPerRow;  // its float4 of a slice
  const int grp = threadIdx.x / kLanesPerRow;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the block's chunks of indices, (tile, offset) in order, each fetched
  // into registers one chunk ahead of its use
  int pre[kIdxPerThread];
  const int step = static_cast<int>(gridDim.y);
  if (static_cast<int>(blockIdx.y) < n_tiles && tile > 0) {
    fetch_chunk(idx, blockIdx.y, 0, tile, pre);
  }
  for (int t = blockIdx.y; t < n_tiles; t += step) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e0 = 0; e0 < tile; e0 += kIdxChunk) {
      const int n = min(kIdxChunk, tile - e0);
#pragma unroll
      for (int k = 0; k < kIdxPerThread; ++k) {
        sidx[threadIdx.x + k * kResidentThreads] = pre[k];
      }
      __syncthreads();  // (the first also publishes the table slice)
      if (e0 + kIdxChunk < tile) {
        fetch_chunk(idx, t, e0 + kIdxChunk, tile, pre);
      } else if (t + step < n_tiles) {
        fetch_chunk(idx, t + step, 0, tile, pre);
      }
#pragma unroll 4
      for (int e = grp; e < n; e += kRowGroups) {
        add4(acc, tab[sidx[e] * kLanesPerRow + piece]);
      }
      __syncthreads();
    }
    // the warp's row groups, lanes of one piece, by a fixed butterfly
    for (int off = kLanesPerRow; off < 32; off <<= 1) {
      acc.x += __shfl_xor_sync(kFullMask, acc.x, off);
      acc.y += __shfl_xor_sync(kFullMask, acc.y, off);
      acc.z += __shfl_xor_sync(kFullMask, acc.z, off);
      acc.w += __shfl_xor_sync(kFullMask, acc.w, off);
    }
    if (lane < kLanesPerRow) part[warp][lane] = acc;
    __syncthreads();
    if (threadIdx.x < kLanesPerRow) {
      float4 sum = part[0][threadIdx.x];
      for (int w = 1; w < kResidentThreads / 32; ++w) {
        add4(sum, part[w][threadIdx.x]);
      }
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(t) * feat + c0 +
                                 4 * threadIdx.x) = sum;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kGlobalWarps * 32)
gather_sum_global_kernel(const float* __restrict__ table,
                         const int32_t* __restrict__ idx,
                         float* __restrict__ out, int n_tiles, int tile,
                         int feat) {
  __shared__ float4 part[kGlobalWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int32_t* tidx = idx + static_cast<int64_t>(t) * tile;
    for (int c0 = 0; c0 < feat; c0 += 32 * 4) {
      const int c = c0 + lane * 4;
      const bool live = c < feat;
      float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0, a2 = a0, a3 = a0;
      // warp-uniform loop: the shuffles below see all 32 lanes
      for (int e0 = warp * 32; e0 < tile; e0 += kGlobalWarps * 32) {
        const int n = min(32, tile - e0);
        const int mine = lane < n ? tidx[e0 + lane] : 0;
        int k = 0;
        for (; k + 4 <= n; k += 4) {
          const int r0 = __shfl_sync(kFullMask, mine, k);
          const int r1 = __shfl_sync(kFullMask, mine, k + 1);
          const int r2 = __shfl_sync(kFullMask, mine, k + 2);
          const int r3 = __shfl_sync(kFullMask, mine, k + 3);
          if (live) {
            const float4 v0 = *reinterpret_cast<const float4*>(
                table + static_cast<int64_t>(r0) * feat + c);
            const float4 v1 = *reinterpret_cast<const float4*>(
                table + static_cast<int64_t>(r1) * feat + c);
            const float4 v2 = *reinterpret_cast<const float4*>(
                table + static_cast<int64_t>(r2) * feat + c);
            const float4 v3 = *reinterpret_cast<const float4*>(
                table + static_cast<int64_t>(r3) * feat + c);
            add4(a0, v0);
            add4(a1, v1);
            add4(a2, v2);
            add4(a3, v3);
          }
        }
        for (; k < n; ++k) {
          const int r = __shfl_sync(kFullMask, mine, k);
          if (live) {
            add4(a0, *reinterpret_cast<const float4*>(
                         table + static_cast<int64_t>(r) * feat + c));
          }
        }
      }
      add4(a0, a1);
      add4(a2, a3);
      add4(a0, a2);
      part[warp][lane] = a0;
      __syncthreads();
      if (warp == 0 && live) {
        float4 s = part[0][lane];
        for (int w = 1; w < kGlobalWarps; ++w) add4(s, part[w][lane]);
        *reinterpret_cast<float4*>(out + static_cast<int64_t>(t) * feat + c) =
            s;
      }
      __syncthreads();
    }
  }
}

// AXIS 0: the block's input slab is all m rows of columns [sc0, sc0 +
// slab_cols); its outputs are rows [or0, or0 + out_rows) of those columns.
// AXIS 1: the slab is all n columns of rows [sr0, sr0 + slab_rows); its
// outputs are columns [oc0, oc0 + out_cols) of those rows.  blockIdx.z
// picks a run of steps_per_block grid steps (the steps are independent:
// each reads x); the block with the last step writes y.  A thread owns
// kShufflePer outputs; each one's index steps by 13 mod lim from one grid
// step to the next, which is (131r + 7c + 13i) mod lim without a division
// in the step loop.
template <int AXIS>
__global__ void __launch_bounds__(kShuffleThreads)
shuffle_kernel(const float* __restrict__ x, float* __restrict__ y, int m,
               int n, int steps_per_block, int slab_rows,
               int slab_cols, int out_rows, int out_cols) {
  extern __shared__ float smem[];
  float* xs = smem;
  volatile float* ys = smem + slab_rows * slab_cols;
  const int sr0 = AXIS == 0 ? 0 : blockIdx.y * slab_rows;
  const int sc0 = AXIS == 0 ? blockIdx.x * slab_cols : 0;
  const int or0 = AXIS == 0 ? blockIdx.y * out_rows : sr0;
  const int oc0 = AXIS == 0 ? sc0 : blockIdx.x * out_cols;
  {  // the slab, row by row; (r, c) stepped without a division
    const int dr = blockDim.x / slab_cols, dc = blockDim.x % slab_cols;
    int r = sr0 + threadIdx.x / slab_cols, c = threadIdx.x % slab_cols;
    for (int i = threadIdx.x; i < slab_rows * slab_cols; i += blockDim.x) {
      xs[i] = (r < m && sc0 + c < n) ? x[static_cast<int64_t>(r) * n + sc0 + c]
                                     : 0.0f;
      r += dr;
      c += dc;
      if (c >= slab_cols) {
        c -= slab_cols;
        ++r;
      }
    }
  }
  __syncthreads();
  const int lim = AXIS == 0 ? m : n;
  const int inc = 13 % lim;
  const int first = blockIdx.z * steps_per_block;
  const int last = min(kShuffleSteps, first + steps_per_block);
  int j[kShufflePer], fixed[kShufflePer];
  bool live[kShufflePer];
#pragma unroll
  for (int k = 0; k < kShufflePer; ++k) {
    const int i = threadIdx.x + k * kShuffleThreads;
    const int r = or0 + i / out_cols, c = oc0 + i % out_cols;
    live[k] = i < out_rows * out_cols && r < m && c < n;
    j[k] = live[k] ? (r * 131 + c * 7 + first * 13) % lim : 0;
    // the slab offset of the gathered element is j * stride + fixed
    fixed[k] = AXIS == 0 ? c - sc0 : (r - sr0) * slab_cols;
  }
  const int stride = AXIS == 0 ? slab_cols : 1;
  for (int step = first; step < last; ++step) {
#pragma unroll
    for (int k = 0; k < kShufflePer; ++k) {
      if (live[k]) {
        ys[threadIdx.x + k * kShuffleThreads] = xs[j[k] * stride + fixed[k]];
      }
      j[k] += inc;
      if (j[k] >= lim) j[k] -= lim;
    }
  }
  if (last != kShuffleSteps) return;  // another block's steps end the grid
  // each thread copies out the elements it wrote
#pragma unroll
  for (int k = 0; k < kShufflePer; ++k) {
    const int i = threadIdx.x + k * kShuffleThreads;
    const int r = or0 + i / out_cols, c = oc0 + i % out_cols;
    if (live[k]) y[static_cast<int64_t>(r) * n + c] = ys[i];
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` the first time a
// launch needs more than it has (`*granted`); later launches, captured into
// a CUDA graph among them, make no call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t bytes, int64_t* granted) {
  if (bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

int64_t resident_smem = 48 * 1024, shuffle_smem[2] = {48 * 1024, 48 * 1024};

}  // namespace

// resident: 1 = the shared-memory column slices (feat % 8 == 0, t_rows *
// 32 bytes of shared memory at most 227 KB), 0 = rows from device memory
// (feat % 4 == 0, table 16-byte aligned).  The caller checks shapes,
// dtypes, devices and index bounds and passes n_tiles, feat >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int sgnn_probe_gather_sum(const void* table, const void* idx,
                                     void* out, int t_rows, int n_tiles,
                                     int tile, int feat, int resident,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(table);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  if (resident) {
    const int64_t smem = int64_t{t_rows} * kSliceCols * 4;
    if (feat % kSliceCols != 0 || t_rows < 1 ||
        smem + 4 * (kResidentThreads / 32 * kSliceCols + kIdxChunk) >
            kMaxSmem) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t err =
        allow_smem(gather_sum_resident_kernel, smem, &resident_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int slices = feat / kSliceCols;
    // one wave of kResidentBlocksPerSm blocks an SM; each walks n_tiles / gy
    // tiles of its slice
    const int gy = std::max(
        1, std::min(n_tiles, kResidentBlocksPerSm * sm_count() / slices));
    gather_sum_resident_kernel<<<dim3(slices, gy), kResidentThreads, smem,
                                 s>>>(tp, ip, op, t_rows, n_tiles, tile, feat);
  } else {
    if (feat % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    gather_sum_global_kernel<<<n_tiles, kGlobalWarps * 32, 0, s>>>(
        tp, ip, op, n_tiles, tile, feat);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y [m, n] f32; axis 0 or 1.  Returns cudaGetLastError().
extern "C" int sgnn_probe_shuffle(const void* x, void* y, int m, int n,
                                  int axis, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || n < 1 || (axis != 0 && axis != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int slab_rows, slab_cols, out_rows, out_cols;
  dim3 grid;
  if (axis == 0) {
    slab_rows = m;
    slab_cols = std::min({n, std::max(1, kShuffleSlab / m), kShuffleOut});
    out_cols = slab_cols;
    out_rows = std::max(1, std::min(m, kShuffleOut / slab_cols));
    grid = dim3((n + slab_cols - 1) / slab_cols, (m + out_rows - 1) / out_rows);
  } else {
    slab_cols = n;
    slab_rows = std::min({m, std::max(1, kShuffleSlab / n), kShuffleOut});
    out_rows = slab_rows;
    out_cols = std::max(1, std::min(n, kShuffleOut / slab_rows));
    grid = dim3((n + out_cols - 1) / out_cols, (m + slab_rows - 1) / slab_rows);
  }
  // runs of steps across blocks, while the blocks fit in one wave of
  // kShuffleBlocksPerSm an SM (each block loads its slab once)
  const int tiles = static_cast<int>(grid.x * grid.y);
  const int want = std::max(
      1, std::min(kShuffleSteps, kShuffleBlocksPerSm * sm_count() / tiles));
  const int per_block = (kShuffleSteps + want - 1) / want;
  grid.z = (kShuffleSteps + per_block - 1) / per_block;
  const int64_t smem =
      (int64_t{slab_rows} * slab_cols + int64_t{out_rows} * out_cols) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  if (axis == 0) {
    const cudaError_t err =
        allow_smem(shuffle_kernel<0>, smem, &shuffle_smem[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    shuffle_kernel<0><<<grid, kShuffleThreads, smem, s>>>(
        xp, yp, m, n, per_block, slab_rows, slab_cols, out_rows, out_cols);
  } else {
    const cudaError_t err =
        allow_smem(shuffle_kernel<1>, smem, &shuffle_smem[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    shuffle_kernel<1><<<grid, kShuffleThreads, smem, s>>>(
        xp, yp, m, n, per_block, slab_rows, slab_cols, out_rows, out_cols);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgnn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
