// The stable ranking of one tile of (key, id) int2 pairs by a
// kRadixBits-bit digit of the key: one pass of a stable LSD radix sort,
// a counting sort per digit.  K1's dx transpose (gather_agg.cu,
// block_transpose_scatter_kernel: slots keyed by source) and the tile
// probe's grouping of edges by output row (probe_tile.cu,
// tile_group_kernel) place each tile's items with it.  Integer atomics on
// shared-memory counts only, so the places are the same on every run.
// The first pass takes item i's pair from the caller's Keys functor
// (`int2 operator()(int64_t i)`: (key, id)); later passes read the
// previous pass's output.  Keys are nonnegative int32.
#pragma once

#include "common.cuh"

namespace sgnn {

constexpr int kRadixBits = 9;
constexpr int kBuckets = 1 << kRadixBits;
constexpr int kSortThreads = 256;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kTileItems = 2048;

// Item i's (key, id): from `keys` in the first pass (pairs null), else
// from the previous pass's pairs.
template <class Keys>
__device__ __forceinline__ int2 sort_item(const Keys& keys,
                                          const int2* __restrict__ pairs,
                                          int64_t i) {
  return pairs != nullptr ? pairs[i] : keys(i);
}

// Ranks tile `tile`'s items by digit, stably, with WARPS warps (the
// sort's kSortWarps): warp v takes the tile's items [v * kTileItems /
// WARPS, (v + 1) * kTileItems / WARPS), ROUNDS rounds of 32 in order, and
// ranks each among its earlier items of the same digit
// (`__match_any_sync`, a running count per warp and digit in shared
// memory); item j of a lane gets its pair, its digit (kBuckets past the
// end) and that rank, and warp_at[v][d] ends as warp v's count of digit d.
// Items then go to the tile's start for their digit plus the earlier
// warps' counts plus their rank: item order within the tile, so a pass is
// stable.  The caller syncs the block before reading warp_at.
template <int WARPS, class Keys, int ROUNDS = kTileItems / (WARPS * 32)>
__device__ __forceinline__ void rank_tile(
    const Keys& keys, const int2* __restrict__ pairs, int64_t n, int shift,
    int64_t tile, int2 (&item)[ROUNDS], int (&digit)[ROUNDS],
    int32_t (&rank)[ROUNDS], int32_t (*warp_at)[kBuckets]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = threadIdx.x; d < kBuckets; d += WARPS * 32) {
    for (int v = 0; v < WARPS; ++v) warp_at[v][d] = 0;
  }
  const unsigned below = (1u << lane) - 1u;
  const int64_t first = tile * kTileItems + warp * (kTileItems / WARPS);
  // every item loaded before any is ranked: ROUNDS loads in flight
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const int64_t i = first + j * 32 + lane;
    item[j] = i < n ? sort_item(keys, pairs, i) : make_int2(0, 0);
    digit[j] = i < n ? (item[j].x >> shift) & (kBuckets - 1) : kBuckets;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROUNDS; ++j) {
    const bool valid = digit[j] < kBuckets;
    const unsigned peers = __match_any_sync(kFullMask, digit[j]);
    const int32_t before = valid ? warp_at[warp][digit[j]] : 0;
    rank[j] = before + __popc(peers & below);
    __syncwarp();
    if (valid && (peers & below) == 0) {
      warp_at[warp][digit[j]] = before + __popc(peers);
    }
    __syncwarp();
  }
}

}  // namespace sgnn
