// Native host sampler: fanout neighbor sampling over a CSC graph.
//
// Plays the role of the reference's C++ FastSampler hop loop
// (core/ntsFastSampler.hpp:962 sample_fast): per-destination
// without-replacement draw of edge positions, bitmap dedup of sources,
// local reindexing — OpenMP-parallel, exposed through a C ABI consumed via
// ctypes (sgnn_tpu_torch/sampler/native/bindings.py).  The PyTorch port's own
// copy of sgnn_tpu/sampler/native/sampler.cpp.
//
// Differences from the reference (deliberate):
//  - exact without-replacement uses Floyd's algorithm instead of the
//    rejection loop (ntsFastSampler.hpp:1028-1040) — same distribution,
//    bounded work per row;
//  - RNG is a counter-based splitmix64 keyed by (seed, destination id), so
//    results are deterministic regardless of thread count/schedule.

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed) {}
  inline uint64_t next() {
    state = splitmix64(state);
    return state;
  }
  // uniform int in [0, n)
  inline uint32_t below(uint32_t n) {
    return static_cast<uint32_t>((next() >> 11) % n);
  }
};

}  // namespace

extern "C" {

// Sample one hop. Outputs nbr_global[n_seeds*fanout] (-1 for invalid slots)
// and valid[n_seeds*fanout]. Also sets bits in `bitmap` (size
// ceil(num_vertices/64) words, caller-zeroed) for every sampled source.
// If omit_map != nullptr, destinations with omit_map[dst] >= 0 are skipped
// (cache-omitting sampling, reference sample_gpu_fast_omit).
void sgnn_sample_hop(const int64_t* indptr, const int32_t* indices,
                     int64_t num_vertices, const int32_t* seeds,
                     int64_t n_seeds, int32_t fanout,
                     const int32_t* omit_map, uint64_t seed,
                     int32_t* nbr_global, uint8_t* valid,
                     uint64_t* bitmap) {
  const int64_t words = (num_vertices + 63) >> 6;
#if defined(_OPENMP)
  const int nthreads = omp_get_max_threads();
#else
  const int nthreads = 1;
#endif
  // Thread-local bitmaps merged after the loop: atomics on shared words are
  // pathological on power-law graphs (every thread hammers the hub words).
  uint64_t* local = new uint64_t[(size_t)words * nthreads]();
#pragma omp parallel
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    uint64_t* bm = local + (size_t)words * tid;
#pragma omp for schedule(dynamic, 64)
    for (int64_t i = 0; i < n_seeds; ++i) {
      const int32_t dst = seeds[i];
      int32_t* out = nbr_global + i * fanout;
      uint8_t* val = valid + i * fanout;
      for (int32_t k = 0; k < fanout; ++k) {
        out[k] = -1;
        val[k] = 0;
      }
      if (omit_map != nullptr && omit_map[dst] >= 0) continue;
      const int64_t start = indptr[dst];
      const int64_t deg64 = indptr[dst + 1] - start;
      if (deg64 <= 0) continue;
      const uint32_t deg = static_cast<uint32_t>(deg64);
      if (deg <= static_cast<uint32_t>(fanout)) {
        // take-all branch (reference ntsFastSampler.hpp:1041-1049)
        for (uint32_t k = 0; k < deg; ++k) {
          const int32_t src = indices[start + k];
          out[k] = src;
          val[k] = 1;
          bm[src >> 6] |= (1ULL << (src & 63));
        }
        continue;
      }
      // Floyd's algorithm: `fanout` distinct uniform draws from [0, deg)
      const uint32_t take = static_cast<uint32_t>(fanout);
      int64_t picked[1024];  // fanout bound (checked in bindings)
      Rng rng(
          splitmix64(seed ^ (0x517CC1B727220A95ULL * (uint64_t)(dst + 1))));
      uint32_t count = 0;
      for (uint32_t j = deg - take; j < deg; ++j) {
        uint32_t t = rng.below(j + 1);
        bool dup = false;
        for (uint32_t c = 0; c < count; ++c) {
          if (picked[c] == t) {
            dup = true;
            break;
          }
        }
        picked[count++] = dup ? j : t;
      }
      for (uint32_t k = 0; k < take; ++k) {
        const int32_t src = indices[start + picked[k]];
        out[k] = src;
        val[k] = 1;
        bm[src >> 6] |= (1ULL << (src & 63));
      }
    }
    // merge: each thread ORs a disjoint word range from all locals
#pragma omp for schedule(static)
    for (int64_t w = 0; w < words; ++w) {
      uint64_t acc = bitmap[w];
      for (int t = 0; t < nthreads; ++t) {
        acc |= local[(size_t)words * t + w];
      }
      bitmap[w] = acc;
    }
  }
  delete[] local;
}

// Add ids (e.g. the seed set) into the bitmap.
void sgnn_bitmap_add(uint64_t* bitmap, const int32_t* ids, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t v = ids[i];
    bitmap[v >> 6] |= (1ULL << (v & 63));
  }
}

// Collect set bits in ascending order into srcs_out and build the V-sized
// local-reindex lookup (reference src_index_array, ntsFastSampler.hpp:1075).
// Returns the number of sources.
int64_t sgnn_collect_srcs(const uint64_t* bitmap, int64_t num_vertices,
                          int32_t* srcs_out, int32_t* lookup) {
  int64_t n = 0;
  const int64_t words = (num_vertices + 63) >> 6;
  for (int64_t w = 0; w < words; ++w) {
    uint64_t word = bitmap[w];
    while (word) {
      const int bit = __builtin_ctzll(word);
      const int64_t v = (w << 6) + bit;
      srcs_out[n] = static_cast<int32_t>(v);
      lookup[v] = static_cast<int32_t>(n);
      ++n;
      word &= word - 1;
    }
  }
  return n;
}

// Map sampled global neighbor ids to local src indices in one pass.
void sgnn_reindex(const int32_t* nbr_global, const uint8_t* valid,
                  int64_t n_slots, const int32_t* lookup,
                  int32_t* nbr_local) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_slots; ++i) {
    nbr_local[i] = valid[i] ? lookup[nbr_global[i]] : 0;
  }
}

// Edge-weight computation, fused single pass (reference GetWeight /
// GetMeanWeight kernels, cuda/ntsCUDATransferKernel.cuh:294-341, and the CPU
// WeightCompute path, core/coocsc.hpp:301).
//   mode 0: GCN, sampled degrees   w = 1/(√out_s(src)·√in_s(dst))
//   mode 1: MEAN, sampled degrees  w = gcn_w / edges_num(dst)
//   mode 2: GCN, global degrees
//   mode 3: MEAN, global degrees   w = 1/edges_num(dst)  — plain mean.
//           Deliberate deviation: the reference's global-degree mean
//           hybrids (GPU gcn_norm/edges_num ntsCUDATransferKernel.cuh:319,
//           CPU gcn_norm/global_in_deg ntsFastSampler.hpp:1117) collapse
//           on high-degree graphs (measured, docs/PERF.md); plain mean is
//           the standard GraphSAGE aggregator.
//   mode 4: NONE                   w = 1 on valid edges
void sgnn_weights(const int32_t* nbr_local, const uint8_t* valid,
                  int64_t n_dst, int32_t fanout, int64_t n_src,
                  const int32_t* global_out_deg, const int32_t* global_in_deg,
                  const int32_t* srcs, const int32_t* seeds, int32_t mode,
                  float* weight) {
#if defined(_OPENMP)
  const int nthreads = omp_get_max_threads();
#else
  const int nthreads = 1;
#endif
  int32_t* out_counts = nullptr;
  if (mode == 0 || mode == 1) {
    // sampled out-degree of each local src (thread-local + merge)
    int32_t* local = new int32_t[(size_t)n_src * nthreads]();
#pragma omp parallel
    {
#if defined(_OPENMP)
      const int tid = omp_get_thread_num();
#else
      const int tid = 0;
#endif
      int32_t* cnt = local + (size_t)n_src * tid;
#pragma omp for schedule(static)
      for (int64_t i = 0; i < n_dst * fanout; ++i) {
        if (valid[i]) cnt[nbr_local[i]] += 1;
      }
    }
    out_counts = new int32_t[n_src];
#pragma omp parallel for schedule(static)
    for (int64_t s = 0; s < n_src; ++s) {
      int32_t acc = 0;
      for (int t = 0; t < nthreads; ++t) acc += local[(size_t)n_src * t + s];
      out_counts[s] = acc;
    }
    delete[] local;
  }
#pragma omp parallel for schedule(static)
  for (int64_t d = 0; d < n_dst; ++d) {
    const int64_t base = d * fanout;
    int32_t edges_num = 0;
    for (int32_t k = 0; k < fanout; ++k) edges_num += valid[base + k];
    float in_term;
    if (mode == 0 || mode == 1) {
      const int32_t samp_in = edges_num > 0 ? edges_num : fanout;
      in_term = 1.0f / __builtin_sqrtf((float)samp_in);
    } else {
      int32_t gid = global_in_deg[seeds[d]];
      in_term = 1.0f / __builtin_sqrtf((float)(gid > 0 ? gid : 1));
    }
    const float mean_div =
        (mode == 1 || mode == 3)
            ? 1.0f / (float)(edges_num > 0 ? edges_num : 1)
            : 1.0f;
    for (int32_t k = 0; k < fanout; ++k) {
      const int64_t e = base + k;
      if (!valid[e]) {
        weight[e] = 0.0f;
        continue;
      }
      if (mode == 4) {
        weight[e] = 1.0f;
        continue;
      }
      if (mode == 3) {  // plain mean, no degree terms
        weight[e] = mean_div;
        continue;
      }
      int32_t od;
      if (mode == 0 || mode == 1) {
        od = out_counts[nbr_local[e]];
      } else {
        od = global_out_deg[srcs[nbr_local[e]]];
      }
      if (od <= 0) od = 1;
      weight[e] = in_term * mean_div / __builtin_sqrtf((float)od);
    }
  }
  delete[] out_counts;
}

// Stable parallel argsort of int32 keys in [0, key_range): the same
// per-(thread, key) cursor counting sort as sgnn_csc_build below, with the
// payload being each element's position.  Output is bit-identical to
// numpy's argsort(keys, kind="stable").  Used for the static CSR-order
// permutations that let whole-graph SpMM backward scatters run as sorted
// segment sums (reference csc_to_csr, core/coocsc.hpp:82).
void sgnn_stable_argsort(const int32_t* keys, int64_t n, int64_t key_range,
                         int32_t* perm) {
#if defined(_OPENMP)
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  const int64_t budget = (int64_t)256 << 20;
  while (nthreads > 1 &&
         (int64_t)nthreads * key_range * (int64_t)sizeof(int64_t) > budget)
    --nthreads;
  int64_t* cursor = new int64_t[(size_t)key_range * nthreads]();
  const int64_t chunk = (n + nthreads - 1) / nthreads;
#pragma omp parallel num_threads(nthreads)
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    int64_t* cnt = cursor + (size_t)key_range * tid;
    const int64_t lo = tid * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    for (int64_t e = lo; e < hi; ++e) cnt[keys[e]] += 1;
#pragma omp barrier
#pragma omp single
    {
      int64_t run = 0;
      for (int64_t k = 0; k < key_range; ++k) {
        for (int t = 0; t < nthreads; ++t) {
          int64_t* c = cursor + (size_t)key_range * t + k;
          const int64_t cn = *c;
          *c = run;
          run += cn;
        }
      }
    }  // implicit barrier
    for (int64_t e = lo; e < hi; ++e) {
      perm[cnt[keys[e]]++] = static_cast<int32_t>(e);
    }
  }
  delete[] cursor;
}

// Stable parallel CSC build from an interleaved COO edge list
// (src = edges[2e], dst = edges[2e+1]).  Plays the role of the reference's
// graph-builder CSC construction (Graph::load_directed per-socket CSC
// assembly, core/graph.hpp:1129; FullyRepGraph::ReadRepGraphFromRawFile,
// core/FullyRepGraph.hpp:724), which also counting-sorts edges by
// destination.  Replaces numpy's argsort(dst, kind="stable") + fancy-index
// (O(E log E), single-threaded) with an O(E) two-pass counting sort whose
// per-(thread, vertex) write cursors keep the original edge order within
// each destination — bit-identical to the stable argsort result.
// Also emits out_degree (bincount of src) in the same parallel region.
void sgnn_csc_build(const int32_t* edges, int64_t n_edges,
                    int64_t num_vertices, int64_t* indptr, int32_t* indices,
                    int32_t* out_degree) {
#if defined(_OPENMP)
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  // Bound the [T, V] cursor matrix at ~256 MB.
  const int64_t budget = (int64_t)256 << 20;
  while (nthreads > 1 &&
         (int64_t)nthreads * num_vertices * (int64_t)sizeof(int64_t) > budget)
    --nthreads;
  int64_t* cursor = new int64_t[(size_t)num_vertices * nthreads]();
  const int64_t chunk = (n_edges + nthreads - 1) / nthreads;
#pragma omp parallel num_threads(nthreads)
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    int64_t* cnt = cursor + (size_t)num_vertices * tid;
    const int64_t lo = tid * chunk;
    const int64_t hi = lo + chunk < n_edges ? lo + chunk : n_edges;
    // pass 1: per-thread destination histogram over its contiguous chunk
    for (int64_t e = lo; e < hi; ++e) cnt[edges[2 * e + 1]] += 1;
#pragma omp barrier
    // serial prefix sum over (vertex, thread) turns histograms into
    // absolute write cursors; thread order within a vertex = stability
#pragma omp single
    {
      int64_t run = 0;
      indptr[0] = 0;
      for (int64_t v = 0; v < num_vertices; ++v) {
        for (int t = 0; t < nthreads; ++t) {
          int64_t* c = cursor + (size_t)num_vertices * t + v;
          const int64_t n = *c;
          *c = run;
          run += n;
        }
        indptr[v + 1] = run;
      }
    }  // implicit barrier
    // pass 2: stable scatter (chunks are in edge order; cursors ordered
    // by thread id, so original order is preserved within each dst)
    for (int64_t e = lo; e < hi; ++e) {
      indices[cnt[edges[2 * e + 1]]++] = edges[2 * e];
    }
#pragma omp barrier
    // pass 3: source histogram (out-degree), reusing the cursor rows
    memset(cnt, 0, (size_t)num_vertices * sizeof(int64_t));
    for (int64_t e = lo; e < hi; ++e) cnt[edges[2 * e]] += 1;
#pragma omp barrier
#pragma omp for schedule(static)
    for (int64_t v = 0; v < num_vertices; ++v) {
      int64_t acc = 0;
      for (int t = 0; t < nthreads; ++t)
        acc += cursor[(size_t)num_vertices * t + v];
      out_degree[v] = static_cast<int32_t>(acc);
    }
  }
  delete[] cursor;
}

// Transpose a CSC in place of the reversed-edge-list rebuild (reference
// Graph::transpose / generate_backward_structure, core/graph.hpp:1115/:4332).
// Same stable counting-sort scheme as sgnn_csc_build, keyed by the source
// ids (indices); the payload — each edge's destination column — is derived
// by walking indptr alongside the edge chunk, so the [E, 2] reversed edge
// list is never materialised.  Output is bit-identical to
// sgnn_csc_build(stack([dst_of_edge, indices]), ...).
void sgnn_csc_transpose(const int64_t* indptr, const int32_t* indices,
                        int64_t num_vertices, int64_t n_edges,
                        int64_t* indptr_t, int32_t* indices_t) {
#if defined(_OPENMP)
  int nthreads = omp_get_max_threads();
#else
  int nthreads = 1;
#endif
  const int64_t budget = (int64_t)256 << 20;
  while (nthreads > 1 &&
         (int64_t)nthreads * num_vertices * (int64_t)sizeof(int64_t) > budget)
    --nthreads;
  int64_t* cursor = new int64_t[(size_t)num_vertices * nthreads]();
  const int64_t chunk = (n_edges + nthreads - 1) / nthreads;
#pragma omp parallel num_threads(nthreads)
  {
#if defined(_OPENMP)
    const int tid = omp_get_thread_num();
#else
    const int tid = 0;
#endif
    int64_t* cnt = cursor + (size_t)num_vertices * tid;
    const int64_t lo = tid * chunk;
    const int64_t hi = lo + chunk < n_edges ? lo + chunk : n_edges;
    for (int64_t e = lo; e < hi; ++e) cnt[indices[e]] += 1;
#pragma omp barrier
#pragma omp single
    {
      int64_t run = 0;
      indptr_t[0] = 0;
      for (int64_t v = 0; v < num_vertices; ++v) {
        for (int t = 0; t < nthreads; ++t) {
          int64_t* c = cursor + (size_t)num_vertices * t + v;
          const int64_t n = *c;
          *c = run;
          run += n;
        }
        indptr_t[v + 1] = run;
      }
    }  // implicit barrier
    if (lo < hi) {
      // column owning edge `lo`: largest d with indptr[d] <= lo
      int64_t d_lo = 0, d_hi = num_vertices;  // invariant: indptr[d_lo]<=lo
      while (d_lo < d_hi) {
        const int64_t mid = d_lo + (d_hi - d_lo + 1) / 2;
        if (indptr[mid] <= lo) d_lo = mid; else d_hi = mid - 1;
      }
      int64_t d = d_lo;
      for (int64_t e = lo; e < hi; ++e) {
        while (indptr[d + 1] <= e) ++d;
        indices_t[cnt[indices[e]]++] = static_cast<int32_t>(d);
      }
    }
  }
  delete[] cursor;
}

int sgnn_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Parallel feature-row gather: out[i] = base[idx[i]] (row_bytes each), rows
// with valid[i]==0 zeroed.  Plays the role of the reference's pinned-host
// feature assembly (load_feature_gpu, ntsFastSampler.hpp:227): the reference
// memcpy-packs sampled rows into a pinned staging block on the CPU before
// the H2D copy; numpy's fancy indexing does the same copy single-threaded.
void sgnn_gather_rows(const uint8_t* base, int64_t row_bytes,
                      const int32_t* idx, int64_t n, const uint8_t* valid,
                      uint8_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    uint8_t* dst = out + i * row_bytes;
    if (valid != nullptr && valid[i] == 0) {
      memset(dst, 0, (size_t)row_bytes);
    } else {
      memcpy(dst, base + (int64_t)idx[i] * row_bytes, (size_t)row_bytes);
    }
  }
}

}  // extern "C"
