"""ctypes bindings of the native sampler (the port's copy of
sgnn_tpu/sampler/native/bindings.py): drive `sampler.cpp` and hand its hops
to the host sampler's shared finalizer, so numpy and native paths pad and
order blocks the same way."""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .build import load_library


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class _Workspace:
    """Per-sampler reusable buffers (bitmap, lookup, srcs)."""

    def __init__(self, num_vertices: int) -> None:
        self.bitmap = np.zeros(((num_vertices + 63) // 64,), dtype=np.uint64)
        self.lookup = np.zeros(num_vertices, dtype=np.int32)
        self.srcs = np.zeros(num_vertices, dtype=np.int32)


def sample_batch(sampler, batch_seeds: np.ndarray,
                 omit_map: Optional[np.ndarray] = None):
    """Native analogue of HostSampler._sample_numpy (same hop-dict
    contract).  Each hop takes one 63-bit seed from `sampler.rng`, and the
    C++ side keys its counter-based RNG by (that seed, destination id), so
    the draws do not depend on the thread count.  `omit_map` ([V] int32)
    goes to the bottom hop: the C++ side leaves destinations with a slot
    unexpanded."""
    lib = load_library()
    adj = sampler.adj
    if getattr(sampler, "_native_ws", None) is None:
        sampler._native_ws = _Workspace(adj.num_vertices)
    ws: _Workspace = sampler._native_ws
    indptr = np.ascontiguousarray(adj.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj.indices, dtype=np.int32)
    omit = None
    if omit_map is not None:
        omit = np.ascontiguousarray(omit_map, dtype=np.int32)
        if omit.shape != (adj.num_vertices,):
            raise ValueError(f"omit_map must be [{adj.num_vertices}], got "
                             f"{omit.shape}")
    hops = []
    seeds = np.ascontiguousarray(batch_seeds, dtype=np.int32)
    nseed = seeds.shape[0]
    last = len(sampler.plans) - 1
    for h, plan in enumerate(sampler.plans):
        if plan.fanout > 1024:
            raise ValueError("the native sampler takes fanout <= 1024")
        n = seeds.shape[0]
        nbr_global = np.empty((n, plan.fanout), dtype=np.int32)
        valid_u8 = np.empty((n, plan.fanout), dtype=np.uint8)
        ws.bitmap[:] = 0
        lib.sgnn_sample_hop(
            _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
            adj.num_vertices, _ptr(seeds, ctypes.c_int32), n, plan.fanout,
            _ptr(omit, ctypes.c_int32) if omit is not None and h == last
            else None,
            np.uint64(sampler.rng.integers(0, 2**63, dtype=np.int64)),
            _ptr(nbr_global, ctypes.c_int32), _ptr(valid_u8, ctypes.c_uint8),
            _ptr(ws.bitmap, ctypes.c_uint64),
        )
        # srcs = sampled neighbors ∪ seeds (sorted unique via bitmap scan)
        lib.sgnn_bitmap_add(_ptr(ws.bitmap, ctypes.c_uint64),
                            _ptr(seeds, ctypes.c_int32), n)
        n_src = lib.sgnn_collect_srcs(
            _ptr(ws.bitmap, ctypes.c_uint64), adj.num_vertices,
            _ptr(ws.srcs, ctypes.c_int32), _ptr(ws.lookup, ctypes.c_int32))
        srcs = ws.srcs[:n_src].copy()
        nbr_local = np.empty_like(nbr_global)
        lib.sgnn_reindex(
            _ptr(nbr_global, ctypes.c_int32), _ptr(valid_u8, ctypes.c_uint8),
            nbr_global.size, _ptr(ws.lookup, ctypes.c_int32),
            _ptr(nbr_local, ctypes.c_int32))
        valid = valid_u8.astype(bool)
        weight = _native_weights(sampler, lib, nbr_local, valid_u8, seeds,
                                 srcs, plan.fanout)
        hops.append(dict(
            seeds=seeds, nbr_global=np.where(valid, nbr_global, -1),
            nbr_local=nbr_local, valid=valid, srcs=srcs,
            seed_in_src=ws.lookup[seeds], plan=plan, weight=weight))
        seeds = srcs
    return sampler._finalize(hops, nseed)


def gather_rows(features: np.ndarray, idx: np.ndarray,
                valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Parallel host row gather: out[i] = features[idx[i]], zeroed where
    ~valid (OpenMP memcpy per row; numpy's fancy indexing does the same
    copies on one thread)."""
    features = np.ascontiguousarray(features)
    n = int(idx.shape[0])
    out = np.empty((n, features.shape[1]), features.dtype)
    idx32 = np.ascontiguousarray(np.maximum(idx, 0), dtype=np.int32)
    if n and (int(idx32.max()) >= features.shape[0]):
        raise ValueError(f"row id out of range [0, {features.shape[0]})")
    v8 = None if valid is None else np.ascontiguousarray(valid, np.uint8)
    load_library().sgnn_gather_rows(
        features.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        features.shape[1] * features.itemsize, _ptr(idx32, ctypes.c_int32),
        n, _ptr(v8, ctypes.c_uint8) if v8 is not None else None,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def build_csc(edges: np.ndarray, num_vertices: int):
    """Stable CSC build (counting sort by dst), bit-identical to the
    `np.argsort(dst, kind="stable")` assembly but O(E) and parallel.
    Returns (indptr[V+1] i64, indices[E] i32, out_degree[V] i32)."""
    e = np.ascontiguousarray(edges, dtype=np.int32)
    n_edges = int(e.shape[0])
    if n_edges and (e.max() >= num_vertices or e.min() < 0):
        raise ValueError(f"edge endpoint out of range [0, {num_vertices})")
    indptr = np.empty(num_vertices + 1, dtype=np.int64)
    indices = np.empty(n_edges, dtype=np.int32)
    out_degree = np.empty(num_vertices, dtype=np.int32)
    load_library().sgnn_csc_build(
        _ptr(e, ctypes.c_int32), n_edges, num_vertices,
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(out_degree, ctypes.c_int32))
    return indptr, indices, out_degree



def stable_argsort(keys: np.ndarray, key_range: int) -> np.ndarray:
    """Stable argsort of int32 keys in [0, key_range): an OpenMP counting
    sort, [n] int32, bit-identical to `np.argsort(keys, kind="stable")`
    (the transposed CSR of a whole-graph build, ops/segment.csr_transpose).
    A key outside the range raises ValueError."""
    k = np.ascontiguousarray(keys, dtype=np.int32)
    n = int(k.shape[0])
    if n and (int(k.max()) >= key_range or int(k.min()) < 0):
        raise ValueError(f"key out of range [0, {key_range})")
    perm = np.empty(n, dtype=np.int32)
    load_library().sgnn_stable_argsort(_ptr(k, ctypes.c_int32), n, key_range,
                                       _ptr(perm, ctypes.c_int32))
    return perm


def transpose_csc(indptr: np.ndarray, indices: np.ndarray,
                  num_vertices: int):
    """The CSC keyed by source: (indptr_t [V+1] int64, indices_t [E] int32
    destinations), bit-identical to `build_csc` over the reversed edge
    list, which it never materialises."""
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int32)
    n_edges = int(ix.shape[0])
    if ip.shape != (num_vertices + 1,) or (n_edges and int(ip[-1]) != n_edges):
        raise ValueError(f"indptr must be [{num_vertices + 1}] ending at "
                         f"{n_edges}")
    if n_edges and (int(ix.max()) >= num_vertices or int(ix.min()) < 0):
        raise ValueError(f"source id out of range [0, {num_vertices})")
    indptr_t = np.empty(num_vertices + 1, dtype=np.int64)
    indices_t = np.empty(n_edges, dtype=np.int32)
    load_library().sgnn_csc_transpose(
        _ptr(ip, ctypes.c_int64), _ptr(ix, ctypes.c_int32), num_vertices,
        n_edges, _ptr(indptr_t, ctypes.c_int64),
        _ptr(indices_t, ctypes.c_int32))
    return indptr_t, indices_t

_MODE = {  # (WeightKind.value, degree_mode) → sgnn_weights mode enum
    ("gcn", "sampled"): 0,
    ("mean", "sampled"): 1,
    ("gcn", "global"): 2,
    ("mean", "global"): 3,
}


def _native_weights(sampler, lib, nbr_local, valid_u8, seeds, srcs, fanout):
    mode = _MODE.get((sampler.weight_kind.value, sampler.degree_mode), 4)
    weight = np.empty((seeds.shape[0], fanout), dtype=np.float32)
    adj = sampler.adj
    out_deg = np.ascontiguousarray(adj.out_degree, dtype=np.int32)
    in_deg = np.ascontiguousarray(adj.in_degree, dtype=np.int32)
    lib.sgnn_weights(
        _ptr(nbr_local, ctypes.c_int32), _ptr(valid_u8, ctypes.c_uint8),
        seeds.shape[0], fanout, srcs.shape[0],
        _ptr(out_deg, ctypes.c_int32), _ptr(in_deg, ctypes.c_int32),
        _ptr(srcs, ctypes.c_int32), _ptr(seeds, ctypes.c_int32), mode,
        _ptr(weight, ctypes.c_float))
    return weight
