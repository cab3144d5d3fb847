"""Device-resident hot-vertex embedding cache with bounded-staleness weights.

The port of sgnn_tpu/cache/embedding_cache.py.  Reference (the NeutronOrch
core, GCN_SAMPLE_PD_CACHE.hpp): a CPU helper thread computes the bottom
GNN layer of the "hot" vertices once per super-batch — a full-neighborhood
aggregation over the global features (PushDownBatchOp,
ntsPushdownGraphOp.hpp:108, no gradient) followed by `y = X0·W` with a
weight snapshot popped from `shared_W_queue` (:818, one version per
super-batch: bounded staleness) — and the trainer splices those rows into
the layer-0 activations (load_share_embedding, ntsDataloador.hpp:938)
while the sampler omits the cached vertices' bottom-layer expansion.

The hot set, its full in-neighborhoods, their edge weights and the raw
features are all fixed after pre-sampling, so the PushDown aggregate
`agg[c] = Σ_{e∈row c} w_e·x[src_e]` is weight-independent and computed
ONCE per plan (`precompute_aggregate`): on the card by K2's forward
(`ops.segment.spmm_csr`) over a CSR whose rows are the cache slots and
whose columns are the hot vertices' CSC in-neighbours, in slot-major
order; from a host feature store by chunked numpy sums.  Each super-batch
refresh is then `cache_emb = agg @ W0` (`torch.matmul`, no gradient).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..graph.adjacency import Adjacency
from ..ops.segment import Csr, csr_from_numpy, spmm_csr, unique_inverse
from ..sampler.blocks import WeightKind

# edges of the hot CSR a K2 launch takes when the resident features are
# int8: the launch's unique source rows are converted to f32 (levels up to
# 127 are exact), at most this many rows of F f32 at once (158 MB at
# F = 602), where the whole matrix in f32 may not fit
INT8_AGG_EDGES = 1 << 16
# edges the host aggregate gathers at once: bounds its [chunk, F] f32 rows
HOST_AGG_EDGES = 1 << 19


class StalenessQueue:
    """Bounded-staleness weight versioning (reference shared_W_queue +
    cpu_version/gpu_version guards, NtsScheduler.hpp:696/:997-1029):
    depth 1, `push` publishes the trained W at a super-batch boundary and
    `get` returns the newest published version."""

    def __init__(self) -> None:
        self._w: Optional[torch.Tensor] = None
        self.version = -1

    def push(self, w: torch.Tensor) -> None:
        self._w = w.detach()
        self.version += 1

    def get(self):
        if self._w is None:
            raise RuntimeError("no W version published yet")
        return self._w, self.version


def hot_csr(adj: Adjacency, cache_ids: np.ndarray, weight_kind: WeightKind,
            mean_style: str = "hybrid"):
    """The hot set's full in-neighbourhoods as a host CSR: `(rowptr [C+1]
    int64, col [E] int32 source ids, w [E] f32)`, row c holding the CSC
    in-edges of `cache_ids[c]` in CSC order — the JAX package's slot-major
    COO without its padding.

    Weights as the JAX package's (`EmbeddingCache.build`), which must
    match the trainer's sampler: GCN 1/sqrt(outdeg·indeg); MEAN "hybrid"
    (the GCN weight over indeg, what the sampled-degree samplers converge
    to) or "plain" (1/indeg, the global-degree samplers' plain mean); GAT
    (WeightKind.NONE) the plain mean, as the reference's PD-cache engines
    reuse the plain PushDown op for GAT too."""
    ids = np.asarray(cache_ids, np.int64)
    starts = adj.indptr[ids]
    deg = (adj.indptr[ids + 1] - starts).astype(np.int64)
    rowptr = np.zeros(ids.size + 1, np.int64)
    np.cumsum(deg, out=rowptr[1:])
    # the edge ids of every row's CSC slice, vectorised
    eid = np.arange(int(rowptr[-1]), dtype=np.int64) + np.repeat(
        starts - rowptr[:-1], deg)
    col = adj.indices[eid].astype(np.int32)
    dstv = np.repeat(ids, deg)
    if weight_kind == WeightKind.GCN:
        w = adj.gcn_edge_weight(col, dstv)
    elif weight_kind == WeightKind.MEAN and mean_style == "hybrid":
        w = adj.gcn_edge_weight(col, dstv) / np.maximum(adj.in_degree[dstv],
                                                        1)
    else:   # plain mean, and GAT's pushdown
        w = 1.0 / np.maximum(adj.in_degree[dstv], 1).astype(np.float32)
    return rowptr, col, np.asarray(w, np.float32)


@dataclasses.dataclass
class EmbeddingCache:
    """A hot set's CSR, slot map and (after `precompute_aggregate` and
    `refresh`) its aggregate and cached layer-0 rows, on `device`."""

    cache_ids: np.ndarray          # [C] int32 global ids of hot vertices
    cache_map_host: np.ndarray     # [V] int32, slot or -1
    rowptr: np.ndarray             # [C+1] int64 (host CSR, `hot_csr`)
    col: np.ndarray                # [E] int32 source ids
    w: np.ndarray                  # [E] f32 edge weights
    cache_map: torch.Tensor        # [V] int32, the slot map on `device`
    device: torch.device
    cache_emb: Optional[torch.Tensor] = None   # [C, H] cached rows
    cache_agg: Optional[torch.Tensor] = None   # [C, F] f32 aggregate
    version: int = -1

    @property
    def num_cached(self) -> int:
        return int(self.cache_ids.shape[0])

    @staticmethod
    def build(adj: Adjacency, cache_ids: np.ndarray, weight_kind: WeightKind,
              mean_style: str = "hybrid", device=None) -> "EmbeddingCache":
        """The static full-neighbourhood CSR of the hot set (`hot_csr`)
        and its slot map, on `device` (None means CUDA)."""
        dev = resolve_device(device)
        ids = np.asarray(cache_ids, np.int32)
        cache_map = np.full(adj.num_vertices, -1, dtype=np.int32)
        cache_map[ids] = np.arange(ids.size, dtype=np.int32)
        rowptr, col, w = hot_csr(adj, ids, weight_kind, mean_style)
        return EmbeddingCache(cache_ids=ids, cache_map_host=cache_map,
                              rowptr=rowptr, col=col, w=w,
                              cache_map=torch.from_numpy(cache_map).to(dev),
                              device=dev)

    def precompute_aggregate(self, features, feat_scale=None) -> None:
        """The one-time weight-independent PushDown aggregate, f32 [C, F]
        on the cache's device.

        `features` is a device tensor (resident features: K2's forward
        over the hot CSR; int8 levels go through `_int8_aggregate`) or a
        host numpy array (beyond device memory: `_host_aggregate`, the
        reference CPU helper's role).  `feat_scale` ([F] per-column
        scales, a tensor or an array) marks int8 storage
        (FEATURE_DTYPE:int8): per-column dequantization commutes with the
        row sum, so the scale multiplies the [C, F] aggregate once."""
        if isinstance(features, np.ndarray):
            agg = torch.from_numpy(self._host_aggregate(features))
        elif features.dtype == torch.int8:
            agg = self._int8_aggregate(features)
        else:
            csr = csr_from_numpy(self.rowptr, self.col, self.w,
                                 features.shape[0], features.device)
            agg = spmm_csr(features, *csr).float()
        agg = agg.to(self.device)
        if feat_scale is not None:
            agg = agg * torch.as_tensor(feat_scale, dtype=torch.float32,
                                        device=self.device)[None, :]
        self.cache_agg = agg

    def _int8_aggregate(self, features: torch.Tensor) -> torch.Tensor:
        """K2 over int8 levels without an f32 copy of the matrix: the hot
        CSR in row blocks of about INT8_AGG_EDGES edges, each block's
        unique source rows gathered and converted to f32 (exact), its
        columns remapped to them (as chunked `layerwise_inference`)."""
        out = []
        c = self.num_cached
        a = 0
        while a < c:
            # the rows [a, b) whose edges fit the block (one row at least)
            b = max(int(np.searchsorted(
                self.rowptr, self.rowptr[a] + INT8_AGG_EDGES, "right")) - 1,
                a + 1)
            b = min(b, c)
            lo, hi = int(self.rowptr[a]), int(self.rowptr[b])
            uniq, inv = unique_inverse(self.col[lo:hi])
            rows = features.index_select(0, torch.from_numpy(uniq).to(
                features.device).long()).float()
            csr: Csr = csr_from_numpy(self.rowptr[a:b + 1] - lo, inv,
                                      self.w[lo:hi], uniq.size,
                                      features.device)
            out.append(spmm_csr(rows, *csr))
            a = b
        if not out:
            return torch.zeros((0, features.shape[1]), dtype=torch.float32,
                               device=features.device)
        return torch.cat(out)

    def _host_aggregate(self, features: np.ndarray) -> np.ndarray:
        """agg[c] = Σ w·features[src] over the slot-major host CSR, in
        f32, HOST_AGG_EDGES edges at a time: each chunk's rows gathered by
        the native sampler's threaded `gather_rows`, weighted, and summed by
        a reduceat over its contiguous runs of one slot (the JAX package's
        `_host_aggregate`, unpadded: the same sums)."""
        from ..sampler.native import gather_rows

        slot = np.repeat(np.arange(self.num_cached, dtype=np.int32),
                         np.diff(self.rowptr))
        agg = np.zeros((self.num_cached, features.shape[1]), np.float32)
        for a in range(0, self.col.size, HOST_AGG_EDGES):
            b = min(a + HOST_AGG_EDGES, self.col.size)
            rows = gather_rows(features, self.col[a:b]).astype(np.float32,
                                                                copy=False)
            rows *= self.w[a:b, None]
            s = slot[a:b]
            starts = np.concatenate(
                [[0], np.flatnonzero(np.diff(s)) + 1]).astype(np.int64)
            agg[s[starts]] += np.add.reduceat(rows, starts, axis=0)
        return agg

    @torch.no_grad()
    def refresh(self, w0: torch.Tensor, version: int) -> None:
        """Super-batch refresh: cache_emb = agg @ W0 in f32, no gradient.
        Bounded staleness lies in WHEN the caller snapshots w0 (super-batch
        boundaries), not here."""
        if self.cache_agg is None:
            raise RuntimeError("call precompute_aggregate() first")
        self.cache_emb = refresh_rows(self.cache_agg, w0)
        self.version = version


@torch.no_grad()
def refresh_rows(agg: torch.Tensor, w0: torch.Tensor) -> torch.Tensor:
    """`agg @ W0` in f32 with no gradient: the refresh's one product."""
    return torch.matmul(agg.float(), w0.detach().float())
