"""Immutable CSC whole-graph topology container (host side, numpy).

Reference: Graph<EdgeData> (core/graph.hpp:82) + FullyRepGraph
(core/FullyRepGraph.hpp:682) keep a CSC keyed by destination (column_offset /
row_indices, srcs in rows) plus the global in/out degree tables used by the
GCN symmetric normalisation (nts_norm_degree, core/ntsBaseOp.hpp:652).

The CSC is built by the native sampler library's counting sort
(sampler/native, `sgnn_csc_build`), bit-identical to a numpy stable argsort
by destination, and transposed by its one-pass `sgnn_csc_transpose`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Adjacency:
    """In-neighbor CSC: for vertex v, srcs are indices[indptr[v]:indptr[v+1]]."""

    num_vertices: int
    indptr: np.ndarray       # [V+1] int64, CSC column offsets (keyed by dst)
    indices: np.ndarray      # [E]   int32, source vertex ids
    in_degree: np.ndarray    # [V]   int32 (full-graph, = indptr diffs)
    out_degree: np.ndarray   # [V]   int32 (full-graph)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @staticmethod
    def from_edges(edges: np.ndarray, num_vertices: int) -> "Adjacency":
        """Build from a COO [E, 2] (src, dst) edge list. Stable edge order."""
        from ..sampler.native import build_csc

        indptr, indices, out_degree = build_csc(
            np.asarray(edges).reshape(-1, 2), num_vertices)
        return Adjacency(
            num_vertices=num_vertices,
            indptr=indptr,
            indices=indices,
            in_degree=np.diff(indptr).astype(np.int32),
            out_degree=out_degree,
        )

    def neighbors(self, v: int) -> np.ndarray:
        """The in-neighbors (sources) of vertex v."""
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def transpose(self) -> "Adjacency":
        """Out-neighbor view (CSR of the same edge set), as an Adjacency.

        Reference analog: Graph::transpose / generate_backward_structure
        (core/graph.hpp:1115/:4332).  The native one-pass transpose
        (`sgnn_csc_transpose`) materialises no reversed [E, 2] edge list,
        and the degree tables swap roles, so nothing is recounted; the
        result is bit-identical to `from_edges` over the reversed edges."""
        from ..sampler.native import transpose_csc

        indptr_t, indices_t = transpose_csc(self.indptr, self.indices,
                                            self.num_vertices)
        return Adjacency(
            num_vertices=self.num_vertices,
            indptr=indptr_t,
            indices=indices_t,
            in_degree=self.out_degree,
            out_degree=self.in_degree,
        )

    def gcn_edge_weight(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Symmetric normalisation 1/(sqrt(outdeg(src))*sqrt(indeg(dst))).

        Parity with nts_norm_degree (core/ntsBaseOp.hpp:652) using full-graph
        degrees (reference default, up_degree=false).
        """
        od = np.maximum(self.out_degree[src], 1).astype(np.float32)
        idg = np.maximum(self.in_degree[dst], 1).astype(np.float32)
        return 1.0 / (np.sqrt(od) * np.sqrt(idg))

    def to_padded_device_csc(
        self, pad_to_multiple: int = 128
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(indptr, indices) padded to a multiple of `pad_to_multiple`:
        indptr with its last offset, indices with 0 (the JAX package's
        export for static shapes, kept for its callers)."""
        def pad(a, fill):
            n = a.shape[0]
            m = (n + pad_to_multiple - 1) // pad_to_multiple * pad_to_multiple
            if m == n:
                return a
            return np.concatenate([a, np.full(m - n, fill, dtype=a.dtype)])

        return pad(self.indptr, self.indptr[-1]), pad(self.indices, 0)
