"""Immutable CSC whole-graph topology container (host side, numpy).

Reference: Graph<EdgeData> (core/graph.hpp:82) + FullyRepGraph
(core/FullyRepGraph.hpp:682) keep a CSC keyed by destination (column_offset /
row_indices, srcs in rows) plus the global in/out degree tables used by the
GCN symmetric normalisation (nts_norm_degree, core/ntsBaseOp.hpp:652).

The CSC is built by the native sampler library's counting sort
(sampler/native, `sgnn_csc_build`), bit-identical to a numpy stable argsort
by destination.
"""

from __future__ import annotations

import dataclasses

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

    def transpose(self) -> "Adjacency":
        """Out-neighbor view (CSR of the same edge set), as an Adjacency.

        Reference analog: Graph::transpose (core/graph.hpp:1115)."""
        dst_of_edge = np.repeat(
            np.arange(self.num_vertices, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64),
        )
        rev_edges = np.stack([dst_of_edge, self.indices], axis=1)
        return Adjacency.from_edges(rev_edges, self.num_vertices)

    def gcn_edge_weight(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """Symmetric normalisation 1/(sqrt(outdeg(src))*sqrt(indeg(dst))).

        Parity with nts_norm_degree (core/ntsBaseOp.hpp:652) using full-graph
        degrees (reference default, up_degree=false).
        """
        od = np.maximum(self.out_degree[src], 1).astype(np.float32)
        idg = np.maximum(self.in_degree[dst], 1).astype(np.float32)
        return 1.0 / (np.sqrt(od) * np.sqrt(idg))
