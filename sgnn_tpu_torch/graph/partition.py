"""Vertex-range graph partitioning for whole-graph training over ranks.

The port's numpy copy of sgnn_tpu/graph/partition.py (bit-identical
output).  Reference: Gemini-style chunked, degree-balanced vertex-range
partitioning across MPI ranks (Graph::load_directed partition_offset
balancing, core/graph.hpp:694-751; tune_chunks :1837), with master/mirror
halo sets computed per partition (PartitionedGraph::DetermineMirror,
core/PartitionedGraph.hpp).

Here partitions map to the ranks of a `torch.distributed` graph group; the
halo exchange is an all_gather or an all_to_all of the group
(parallel/halo.py).  The partitioner itself is plain host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .adjacency import Adjacency


def degree_balanced_ranges(
    degrees: np.ndarray, num_parts: int, alpha: float = 8.0
) -> np.ndarray:
    """Split [0, V) into contiguous ranges with balanced alpha*V + E weight.

    Same cost model as the reference's owned-vertices balancing
    (core/graph.hpp:697: amount = alpha * |V_chunk| + |E_chunk|).
    Returns offsets array of shape [num_parts+1].
    """
    v = degrees.shape[0]
    w = degrees.astype(np.float64) + alpha
    cw = np.concatenate([[0.0], np.cumsum(w)])
    total = cw[-1]
    offsets = np.zeros(num_parts + 1, dtype=np.int64)
    for p in range(1, num_parts):
        offsets[p] = np.searchsorted(cw, total * p / num_parts)
    offsets[num_parts] = v
    return offsets


@dataclasses.dataclass(frozen=True)
class Partition:
    """One vertex-range partition with its halo (mirror) vertex set.

    `owned` vertices [start, end) are masters here; `halo` lists remote
    vertices whose features this partition needs for in-edge aggregation
    (the reference's mirror set, PartitionedGraph::DetermineMirror).
    """

    part_id: int
    start: int
    end: int
    halo: np.ndarray          # remote src ids referenced by local in-edges
    halo_owner: np.ndarray    # owning partition of each halo vertex

    @property
    def num_owned(self) -> int:
        return self.end - self.start


def partition_graph(adj: Adjacency, num_parts: int,
                    alpha: float = 8.0) -> List[Partition]:
    offsets = degree_balanced_ranges(adj.in_degree, num_parts, alpha)
    parts: List[Partition] = []
    owner = np.searchsorted(offsets, np.arange(adj.num_vertices),
                            side="right") - 1
    for p in range(num_parts):
        s, e = int(offsets[p]), int(offsets[p + 1])
        local_srcs = adj.indices[adj.indptr[s]:adj.indptr[e]]
        remote = np.unique(local_srcs[(local_srcs < s) | (local_srcs >= e)])
        parts.append(
            Partition(
                part_id=p,
                start=s,
                end=e,
                halo=remote.astype(np.int32),
                halo_owner=owner[remote].astype(np.int32),
            )
        )
    return parts
