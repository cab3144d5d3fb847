"""Vertex renumbering for gather locality (opt-in, the REORDER cfg key).

The port of sgnn_tpu/graph/reorder.py: the same orders, bit for bit.
Renumbering the vertices so that ids read together sit in nearby rows
narrows the spread of the row addresses a kernel gathers: on the card, the
rows of one warp's edges share more L2 lines and more of the table stays in
the 50 MB L2 (a Reddit-scale [V, 128] f32 table is 119 MB).  Reference
analog: Gemini's degree-aware chunk placement (core/graph.hpp:694-751).

Orders:
- "degree": in-degree descending (stable, so equal-degree runs keep their
  original order and a renumbering is deterministic);
- "bfs": repeated breadth-first search from the highest-degree unvisited
  vertex over the undirected adjacency, neighbors getting nearby ids;
- "none": the identity.

Each returns `order` with order[new_id] = old_id; `apply_vertex_order`
remaps a Dataset (features, labels and masks move with their vertex) and
returns old_to_new for translating external ids going in; per-vertex rows
coming out translate back through `order` itself.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..data.dataset import Dataset
from .adjacency import Adjacency

ORDERS = ("none", "degree", "bfs")


def vertex_order(ds_or_adj, mode: str = "degree") -> np.ndarray:
    """[V] int32 permutation, order[new_id] = old_id, of a Dataset or an
    Adjacency; ValueError for an unknown mode."""
    from ..sampler.native import stable_argsort

    if isinstance(ds_or_adj, Adjacency):
        adj = ds_or_adj
    else:
        adj = Adjacency.from_edges(ds_or_adj.edges, ds_or_adj.num_vertices)
    v = adj.num_vertices
    deg = np.diff(adj.indptr)
    mode = (mode or "none").lower()
    if mode in ("none", ""):
        return np.arange(v, dtype=np.int32)
    if mode == "degree":
        return np.argsort(-deg, kind="stable").astype(np.int32)
    if mode != "bfs":
        raise ValueError(f"unknown vertex order {mode!r} "
                         "(none | degree | bfs)")
    # the undirected view: both directions of every edge, grouped by their
    # first end (a stable counting sort, the same permutation as numpy's
    # stable argsort)
    src = adj.indices.astype(np.int64)
    dst = np.repeat(np.arange(v, dtype=np.int64), deg)
    u = np.concatenate([src, dst])
    w = np.concatenate([dst, src])
    o = stable_argsort(u, v)
    u, w = u[o], w[o]
    nbr_ptr = np.searchsorted(u, np.arange(v + 1, dtype=np.int64))
    order = np.empty(v, np.int32)
    visited = np.zeros(v, bool)
    pos = 0
    by_deg = np.argsort(-deg, kind="stable")
    seed_i = 0
    frontier = np.empty(0, np.int64)
    while pos < v:
        if frontier.size == 0:
            while visited[by_deg[seed_i]]:
                seed_i += 1
            frontier = np.array([by_deg[seed_i]], np.int64)
            visited[frontier[0]] = True
        order[pos:pos + frontier.size] = frontier
        pos += frontier.size
        spans = [w[nbr_ptr[f]:nbr_ptr[f + 1]] for f in frontier]
        nxt = np.unique(np.concatenate(spans)) if spans else frontier[:0]
        nxt = nxt[~visited[nxt]]
        visited[nxt] = True
        frontier = nxt
    return order


def apply_vertex_order(ds: Dataset, order: np.ndarray
                       ) -> Tuple[Dataset, np.ndarray]:
    """The Dataset renumbered by `order` (order[new_id] = old_id), and
    old_to_new [V] int32: row new_id of any per-vertex result belongs to
    old vertex order[new_id]."""
    v = ds.num_vertices
    order = np.asarray(order, np.int64)
    old_to_new = np.empty(v, np.int32)
    old_to_new[order] = np.arange(v, dtype=np.int32)
    edges = old_to_new[ds.edges.astype(np.int64)].astype(ds.edges.dtype)
    new_ds = Dataset(
        num_vertices=v,
        edges=edges,
        features=None if ds.features is None else ds.features[order],
        labels=None if ds.labels is None else ds.labels[order],
        masks=None if ds.masks is None else ds.masks[order],
        name=f"{ds.name}+reordered",
    )
    return new_ds, old_to_new
