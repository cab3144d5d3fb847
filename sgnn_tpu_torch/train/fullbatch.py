"""Whole-graph (full-neighborhood) forward for GCN, GraphSAGE and GAT.

The port of `sgnn_tpu/train/fullbatch.py`'s `build_coo` and the
sum-aggregator branches of `full_forward` (fullbatch.py:212-388), forward
only: the serving passes take no gradients.  Per layer:

    GCN/SAGE, transform first when in > out:  h = spmm_csr(h @ W)
              else:                            h = spmm_csr(h) @ W
              hidden layers: relu(bn(h)); last layer: log_softmax in f32
    GAT:      ht = h @ W; (ts, td) = score tables of ht with a = attn[l]
              (heads on hidden layers, one head on the last);
              h = gat_aggregate(ht, ts, td[dst rows], csr)
              relu(bn(h)) on hidden layers, relu(h) then log_softmax in f32
              on the last (the reference GAT's relu at every layer)

The aggregations are the CSR SpMM of ops/segment.py and the attention
aggregation of ops/gat.py (hand-written kernels on the card); the dense
products are `torch.matmul`, as the JAX package left them to XLA.  Float32
products are meant to run in full float32: TF32 keeps only about three
decimal digits and the port is held to the reference at 1e-5.
`InferenceServer` switches TF32 off when it is built on CUDA
(`torch.backends.cuda.matmul.allow_tf32 = False`); a caller of
`full_forward` alone on the card owns that flag.

Full-batch training (the K2 backward, GAT's K4, min/max aggregators)
joins in a later slice; see ROADMAP.md Queue 1.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads
from ..nn.functional import BN_EPS, log_softmax
from ..ops.gat import gat_aggregate, pack_score_tables
from ..ops.segment import Csr, spmm_csr
from ..sampler.blocks import WeightKind

NOT_PORTED_MINMAX = ("aggregator min/max is not ported yet: ROADMAP.md "
                     "Queue 1 item 3 (whole-graph tier, ops/reductions.py)")


def check_ported(family: str, aggregator: str = "sum") -> None:
    """Raise NotImplementedError for what the JAX package serves but the
    port does not yet, ValueError for what neither serves.  GAT ignores
    `aggregator`, as the JAX package does (fullbatch.py:203)."""
    if family not in ("gcn", "sage", "gat"):
        raise ValueError(f"unknown model family {family!r}")
    if family == "gat":
        return
    if aggregator in ("min", "max"):
        raise NotImplementedError(NOT_PORTED_MINMAX)
    if aggregator != "sum":
        raise ValueError(f"unknown aggregator {aggregator!r}")


def build_coo(adj: Adjacency, weight_kind: WeightKind
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole-graph (src, dst, weight) arrays in CSC order, unpadded: the
    first E entries of the JAX package's `build_coo`, same arithmetic
    (MEAN here is the full-batch sym-norm/indeg hybrid)."""
    v = adj.num_vertices
    dst = np.repeat(np.arange(v, dtype=np.int32),
                    np.diff(adj.indptr).astype(np.int64))
    src = adj.indices.astype(np.int32)
    if weight_kind == WeightKind.GCN:
        w = adj.gcn_edge_weight(src, dst)
    elif weight_kind == WeightKind.MEAN:
        w = adj.gcn_edge_weight(src, dst) / np.maximum(adj.in_degree[dst], 1)
    else:
        w = np.ones(src.size, np.float32)
    return src, dst, w.astype(np.float32)


def _bn(t: torch.Tensor) -> torch.Tensor:
    """Whole-graph batch norm: per-feature population statistics in f32."""
    t32 = t.float()
    mu = t32.mean(dim=0, keepdim=True)
    var = t32.var(dim=0, unbiased=False, keepdim=True)
    return ((t32 - mu) * torch.rsqrt(var + BN_EPS)).to(t.dtype)


def _gat_layer(ht: torch.Tensor, attn: torch.Tensor, csr: Csr,
               dst_rows: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """One attention aggregation (pre-activation): the score tables of the
    layer's rows, the destinations' half gathered at `dst_rows` (None when
    the rows are the destinations, as in the whole graph), then K3."""
    f = ht.shape[1]
    a_src = attn[:f, 0].to(ht.dtype)
    a_dst = attn[f:, 0].to(ht.dtype)
    ts, td = pack_score_tables(ht, a_src, a_dst, heads)
    if dst_rows is not None:
        td = td.index_select(0, dst_rows)
    h, _ = gat_aggregate(ht, ts, td, csr.rowptr, csr.col, heads)
    return h


def full_forward(
    params: GNNParams,
    family: str,
    x: torch.Tensor,
    graph: Union[Csr, Sequence[Csr]],
    *,
    batch_norm: bool = False,
    aggregator: str = "sum",
    heads: int = 1,
    dst_rows: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """L-layer forward: [rows of the last graph, C] float32 log-probs.

    `graph` is one Csr shared by every layer (the whole graph: rows and
    sources are all V vertices) or one Csr per layer, bottom first, whose
    layer-l rows are the sources of layer l+1 (a query neighborhood); then
    `dst_rows[l]` (int64) gives the row of each of layer l's destinations
    among its sources, which GAT needs for the destinations' score half.
    For GCN/SAGE the edge weights in the Csr decide the family; GAT reads
    no weights, and takes `heads` on its hidden layers (GCN/SAGE ignore
    it, as in the JAX package).  `batch_norm` standardizes each hidden
    pre-activation per feature over all rows before relu."""
    check_ported(family, aggregator)
    check_heads(params, family, heads)
    n_layers = len(params.weights)
    graphs = [graph] * n_layers if isinstance(graph, Csr) else list(graph)
    if len(graphs) != n_layers:
        raise ValueError(f"{n_layers} layers but {len(graphs)} graphs")
    if dst_rows is None:
        if not isinstance(graph, Csr) and family == "gat":
            raise ValueError("GAT over per-layer graphs needs dst_rows")
        dst_rows = [None] * n_layers
    h = x
    for l, (wl, csr, rows) in enumerate(zip(params.weights, graphs,
                                            dst_rows)):
        last = l == n_layers - 1
        wl = wl.to(h.dtype)
        if family == "gat":
            h = _gat_layer(torch.matmul(h, wl), params.attn[l], csr, rows,
                           1 if last else heads)
            h = torch.relu(_bn(h) if batch_norm and not last else h)
            if last:
                h = log_softmax(h.float())
            continue
        if wl.shape[0] > wl.shape[1]:  # transform-first: SpMM on fewer columns
            h = spmm_csr(torch.matmul(h, wl), *csr)
        else:
            h = torch.matmul(spmm_csr(h, *csr), wl)
        if last:
            h = log_softmax(h.float())
        else:
            h = torch.relu(_bn(h) if batch_norm else h)
    return h
