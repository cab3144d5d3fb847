"""Whole-graph (full-neighborhood) forward for GCN/GraphSAGE.

The port's counterpart of `sgnn_tpu/train/fullbatch.py`'s `build_coo` and
the GCN/SAGE, sum-aggregator branch of `full_forward` (fullbatch.py:376-388),
forward only: the serving passes take no gradients.  Per layer:

    transform first when in > out:  h = spmm_csr(h @ W)
    else:                            h = spmm_csr(h) @ W
    hidden layers: relu(bn(h)); last layer: log_softmax in f32

The aggregation is the CSR SpMM of ops/segment.py (the hand-written kernel
on the card); the dense product is `torch.matmul`, as the JAX package left
it to XLA.  Float32 products are meant to run in full float32: TF32 keeps
only about three decimal digits and the port is held to the reference at
1e-5.  `InferenceServer` switches TF32 off when it is built on CUDA
(`torch.backends.cuda.matmul.allow_tf32 = False`); a caller of
`full_forward` alone on the card owns that flag.

Full-batch training (the K2 backward, GAT's K3/K4, min/max aggregators)
joins in later slices; see ROADMAP.md Queue 1.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams
from ..nn.functional import BN_EPS, log_softmax
from ..ops.segment import Csr, spmm_csr
from ..sampler.blocks import WeightKind

NOT_PORTED = {
    "gat": "family='gat' (GAT serving, kernel K3) is not ported yet: "
           "ROADMAP.md Queue 1 item 2",
    "minmax": "aggregator min/max is not ported yet: ROADMAP.md Queue 1 "
              "item 3 (whole-graph tier, ops/reductions.py)",
}


def check_ported(family: str, aggregator: str = "sum", heads: int = 1) -> None:
    """Raise NotImplementedError for what the JAX package serves but the
    port does not yet, ValueError for what neither serves."""
    if family == "gat":
        raise NotImplementedError(NOT_PORTED["gat"])
    if family not in ("gcn", "sage"):
        raise ValueError(f"unknown model family {family!r}")
    if aggregator in ("min", "max"):
        raise NotImplementedError(NOT_PORTED["minmax"])
    if aggregator != "sum":
        raise ValueError(f"unknown aggregator {aggregator!r}")
    if heads != 1:
        raise NotImplementedError("heads > 1 is multi-head GAT: "
                                  + NOT_PORTED["gat"])


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


def full_forward(
    params: GNNParams,
    family: str,
    x: torch.Tensor,
    graph: Union[Csr, Sequence[Csr]],
    *,
    batch_norm: bool = False,
    aggregator: str = "sum",
) -> torch.Tensor:
    """L-layer forward of a GCN/SAGE model: [rows of the last graph, C]
    float32 log-probs.

    `graph` is one Csr shared by every layer (the whole graph: rows and
    sources are all V vertices) or one Csr per layer, bottom first, whose
    layer-l rows are the sources of layer l+1 (a query neighborhood).
    The edge weights in the Csr decide GCN or SAGE; `family` is checked.
    `batch_norm` standardizes each hidden pre-activation per feature over
    all rows before relu."""
    check_ported(family, aggregator)
    n_layers = len(params.weights)
    graphs = [graph] * n_layers if isinstance(graph, Csr) else list(graph)
    if len(graphs) != n_layers:
        raise ValueError(f"{n_layers} layers but {len(graphs)} graphs")
    h = x
    for l, (wl, csr) in enumerate(zip(params.weights, graphs)):
        wl = wl.to(h.dtype)
        if wl.shape[0] > wl.shape[1]:  # transform-first: SpMM on fewer columns
            h = spmm_csr(torch.matmul(h, wl), *csr)
        else:
            h = torch.matmul(spmm_csr(h, *csr), wl)
        if l == n_layers - 1:
            h = log_softmax(h.float())
        else:
            h = torch.relu(_bn(h) if batch_norm else h)
    return h
