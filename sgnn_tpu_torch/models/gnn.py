"""GNN parameters: the container, its initialisation, and the carry-across.

Model structure (reference toolkits/ engines), the same in both packages:
  GCN/SAGE layer l:  X' = relu(aggregate(X_l) · W_l), log_softmax at the last
  (GCN uses symmetric-norm weights, SAGE mean weights — the only difference
  between the GCN* and GS* engines, GS_SAMPLE_ALLGPU.hpp:296).
  GAT layer l: W_l [in, out] plus an attention vector a_l [2·out, 1].

The parameters are a plain NamedTuple of tensors, as the JAX package's are a
pytree of arrays, so one layout crosses between them by `params_from_numpy`.
`model_forward` runs the sampled model over a `SampledBatch` (training);
serving runs the whole-graph forward of train/fullbatch.py.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..nn.functional import BN_EPS, dropout, log_softmax
from ..nn.layers import xavier_uniform_init
from ..ops.aggregate import (
    aggregate_edges_to_dst, edge_softmax, gather_aggregate,
    scatter_src_to_edges,
)
from ..ops.gat import NEG_SLOPE
from ..sampler.blocks import SampledBatch

MODEL_FAMILIES = ("gcn", "sage", "gat")


class GNNParams(NamedTuple):
    """Per-layer weights; attn is empty for GCN/SAGE, [2F',1]-style for GAT."""

    weights: Tuple[torch.Tensor, ...]     # W_l: [in_l, out_l]
    attn: Tuple[torch.Tensor, ...]        # GAT a_l: [2*out_l, 1] (else empty)

    def to(self, device=None, dtype=None) -> "GNNParams":
        return GNNParams(
            weights=tuple(w.to(device=device, dtype=dtype) for w in self.weights),
            attn=tuple(a.to(device=device, dtype=dtype) for a in self.attn))

    def leaves(self) -> List[torch.Tensor]:
        """Weights then attention vectors: the optimizers' flat order."""
        return [*self.weights, *self.attn]

    def replace_leaves(self, leaves: Sequence[torch.Tensor]) -> "GNNParams":
        n = len(self.weights)
        return GNNParams(weights=tuple(leaves[:n]), attn=tuple(leaves[n:]))


def init_model(
    seed: int,
    family: str,
    layer_sizes: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GNNParams:
    """W: xavier-uniform (torch parity), drawn from a CPU `torch.Generator`
    seeded with `seed`, then moved to `device`.  GAT attention vectors
    `a`: zeros, as in the JAX package (gnn.py:79-80) — every layer starts
    at uniform attention.

    Torch's generator draws other numbers than `jax.random` from the same
    seed; to hold the two packages to each other, make the weights once
    (numpy, or the JAX package's `init_model`) and carry them across with
    `params_from_numpy`."""
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    ws, atts = [], []
    for i in range(len(layer_sizes) - 1):
        ws.append(xavier_uniform_init(gen, layer_sizes[i], layer_sizes[i + 1],
                                      dtype=dtype).to(dev))
        if family == "gat":
            atts.append(torch.zeros((2 * layer_sizes[i + 1], 1), dtype=dtype,
                                    device=dev))
    return GNNParams(weights=tuple(ws), attn=tuple(atts))


def params_from_numpy(weights, attn=(), device=None) -> GNNParams:
    """The JAX package's parameters, given as numpy arrays (or anything
    `np.asarray` takes), as the port's: same layout, same dtype, on
    `device`.  This is the carry-across every parity test uses."""
    dev = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return GNNParams(weights=tuple(conv(w) for w in weights),
                     attn=tuple(conv(a) for a in attn))


def _batch_norm(t: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Standardise each column over the VALID rows only (statistics in f32
    even for bf16 compute), batch-stats mode at train and eval alike."""
    t32 = t.float()
    m = valid.float()[:, None]
    cnt = m.sum().clamp_min(1.0)
    mu = (t32 * m).sum(dim=0, keepdim=True) / cnt
    var = ((t32 - mu).square() * m).sum(dim=0, keepdim=True) / cnt
    return ((t32 - mu) * torch.rsqrt(var + BN_EPS)).to(t.dtype)


def check_heads(params: GNNParams, family: str, heads: int) -> None:
    """GAT: raise ValueError unless every layer has its attention vector
    [2·out, 1] and `heads` >= 1 divides every hidden width (the last layer
    is single-head).  GCN/SAGE ignore `heads`, as in the JAX package."""
    if family != "gat":
        return
    n_layers = len(params.weights)
    if len(params.attn) != n_layers or any(
            tuple(a.shape) != (2 * w.shape[1], 1)
            for w, a in zip(params.weights, params.attn)):
        raise ValueError("GAT needs one attention vector [2*out, 1] per "
                         f"layer, got {[tuple(a.shape) for a in params.attn]}")
    widths = [int(w.shape[1]) for w in params.weights[:-1]]
    if heads < 1 or any(f % heads for f in widths):
        raise ValueError(f"heads={heads} must divide every hidden width "
                         f"{widths}")


def _agg_linear(w: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor,
                wgt: torch.Tensor) -> torch.Tensor:
    """agg(X)·W == agg(X·W): when the layer SHRINKS the width (in > out),
    transform first, so the gather moves out-wide rows."""
    if w.shape[0] > w.shape[1]:
        return gather_aggregate(x @ w.to(x.dtype), nbr, wgt)
    return gather_aggregate(x, nbr, wgt) @ w.to(x.dtype)


def _gat_layer(w: torch.Tensor, a: torch.Tensor, x: torch.Tensor,
               nbr: torch.Tensor, wgt: torch.Tensor, seed_in_src: torch.Tensor,
               heads: int = 1) -> torch.Tensor:
    """One sampled GAT layer, pre-activation (sgnn_tpu/models/gnn.py:84-125):
    `heads` > 1 splits the F' output columns into blocks, each with its own
    attention (concat-of-heads; parameter shapes as single-head).  The
    leaky_relu slope is NEG_SLOPE, the one whole-graph serving uses."""
    h = x @ w.to(x.dtype)                                   # [S, F']
    fprime = h.shape[-1]
    h_src_e = scatter_src_to_edges(h, nbr)                  # [D, K, F']
    h_dst = h.index_select(0, seed_in_src)                  # [D, F']
    # [H_src ‖ H_dst]·a  ==  H_src·a[:F'] + H_dst·a[F':]
    a_src = a[:fprime, 0].to(h.dtype)
    a_dst = a[fprime:, 0].to(h.dtype)
    mask = wgt != 0.0
    if heads > 1:
        fh = fprime // heads
        d, k = h_src_e.shape[0], h_src_e.shape[1]
        src_h = h_src_e.view(d, k, heads, fh)
        score = torch.einsum("dkhf,hf->dkh", src_h, a_src.view(heads, fh))
        score = score + torch.einsum("dhf,hf->dh", h_dst.view(d, heads, fh),
                                     a_dst.view(heads, fh))[:, None, :]
        att = edge_softmax(F.leaky_relu(score, NEG_SLOPE), mask)
        return aggregate_edges_to_dst(src_h, att).reshape(d, fprime)
    score = torch.einsum("dkf,f->dk", h_src_e, a_src) + (h_dst @ a_dst)[:, None]
    att = edge_softmax(F.leaky_relu(score, NEG_SLOPE), mask)
    return aggregate_edges_to_dst(h_src_e, att)             # [D, F']


def model_forward(
    params: GNNParams,
    family: str,
    batch: SampledBatch,
    *,
    drop_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    cache_emb: Optional[torch.Tensor] = None,
    remat: bool = False,
    heads: int = 1,
    batch_norm: bool = False,
) -> torch.Tensor:
    """Run the L-layer model; returns log-probs [num_seed_pad, C].

    The port of sgnn_tpu/models/gnn.py:128-238: blocks are consumed
    input→output (layer l aggregates over batch.blocks[l]).  GCN/SAGE:
    hidden layers are relu(bn(agg(X)·W)) then dropout (drawn from
    `generator`, on the batch's device); the last layer is log_softmax in
    f32.  GAT: `heads` attention heads on hidden layers, one on the last;
    relu(bn(.)) on hidden layers and relu then log_softmax in f32 on the
    last (the reference's relu at every layer); no dropout, so nothing is
    drawn from `generator`, as the JAX GAT branch draws none.  `batch_norm`
    standardises hidden pre-activations over the hop's valid destination
    rows.  `remat` recomputes a layer in the backward pass
    (torch.utils.checkpoint) instead of storing it: GCN/SAGE's hidden
    aggregations, every GAT layer (as the JAX package's checkpoints)."""
    if cache_emb is not None:
        raise NotImplementedError(
            "the embedding cache waits for the cache slice (ROADMAP Queue 1 "
            "item 5)")
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    n_layers = len(params.weights)
    if batch.num_layers != n_layers:
        raise ValueError(f"{batch.num_layers} blocks for {n_layers} layers")
    check_heads(params, family, heads)
    x = batch.x0
    for l, block in enumerate(batch.blocks):
        is_last = l == n_layers - 1
        if family == "gat":
            fn = functools.partial(_gat_layer, heads=1 if is_last else heads)
            args = (params.weights[l], params.attn[l], x, block.nbr,
                    block.weight, block.seed_in_src)
            pre = (checkpoint(fn, *args, use_reentrant=False) if remat
                   else fn(*args))
            if not is_last and batch_norm:
                pre = _batch_norm(pre, block.dst_valid)
            x = torch.relu(pre)
            if is_last:
                x = log_softmax(x.float())
            continue
        args = (params.weights[l], x, block.nbr, block.weight)
        if remat and not is_last:
            y = checkpoint(_agg_linear, *args, use_reentrant=False)
        else:
            y = _agg_linear(*args)
        if is_last:
            # classification head in f32 regardless of compute dtype
            x = log_softmax(y.float())
        else:
            x = torch.relu(_batch_norm(y, block.dst_valid) if batch_norm
                           else y)
            if train and drop_rate > 0.0 and generator is not None:
                x = dropout(generator, x, drop_rate, train)
    return x
