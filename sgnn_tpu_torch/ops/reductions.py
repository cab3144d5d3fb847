"""Min/max neighbor aggregation over a CSR keyed by destination.

The port of `sgnn_tpu/ops/reductions.py::segment_min_coo` /
`segment_max_coo` (:93-119), the AGGREGATOR min/max of the whole-graph
tier (reference SingleCPUDstAggregateOpMin/Max,
core/ntsSingleCPUGraphOp.hpp): `out[d] = min/max over e∈row d of
x[col_e]`, elementwise, and 0 for a row with no edges.  The JAX package
computes this in XLA, not in a Pallas kernel, so torch ops are the port,
on the CPU and on the card alike.

The gradient follows JAX's scatter-extremal rule (the VJP of
`jax.ops.segment_max`): each element's cotangent is split evenly among the
edges whose message equals the extreme (a tie shares it), and a row with
no edges passes none.  Forward and backward walk the edges in chunks of
PLAIN_CHUNK_EDGES, bounding the [chunk, F] temporaries.

`gather_min` / `gather_max` are the same reductions over a sampled block's
dense [D, K] slots (`nbr`, `edge_mask`), and `edge_view` is its [D, K, F]
edge-major view (reference ntsEdgeTensor, NtsEdgeTensor.hpp:22): the JAX
package's `sgnn_tpu/ops/reductions.py:23-43,122`, torch ops whose autograd
splits a tie's cotangent evenly, as jnp.min/max's does.
"""

from __future__ import annotations

import torch

from .segment import csr_rows, edge_chunks

_REDUCE = {"min": "amin", "max": "amax"}


class SegmentExtreme(torch.autograd.Function):
    """`segment_extreme`'s forward and its tie-sharing backward."""

    @staticmethod
    def forward(ctx, x, rowptr, col, kind):
        num_rows = rowptr.numel() - 1
        init = float("inf") if kind == "min" else float("-inf")
        out = torch.full((num_rows, x.shape[1]), init, dtype=x.dtype,
                         device=x.device)
        rows = csr_rows(rowptr)
        for lo, hi in edge_chunks(col.numel()):
            msg = x.index_select(0, col[lo:hi])
            out.scatter_reduce_(0, rows[lo:hi, None].expand_as(msg), msg,
                                _REDUCE[kind])
        empty = (rowptr[1:] == rowptr[:-1])[:, None]
        out = out.masked_fill(empty, 0.0)
        ctx.save_for_backward(x, rowptr, col, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, rowptr, col, out = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        rows = csr_rows(rowptr)
        # first pass: how many edges reach each element's extreme
        ties = torch.zeros(out.shape, dtype=torch.float32, device=x.device)
        for lo, hi in edge_chunks(col.numel()):
            hit = x.index_select(0, col[lo:hi]) == out.index_select(
                0, rows[lo:hi])
            ties.index_add_(0, rows[lo:hi], hit.float())
        share = g.float() / ties.clamp_min(1.0)
        # second pass: each arg-extreme edge takes its share
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for lo, hi in edge_chunks(col.numel()):
            r, c = rows[lo:hi], col[lo:hi]
            hit = x.index_select(0, c) == out.index_select(0, r)
            dx.index_add_(0, c, torch.where(hit, share.index_select(0, r),
                                            0.0))
        return dx.to(x.dtype), None, None, None


def segment_extreme(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                    kind: str) -> torch.Tensor:
    """`out[d] = min/max_{e∈row d} x[col_e]` (kind "min" or "max"), rows
    with no edges 0, in x's dtype; differentiable in x."""
    if kind not in _REDUCE:
        raise ValueError(f"segment_extreme: kind must be min or max, not "
                         f"{kind!r}")
    if x.dim() != 2 or not x.dtype.is_floating_point:
        raise ValueError(f"segment_extreme: x must be a 2-D float tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    return SegmentExtreme.apply(x, rowptr, col, kind)


def gather_min(x_src: torch.Tensor, nbr: torch.Tensor,
               edge_mask: torch.Tensor) -> torch.Tensor:
    """out[d] = min over valid slots k of x_src[nbr[d, k]]; a row with no
    valid slot is 0."""
    return _gather_extreme(x_src, nbr, edge_mask, "min")


def gather_max(x_src: torch.Tensor, nbr: torch.Tensor,
               edge_mask: torch.Tensor) -> torch.Tensor:
    """out[d] = max over valid slots k of x_src[nbr[d, k]]; a row with no
    valid slot is 0."""
    return _gather_extreme(x_src, nbr, edge_mask, "max")


def _gather_extreme(x_src, nbr, edge_mask, kind):
    gathered = edge_view(x_src, nbr)                       # [D, K, F]
    fin = torch.finfo(x_src.dtype)
    fill = torch.tensor(fin.max if kind == "min" else fin.min,
                        dtype=x_src.dtype, device=x_src.device)
    masked = torch.where(edge_mask[:, :, None], gathered, fill)
    out = (torch.amin if kind == "min" else torch.amax)(masked, dim=1)
    return torch.where(edge_mask.any(dim=1)[:, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def edge_view(x_src: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The [D, K, F] edge-major view of the source rows: x_src[nbr]."""
    return x_src[nbr.long()]
