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
