"""The sampled GAT layer's attention aggregation as one differentiable op.

`gat_sampled_aggregate(h, ts, td, nbr, w, seed_in_src, heads)` is the
function models/gnn._gat_layer computes with torch ops on the CPU
(`scatter_src_to_edges`, the score einsums, `edge_softmax`,
`aggregate_edges_to_dst`), over a sampled block: nbr int32 [D, K] local
source rows, w f32 [D, K] (0 on padded slots, used only as the mask),
seed_in_src int32 [D] each destination's own source row, h [S, F] with
F = heads·fh, and the per-row score halves ts, td [S, H]
(`ops/gat.pack_score_tables`).  Per destination d, slot k, head h:

    score  = leaky_relu(ts[nbr[d,k], h] + td[seed_in_src[d], h], NEG_SLOPE)
    att    = edge_softmax(score, w != 0)   (max-shifted, max detached; 0 on
             padded slots, a row with no valid slot all zero)
    out[d, head h] = Σ_k att[d,k,h] · h[nbr[d,k], head h]

and its backward, with G = dL/dout, datt = <G[d, head h], h[nbr, head h]>:

    dscore = att · (datt − Σ_k att·datt) · leaky_relu'(score)
    dh[s, head h] = Σ_{nbr[d,k]=s} att[d,k,h] · G[d, head h]
    dts[s, h]     = Σ_{nbr[d,k]=s} dscore[d,k,h]
    dtd[s, h]     = Σ_{seed_in_src[d]=s} Σ_k dscore[d,k,h]

leaky_relu'(x) is 1 for x > 0, else NEG_SLOPE (torch's).  The score
tables carry their gradients back to h and the attention vectors through
`pack_score_tables`' einsum.  No [D, K, F] tensor is formed on either
path: the forward saves att [D, K, H].

Dispatch: a CPU tensor goes to the plain versions here (sums in f32, f64
for f64 rows); a CUDA tensor to the kernels (ops/cuda/gat_sampled.py,
csrc/gat_sampled.cu), which take f32 or bf16 rows and f32 tables and sum
in f32.  There is no fallback between them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .aggregate import edge_softmax
from .gat import NEG_SLOPE, table_dtype
from .segment import SPMM_DTYPES


def check_gat_sampled_args(h: torch.Tensor, ts: torch.Tensor,
                           td: torch.Tensor, nbr: torch.Tensor,
                           w: torch.Tensor, seed_in_src: torch.Tensor,
                           heads: int) -> None:
    """Raise ValueError unless the arguments are what the op takes: h a
    contiguous [S, F] f32 or bf16 tensor (f64 too on the CPU), ts and td
    [S, heads] in the sum dtype, nbr int32 and w f32 [D, K], seed_in_src
    int32 [D], all on h's device, heads dividing F.  Index bounds are the
    caller's (the sampler's, by construction)."""
    cpu = h.device.type == "cpu"
    dtypes = SPMM_DTYPES + ((torch.float64,) if cpu else ())
    if h.dim() != 2 or h.dtype not in dtypes or not h.is_contiguous():
        raise ValueError("gat_sampled: h must be a contiguous 2-D float32 "
                         f"or bfloat16 tensor, got {h.dtype} "
                         f"{tuple(h.shape)}")
    if heads < 1 or h.shape[1] < 1 or h.shape[1] % heads:
        raise ValueError(f"gat_sampled: heads={heads} must divide the width "
                         f"{h.shape[1]} (at least 1)")
    d = nbr.shape[0] if nbr.dim() == 2 else -1
    acc = table_dtype(h)
    for name, t, dt, shape in (
            ("ts", ts, acc, (h.shape[0], heads)),
            ("td", td, acc, (h.shape[0], heads)),
            ("nbr", nbr, torch.int32, None),
            ("w", w, torch.float32, tuple(nbr.shape)),
            ("seed_in_src", seed_in_src, torch.int32, (d,))):
        want = 2 if shape is None else len(shape)
        if t.dim() != want or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gat_sampled: {name} must be a contiguous "
                             f"{want}-D {dt} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"gat_sampled: {name} must be {list(shape)}, "
                             f"got {list(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"gat_sampled: {name} is on {t.device}, h on "
                             f"{h.device}")


def check_gat_sampled_grad(g: torch.Tensor, att: torch.Tensor,
                           h: torch.Tensor, nbr: torch.Tensor,
                           heads: int) -> None:
    """Raise ValueError unless g is the contiguous [D, F] cotangent in h's
    dtype and att the forward's [D, K, heads] attention, on h's device."""
    d, k = nbr.shape
    for name, t, dt, shape in (("g", g, h.dtype, (d, h.shape[1])),
                               ("att", att, table_dtype(h), (d, k, heads))):
        if (t.dtype != dt or t.device != h.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"gat_sampled: {name} must be a contiguous {dt} "
                             f"{list(shape)} tensor on {h.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


# ---------------------------------------------------------------- plain ----
def _scores(ts, td, nbr, seed_in_src, acc) -> torch.Tensor:
    """The scores before leaky_relu, [D, K, H] in `acc`."""
    d, k = nbr.shape
    src = ts.to(acc).index_select(0, nbr.reshape(-1).long())
    dst = td.to(acc).index_select(0, seed_in_src.long())
    return src.view(d, k, -1) + dst[:, None, :]


def gat_sampled_fwd_plain(h: torch.Tensor, ts: torch.Tensor,
                          td: torch.Tensor, nbr: torch.Tensor,
                          w: torch.Tensor, seed_in_src: torch.Tensor,
                          heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: `(out [D, F] in h's dtype,
    att [D, K, H] in the sum dtype)`; the scores and `edge_softmax` over
    [D, K, H], then K slot-wise gather·att·add passes over [D, F] in slot
    order (never the [D, K, F] gather)."""
    acc = table_dtype(h)
    (d, k), feat = nbr.shape, h.shape[1]
    att = edge_softmax(F.leaky_relu(_scores(ts, td, nbr, seed_in_src, acc),
                                    NEG_SLOPE), w != 0)
    out = torch.zeros((d, heads, feat // heads), dtype=acc, device=h.device)
    for j in range(k):
        rows = h.index_select(0, nbr[:, j].long()).to(acc)
        out += rows.view(d, heads, -1) * att[:, j, :, None]
    return out.view(d, feat).to(h.dtype), att


def gat_sampled_bwd_plain(g: torch.Tensor, h: torch.Tensor, ts: torch.Tensor,
                          td: torch.Tensor, nbr: torch.Tensor,
                          w: torch.Tensor, seed_in_src: torch.Tensor,
                          att: torch.Tensor, heads: int
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Plain version of the backward kernels: `(dh [S, F] in h's dtype,
    dts, dtd [S, H] in the tables' dtype)`, per slot in the sum dtype,
    summed by `index_add_` (padded slots add zeros: their att and dscore
    are 0)."""
    acc = table_dtype(h)
    (d, k), (s, feat) = nbr.shape, h.shape
    g3 = g.to(acc).view(d, heads, -1)
    datt = torch.stack(
        [(g3 * h.index_select(0, nbr[:, j].long()).to(acc).view(d, heads, -1)
          ).sum(-1) for j in range(k)], dim=1)                  # [D, K, H]
    score = _scores(ts, td, nbr, seed_in_src, acc)
    one = torch.ones_like(score)
    slope = torch.where(score > 0, one, NEG_SLOPE * one)
    dscore = att * (datt - (att * datt).sum(1, keepdim=True)) * slope
    dts = torch.zeros((s, heads), dtype=acc, device=h.device)
    dts.index_add_(0, nbr.reshape(-1).long(), dscore.reshape(-1, heads))
    dtd = torch.zeros((s, heads), dtype=acc, device=h.device)
    dtd.index_add_(0, seed_in_src.long(), dscore.sum(1))
    dh = torch.zeros((s, feat), dtype=acc, device=h.device)
    for j in range(k):
        dh.index_add_(0, nbr[:, j].long(),
                      (g3 * att[:, j, :, None]).view(d, feat))
    return dh.to(h.dtype), dts.to(ts.dtype), dtd.to(td.dtype)


# ------------------------------------------------------------- dispatch ----
def gat_sampled_fwd(h, ts, td, nbr, w, seed_in_src, heads):
    """The forward `(out, att)`: the plain version on the CPU, the kernel
    on the card."""
    if h.device.type == "cpu":
        check_gat_sampled_args(h, ts, td, nbr, w, seed_in_src, heads)
        return gat_sampled_fwd_plain(h, ts, td, nbr, w, seed_in_src, heads)
    if h.device.type == "cuda":
        from .cuda.gat_sampled import gat_sampled_fwd_cuda

        return gat_sampled_fwd_cuda(h, ts, td, nbr, w, seed_in_src, heads)
    raise ValueError(f"gat_sampled runs on cpu or cuda tensors, not "
                     f"{h.device}")


def gat_sampled_bwd(g, h, ts, td, nbr, w, seed_in_src, att, heads):
    """The backward `(dh, dts, dtd)`: the plain version on the CPU, the
    kernels on the card."""
    if h.device.type == "cpu":
        check_gat_sampled_args(h, ts, td, nbr, w, seed_in_src, heads)
        check_gat_sampled_grad(g, att, h, nbr, heads)
        return gat_sampled_bwd_plain(g, h, ts, td, nbr, w, seed_in_src, att,
                                     heads)
    if h.device.type == "cuda":
        from .cuda.gat_sampled import gat_sampled_bwd_cuda

        return gat_sampled_bwd_cuda(g, h, ts, td, nbr, w, seed_in_src, att,
                                    heads)
    raise ValueError(f"gat_sampled runs on cpu or cuda tensors, not "
                     f"{h.device}")


class GatSampledAggregate(torch.autograd.Function):
    """Differentiable in h, ts and td; the forward saves att [D, K, H]."""

    @staticmethod
    def forward(ctx, h, ts, td, nbr, w, seed_in_src, heads):
        out, att = gat_sampled_fwd(h, ts, td, nbr, w, seed_in_src, heads)
        ctx.heads = heads
        ctx.save_for_backward(h, ts, td, nbr, w, seed_in_src, att)
        return out

    @staticmethod
    def backward(ctx, g):
        h, ts, td, nbr, w, seed_in_src, att = ctx.saved_tensors
        dh, dts, dtd = gat_sampled_bwd(g.contiguous(), h, ts, td, nbr, w,
                                       seed_in_src, att, ctx.heads)
        return dh, dts, dtd, None, None, None, None


def gat_sampled_aggregate(h: torch.Tensor, ts: torch.Tensor,
                          td: torch.Tensor, nbr: torch.Tensor,
                          w: torch.Tensor, seed_in_src: torch.Tensor,
                          heads: int) -> torch.Tensor:
    """The attention aggregation of the module docstring, [D, F] in h's
    dtype, differentiable in h, ts and td."""
    return GatSampledAggregate.apply(h, ts, td, nbr, w, seed_in_src, heads)
