"""The sampled GATv2 layer's attention aggregation as one differentiable op.

`gatv2_sampled_aggregate(xl, xr, att, nbr, w, heads)` is the attention of
PyG's `GATv2Conv` (Brody, Alon & Yahav, "How Attentive are Graph
Attention Networks?", ICLR 2022, eq. (7); `share_weights=False`) over a
sampled block: nbr int32 [D, K] local source rows, w f32 [D, K] (0 on
padded slots, used only as the mask), xl [S, F] the sources' rows
(`lin_l`), xr [D, F] the destinations' own rows (`lin_r`), att [F] the
attention vector, F = heads·C.  Per destination d, slot k with source
s = nbr[d, k], head h and column c of the head:

    u[d,k,h,c] = xl[s, h, c] + xr[d, h, c]
    e[d,k,h]   = Σ_c att[h, c] · leaky_relu(u[d,k,h,c], NEG_SLOPE)
    alpha      = edge_softmax(e, w != 0)   (max-shifted; 0 on padded
                 slots, a row with no valid slot all zero)
    out[d, h]  = Σ_k alpha[d,k,h] · xl[s, h]

No per-vertex table splits the score, as GAT's `ts[s] + td[d]` does
(ops/gat_sampled.py): the nonlinearity sits between the sum and the dot
product, so every edge and head costs a C-wide vector operation in both
passes.  Its backward, with G = dL/dout, datt = <G[d, h], xl[s, h]> and
leaky'(x) 1 for x > 0, else NEG_SLOPE (torch's):

    dscore  = alpha · (datt − Σ_k alpha·datt)
    dxl[s]  = Σ_{nbr[d,k]=s} alpha·G[d] + dscore · att ⊙ leaky'(u)
    dxr[d]  = Σ_k dscore · att ⊙ leaky'(u)
    d att   = Σ_{d,k} dscore · leaky_relu(u)

GATv2Conv's self-loop rule is GATConv's (`gat_sampled.own_row_slots`):
the caller's block already holds one own-row slot a destination.

Dispatch: a CPU tensor goes to the plain versions here (sums in f32, f64
for f64 rows); a CUDA tensor to the kernels (ops/cuda/gatv2_sampled.py,
csrc/gatv2_sampled.cu), which take f32 rows and sum in f32.  There is no
fallback between them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import timing
from .aggregate import edge_softmax
from .gat import NEG_SLOPE


def check_gatv2_sampled_args(xl: torch.Tensor, xr: torch.Tensor,
                             att: torch.Tensor, nbr: torch.Tensor,
                             w: torch.Tensor, heads: int) -> None:
    """Raise ValueError unless the arguments are what the op takes: xl a
    contiguous [S, F] f32 tensor (f64 too on the CPU), xr [D, F] and att
    [F] in xl's dtype, nbr int32 and w f32 [D, K], all contiguous and on
    xl's device, heads dividing F.  Index bounds are the caller's (the
    sampler's, by construction)."""
    cpu = xl.device.type == "cpu"
    dtypes = (torch.float32,) + ((torch.float64,) if cpu else ())
    if xl.dim() != 2 or xl.dtype not in dtypes or not xl.is_contiguous():
        raise ValueError("gatv2_sampled: xl must be a contiguous 2-D "
                         f"float32 tensor, got {xl.dtype} "
                         f"{tuple(xl.shape)}")
    feat = xl.shape[1]
    if heads < 1 or feat < 1 or feat % heads:
        raise ValueError(f"gatv2_sampled: heads={heads} must divide the "
                         f"width {feat} (at least 1)")
    d = nbr.shape[0] if nbr.dim() == 2 else -1
    for name, t, dt, shape in (
            ("xr", xr, xl.dtype, (d, feat)),
            ("att", att, xl.dtype, (feat,)),
            ("nbr", nbr, torch.int32, None),
            ("w", w, torch.float32, tuple(nbr.shape))):
        want = 2 if shape is None else len(shape)
        if t.dim() != want or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gatv2_sampled: {name} must be a contiguous "
                             f"{want}-D {dt} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"gatv2_sampled: {name} must be "
                             f"{list(shape)}, got {list(t.shape)}")
        if t.device != xl.device:
            raise ValueError(f"gatv2_sampled: {name} is on {t.device}, xl "
                             f"on {xl.device}")


def check_gatv2_sampled_grad(g: torch.Tensor, alpha: torch.Tensor,
                             xl: torch.Tensor, nbr: torch.Tensor,
                             heads: int) -> None:
    """Raise ValueError unless g is the contiguous [D, F] cotangent and
    alpha the forward's [D, K, heads] attention, in xl's dtype and on its
    device."""
    d, k = nbr.shape
    for name, t, shape in (("g", g, (d, xl.shape[1])),
                           ("alpha", alpha, (d, k, heads))):
        if (t.dtype != xl.dtype or t.device != xl.device
                or not t.is_contiguous() or tuple(t.shape) != shape):
            raise ValueError(f"gatv2_sampled: {name} must be a contiguous "
                             f"{xl.dtype} {list(shape)} tensor on "
                             f"{xl.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


# ---------------------------------------------------------------- plain ----
def _slot_rows(xl: torch.Tensor, nbr: torch.Tensor, j: int,
               heads: int) -> torch.Tensor:
    """Slot j's source rows, [D, H, C]."""
    return xl.index_select(0, nbr[:, j].long()).view(nbr.shape[0], heads, -1)


def gatv2_sampled_fwd_plain(xl: torch.Tensor, xr: torch.Tensor,
                            att: torch.Tensor, nbr: torch.Tensor,
                            w: torch.Tensor, heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: `(out [D, F], alpha [D, K,
    H])`, slot by slot over [D, F] (never a [D, K, F] tensor)."""
    (d, k), feat = nbr.shape, xl.shape[1]
    a, xr3 = att.view(heads, -1), xr.view(d, heads, -1)
    scores = torch.stack(
        [(F.leaky_relu(_slot_rows(xl, nbr, j, heads) + xr3, NEG_SLOPE) * a
          ).sum(-1) for j in range(k)], dim=1)                  # [D, K, H]
    alpha = edge_softmax(scores, w != 0)
    out = torch.zeros_like(xr3)
    for j in range(k):
        out += _slot_rows(xl, nbr, j, heads) * alpha[:, j, :, None]
    return out.view(d, feat), alpha


def gatv2_sampled_bwd_plain(g: torch.Tensor, xl: torch.Tensor,
                            xr: torch.Tensor, att: torch.Tensor,
                            nbr: torch.Tensor, alpha: torch.Tensor,
                            heads: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the backward kernels: `(dxl [S, F], dxr [D, F],
    datt [F])`, slot by slot, dxl summed by `index_add_` (padded slots add
    zeros: their alpha and dscore are 0)."""
    (d, k), feat = nbr.shape, xl.shape[1]
    g3, a, xr3 = g.view(d, heads, -1), att.view(heads, -1), xr.view(d, heads,
                                                                     -1)
    datt = torch.stack([(g3 * _slot_rows(xl, nbr, j, heads)).sum(-1)
                        for j in range(k)], dim=1)              # [D, K, H]
    dscore = alpha * (datt - (alpha * datt).sum(1, keepdim=True))
    dxl = torch.zeros_like(xl)
    dxr = torch.zeros_like(xr3)
    datt_vec = torch.zeros_like(a)
    for j in range(k):
        u = _slot_rows(xl, nbr, j, heads) + xr3
        ds = dscore[:, j, :, None]
        slope = torch.where(u > 0, torch.ones_like(u),
                            torch.full_like(u, NEG_SLOPE))
        t = ds * a * slope
        dxr += t
        dxl.index_add_(0, nbr[:, j].long(),
                       (alpha[:, j, :, None] * g3 + t).view(d, feat))
        datt_vec += (ds * F.leaky_relu(u, NEG_SLOPE)).sum(0)
    return dxl, dxr.view(d, feat), datt_vec.view(feat)


# ------------------------------------------------------------- dispatch ----
def gatv2_sampled_fwd(xl, xr, att, nbr, w, heads):
    """The forward `(out, alpha)`: the plain version on the CPU, the
    kernel on the card."""
    if xl.device.type == "cpu":
        check_gatv2_sampled_args(xl, xr, att, nbr, w, heads)
        return gatv2_sampled_fwd_plain(xl, xr, att, nbr, w, heads)
    if xl.device.type == "cuda":
        from .cuda.gatv2_sampled import gatv2_sampled_fwd_cuda

        return gatv2_sampled_fwd_cuda(xl, xr, att, nbr, w, heads)
    raise ValueError(f"gatv2_sampled runs on cpu or cuda tensors, not "
                     f"{xl.device}")


def gatv2_sampled_bwd(g, xl, xr, att, nbr, w, alpha, heads):
    """The backward `(dxl, dxr, datt)`: the plain version on the CPU, the
    kernels on the card."""
    if xl.device.type == "cpu":
        check_gatv2_sampled_args(xl, xr, att, nbr, w, heads)
        check_gatv2_sampled_grad(g, alpha, xl, nbr, heads)
        return gatv2_sampled_bwd_plain(g, xl, xr, att, nbr, alpha, heads)
    if xl.device.type == "cuda":
        from .cuda.gatv2_sampled import gatv2_sampled_bwd_cuda

        return gatv2_sampled_bwd_cuda(g, xl, xr, att, nbr, w, alpha, heads)
    raise ValueError(f"gatv2_sampled runs on cpu or cuda tensors, not "
                     f"{xl.device}")


class Gatv2SampledAggregate(torch.autograd.Function):
    """Differentiable in xl, xr and att; the forward saves alpha [D, K,
    H].  Each forward and each backward raises its counter
    (`attention.gatv2_forwards`, `attention.gatv2_backwards`) by one, on
    the host, with no sync."""

    @staticmethod
    def forward(ctx, xl, xr, att, nbr, w, heads):
        out, alpha = gatv2_sampled_fwd(xl, xr, att, nbr, w, heads)
        timing.RECORDER.counters.add("attention.gatv2_forwards")
        ctx.heads = heads
        ctx.save_for_backward(xl, xr, att, nbr, w, alpha)
        return out

    @staticmethod
    def backward(ctx, g):
        xl, xr, att, nbr, w, alpha = ctx.saved_tensors
        dxl, dxr, datt = gatv2_sampled_bwd(g.contiguous(), xl, xr, att, nbr,
                                           w, alpha, ctx.heads)
        timing.RECORDER.counters.add("attention.gatv2_backwards")
        return dxl, dxr, datt, None, None, None


def gatv2_sampled_aggregate(xl: torch.Tensor, xr: torch.Tensor,
                            att: torch.Tensor, nbr: torch.Tensor,
                            w: torch.Tensor, heads: int) -> torch.Tensor:
    """The attention aggregation of the module docstring, [D, F] in xl's
    dtype, differentiable in xl, xr and att."""
    return Gatv2SampledAggregate.apply(xl, xr, att, nbr, w, heads)
