"""Differentiable aggregation over dense-fanout sampled blocks (K1).

`gather_aggregate(x, nbr, w)` computes `out[d] = Σ_k w[d,k]·x[nbr[d,k]]`
with an f32 sum and the result in x's dtype: the sampled-subgraph SpMM of
every GCN/SAGE layer (the JAX package's `gather_aggregate`,
sgnn_tpu/ops/aggregate.py:29, and its Pallas twin
`pallas_gather_aggregate_fwd_impl`).  It is a `torch.autograd.Function`
whose backward is the math of sgnn_tpu/ops/aggregate.py:60-81:

    dx[s]    = Σ_{nbr[d,k]=s} w[d,k]·g[d]
    dw[d,k]  = <g[d], x[nbr[d,k]]>        (only when w requires a gradient)

Dispatch, for each of the three products: a CPU tensor goes to its plain
PyTorch version here; a CUDA tensor launches the kernel
(ops/cuda/gather_agg.py) or raises.  There is no fallback between them.
The GAT edge ops wait for the GAT slice (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import torch

from .segment import SPMM_DTYPES


def check_block_args(x: torch.Tensor, nbr: torch.Tensor,
                     w: torch.Tensor | None = None) -> None:
    """Raise ValueError unless (x, nbr[, w]) are what the kernels take.  The
    index bounds of `nbr` are the caller's to check, once, on the host (the
    host sampler) or by construction (the device sampler): checking them
    here would synchronise with the device on every call."""
    if x.dim() != 2 or x.dtype not in SPMM_DTYPES or not x.is_contiguous():
        raise ValueError("gather_aggregate: x must be a contiguous 2-D "
                         f"float32 or bfloat16 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    args = [("nbr", nbr, torch.int32)]
    if w is not None:
        args.append(("w", w, torch.float32))
    for name, t, dt in args:
        if t.dim() != 2 or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gather_aggregate: {name} must be a contiguous "
                             f"2-D {dt} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"gather_aggregate: {name} is on {t.device}, x "
                             f"on {x.device}")
    if w is not None and nbr.shape != w.shape:
        raise ValueError(f"gather_aggregate: nbr {tuple(nbr.shape)} and w "
                         f"{tuple(w.shape)} differ in shape")


def check_grad_arg(g: torch.Tensor, x: torch.Tensor, nbr: torch.Tensor) -> None:
    """Raise ValueError unless g is the [D, F] cotangent the kernels take."""
    if (g.dtype != x.dtype or g.device != x.device or not g.is_contiguous()
            or tuple(g.shape) != (nbr.shape[0], x.shape[1])):
        raise ValueError(f"gather_aggregate: g must be a contiguous "
                         f"{x.dtype} [{nbr.shape[0]}, {x.shape[1]}] tensor on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")


# ---------------------------------------------------------------- plain ----
def gather_aggregate_plain(x: torch.Tensor, nbr: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel: K slot-wise gather·w·add passes
    over [D, F] in f32 (never the [D, K, F] gather), in slot order, then
    cast to x's dtype."""
    out = torch.zeros((nbr.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(nbr.shape[1]):
        out += x.index_select(0, nbr[:, k]).float() * w[:, k, None]
    return out.to(x.dtype)


def gather_agg_bwd_dx_plain(g: torch.Tensor, nbr: torch.Tensor,
                            w: torch.Tensor, num_src: int,
                            dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the dx kernel: one `index_add_` per slot into an
    f32 [S, F] buffer, cast to `dtype` (x's) at the end."""
    dx = torch.zeros((num_src, g.shape[1]), dtype=torch.float32,
                     device=g.device)
    g32 = g.float()
    for k in range(nbr.shape[1]):
        dx.index_add_(0, nbr[:, k], g32 * w[:, k, None])
    return dx.to(dtype)


def gather_agg_bwd_dw_plain(g: torch.Tensor, x: torch.Tensor,
                            nbr: torch.Tensor) -> torch.Tensor:
    """Plain version of the dw kernel: per slot, the row dots of g with the
    gathered x rows, in f32 ([D, K])."""
    g32 = g.float()
    cols = [(g32 * x.index_select(0, nbr[:, k]).float()).sum(dim=1)
            for k in range(nbr.shape[1])]
    return torch.stack(cols, dim=1)


# ------------------------------------------------------------- dispatch ----
def _cuda(x: torch.Tensor):
    """The CUDA wrappers for a CUDA tensor, None for a CPU tensor; raises
    for any other device."""
    if x.device.type == "cpu":
        return None
    if x.device.type == "cuda":
        from .cuda import gather_agg

        return gather_agg
    raise ValueError(f"gather_aggregate runs on cpu or cuda tensors, not "
                     f"{x.device}")


def gather_agg_fwd(x, nbr, w):
    cuda = _cuda(x)
    if cuda is not None:
        return cuda.gather_agg_fwd_cuda(x, nbr, w)
    check_block_args(x, nbr, w)
    return gather_aggregate_plain(x, nbr, w)


def gather_agg_bwd_dx(g, nbr, w, x):
    cuda = _cuda(x)
    if cuda is not None:
        return cuda.gather_agg_bwd_dx_cuda(g, nbr, w, x)
    check_block_args(x, nbr, w)
    check_grad_arg(g, x, nbr)
    return gather_agg_bwd_dx_plain(g, nbr, w, x.shape[0], x.dtype)


def gather_agg_bwd_dw(g, x, nbr):
    cuda = _cuda(x)
    if cuda is not None:
        return cuda.gather_agg_bwd_dw_cuda(g, x, nbr)
    check_block_args(x, nbr)
    check_grad_arg(g, x, nbr)
    return gather_agg_bwd_dw_plain(g, x, nbr)


class _GatherAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr, w):
        ctx.save_for_backward(x, nbr, w)
        return gather_agg_fwd(x, nbr, w)

    @staticmethod
    def backward(ctx, g):
        x, nbr, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gather_agg_bwd_dx(g, nbr, w, x)
        if ctx.needs_input_grad[2]:
            dw = gather_agg_bwd_dw(g, x, nbr).to(w.dtype)
        return dx, None, dw


def gather_aggregate(x: torch.Tensor, nbr: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Weighted neighbor aggregation `out[d] = Σ_k w[d,k]·x[nbr[d,k]]`.

    x: [S, F] f32 or bf16; nbr: [D, K] int32 local source indices in
    [0, S); w: [D, K] f32 edge weights, 0 on padded slots.  Returns [D, F]
    in x's dtype, differentiable in x and w.  On CUDA, dx goes through
    float atomics and is not bit-deterministic from run to run."""
    return _GatherAggregate.apply(x, nbr, w)
