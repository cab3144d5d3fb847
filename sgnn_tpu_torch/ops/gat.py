"""Whole-graph attention aggregation (K3's function) over a CSR keyed by
destination.

The port's counterpart of the forward half of
`sgnn_tpu/ops/pallas/mxu_gat.py` (`pack_score_tables`, `mxu_gat_aggregate`
and the kernel `_gat_apply`).  Per layer, with `ht` the transformed rows
[S, F], F = heads·fh, and head h owning columns [h·fh, (h+1)·fh):

    ts[s, h] = <ht[s, head h], a_src[head h]>     (score half of a source)
    td[d, h] = <ht_dst[d, head h], a_dst[head h]>  (of a destination)
    u_e,h    = exp(clip(leaky_relu(ts[col_e, h] + td[d, h], 0.2), ±60))
    out[d, head h] = Σ_{e∈row d} u_e,h · ht[col_e, head h]
    z[d, h]  = Σ_{e∈row d} u_e,h
    h[d, head h] = out[d, head h] / max(z[d, h], float32 tiny)

The exponential is max-free: the clip keeps every sum finite, and softmax
is shift-invariant, so this equals the max-shifted softmax while
|score| < 60 (the JAX package's `attention_exp`, ops/segment.py:777-797).
`h` has ht's dtype, `z` is f32 [D, heads] (the backward, K4, needs it).  A
row with no edges gives h = 0 and z = 0.

The JAX kernel's plan (`build_mxu_gat_plan*`, the geometry ladder, the
sentinel padding, the 8-column score tables) exists only for Mosaic's
one-hot tiling; the port keeps the CSR (`ops/segment.Csr`) and tables of
exactly `heads` columns.

Dispatch follows `spmm_csr`: a CPU tensor goes to `gat_aggregate_plain`; a
CUDA tensor launches the kernel (ops/cuda/gat.py, csrc/gat.cu) or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .segment import PLAIN_CHUNK_EDGES, SPMM_DTYPES

# |score| clamp of the max-free exponential: the same constant as the JAX
# package's ops/segment.py:784 and ops/pallas/mxu_gat.py:65
ATT_CLIP = 60.0
# leaky_relu slope of the scores, sampled (models/gnn._gat_layer) and
# whole-graph (here and csrc/gat.cu kNegSlope) alike
NEG_SLOPE = 0.2
F32_TINY = torch.finfo(torch.float32).tiny


def pack_score_tables(ht: torch.Tensor, a_src: torch.Tensor,
                      a_dst: torch.Tensor, heads: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row score halves `(ts, td)`, each [rows, heads] f32: head h's
    attention vectors are the fh-column blocks of a_src / a_dst ([F]), the
    head structure of models/gnn._gat_layer.  Products in f32 (a bf16 ht
    widens exactly), as the JAX einsum with f32 accumulation."""
    f = ht.shape[1]
    if heads < 1 or f % heads:
        raise ValueError(f"pack_score_tables: heads={heads} must divide the "
                         f"width {f}")
    fh = f // heads
    hh = ht.float().reshape(-1, heads, fh)
    ts = torch.einsum("vhf,hf->vh", hh, a_src.float().reshape(heads, fh))
    td = torch.einsum("vhf,hf->vh", hh, a_dst.float().reshape(heads, fh))
    return ts.contiguous(), td.contiguous()


def check_gat_args(ht: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                   rowptr: torch.Tensor, col: torch.Tensor,
                   heads: int) -> None:
    """Raise ValueError unless the arguments are what the kernel takes.
    Index bounds of `col` are the caller's to check, once, on the host
    (`ops/segment.csr_from_numpy`)."""
    if ht.dim() != 2 or ht.dtype not in SPMM_DTYPES or not ht.is_contiguous():
        raise ValueError("gat_aggregate: ht must be a contiguous 2-D float32 "
                         f"or bfloat16 tensor, got {ht.dtype} "
                         f"{tuple(ht.shape)}")
    if heads < 1 or ht.shape[1] < 1 or ht.shape[1] % heads:
        raise ValueError(f"gat_aggregate: heads={heads} must divide the width "
                         f"{ht.shape[1]} (at least 1)")
    num_rows = rowptr.numel() - 1
    if num_rows < 0:
        raise ValueError("gat_aggregate: rowptr needs num_rows+1 entries")
    for name, t, dt, shape in (
            ("ts", ts, torch.float32, (ht.shape[0], heads)),
            ("td", td, torch.float32, (num_rows, heads)),
            ("rowptr", rowptr, torch.int64, None),
            ("col", col, torch.int32, None)):
        want = 2 if shape else 1
        if t.dim() != want or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gat_aggregate: {name} must be a contiguous "
                             f"{want}-D {dt} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if shape and tuple(t.shape) != shape:
            raise ValueError(f"gat_aggregate: {name} must be {list(shape)}, "
                             f"got {list(t.shape)}")
        if t.device != ht.device:
            raise ValueError(f"gat_aggregate: {name} is on {t.device}, ht on "
                             f"{ht.device}")


def gat_aggregate_plain(ht: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                        rowptr: torch.Tensor, col: torch.Tensor,
                        heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: per edge chunk of
    PLAIN_CHUNK_EDGES, the scores, `u`, and `index_add_` of u·ht[col] and
    of u over `repeat_interleave`d destination rows, in f32; then the
    divide and one cast to ht's dtype."""
    num_rows, feat = rowptr.numel() - 1, ht.shape[1]
    fh = feat // heads
    out = torch.zeros((num_rows, feat), dtype=torch.float32, device=ht.device)
    z = torch.zeros((num_rows, heads), dtype=torch.float32, device=ht.device)
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=ht.device), rowptr[1:] - rowptr[:-1])
    for lo in range(0, col.numel(), PLAIN_CHUNK_EDGES):
        hi = min(lo + PLAIN_CHUNK_EDGES, col.numel())
        src, dst = col[lo:hi], rows[lo:hi]
        s = ts.index_select(0, src) + td.index_select(0, dst)
        s = torch.where(s >= 0, s, NEG_SLOPE * s)
        u = torch.exp(s.clamp(-ATT_CLIP, ATT_CLIP))              # [n, H]
        z.index_add_(0, dst, u)
        msg = ht.index_select(0, src).float().view(-1, heads, fh)
        out.index_add_(0, dst, (msg * u[:, :, None]).view(-1, feat))
    h = out.view(num_rows, heads, fh) / z.clamp_min(F32_TINY)[:, :, None]
    return h.view(num_rows, feat).to(ht.dtype), z


def gat_aggregate(ht: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                  rowptr: torch.Tensor, col: torch.Tensor,
                  heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention aggregation `(h, z)` of the module docstring: the plain
    version on the CPU, the CUDA kernel on the card."""
    if ht.device.type == "cpu":
        check_gat_args(ht, ts, td, rowptr, col, heads)
        return gat_aggregate_plain(ht, ts, td, rowptr, col, heads)
    if ht.device.type == "cuda":
        from .cuda.gat import gat_aggregate_cuda

        return gat_aggregate_cuda(ht, ts, td, rowptr, col, heads)
    raise ValueError(f"gat_aggregate runs on cpu or cuda tensors, not "
                     f"{ht.device}")
