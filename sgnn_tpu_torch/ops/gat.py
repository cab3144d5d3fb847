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

Training differentiates through `GatAggregate`, whose backward is K4, the
port of `mxu_gat.py::_gat_bwd_apply` (its math at mxu_gat.py:378-398).
With G = dL/dh, per destination d and head h `Gz = G/z` and `rz =
<G, h>/z` (0 where z = 0; `rz` equals `<G, out>/z²`, mxu_gat.py:655-661),
and per edge e = (s → d):

    score = ts[s,h] + td[d,h];  lr = leaky_relu(score);  u = exp(clip(lr))
    t_e   = <Gz[d, head h], ht[s, head h]>
    q_e   = u · lrelu'(score) · 1[|lr| <= 60] · (t_e − rz[d,h])   (= dL/dscore)
    B1, rows = sources (transposed CSR):  dht_agg[s] = Σ u·Gz[d]  (per head),
                                          dts[s,h]  = Σ q_e
    B2, rows = destinations (CSR):        dtd[d,h]  = Σ q_e

`pack_score_tables` stays a differentiable einsum, so autograd expands
dts/dtd into ht's and the attention vectors' gradients (the same function
as mxu_gat.py:673-682, split differently).  The clip's indicator is kept,
as torch.clamp's and jnp.clip's autodiff keep it (inclusive at ±60, as
torch.clamp); the Pallas K4 leaves it out, which matters only for saturated
scores (ROADMAP Queue 3).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .segment import SPMM_DTYPES, csr_rows, edge_chunks, plain_sum_dtype

# |score| clamp of the max-free exponential: the same constant as the JAX
# package's ops/segment.py:784 and ops/pallas/mxu_gat.py:65
ATT_CLIP = 60.0
# leaky_relu slope of the scores, sampled (models/gnn._gat_layer) and
# whole-graph (here and csrc/gat.cu kNegSlope) alike
NEG_SLOPE = 0.2
F32_TINY = torch.finfo(torch.float32).tiny


def table_dtype(ht: torch.Tensor) -> torch.dtype:
    """The score tables' dtype for rows `ht`: f64 for f64 rows, else f32
    (a bf16 row widens exactly)."""
    return torch.float64 if ht.dtype == torch.float64 else torch.float32


def pack_score_tables(ht: torch.Tensor, a_src: torch.Tensor,
                      a_dst: torch.Tensor, heads: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row score halves `(ts, td)`, each [rows, heads] in
    `table_dtype(ht)`: head h's attention vectors are the fh-column blocks
    of a_src / a_dst ([F]), the head structure of models/gnn._gat_layer.
    Products in f32 (a bf16 ht widens exactly), as the JAX einsum with f32
    accumulation."""
    f = ht.shape[1]
    if heads < 1 or f % heads:
        raise ValueError(f"pack_score_tables: heads={heads} must divide the "
                         f"width {f}")
    fh = f // heads
    acc = table_dtype(ht)
    hh = ht.to(acc).reshape(-1, heads, fh)
    ts = torch.einsum("vhf,hf->vh", hh, a_src.to(acc).reshape(heads, fh))
    td = torch.einsum("vhf,hf->vh", hh, a_dst.to(acc).reshape(heads, fh))
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
    rows = csr_rows(rowptr)
    for lo, hi in edge_chunks(col.numel()):
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


# ------------------------------------------------------------------ K4 -----
def check_gat_bwd_args(ht: torch.Tensor, ts: torch.Tensor, gz: torch.Tensor,
                       td: torch.Tensor, rz: torch.Tensor,
                       rowptr: torch.Tensor, col: torch.Tensor, heads: int,
                       rows_are_sources: bool) -> None:
    """Raise ValueError unless the arguments are what K4's passes take:
    ht [S, F] f32/bf16, ts [S, H], gz [D, F], td and rz [D, H] (all f32),
    and a CSR whose rows are the sources (B1) or the destinations (B2).
    Index bounds are the caller's to check, once, on the host."""
    if ht.dim() != 2 or ht.dtype not in SPMM_DTYPES or not ht.is_contiguous():
        raise ValueError("gat_bwd: ht must be a contiguous 2-D float32 or "
                         f"bfloat16 tensor, got {ht.dtype} {tuple(ht.shape)}")
    if heads < 1 or ht.shape[1] < 1 or ht.shape[1] % heads:
        raise ValueError(f"gat_bwd: heads={heads} must divide the width "
                         f"{ht.shape[1]} (at least 1)")
    num_src, feat = ht.shape
    num_dst = gz.shape[0] if gz.dim() == 2 else -1
    num_rows = rowptr.numel() - 1
    if num_rows != (num_src if rows_are_sources else num_dst):
        raise ValueError(f"gat_bwd: the CSR has {num_rows} rows, not one per "
                         f"{'source' if rows_are_sources else 'destination'}")
    for name, t, dt, shape in (
            ("ts", ts, torch.float32, (num_src, heads)),
            ("gz", gz, torch.float32, (num_dst, feat)),
            ("td", td, torch.float32, (num_dst, heads)),
            ("rz", rz, torch.float32, (num_dst, heads)),
            ("rowptr", rowptr, torch.int64, None),
            ("col", col, torch.int32, None)):
        want = 2 if shape else 1
        if t.dim() != want or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"gat_bwd: {name} must be a contiguous {want}-D "
                             f"{dt} tensor, got {t.dtype} {tuple(t.shape)}")
        if shape and tuple(t.shape) != shape:
            raise ValueError(f"gat_bwd: {name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
        if t.device != ht.device:
            raise ValueError(f"gat_bwd: {name} is on {t.device}, ht on "
                             f"{ht.device}")


def _edge_terms(ht, ts, gz, td, rz, src, dst, heads):
    """Per edge and head of one chunk: u, q (module docstring) and the
    gathered Gz rows [n, F]."""
    fh = ht.shape[1] // heads
    s = ts.index_select(0, src) + td.index_select(0, dst)
    lr = torch.where(s >= 0, s, NEG_SLOPE * s)
    u = torch.exp(lr.clamp(-ATT_CLIP, ATT_CLIP))
    slope = torch.where(s >= 0, 1.0, NEG_SLOPE) * (lr.abs() <= ATT_CLIP)
    g = gz.index_select(0, dst)
    t = (g.view(-1, heads, fh)
         * ht.index_select(0, src).float().view(-1, heads, fh)).sum(-1)
    return u, u * slope * (t - rz.index_select(0, dst)), g


def gat_bwd_src_plain(ht, ts, gz, td, rz, rowptr_t, col_t, heads
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4's B1 over the transposed CSR (rows are
    sources, `col_t` destinations), in edge chunks of PLAIN_CHUNK_EDGES:
    `(dht_agg [S, F], dts [S, H])` in f32, per-edge terms in f32, summed as
    `spmm_csr_plain` sums (`plain_sum_dtype`: f64 over hub rows)."""
    num_src, feat = ht.shape
    fh = feat // heads
    acc = plain_sum_dtype(rowptr_t)
    dht = torch.zeros((num_src, feat), dtype=acc, device=ht.device)
    dts = torch.zeros((num_src, heads), dtype=acc, device=ht.device)
    rows = csr_rows(rowptr_t)
    for lo, hi in edge_chunks(col_t.numel()):
        src, dst = rows[lo:hi], col_t[lo:hi]
        u, q, g = _edge_terms(ht, ts, gz, td, rz, src, dst, heads)
        dht.index_add_(0, src, (g.view(-1, heads, fh)
                                * u[:, :, None]).view(-1, feat).to(acc))
        dts.index_add_(0, src, q.to(acc))
    return dht.float(), dts.float()


def gat_bwd_dst_plain(ht, ts, gz, td, rz, rowptr, col, heads) -> torch.Tensor:
    """Plain PyTorch version of K4's B2 over the CSR (rows are
    destinations, `col` sources), in edge chunks: `dtd [D, H]` in f32,
    summed as B1's."""
    acc = plain_sum_dtype(rowptr)
    dtd = torch.zeros((gz.shape[0], heads), dtype=acc, device=ht.device)
    rows = csr_rows(rowptr)
    for lo, hi in edge_chunks(col.numel()):
        src, dst = col[lo:hi], rows[lo:hi]
        _, q, _ = _edge_terms(ht, ts, gz, td, rz, src, dst, heads)
        dtd.index_add_(0, dst, q.to(acc))
    return dtd.float()


def gat_bwd_src(ht, ts, gz, td, rz, rowptr_t, col_t, heads
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's B1 `(dht_agg, dts)`: the plain version on the CPU, the CUDA
    kernel on the card."""
    if ht.device.type == "cpu":
        check_gat_bwd_args(ht, ts, gz, td, rz, rowptr_t, col_t, heads, True)
        return gat_bwd_src_plain(ht, ts, gz, td, rz, rowptr_t, col_t, heads)
    if ht.device.type == "cuda":
        from .cuda.gat_bwd import gat_bwd_src_cuda

        return gat_bwd_src_cuda(ht, ts, gz, td, rz, rowptr_t, col_t, heads)
    raise ValueError(f"gat_bwd_src runs on cpu or cuda tensors, not "
                     f"{ht.device}")


def gat_bwd_dst(ht, ts, gz, td, rz, rowptr, col, heads) -> torch.Tensor:
    """K4's B2 `dtd`: the plain version on the CPU, the CUDA kernel on the
    card."""
    if ht.device.type == "cpu":
        check_gat_bwd_args(ht, ts, gz, td, rz, rowptr, col, heads, False)
        return gat_bwd_dst_plain(ht, ts, gz, td, rz, rowptr, col, heads)
    if ht.device.type == "cuda":
        from .cuda.gat_bwd import gat_bwd_dst_cuda

        return gat_bwd_dst_cuda(ht, ts, gz, td, rz, rowptr, col, heads)
    raise ValueError(f"gat_bwd_dst runs on cpu or cuda tensors, not "
                     f"{ht.device}")


def gat_bwd_operands(g: torch.Tensor, h: torch.Tensor, z: torch.Tensor,
                     heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The z-folded per-destination operands `(Gz [D, F], rz [D, H])` of
    the cotangent G = g of h, f32 and 0 where z = 0 (a row with no edges
    passes nothing back through the attention)."""
    rows, feat = g.shape
    fh = feat // heads
    zinv = torch.where(z > 0, 1.0 / z.clamp_min(1e-30), 0.0)
    g3 = g.float().view(rows, heads, fh)
    gz = (g3 * zinv[:, :, None]).view(rows, feat).contiguous()
    rz = (torch.einsum("vhf,vhf->vh", g3, h.float().view(rows, heads, fh))
          * zinv).contiguous()
    return gz, rz


class GatAggregate(torch.autograd.Function):
    """Differentiable attention aggregation over `(ht, ts, td)`: forward K3
    (`gat_aggregate`, returning h), backward K4's two passes, B1 over the
    transposed CSR (`rowptr_t`, `col_t`) and B2 over the CSR."""

    @staticmethod
    def forward(ctx, ht, ts, td, rowptr, col, rowptr_t, col_t, heads):
        h, z = gat_aggregate(ht, ts, td, rowptr, col, heads)
        ctx.heads = heads
        ctx.save_for_backward(ht, ts, td, h, z, rowptr, col, rowptr_t, col_t)
        return h

    @staticmethod
    def backward(ctx, g):
        ht, ts, td, h, z, rowptr, col, rowptr_t, col_t = ctx.saved_tensors
        heads = ctx.heads
        need_ht, need_ts, need_td = ctx.needs_input_grad[:3]
        dht = dts = dtd = None
        gz, rz = gat_bwd_operands(g, h, z, heads)
        if need_ht or need_ts:
            dht, dts = gat_bwd_src(ht, ts, gz, td, rz, rowptr_t, col_t, heads)
            dht = dht.to(ht.dtype) if need_ht else None
            dts = dts if need_ts else None
        if need_td:
            dtd = gat_bwd_dst(ht, ts, gz, td, rz, rowptr, col, heads)
        return dht, dts, dtd, None, None, None, None, None
