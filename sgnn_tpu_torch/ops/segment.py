"""Whole-graph weighted aggregation over a CSR keyed by destination.

`spmm_csr(x, rowptr, col, w)` computes `out[d] = Σ_{e∈row d} w_e·x[col_e]`
with an f32 sum and the result in x's dtype.  It is the port's counterpart
of the JAX package's static-weight SpMMs (`spmm_coo_fwd_sorted` and the
one-hot `mxu_spmm_fwd` kernel): the graph is kept as the CSC arrays
themselves — `rowptr` the column offsets (int64), `col` the source ids
(int32), `w` the edge weights (f32) — with no window planner and no edge
padding, which the JAX package needs only for XLA's static shapes.

Dispatch: a CPU tensor goes to `spmm_csr_plain`; a CUDA tensor launches the
kernel (ops/cuda/spmm.py) or raises.  There is no fallback between them.

Training (the whole-graph engines) differentiates through `SpmmCsr`: its
backward is K2's backward, `dx = Aᵀ·g`, the same function over the CSR
keyed by source that `csr_transpose` builds once on the host — what
`sgnn_tpu/ops/pallas/mxu_spmm.py::_mxu_bwd` is on the TPU (the same kernel
on the transposed plan); on the card the edge-balanced sum of
csrc/csr_sum.cuh takes its hub rows.  The edge weights are graph constants: no
gradient reaches them, as in `_mxu_bwd`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device

# edges per index_add_ step in the plain versions: bounds their [chunk, F]
# temporaries (128 MB of f32 at F = 128)
PLAIN_CHUNK_EDGES = 1 << 18
# the plain versions sum in f32 in CSR edge order, as the JAX package's CPU
# path does; over a CSR with a row longer than this they sum in f64: the f32
# sum of a hub row of ~1e6 terms strays by ~sqrt(n) roundings, more than the
# kernels' pieced sums (csr_chunk_edges) that the plain versions check
PLAIN_F64_ROW_EDGES = 1 << 16
# edges per warp of the CSR walk (csrc/csr_sum.cuh: K2's backward, K1's
# dx, K4's B1), `csr_chunk_edges`: a power of two near max_edges /
# CSR_CHUNK_WARPS within [CSR_CHUNK_MIN, CSR_CHUNK_MAX], so a large CSR
# gets some 2^15-2^16 warps and a small one the minimum.  A row with more edges is summed in pieces,
# one per chunk it overlaps, combined in a fixed tree; the chunk depends
# only on the edge count, so a given CSR always sums in the same order.
# scripts/torch_csr_sum_chunks.py times 32-1024 at the main path's shapes
# (PERF.md §6): the transposed Reddit-shaped CSR (11.9M edges) is
# fastest at 256-512, a sampled block's transpose (2.3M and 0.25M slots)
# at 64.
CSR_CHUNK_MIN, CSR_CHUNK_MAX, CSR_CHUNK_WARPS = 64, 1024, 1 << 16
# rows with more edges than this would keep one warp busy while the card
# idles: K2's forward takes the edge-balanced sum over a CSR that has one
# (a warp per row otherwise).  The transposed CSR of a skewed graph has hub
# rows of ~1e6 edges
LONG_ROW_EDGES = 1024
# dtypes of x (and of the result) that the kernels take; w is always f32
SPMM_DTYPES = (torch.float32, torch.bfloat16)
# the C side's dtype codes of every csrc/ kernel: 0 = float32, 1 = bfloat16
DTYPE_CODES = {dt: code for code, dt in enumerate(SPMM_DTYPES)}


class Csr(NamedTuple):
    """Rows are destinations: row d's edges are [rowptr[d], rowptr[d+1])."""

    rowptr: torch.Tensor   # [R+1] int64
    col: torch.Tensor      # [E]   int32, source row ids
    w: torch.Tensor        # [E]   f32 edge weights

    @property
    def num_rows(self) -> int:
        return self.rowptr.numel() - 1


def csr_from_numpy(rowptr: np.ndarray, col: np.ndarray, w: np.ndarray,
                   num_src: int, device=None) -> Csr:
    """Check a host CSR once and upload it.  A CUDA kernel reads out of
    bounds where JAX would clamp, so the bounds are checked here."""
    rowptr = np.ascontiguousarray(rowptr, np.int64)
    col = np.ascontiguousarray(col, np.int32)
    w = np.ascontiguousarray(w, np.float32)
    if rowptr.ndim != 1 or rowptr.size < 1 or rowptr[0] != 0:
        raise ValueError("rowptr must be 1-D and start at 0")
    if np.any(np.diff(rowptr) < 0):
        raise ValueError("rowptr must be non-decreasing")
    if int(rowptr[-1]) != col.size or col.size != w.size:
        raise ValueError(f"rowptr ends at {int(rowptr[-1])}, with {col.size} "
                         f"source ids and {w.size} weights")
    if col.size and (int(col.min()) < 0 or int(col.max()) >= num_src):
        raise ValueError(f"source ids must lie in [0, {num_src})")
    dev = resolve_device(device)
    return Csr(torch.from_numpy(rowptr).to(dev), torch.from_numpy(col).to(dev),
               torch.from_numpy(w).to(dev))


def unique_inverse(ids: np.ndarray):
    """`np.unique(ids, return_inverse=True)` (the same two arrays, int32)
    for non-negative int32 ids, by one value sort of (id, position) keys
    instead of numpy's argsort: O(n log n) in the ids alone, whatever the
    number of vertices they index."""
    n = ids.size
    key = (ids.astype(np.int64) << 32) | np.arange(n, dtype=np.int64)
    key.sort()
    s = (key >> 32).astype(np.int32)
    new = np.empty(n, bool)
    new[:1] = True
    np.not_equal(s[1:], s[:-1], out=new[1:])
    inv = np.empty(n, np.int32)
    inv[key & 0xFFFFFFFF] = np.cumsum(new, dtype=np.int32) - 1
    return s[new], inv


def csr_transpose(rowptr: np.ndarray, col: np.ndarray, w: np.ndarray,
                  num_src: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The same edges as a CSR keyed by source, on the host: `(rowptr_t
    [num_src+1] int64, col_t [E] int32 destinations, w_t [E] f32)`.  The
    native library's stable counting sort by source
    (`sampler.native.stable_argsort`, bit-identical to `np.argsort(col,
    kind="stable")`) keeps each source's edges in ascending destination
    order, as `sgnn_tpu/train/fullbatch.py::csr_order`."""
    from ..sampler.native import stable_argsort

    rowptr = np.asarray(rowptr, np.int64)
    col = np.asarray(col)
    rows = np.repeat(np.arange(rowptr.size - 1, dtype=np.int32),
                     np.diff(rowptr))
    perm = stable_argsort(col, num_src)
    rowptr_t = np.zeros(num_src + 1, np.int64)
    np.cumsum(np.bincount(col, minlength=num_src), out=rowptr_t[1:])
    return rowptr_t, rows[perm], np.asarray(w, np.float32)[perm]


def csr_chunk_edges(max_edges: int) -> int:
    """The CSR sum's edges per warp for a CSR of at most `max_edges`
    edges."""
    near = 1 << (max_edges // CSR_CHUNK_WARPS).bit_length()
    return min(CSR_CHUNK_MAX, max(CSR_CHUNK_MIN, near))


def check_spmm_args(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                    w: torch.Tensor) -> None:
    """Raise ValueError unless the arguments are what the kernel takes."""
    if x.dim() != 2 or x.dtype not in SPMM_DTYPES or not x.is_contiguous():
        raise ValueError("spmm_csr: x must be a contiguous 2-D float32 or "
                         f"bfloat16 tensor, got {x.dtype} {tuple(x.shape)}")
    for name, t, dt in (("rowptr", rowptr, torch.int64),
                        ("col", col, torch.int32), ("w", w, torch.float32)):
        if t.dim() != 1 or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"spmm_csr: {name} must be a contiguous 1-D "
                             f"{dt} tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"spmm_csr: {name} is on {t.device}, x on "
                             f"{x.device}")
    if rowptr.numel() < 1 or col.numel() != w.numel():
        raise ValueError("spmm_csr: rowptr needs num_rows+1 entries and col "
                         f"and w one per edge, got {rowptr.numel()}, "
                         f"{col.numel()}, {w.numel()}")


def plain_sum_dtype(rowptr: torch.Tensor) -> torch.dtype:
    """The plain versions' summation dtype over this CSR: f32, or f64 when
    a row is longer than PLAIN_F64_ROW_EDGES."""
    if rowptr.numel() < 2:
        return torch.float32
    longest = int((rowptr[1:] - rowptr[:-1]).max())
    return torch.float64 if longest > PLAIN_F64_ROW_EDGES else torch.float32


def csr_rows(rowptr: torch.Tensor) -> torch.Tensor:
    """Each edge's row, in CSR edge order (int64, on rowptr's device)."""
    num_rows = rowptr.numel() - 1
    return torch.repeat_interleave(torch.arange(num_rows, device=rowptr.device),
                                   rowptr[1:] - rowptr[:-1])


def edge_chunks(num_edges: int):
    """The plain versions' steps: `(lo, hi)` edge ranges of at most
    PLAIN_CHUNK_EDGES."""
    for lo in range(0, num_edges, PLAIN_CHUNK_EDGES):
        yield lo, min(lo + PLAIN_CHUNK_EDGES, num_edges)


def spmm_csr_plain(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `index_add_` of weighted source
    rows over `repeat_interleave`d destination rows, in edge chunks of
    PLAIN_CHUNK_EDGES, summed in f32 (f64 over a CSR with hub rows,
    `plain_sum_dtype`) and returned in x's dtype."""
    num_rows = rowptr.numel() - 1
    acc = plain_sum_dtype(rowptr)
    out = torch.zeros((num_rows, x.shape[1]), dtype=acc, device=x.device)
    rows = csr_rows(rowptr)
    for lo, hi in edge_chunks(col.numel()):
        msg = x.index_select(0, col[lo:hi]).to(acc) * w[lo:hi, None].to(acc)
        out.index_add_(0, rows[lo:hi], msg)
    return out.to(x.dtype)


def spmm_csr(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """`out[d] = Σ_{e∈row d} w_e·x[col_e]`: the plain version on the CPU,
    the CUDA kernel on the card."""
    if x.device.type == "cpu":
        check_spmm_args(x, rowptr, col, w)
        return spmm_csr_plain(x, rowptr, col, w)
    if x.device.type == "cuda":
        from .cuda.spmm import spmm_csr_cuda

        return spmm_csr_cuda(x, rowptr, col, w)
    raise ValueError(f"spmm_csr runs on cpu or cuda tensors, not {x.device}")


def spmm_csr_bwd(g: torch.Tensor, rowptr_t: torch.Tensor, col_t: torch.Tensor,
                 w_t: torch.Tensor) -> torch.Tensor:
    """K2's backward, `dx = Aᵀ·g` over the transposed CSR: the plain
    version on the CPU, the edge-balanced CSR sum on the card, launched
    through a wrapper of its own (`spmm_csr_bwd_cuda`, with its own launch
    count)."""
    if g.device.type == "cpu":
        check_spmm_args(g, rowptr_t, col_t, w_t)
        return spmm_csr_plain(g, rowptr_t, col_t, w_t)
    if g.device.type == "cuda":
        from .cuda.spmm import spmm_csr_bwd_cuda

        return spmm_csr_bwd_cuda(g, rowptr_t, col_t, w_t)
    raise ValueError(f"spmm_csr_bwd runs on cpu or cuda tensors, not "
                     f"{g.device}")


class SpmmCsr(torch.autograd.Function):
    """Differentiable whole-graph SpMM: forward `spmm_csr` over the CSR,
    backward `spmm_csr_bwd` over the transposed one (`csr_transpose`).
    Only x takes a gradient."""

    @staticmethod
    def forward(ctx, x, rowptr, col, w, rowptr_t, col_t, w_t):
        ctx.save_for_backward(rowptr_t, col_t, w_t)
        return spmm_csr(x, rowptr, col, w)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return (None,) * 7
        dx = spmm_csr_bwd(g.contiguous(), *ctx.saved_tensors)
        return (dx,) + (None,) * 6
