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
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

# edges per index_add_ step in the plain version: bounds its [chunk, F] f32
# temporaries (128 MB at F = 128)
PLAIN_CHUNK_EDGES = 1 << 18
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


def spmm_csr_plain(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `index_add_` of weighted source
    rows over `repeat_interleave`d destination rows, in edge chunks of
    PLAIN_CHUNK_EDGES, summed in f32 and returned in x's dtype."""
    num_rows = rowptr.numel() - 1
    out = torch.zeros((num_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    rows = torch.repeat_interleave(
        torch.arange(num_rows, device=x.device), rowptr[1:] - rowptr[:-1])
    for lo in range(0, col.numel(), PLAIN_CHUNK_EDGES):
        hi = min(lo + PLAIN_CHUNK_EDGES, col.numel())
        msg = x.index_select(0, col[lo:hi]).float() * w[lo:hi, None]
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
