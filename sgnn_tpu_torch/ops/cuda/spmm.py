"""Wrappers of the CSR SpMM kernels (`csrc/spmm.cu`).

`spmm_csr_cuda(x, rowptr, col, w)` launches the forward on PyTorch's
current stream and returns `out[d] = Σ_{e∈row d} w_e·x[col_e]` in x's
dtype: a warp per row when every row has at most LONG_ROW_EDGES edges
(`rows_fit_a_warp`, worked out once per CSR; `forward_layout` says how the
row kernel lays out x's columns), else the edge-balanced sum of
`csrc/csr_sum.cuh`.  `spmm_csr_bwd_cuda(g, rowptr_t, col_t, w_t)` is K2's
backward, `dx = Aᵀ·g` over the transposed CSR (`ops/segment.
csr_transpose`), whose hub rows that sum takes: every warp the same number
of edges (`ops/segment.csr_chunk_edges`), the pieces of longer rows
combined in a fixed tree, and no per-call setup but the carry scratch.
Both check device, dtype, contiguity and shapes and raise on anything the
kernels do not take; index bounds are the caller's to check, once, on the
host (`ops/segment.csr_from_numpy`).  Each wrapper's `.launches` counts
its calls that launch its kernels, so a run can show that its path went
through them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import (
    DTYPE_CODES, LONG_ROW_EDGES, check_spmm_args, csr_chunk_edges,
)
from .build import build

# the C signature that spmm.cu's and gather_agg.cu's CSR sums share: x,
# rowptr, col, w, out, carry, carry_row; num_rows, max_edges, chunk, feat;
# vec, dtype; stream
CSR_SUM_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4
                    + [ctypes.c_int] * 2 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    lib = build("spmm").lib
    fn = getattr(lib, name)
    fn.argtypes = {
        "sgnn_spmm_csr_sum": CSR_SUM_ARGTYPES,
        "sgnn_spmm_csr": ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 2
                          + [ctypes.c_int, ctypes.c_void_p]),
        "sgnn_spmm_csr_layout": ([ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_int]
                                 + [ctypes.POINTER(ctypes.c_int)] * 5),
    }[name]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def rows_fit_a_warp(rowptr: torch.Tensor) -> bool:
    """Whether every row of the CSR has at most LONG_ROW_EDGES edges, the
    forward's choice of kernel.  Worked out once per CSR, with one host
    sync, and kept on its rowptr tensor: a CSR's tensors are constants of
    the model."""
    fits = getattr(rowptr, "_sgnn_rows_fit_a_warp", None)
    if fits is None:
        fits = bool(rowptr.numel() < 2 or int(
            (rowptr[1:] - rowptr[:-1]).max()) <= LONG_ROW_EDGES)
        rowptr._sgnn_rows_fit_a_warp = fits
    return fits


def forward_layout(x: torch.Tensor) -> dict:
    """How the row kernel (`csrc/spmm.cu` `row_layout`) lays out x's
    columns: `lanes` a group (16: two half-warps on alternate edges),
    `cols` column groups a lane, `vec` columns a load (4: one 16-/8-byte
    vector where F % 4 == 0 and x is 16-byte aligned; 1: scalar); and the
    `registers` and `local_bytes` (spills) a thread of that kernel
    instance, as the loaded module reports them."""
    got = [ctypes.c_int() for _ in range(5)]
    fn, err = _entry("sgnn_spmm_csr_layout")
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), x.shape[1], DTYPE_CODES[x.dtype],
                *(ctypes.byref(g) for g in got))
    if rc != 0:
        raise RuntimeError(f"spmm_csr_layout failed: {err(rc).decode()}")
    return dict(zip(("lanes", "cols", "vec", "registers", "local_bytes"),
                    (g.value for g in got)))


_sum_entry = functools.partial(_entry, "sgnn_spmm_csr_sum")


def launch_csr_sum(entry, name: str, x: torch.Tensor, rowptr: torch.Tensor,
                   col: torch.Tensor, w: torch.Tensor, max_edges: int,
                   stream: int) -> torch.Tensor:
    """Launch a csr_sum.cuh entry (`entry()` → (fn, err)) on `stream` of
    x's device, the current one, over a CSR of `rowptr.numel() - 1 >= 1`
    rows whose edge count is at most `max_edges`; returns the [rows, F]
    result in x's dtype.  The carry scratch, one f32 row per piece slot of
    a chunk and then each slot's row (int32), is one allocation."""
    num_rows, feat = rowptr.numel() - 1, x.shape[1]
    out = torch.empty((num_rows, feat), dtype=x.dtype, device=x.device)
    chunk = csr_chunk_edges(max_edges)
    slots = 2 * max(1, -(-max_edges // chunk))
    carry = torch.empty(slots * (feat + 1), dtype=torch.float32,
                        device=x.device)
    # 16-byte (f32) or 8-byte (bf16) loads of 4 columns need F % 4 == 0 and
    # an aligned base; a view at an odd offset takes scalar columns
    vec = int(feat % 4 == 0 and x.data_ptr() % 16 == 0)
    fn, err = entry()
    rc = fn(x.data_ptr(), rowptr.data_ptr(), col.data_ptr(), w.data_ptr(),
            out.data_ptr(), carry.data_ptr(),
            carry.data_ptr() + 4 * slots * feat, num_rows, max_edges, chunk,
            feat, vec, DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    return out


def _checked(name: str, x: torch.Tensor, rowptr: torch.Tensor,
             col: torch.Tensor, w: torch.Tensor) -> bool:
    """Check the arguments; False for an empty output (nothing to
    launch)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {x.device}")
    check_spmm_args(x, rowptr, col, w)
    return rowptr.numel() > 1 and x.shape[1] > 0


def spmm_csr_cuda(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """The forward on CUDA tensors; raises on anything else."""
    live = _checked("spmm_csr", x, rowptr, col, w)
    num_rows, feat = rowptr.numel() - 1, x.shape[1]
    if not live:
        return torch.empty((num_rows, feat), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if rows_fit_a_warp(rowptr):
            out = torch.empty((num_rows, feat), dtype=x.dtype,
                              device=x.device)
            fn, err = _entry("sgnn_spmm_csr")
            rc = fn(x.data_ptr(), rowptr.data_ptr(), col.data_ptr(),
                    w.data_ptr(), out.data_ptr(), num_rows, feat,
                    DTYPE_CODES[x.dtype], stream)
            if rc != 0:
                raise RuntimeError(f"spmm_csr kernel launch failed: CUDA "
                                   f"error {rc} ({err(rc).decode()})")
        else:
            out = launch_csr_sum(_sum_entry, "spmm_csr", x, rowptr, col, w,
                                 col.numel(), stream)
    spmm_csr_cuda.launches += 1
    return out


def spmm_csr_bwd_cuda(g: torch.Tensor, rowptr_t: torch.Tensor,
                      col_t: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """K2's backward: the edge-balanced sum over the transposed CSR;
    raises on anything but CUDA tensors."""
    if not _checked("spmm_csr_bwd", g, rowptr_t, col_t, w_t):
        return torch.empty((rowptr_t.numel() - 1, g.shape[1]), dtype=g.dtype,
                           device=g.device)
    with torch.cuda.device(g.device):
        out = launch_csr_sum(
            _sum_entry, "spmm_csr_bwd", g, rowptr_t, col_t, w_t,
            col_t.numel(), torch.cuda.current_stream(g.device).cuda_stream)
    spmm_csr_bwd_cuda.launches += 1
    return out


spmm_csr_cuda.launches = 0
spmm_csr_bwd_cuda.launches = 0
