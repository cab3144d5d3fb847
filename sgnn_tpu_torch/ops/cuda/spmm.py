"""Wrappers of the CSR SpMM kernel (`csrc/spmm.cu`).

`spmm_csr_cuda(x, rowptr, col, w)` launches the kernel on PyTorch's current
stream and returns `out[d] = Σ_{e∈row d} w_e·x[col_e]` in x's dtype.
`spmm_csr_bwd_cuda(g, rowptr_t, col_t, w_t)` launches the same kernel as
K2's backward, `dx = Aᵀ·g` over the transposed CSR (`ops/segment.
csr_transpose`), through a wrapper of its own so that its launches are
counted apart from the forward's.  Both check device, dtype, contiguity
and shapes and raise on anything the kernel does not take; index bounds
are the caller's to check, once, on the host (`ops/segment.
csr_from_numpy`).  Rows longer than LONG_ROW_EDGES are split across warps
(`ops/segment.long_row_segments`, csrc/spmm.cu).  Each wrapper's
`.launches` counts its calls that launch the kernel, so a run can show
that its path went through it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..segment import (
    DTYPE_CODES, LONG_ROW_EDGES, check_spmm_args, long_row_segments,
)
from .build import build


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build("spmm").lib
    fn = lib.sgnn_spmm_csr
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 4 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(name: str, x: torch.Tensor, rowptr: torch.Tensor,
            col: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Check the arguments and launch; returns the output and the number
    of launches (0 for an empty output), which the caller counts."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {x.device}")
    check_spmm_args(x, rowptr, col, w)
    num_rows, feat = rowptr.numel() - 1, x.shape[1]
    out = torch.empty((num_rows, feat), dtype=x.dtype, device=x.device)
    if num_rows == 0 or feat == 0:
        return out, 0
    fn, err = _entry()
    with torch.cuda.device(x.device):
        seg_ptr, max_seg = long_row_segments(rowptr, col.numel())
        partial = torch.empty((max_seg, feat), dtype=torch.float32,
                              device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), rowptr.data_ptr(), col.data_ptr(),
                w.data_ptr(), out.data_ptr(), seg_ptr.data_ptr(),
                partial.data_ptr(), num_rows, feat, LONG_ROW_EDGES, max_seg,
                DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    return out, 1


def spmm_csr_cuda(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    out, n = _launch("spmm_csr", x, rowptr, col, w)
    spmm_csr_cuda.launches += n
    return out


def spmm_csr_bwd_cuda(g: torch.Tensor, rowptr_t: torch.Tensor,
                      col_t: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """K2's backward: the kernel over the transposed CSR; raises on
    anything but CUDA tensors."""
    out, n = _launch("spmm_csr_bwd", g, rowptr_t, col_t, w_t)
    spmm_csr_bwd_cuda.launches += n
    return out


spmm_csr_cuda.launches = 0
spmm_csr_bwd_cuda.launches = 0
