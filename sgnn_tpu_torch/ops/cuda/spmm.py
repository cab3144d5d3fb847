"""Wrapper of the CSR SpMM kernel (`csrc/spmm.cu`).

`spmm_csr_cuda(x, rowptr, col, w)` launches the kernel on PyTorch's current
stream and returns `out[d] = Σ_{e∈row d} w_e·x[col_e]` in x's dtype.  It
checks device, dtype, contiguity and shapes and raises on anything the
kernel does not take; index bounds are the caller's to check, once, on the
host (`ops/segment.csr_from_numpy`).  `spmm_csr_cuda.launches` counts the
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..segment import SPMM_DTYPES, check_spmm_args
from .build import build

# the C side's dtype codes: 0 = float32, 1 = bfloat16, SPMM_DTYPES' order
_DTYPE_CODES = {dt: code for code, dt in enumerate(SPMM_DTYPES)}


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build("spmm").lib
    fn = lib.sgnn_spmm_csr
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def spmm_csr_cuda(x: torch.Tensor, rowptr: torch.Tensor, col: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    if x.device.type != "cuda":
        raise ValueError(f"spmm_csr_cuda takes CUDA tensors, got {x.device}")
    check_spmm_args(x, rowptr, col, w)
    num_rows, feat = rowptr.numel() - 1, x.shape[1]
    out = torch.empty((num_rows, feat), dtype=x.dtype, device=x.device)
    if num_rows == 0 or feat == 0:
        return out
    fn, err = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), rowptr.data_ptr(), col.data_ptr(),
                w.data_ptr(), out.data_ptr(), num_rows, feat,
                _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"spmm_csr kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
    spmm_csr_cuda.launches += 1
    return out


spmm_csr_cuda.launches = 0
